// What the two env-last sweeps share (sweep_envlast_slim.cu, kernel #1, and
// solver_sweep_envlast.cu, kernel #3), for Hopper (sm_90a).
//
// Both walk `n_iters` passes over the constraint rows, strictly in order
// within each env, envs independent, on arrays laid out env-LAST
// ([rows, cols, B]). A block takes E envs (E a power of two, at most 16):
//
// - the consumer warp: 2 threads per env, lane = side * E + e (a lane past
//   2 * E repeats lane % (2 * E)). Side 0 holds body A of every row, side 1
//   body B. Each computes its half of J.v and its own body's update; one
//   __shfl_xor_sync(.., E) joins the halves (sum = A's half + B's half, as
//   the one-thread-per-env kernels summed), so both lanes of an env hold
//   the same sums and store the same impulses. On a skip_b row both take
//   side 0's half, and side 1 updates a spare body (zeroed at set-up) that
//   nothing reads. Everything the dependent chain reads
//   or writes sits in shared memory for the whole call (`Resident`):
//   velocities and push velocities [6][nb + 1][E], impulses [n_rows][E],
//   push impulses [n_push][E]. Device memory sees them once on the way in
//   and once on the way out.
// - the producer warp streams the rows into a ring of `stages` stages of
//   kStageRows rows each ([rows*cols][E] boxes per streamed array, plus the
//   rows' block of the metadata table), ahead of the consumer. Where the
//   env stride is a multiple of 16 bytes its lane 0 fills each box with one
//   TMA copy (cp.async.bulk.tensor.2d on the [rows*cols, B] view) and the
//   metadata with one bulk copy, completion on the stage's `full`
//   mbarrier; otherwise its 32 lanes copy with plain loads. The consumer
//   waits on the stage's `ready` mbarrier (`full`, or in kernel #1 a third
//   warp's, once it has added the stage's 1/eff) and frees the stage on
//   its `empty` mbarrier after the stage's last visit. The kernels never
//   write what they stream, so the async copies cannot race their stores.
//
// A visit is one basic block: its shared-memory loads first, then the read
// of the next row (its offsets and, in #1, dv: off the chain), then the
// chain (six FMAs, the shuffle, the clamp by selects) and the stores, with
// no store guarded. So a visit costs its chain plus what the one warp
// issues beside it; the ring's 8-row stages run unrolled.
//
// Shared memory, in bytes (kernels/sweep.py and kernels/sweep_envlast.py
// plan the same sums): kAlign of slack to align the ring, the ring
// (stages * stage_bytes), kAlign for the 3 * stages mbarriers, then the
// resident arrays, 4 * E * (2 * (nb6 + 6) + n_rows + n_push + extra_per_env).

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace ring {

constexpr int kStageRows = 8;    // rows per stage, the TPU kernels' chunk
constexpr int kThreads = 64;     // consumer and producer warps (kernel #1 adds a third)
constexpr int kMaxEnvs = 16;     // 2 threads per env in one warp
constexpr int kMaxStages = 4;    // the mbarriers' kAlign bytes hold 3 * 4
constexpr size_t kAlign = 128;   // TMA destinations and the mbarrier block
constexpr int kJoint = 0;
constexpr int kNormal = 1;
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

// the whole dynamic shared memory of a launch; see the header note
__host__ __device__ constexpr size_t smem_bytes(int envs, int stages, size_t stage_bytes,
                                                int nb6, int n_rows, int n_push,
                                                int extra_per_env) {
  return kAlign + (size_t)stages * stage_bytes + kAlign +
         4 * (size_t)envs * (2 * ((size_t)nb6 + 6) + n_rows + n_push + extra_per_env);
}

// Calls f(std::integral_constant<int, E>{}) with the plan's envs per block
// as a constant: every E a plan can take has its own instance.
template <typename F>
int with_envs(int envs, F&& f) {
  switch (envs) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 1: return f(std::integral_constant<int, 1>{});
  }
  return (int)cudaErrorInvalidValue;
}

inline bool valid_plan(int envs, int stages) {
  return envs >= 1 && envs <= kMaxEnvs && (envs & (envs - 1)) == 0 && stages >= 2 &&
         stages <= kMaxStages;
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of parity `parity` has completed. A wait that has
// not completed after ~2^35 cycles (~17 s) can only be a fault of the
// pipeline: it traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// one contiguous block of global memory into shared memory (16-byte aligned,
// a multiple of 16 bytes), completion on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

constexpr int kBatch = 8;  // loads a lane has in flight in the plain-load copies

// One stage's box of an env-last array [nr_pad, cols, B] by plain loads:
// rows [row0, row0 + kStageRows) x cols x envs [env0, env0 + E) into
// dst [kStageRows * cols][E], zero outside the array. T is the raw element
// (2 or 4 bytes): bits are copied, not converted. Each lane issues kBatch
// loads before it stores any.
template <typename T>
__device__ __forceinline__ void copy_box(T* dst, const T* __restrict__ src, int row0, int cols,
                                         int nr_pad, int B, int env0, int E, int lane) {
  const int n = kStageRows * cols * E;
  const int valid = (nr_pad - row0) * cols;  // box rows*cols inside the array
  for (int base = lane; base < n; base += 32 * kBatch) {
    T x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + 32 * k, rc = i / E, env = env0 + (i - rc * E);
      x[k] = (i < n && rc < valid && env < B) ? src[((size_t)row0 * cols + rc) * B + env] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (base + 32 * k < n) dst[base + 32 * k] = x[k];
  }
}

// `n` words by plain loads, kBatch in flight per lane
__device__ __forceinline__ void copy_words(int* dst, const int* __restrict__ src, int n,
                                           int lane) {
  for (int base = lane; base < n; base += 32 * kBatch) {
    int x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) x[k] = base + 32 * k < n ? src[base + 32 * k] : 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (base + 32 * k < n) dst[base + 32 * k] = x[k];
  }
}

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime,
// so the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA map of an env-last array [nr_pad, cols, B] seen as [nr_pad * cols, B]
// (B innermost), with boxes of [kStageRows * cols][envs]; outside the array
// the box is zero-filled
inline cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int elt_bytes, int nr_pad,
                               int cols, int B, int envs) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)B, (cuuint64_t)nr_pad * cols};
  const cuuint64_t strides[1] = {(cuuint64_t)B * elt_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)envs, (cuuint32_t)(kStageRows * cols)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map,
                        elt_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        2, const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the ring: where stage `slot` lies, and one warp's slot/phase counters
// ---------------------------------------------------------------------------

struct Ring {
  unsigned char* base;  // stage 0
  size_t stage_bytes;
  uint64_t* full;   // [stages]: the producer's 32 lanes arrive (+ TMA bytes)
  uint64_t* empty;  // [stages]: the consumer's 32 lanes arrive
  uint64_t* ready;  // [stages]: what the consumer waits on; `full`, or a barrier
                    // another warp's 32 lanes arrive on once they have prepared the stage
  int stages;
  int slot = 0;
  unsigned phase = 0;

  __device__ unsigned char* stage() const { return base + (size_t)slot * stage_bytes; }
  __device__ void advance() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// ---------------------------------------------------------------------------
// the resident arrays and the dependent chain of one row visit
// ---------------------------------------------------------------------------

// One row as one consumer thread needs it: its body's half of J and of
// Minv.J^T, the row's scalars, and where its loads and stores go. Read one
// row ahead of its visit.
struct Row {
  float j[6], dv[6];
  float ie, rhs, rhs_push, mu;
  float lo, hi;  // the clamp of a joint row ([lo, hi]) or a contact normal ([0, inf))
  int vo;        // this thread's body in the [6][nb + 1][E] arrays, body * E + e; side 1
                 // of a skip_b row takes the spare body nb, whose values nothing reads
  int lam_at;    // r * E + e
  int par_at;    // the friction parent's impulse, parent * E + e (lam_at on other rows)
  int plam_at;   // the push slot, pslot * E + e (contact normal rows)
  bool both;     // the row has a body B: sum the partner's half
  bool fric;     // friction row: clamp +-mu * lam[parent]
  bool push;     // contact normal row: the split-impulse pass too
};

struct Resident {
  float* v;     // [6][nb + 1][E] velocities (body nb: spare)
  float* pv;    // [6][nb + 1][E] push velocities
  float* lam;   // [n_rows][E] impulses
  float* plam;  // [n_push][E] push impulses
  int nbE;      // (nb + 1) * E: the stride of a velocity component
  int E;
};

// clamp that keeps a NaN candidate NaN (jnp.clip / torch.clamp semantics)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// The joined half sums, the same float on both lanes of an env: A's half +
// B's half (side 1 adds them the other way round, which gives the same
// float), or, on a skip_b row, A's half alone, which side 1 takes from its
// partner. The side is the lane's bit `partner` (lane = side * E + e, and
// warps start at multiples of 32 > E).
__device__ __forceinline__ float join(float own, bool both, int partner) {
  const float other = __shfl_xor_sync(kAll, own, partner);
  const bool side1 = (threadIdx.x & partner) != 0;
  return both ? own + other : (side1 ? other : own);
}

// 1 / eff as the one-thread-per-env kernels computed it
__device__ __forceinline__ float inv_eff(float eff) {
  return eff > 1e-12f ? 1.f / fmaxf(eff, 1e-12f) : 0.f;
}

__device__ __forceinline__ float infinity() { return __int_as_float(0x7f800000); }

// The clamp bounds of a row by kind, fixed when the row is read: joint rows
// their streamed bounds, contact normals [0, inf) (max(cand, 0), NaN kept);
// friction rows take +-mu * lam[parent] at the visit.
__device__ __forceinline__ void set_kind(Row& w, int kind, float lo, float hi) {
  w.fric = kind > kNormal;
  w.lo = kind == kJoint ? lo : 0.f;
  w.hi = kind == kJoint ? hi : infinity();
}

// One visit of row w: the velocity pass (impulse update with the clamp by
// kind, friction bounded by mu * lam[parent] as it stands) and, where kPush,
// the contact normal row's split-impulse pass, which shares no data with the
// velocity pass and runs beside it. All loads come first, then `read_next`
// (the next row's read, off the chain), then the chain and the stores: one
// basic block, no branch. Every lane stores; the two sides of an env hold
// the same joined sums (`join`) and so store the same impulse, and a lane
// beyond 2 * E repeats lane % (2 * E) exactly. Ends
// with __syncwarp, so the next visit's loads see every lane's stores.
template <bool kPush, typename Next>
__device__ __forceinline__ void visit(const Row& w, const Resident& s, Next&& read_next) {
  float x[6], px[6], pold = 0.f;
#pragma unroll
  for (int c = 0; c < 6; ++c) x[c] = s.v[w.vo + c * s.nbE];
  if (kPush) {
#pragma unroll
    for (int c = 0; c < 6; ++c) px[c] = s.pv[w.vo + c * s.nbE];
    pold = s.plam[w.plam_at];
  }
  const float old = s.lam[w.lam_at];
  const float par = s.lam[w.par_at];
  read_next();
  float jv = 0.f;
#pragma unroll
  for (int c = 0; c < 6; ++c) jv += w.j[c] * x[c];
  jv = join(jv, w.both, s.E);
  const float cand = old + (w.rhs - jv) * w.ie;
  const float lim = w.mu * par;
  const float nl = clip(cand, w.fric ? -lim : w.lo, w.fric ? lim : w.hi);
  const float d = nl - old;
  s.lam[w.lam_at] = nl;
#pragma unroll
  for (int c = 0; c < 6; ++c) s.v[w.vo + c * s.nbE] = x[c] + w.dv[c] * d;
  if (kPush) {
    float jvp = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) jvp += w.j[c] * px[c];
    jvp = join(jvp, w.both, s.E);
    float pnew = pold + (w.rhs_push - jvp) * w.ie;
    pnew = pnew < 0.f ? 0.f : pnew;
    const float dp = pnew - pold;
    s.plam[w.plam_at] = pnew;
#pragma unroll
    for (int c = 0; c < 6; ++c) s.pv[w.vo + c * s.nbE] = px[c] + w.dv[c] * dp;
  }
  __syncwarp();
}

// The consumer warp's walk over the ring: per stage, wait until it is
// ready, visit its rows in order, each read one row ahead (`rd.read`)
// inside the visit before, and free the stage. Full stages run unrolled;
// the last, partial stage of a pass (n_rows not a multiple of kStageRows)
// checks its count.
template <bool kFull, typename Reader>
__device__ __forceinline__ void visit_stage(Reader& rd, const Resident& s,
                                            const unsigned char* st, int r0, int count) {
  Row w[2];
  rd.read(w[0], st, 0, r0);
#pragma unroll
  for (int k = 0; k < kStageRows; ++k) {
    if (!kFull && k >= count) break;
    Row& cur = w[k & 1];
    Row& nxt = w[(k + 1) & 1];
    auto next = [&]() {
      if (k + 1 < kStageRows && (kFull || k + 1 < count)) rd.read(nxt, st, k + 1, r0 + k + 1);
    };
    if (cur.push)
      visit<true>(cur, s, next);
    else
      visit<false>(cur, s, next);
  }
}

template <typename Reader>
__device__ __forceinline__ void consume(Ring& ring, Reader& rd, const Resident& s, int n_rows,
                                        int n_iters) {
  for (int it = 0; it < n_iters; ++it) {
    for (int r0 = 0; r0 < n_rows; r0 += kStageRows) {
      bar_wait(&ring.ready[ring.slot], ring.phase);
      const unsigned char* st = ring.stage();
      const int count = min(kStageRows, n_rows - r0);
      if (count == kStageRows)
        visit_stage<true>(rd, s, st, r0, count);
      else
        visit_stage<false>(rd, s, st, r0, count);
      bar_arrive(&ring.empty[ring.slot]);
      ring.advance();
    }
  }
}

// ---------------------------------------------------------------------------
// setup and write-back of the resident arrays (env-last in device memory)
// ---------------------------------------------------------------------------

// All the block's threads: velocities (push velocities zero), impulses of the
// visited rows, push impulses zero; padding rows' impulses go straight to
// lam_out. Envs beyond B read as zero; so does the spare body.
__device__ __forceinline__ void load_resident(const Resident& s, const float* __restrict__ vel_in,
                                              const float* __restrict__ lam_in,
                                              float* __restrict__ lam_out, int nb, int nr_pad,
                                              int n_rows, int n_push, int B, int env0) {
  const int E = s.E;
  for (int i = threadIdx.x; i < nb * 6 * E; i += blockDim.x) {
    const int k = i / E, e = i - k * E, env = env0 + e;
    const int at = (k % 6) * s.nbE + (k / 6) * E + e;
    s.v[at] = env < B ? vel_in[(size_t)k * B + env] : 0.f;
    s.pv[at] = 0.f;
  }
  for (int i = threadIdx.x; i < 6 * E; i += blockDim.x) {  // the spare body nb
    const int at = (i / E) * s.nbE + nb * E + i % E;
    s.v[at] = 0.f;
    s.pv[at] = 0.f;
  }
  for (int i = threadIdx.x; i < n_rows * E; i += blockDim.x) {
    const int r = i / E, env = env0 + (i - r * E);
    s.lam[i] = env < B ? lam_in[(size_t)r * B + env] : 0.f;
  }
  for (int i = threadIdx.x; i < n_push * E; i += blockDim.x) s.plam[i] = 0.f;
  for (int i = threadIdx.x; i < (nr_pad - n_rows) * E; i += blockDim.x) {
    const int r = n_rows + i / E, env = env0 + i % E;
    if (env < B) lam_out[(size_t)r * B + env] = lam_in[(size_t)r * B + env];
  }
}

// The consumer warp, after its last visit: velocities, push velocities and
// the visited rows' impulses of the block's real envs.
__device__ __forceinline__ void store_resident(const Resident& s, float* __restrict__ vel_out,
                                               float* __restrict__ push_out,
                                               float* __restrict__ lam_out, int nb, int n_rows,
                                               int B, int env0, int lane) {
  const int E = s.E;
  for (int i = lane; i < nb * 6 * E; i += 32) {
    const int k = i / E, e = i - k * E, env = env0 + e;
    const int at = (k % 6) * s.nbE + (k / 6) * E + e;
    if (env < B) {
      vel_out[(size_t)k * B + env] = s.v[at];
      push_out[(size_t)k * B + env] = s.pv[at];
    }
  }
  for (int i = lane; i < n_rows * E; i += 32) {
    const int r = i / E, env = env0 + (i - r * E);
    if (env < B) lam_out[(size_t)r * B + env] = s.lam[i];
  }
}

// Carves the dynamic shared memory: aligned ring, then its mbarriers (full,
// empty, and a third set a kernel may take as `ready`; ready = full here),
// then the resident arrays; returns where the arrays' extra part (after the
// push impulses) begins. Thread 0 initialises the mbarriers; the caller
// synchronises the block before either warp uses them.
__device__ __forceinline__ float* carve(unsigned char* smem, Ring& ring, Resident& s, int stages,
                                        size_t stage_bytes, int nb, int n_rows, int n_push,
                                        int E) {
  unsigned char* base = smem + ((kAlign - (smem_u32(smem) & (kAlign - 1))) & (kAlign - 1));
  ring.base = base;
  ring.stage_bytes = stage_bytes;
  ring.stages = stages;
  ring.full = reinterpret_cast<uint64_t*>(base + (size_t)stages * stage_bytes);
  ring.empty = ring.full + stages;
  ring.ready = ring.full;
  float* f = reinterpret_cast<float*>(base + (size_t)stages * stage_bytes + kAlign);
  s.nbE = (nb + 1) * E;
  s.v = f;
  s.pv = s.v + 6 * s.nbE;
  s.lam = s.pv + 6 * s.nbE;
  s.plam = s.lam + n_rows * E;
  s.E = E;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3 * stages; ++i) bar_init(&ring.full[i], 32);  // full, empty, spare
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  return s.plam + n_push * E;
}

}  // namespace ring

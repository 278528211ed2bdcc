// Fused sequential-impulse sweep over slim env-last rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sweep_kernel_envlast_slim` behind
// `solver_sweep_envlast_slim` in evomotion_tpu/physics/solver_pallas.py
// (pallas_call at :592). It computes the same function: `n_iters` passes over
// the constraint rows, rows visited strictly in order within each env (Bullet's
// btSequentialImpulseConstraintSolver order), envs independent. Per row:
//   dv   = [m^-1 * J_lin, Iinv_world * J_ang] for body A (and B unless skip_b)
//   eff  = J . dv ;  ie = eff > 1e-12 ? 1 / eff : 0
//   cand = lam + (rhs - J . v) * ie, clamped by kind:
//          joint [lo, hi], normal >= 0, friction +-mu * lam[parent] (read live)
//   v   += dv * (new - old) on A, and on B unless skip_b.
// Contact normal rows also advance the split-impulse push accumulator
// (rhs_push, clamp >= 0) into the push velocities in the same visit.
//
// Groups (the `scheduled` row order, TPU kernel :718-805): the TPU kernel
// loads every row of a group before it stores any. The caller gathers the
// rows into visit order, and `make_sweep_meta` (kernels/sweep.py) accepts
// only groups whose rows write pairwise disjoint bodies and whose friction
// rows' parents lie in earlier groups. Under that check every load of the
// group's load phase reads what a one-at-a-time visit would read, so this
// kernel visits the permuted rows one at a time and computes what the TPU
// kernel computes.
//
// What bounds it on an H100. Counted as the contract counts it (each input
// read once), a spider call at B=2048 moves ~0.2 GB and does ~5 GFLOP of
// fp32 work, both under 0.1 ms at the card's peaks. What bounds any sweep
// of this kind is the dependent chain: 18,960 row visits per env (1,896
// rows x 10 iterations) plus the push pass's 5,480, each reading velocities
// the visit before may have written; and, for a design that keeps the
// chain's data on chip, the shared memory of one SM.
//
// What this design does (envlast_ring.cuh): everything on the chain sits in
// shared memory for the whole call, as the TPU kernel keeps it in VMEM:
// velocities, push velocities, impulses, push impulses, and this kernel's
// inverse-inertia table iinv9 [9][nb][E], constant during a call. A
// producer warp streams the rows (J [8*12][E] in bf16 or f32, scalars
// [8*4][E], the rows' block of the metadata table) through a ring of 8-row
// stages by TMA, or by plain loads where the env stride is not a multiple
// of 16 bytes. A third warp computes each landed stage's 1/(J Minv J^T)
// (its IEEE division branches, which would split the consumer's blocks)
// into the stage. The consumer warp runs 2 threads per env (body A, body
// B); it recomputes its body's Minv.J^T from iinv9 one row ahead of the
// chain. The budget is shared memory: 13,352 B per env of the spider
// (1,896 rows, 42 bodies + a spare, 548 push slots), so E = 16 envs (128
// blocks at B=2048, one per SM) leaves room for 3 bf16 stages or 2 f32
// stages; the wrapper's planner (kernels/sweep.py `plan`) takes fewer envs
// per block where a model needs more. Each E a plan can take (16, 8, 4, 2,
// 1) has its own instance, with E a constant.
//
// What is left: the chain and what the one consumer warp per SM issues
// beside it (5.4-5.7 ms per spider call at B=2048 on an H100 at 700 W,
// ~9-10x an estimate of the chain's fp32 latency alone); the push pass's
// chain runs beside the velocity pass's only on its own row.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (evomotion_tpu_torch/kernels/sweep.py).

#include <cuda_bf16.h>

#include "envlast_ring.cuh"

namespace {

using namespace ring;

constexpr int kRowJ = 12;
constexpr int kRowS = 4;
// metadata words per row (kernels/ring.py stage_table): body A, body B or -1
// (skip_b), kind, bounding row, push slot or -1, 0 | mu, inv_mass_a,
// inv_mass_b, 0, 0, 0: three 16-byte words
constexpr int kMeta = 12;

// A stage: J box [8*12][E], scalar box [8*4][E], the rows' metadata [8][12],
// and 1/eff [8][E] (written by the prep warp), each aligned for TMA.
struct Stage {
  size_t j_box, s_box, meta, ie_box;  // bytes of each part, aligned
  __host__ __device__ Stage(int envs, int j_bytes)
      : j_box(align_up((size_t)kStageRows * kRowJ * envs * j_bytes, kAlign)),
        s_box(align_up((size_t)kStageRows * kRowS * envs * 4, kAlign)),
        meta(align_up((size_t)kStageRows * kMeta * 4, kAlign)),
        ie_box(align_up((size_t)kStageRows * envs * 4, kAlign)) {}
  __host__ __device__ size_t bytes() const { return j_box + s_box + meta + ie_box; }
};

inline size_t slim_smem(int envs, int stages, int j_bytes, int nb6, int n_rows, int n_push) {
  return smem_bytes(envs, stages, Stage(envs, j_bytes).bytes(), nb6, n_rows, n_push,
                    9 * (nb6 / 6));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const void* row_j;    // [nr_pad, 12, B] bf16 or f32
  const float* row_s;   // [nr_pad, 4, B]: rhs, lo, hi, rhs_push
  const float* vel_in;  // [nb6, B]
  const float* lam_in;  // [nr_pad, B]
  const float* iinv9;   // [nb * 9, B]
  const int* table;     // [ceil8(n_rows), 12]: see kMeta
  float* vel_out;       // [nb6, B]
  float* lam_out;       // [nr_pad, B]
  float* push_out;      // [nb6, B]
  int B, nb, nr_pad, n_rows, n_iters, n_push, envs, stages, use_tma;
};

// A thread's view of a stage (the prep warp's and the consumer's lanes map
// to (side, env) alike): its half of a row (J of its body and that body's
// Minv.J^T from the resident iinv9), the row's scalars and metadata, and
// where the row's loads and stores go.
template <typename JT, int E>
struct Reader {
  Stage sg;
  const float* ii;  // resident iinv9, [9][nb][E]
  int e, side, nb;

  __device__ __forceinline__ const int4* meta(const unsigned char* st, int rr) const {
    return reinterpret_cast<const int4*>(st + sg.j_box + sg.s_box) + rr * (kMeta / 4);
  }

  // this thread's J half and its body's dv = [im * j_lin, Iinv * j_ang];
  // returns whether the row has a body B
  __device__ __forceinline__ bool own(const unsigned char* st, int rr, float* j,
                                      float* dv) const {
    const JT* js = reinterpret_cast<const JT*>(st) + (rr * kRowJ + side * 6) * E + e;
    const int4 m0 = meta(st, rr)[0];
    const float im = __int_as_float(side ? meta(st, rr)[2].x : meta(st, rr)[1].w);
    const float* ib = ii + (side && m0.y >= 0 ? m0.y : m0.x) * E + e;
    const int nbE = nb * E;
#pragma unroll
    for (int c = 0; c < 6; ++c) j[c] = to_f(js[c * E]);
    dv[0] = im * j[0];
    dv[1] = im * j[1];
    dv[2] = im * j[2];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      dv[3 + q] = ib[(3 * q) * nbE] * j[3] + ib[(3 * q + 1) * nbE] * j[4] +
                  ib[(3 * q + 2) * nbE] * j[5];
    }
    return m0.y >= 0;
  }

  // The prep warp's part: 1/eff of the stage's rows into its ie box. Rows
  // past n_rows (zero metadata) give finite values nothing reads. Both
  // lanes of an env write the same value (`join`).
  __device__ __forceinline__ void stage_ie(unsigned char* st) const {
    float eff[kStageRows];
    bool both[kStageRows];
#pragma unroll
    for (int k = 0; k < kStageRows; ++k) {
      float j[6], dv[6];
      both[k] = own(st, k, j, dv);
      eff[k] = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) eff[k] += j[c] * dv[c];
    }
#pragma unroll
    for (int k = 0; k < kStageRows; ++k) eff[k] = join(eff[k], both[k], E);
    float* ie = reinterpret_cast<float*>(st + sg.j_box + sg.s_box + sg.meta);
#pragma unroll
    for (int k = 0; k < kStageRows; ++k) ie[k * E + e] = inv_eff(eff[k]);
  }

  __device__ __forceinline__ void read(Row& w, const unsigned char* st, int rr, int r) const {
    const float* ss = reinterpret_cast<const float*>(st + sg.j_box) + rr * kRowS * E + e;
    const int4 m0 = meta(st, rr)[0], m1 = meta(st, rr)[1];
    w.both = own(st, rr, w.j, w.dv);
    w.ie = reinterpret_cast<const float*>(st + sg.j_box + sg.s_box + sg.meta)[rr * E + e];
    w.rhs = ss[0];
    w.rhs_push = ss[3 * E];
    w.mu = __int_as_float(m1.z);
    set_kind(w, m0.z, ss[E], ss[2 * E]);
    w.push = m1.x >= 0;
    w.vo = (side == 0 ? m0.x : w.both ? m0.y : nb) * E + e;
    w.lam_at = r * E + e;
    w.par_at = m0.w * E + e;
    w.plam_at = (w.push ? m1.x : 0) * E + e;
  }
};

// the raw element a plain-load copy moves
template <typename JT>
struct Raw;
template <>
struct Raw<float> {
  using T = unsigned;
};
template <>
struct Raw<__nv_bfloat16> {
  using T = unsigned short;
};

constexpr int kSlimThreads = 96;  // consumer, producer and prep warps

// E: envs per block, the plan's (a.envs), as a constant
template <typename JT, int E>
__global__ void __launch_bounds__(kSlimThreads, 1)
    sweep_envlast_slim_kernel(const Args a, const __grid_constant__ CUtensorMap tm_j,
                              const __grid_constant__ CUtensorMap tm_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = a.nb;
  const int env0 = blockIdx.x * E;
  const Stage sg(E, sizeof(JT));
  Ring ring;
  Resident s;
  float* ii = carve(smem, ring, s, a.stages, sg.bytes(), nb, a.n_rows, a.n_push, E);
  ring.ready = ring.empty + a.stages;  // the consumer waits until the prep warp is done
  load_resident(s, a.vel_in, a.lam_in, a.lam_out, nb, a.nr_pad, a.n_rows, a.n_push, a.B, env0);
  for (int i = threadIdx.x; i < nb * 9 * E; i += blockDim.x) {  // [nb * 9, B] -> [9][nb][E]
    const int k = i / E, e = i - k * E, env = env0 + e;
    ii[((k % 9) * nb + k / 9) * E + e] = env < a.B ? a.iinv9[(size_t)k * a.B + env] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int e = lane % E;
  const Reader<JT, E> rd{sg, ii, e, (lane / E) & 1, nb};

  if (threadIdx.x >= 32 && threadIdx.x < 64) {  // producer warp: fill the stages
    using T = typename Raw<JT>::T;
    const unsigned tx =
        kStageRows * ((kRowJ * sizeof(JT) + kRowS * sizeof(float)) * E + kMeta * 4);
    const int n_chunks = (a.n_rows + kStageRows - 1) / kStageRows;
    const int total = a.n_iters * n_chunks;
    for (int g = 0, c = 0; g < total; ++g) {
      bar_wait(&ring.empty[ring.slot], ring.phase ^ 1u);
      unsigned char* st = ring.stage();
      uint64_t* full = &ring.full[ring.slot];
      const int row0 = c * kStageRows;
      int* mt = reinterpret_cast<int*>(st + sg.j_box + sg.s_box);
      const int* table = a.table + row0 * kMeta;
      if (a.use_tma) {
        if (lane == 0) {
          bar_arrive_tx(full, tx);
          tma_load_2d(st, &tm_j, env0, row0 * kRowJ, full);
          tma_load_2d(st + sg.j_box, &tm_s, env0, row0 * kRowS, full);
          bulk_load(mt, table, kStageRows * kMeta * 4, full);
        } else {
          bar_arrive(full);
        }
      } else {
        copy_box(reinterpret_cast<T*>(st), static_cast<const T*>(a.row_j), row0, kRowJ,
                 a.nr_pad, a.B, env0, E, lane);
        copy_box(reinterpret_cast<unsigned*>(st + sg.j_box),
                 reinterpret_cast<const unsigned*>(a.row_s), row0, kRowS, a.nr_pad, a.B, env0,
                 E, lane);
        copy_words(mt, table, kStageRows * kMeta, lane);
        bar_arrive(full);
      }
      ring.advance();
      if (++c == n_chunks) c = 0;
    }
    return;
  }
  if (threadIdx.x >= 64) {  // prep warp: each stage's 1/eff once it has landed
    const int total = a.n_iters * ((a.n_rows + kStageRows - 1) / kStageRows);
    for (int g = 0; g < total; ++g) {
      bar_wait(&ring.full[ring.slot], ring.phase);
      rd.stage_ie(ring.stage());
      bar_arrive(&ring.ready[ring.slot]);
      ring.advance();
    }
    return;
  }

  consume(ring, rd, s, a.n_rows, a.n_iters);
  store_resident(s, a.vel_out, a.push_out, a.lam_out, nb, a.n_rows, a.B, env0, lane);
}

template <typename JT, int E>
int launch(const Args& a, int smem, cudaStream_t stream) {
  CUtensorMap tm_j{}, tm_s{};
  if (a.use_tma) {
    cudaError_t err = encode_rows(&tm_j, a.row_j, sizeof(JT), a.nr_pad, kRowJ, a.B, a.envs);
    if (err == cudaSuccess)
      err = encode_rows(&tm_s, a.row_s, sizeof(float), a.nr_pad, kRowS, a.B, a.envs);
    if (err != cudaSuccess) return (int)err;
  }
  auto kern = sweep_envlast_slim_kernel<JT, E>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(a.B + E - 1) / E, kSlimThreads, smem, stream>>>(a, tm_j, tm_s);
  return (int)cudaGetLastError();
}

template <typename JT>
int launch_envs(const Args& a, int smem, cudaStream_t stream) {
  return with_envs(a.envs, [&](auto e) { return launch<JT, decltype(e)::value>(a, smem, stream); });
}

// the card's resident blocks per SM of the instance for (JT, E) at `smem`
// bytes, or a negative CUDA error code
template <typename JT, int E>
int occupancy(int smem) {
  auto kern = sweep_envlast_slim_kernel<JT, E>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kSlimThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Shared-memory bytes of a launch plan (the wrapper's planner sums the same).
extern "C" long long sweep_envlast_slim_smem_bytes(int envs, int stages, int j_bytes, int nb6,
                                                   int n_rows, int n_push) {
  return (long long)slim_smem(envs, stages, j_bytes, nb6, n_rows, n_push);
}

// Launch on `stream` with the wrapper's plan: `envs` envs per block,
// `stages` ring stages, `smem` bytes (must equal the plan's sum), rows by TMA
// where `use_tma` (the env stride and the box width a multiple of 16 bytes,
// the arrays 16-byte aligned). Returns the CUDA error code of the launch (0
// on success; cudaErrorInvalidValue for a plan or layout it does not take).
extern "C" int sweep_envlast_slim_launch(
    const void* row_j, int j_is_bf16, const void* row_s, const void* vel_in,
    const void* lam_in, const void* iinv9, const void* table, void* vel_out, void* lam_out,
    void* push_out, int B, int nb6, int nr_pad, int n_rows, int n_iters, int n_push, int envs,
    int stages, int smem, int use_tma, void* stream) {
  const int jb = j_is_bf16 ? 2 : 4;
  if (!valid_plan(envs, stages) || B < 1 || nb6 < 6 || nb6 % 6 || n_rows > nr_pad ||
      n_push < 1 || (long long)smem != sweep_envlast_slim_smem_bytes(envs, stages, jb, nb6,
                                                                    n_rows, n_push))
    return (int)cudaErrorInvalidValue;
  if (use_tma && ((B * jb) % 16 || (envs * jb) % 16 || (envs * 4) % 16 || !aligned16(row_j) ||
                  !aligned16(row_s) || !aligned16(table)))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.row_j = row_j;
  a.row_s = static_cast<const float*>(row_s);
  a.vel_in = static_cast<const float*>(vel_in);
  a.lam_in = static_cast<const float*>(lam_in);
  a.iinv9 = static_cast<const float*>(iinv9);
  a.table = static_cast<const int*>(table);
  a.vel_out = static_cast<float*>(vel_out);
  a.lam_out = static_cast<float*>(lam_out);
  a.push_out = static_cast<float*>(push_out);
  a.B = B;
  a.nb = nb6 / 6;
  a.nr_pad = nr_pad;
  a.n_rows = n_rows;
  a.n_iters = n_iters;
  a.n_push = n_push;
  a.envs = envs;
  a.stages = stages;
  a.use_tma = use_tma;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return j_is_bf16 ? launch_envs<__nv_bfloat16>(a, smem, st) : launch_envs<float>(a, smem, st);
}

// Resident blocks per SM of a plan on the current card, as the CUDA runtime
// reckons them (cudaOccupancyMaxActiveBlocksPerMultiprocessor); negative on
// an error.
extern "C" int sweep_envlast_slim_blocks_per_sm(int j_is_bf16, int envs, int smem) {
  if (!valid_plan(envs, 2)) return -(int)cudaErrorInvalidValue;
  return with_envs(envs, [&](auto e) {
    constexpr int E = decltype(e)::value;
    return j_is_bf16 ? occupancy<__nv_bfloat16, E>(smem) : occupancy<float, E>(smem);
  });
}

extern "C" int sweep_envlast_slim_max_smem_per_block() {
  int dev = 0, val = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return val;
}

// Sequential-impulse sweep over fat batch-first rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sweep_kernel` behind `solver_sweep` in
// evomotion_tpu/physics/solver_pallas.py (pallas_call at :276). It computes the
// same function: `n_iters` passes over the constraint rows, rows visited
// strictly in order within each env (Bullet's btSequentialImpulseConstraint-
// Solver order), envs independent. Each row carries 28 floats computed by the
// caller: J (12: a_lin, a_ang, b_lin, b_ang), dv_a = Minv_a J_a^T (6),
// dv_b (6), rhs, lo, hi, inv_eff. Per row:
//   jv   = J_a . v_a (+ J_b . v_b unless body B is static)
//   cand = lam + (rhs - jv) * inv_eff, clamped by kind:
//          joint [lo, hi], normal >= 0, friction +-mu * lam[parent] (read live)
//   v_a += dv_a * (new - old), v_b likewise unless body B is static.
// The per-env physics step calls it twice per step at B = 1: once over the
// contact normal rows with the split-impulse rhs (push pass, 548 rows on the
// spider), once over all rows (1,896).
//
// Groups (the `scheduled` row order, TPU kernel :133-181): `make_fat_meta`
// (kernels/sweep_fat.py) accepts only groups whose rows write pairwise
// disjoint bodies and whose friction rows' parents lie in earlier groups, so
// visiting the permuted rows one at a time here computes what the TPU
// kernel's load-then-store groups compute.
//
// What bounds it on an H100. Not bytes: a spider velocity sweep at B = 1
// moves ~0.27 MB (0.08 us at 3.35 TB/s) and does ~1 MFLOP. What bounds it is
// the dependent chain: 18,960 row visits (10 passes of 1,896 rows) one after
// another, each reading velocities the visit before may have written (in
// the canonical order 94.5% of consecutive visits share a body), run by one
// thread.
//
// What this design does (one block per env, 64 threads):
// - Everything on the chain stays in shared memory for the whole call: the
//   env's velocities, in slots of 8 floats per body ([nb + 1][8]: 6
//   velocities and 2 of padding, so a body is one 16-byte and one 8-byte
//   access; body nb is a spare that skip_b rows write and nothing reads),
//   and its impulses [nr]. Device memory sees them once on the way in and
//   once on the way out.
// - A producer warp's lane 0 streams the rows through a ring of `stages`
//   stages ahead of the chain, with 1-D bulk copies (cp.async.bulk,
//   completion on the stage's `full` mbarrier): a stage holds the rows of an
//   8-row chunk and the row after them in visit order (contiguous runs of the
//   env's [nr, 28] slab; the run wraps to row 0, as the passes do), and the
//   table entries (kernels/sweep_fat.py make_fat_meta) of those rows and one
//   more. So every read of a visit stays in its stage. Nothing streamed is
//   written, so the copies cannot race the stores.
// - One consumer lane runs the chain. Visit k first issues the loads of row
//   k + 1 from shared memory (its bodies' velocities, its impulse, its
//   bounding row's impulse; its metadata was read a visit earlier, so the
//   addresses are in registers), reads row k + 1's data and row k + 2's
//   metadata from the stage, then runs row k's chain: J.v, each half
//   ((p0 + p1) + p2) + ((p3 + p4) + p5) by FMAs, then A's half + B's half
//   (A's half alone on skip_b rows); cand; the clamp by selects in the
//   comparison form, which keeps a NaN candidate NaN (jnp.clip /
//   torch.clamp; fminf/fmaxf would drop it); the delta; both bodies' updates.
// - The hand-over (`solve`) is planned on the host: per row, flags say
//   whether it shares body A or B with the row before it in the same slot,
//   and whether that row must store each body. A shared body's new
//   velocities go from registers to the next row by a select; a body the
//   next row carries is not stored, so a body that stays in play across
//   visits (a joint's rows, a contact's rows) costs no shared-memory round
//   trip and no store. The rare hand-overs (a body in the other slot, a
//   friction row right after its parent, a single row) take a branch in a
//   second instance of the kernel, launched only for row sets that have
//   them: the row before stores everything and the next row reloads after
//   it. The spider has none in any row order.
// - The resident arrays are read and written by 32-bit shared addresses
//   computed once per row, and every visit of an 8-row stage is unrolled:
//   in the spider's instance a visit is one basic block.
// The sum order of J.v differs from the old kernel's running sum; the
// outputs agree with the plain version within f32 rounding (~3e-6 on the
// spider's rows).
//
// What is left: one warp's instruction issue. A visit issues its shared
// loads and up to 5 stores, 12 hand-over selects, the dot, the clamp, 12
// update FMAs and flag and address work, several times the ~16 dependent
// operations of its chain: ~156 cycles a visit on an H100 at 1,980 MHz
// (chip_smoke.py phase 8). The B = 64 call shape runs 64 such chains, one
// per block.
//
// Shared memory, in bytes (kernels/sweep_fat.py `plan` sums the same):
// kAlign of slack to align the ring, the ring (stages * kStageBytes), kAlign
// for the 2 * stages mbarriers, then 4 * (8 * (nb + 1) + nr).
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (evomotion_tpu_torch/kernels/sweep_fat.py).

#include "envlast_ring.cuh"

namespace {

using namespace ring;

constexpr int kRowF = 28;
constexpr int kRowF4 = kRowF / 4;
constexpr unsigned kRowBytes = kRowF * 4;
// table words per row: body A, body B or -1, kind, bounding row, -1, flags, mu, row
constexpr int kMeta = 8;
// bits of the flags word (kernels/sweep_fat.py visit_flags): the row's kind,
// and how the visit of the row before it hands its state over
constexpr int kSameA = 1 << 0, kSameB = 1 << 1, kRare = 1 << 2, kStoreA = 1 << 3,
              kStoreB = 1 << 4, kBoth = 1 << 5, kFric = 1 << 6, kJoint = 1 << 7;
constexpr int kSlot = 8;  // floats per body in shared memory
constexpr int kFatThreads = 64;   // consumer and producer warps
constexpr int kFatMaxStages = 8;  // the mbarriers' kAlign bytes hold 2 * 8
// A stage carries the rows of its chunk and the row after them in visit
// order (wrapping to row 0), and the table entries of those and one more, so
// every read of a visit (the next row's data, the metadata of the row after
// it) stays in its stage.
constexpr int kRowSpan = kStageRows + 1;
constexpr int kMetaSpan = kStageRows + 2;
constexpr size_t kRowBox = align_up((size_t)kRowSpan * kRowBytes, kAlign);
constexpr size_t kStageBytes = kRowBox + align_up((size_t)kMetaSpan * kMeta * 4, kAlign);

__host__ __device__ constexpr size_t fat_smem_bytes(int stages, int nb6, int nr) {
  return kAlign + (size_t)stages * kStageBytes + kAlign +
         4 * ((size_t)kSlot * (nb6 / 6 + 1) + (size_t)nr);
}

struct Args {
  const float* rows;    // [B, nr, 28]
  const float* vel_in;  // [B, nb6]
  const float* lam_in;  // [B, nr]
  const int* table;     // [ceil8(nr) + 8, 8]: see kMeta; entry i >= nr repeats i % nr
  float* vel_out;       // [B, nb6]
  float* lam_out;       // [B, nr]
  int nb, nr, n_iters, stages;
};

// A row's metadata, decoded: where its loads and stores go (shared-memory
// byte addresses), its clamp, and the hand-over from the row before it.
struct Meta {
  uint32_t a, b;   // body A's and body B's slots (the spare on skip_b rows)
  uint32_t row;    // the row's impulse
  uint32_t bound;  // the impulse that bounds it (friction parent, else its own)
  int fl;          // the flags word
  float mu;
};

// One row as the consumer lane holds it from the visit before its own: its
// metadata (read a visit earlier still), its data from the stage, and its
// velocities and impulses, loaded before the stores of the visit before it
// and then handed over.
struct Visit {
  float j[12], dva[6], dvb[6];
  float rhs, lo, hi, ie;
  Meta m;
  float va[6], vb[6], old, par;
};

// Shared-memory accesses of the resident arrays by 32-bit address. They are
// volatile, so they keep their program order (a load issued before a store
// stays before it).
__device__ __forceinline__ void load_body(float* x, uint32_t at) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3]) : "r"(at));
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2+16];" : "=f"(x[4]), "=f"(x[5]) : "r"(at));
}

__device__ __forceinline__ void store_body(uint32_t at, const float* x) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(at), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]));
  asm volatile("st.shared.v2.f32 [%0+16], {%1, %2};" :: "r"(at), "f"(x[4]), "f"(x[5]));
}

__device__ __forceinline__ float load_f(uint32_t at) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(at));
  return x;
}

__device__ __forceinline__ void store_f(uint32_t at, float x) {
  asm volatile("st.shared.f32 [%0], %1;" :: "r"(at), "f"(x));
}

// The loads of row n (its metadata known): its bodies' velocities, its
// impulse and its bounding row's impulse as they stand.
__device__ __forceinline__ void load_state(Visit& n) {
  load_body(n.va, n.m.a);
  load_body(n.vb, n.m.b);
  n.old = load_f(n.m.row);
  n.par = load_f(n.m.bound);
}

// Where the resident arrays start, and the spare body.
struct Base {
  uint32_t v, lam;
  int spare;
};

// Table entry `p` of stage `st`: a row's metadata.
__device__ __forceinline__ Meta read_meta(const unsigned char* st, int p, const Base& sb) {
  const int4* m = reinterpret_cast<const int4*>(st + kRowBox) + p * (kMeta / 4);
  const int4 m0 = m[0], m1 = m[1];
  Meta d;
  d.fl = m1.y;
  d.a = sb.v + m0.x * (kSlot * 4);
  d.b = sb.v + (d.fl & kBoth ? m0.y : sb.spare) * (kSlot * 4);
  d.bound = sb.lam + m0.w * 4;
  d.row = sb.lam + m1.w * 4;
  d.mu = __int_as_float(m1.z);
  return d;
}

// Row `p` of stage `st`: row n's data (its metadata known).
__device__ __forceinline__ void read_row(Visit& n, const unsigned char* st, int p) {
  const float4* x = reinterpret_cast<const float4*>(st) + p * kRowF4;
  float f[kRowF];
#pragma unroll
  for (int i = 0; i < kRowF4; ++i) {
    const float4 q = x[i];
    f[4 * i] = q.x, f[4 * i + 1] = q.y, f[4 * i + 2] = q.z, f[4 * i + 3] = q.w;
  }
#pragma unroll
  for (int c = 0; c < 12; ++c) n.j[c] = f[c];
#pragma unroll
  for (int c = 0; c < 6; ++c) n.dva[c] = f[12 + c], n.dvb[c] = f[18 + c];
  n.rhs = f[24];
  n.ie = f[27];
  n.lo = n.m.fl & kJoint ? f[25] : 0.f;  // contact normals [0, inf): max(cand, 0), NaN kept
  n.hi = n.m.fl & kJoint ? f[26] : infinity();
}

// one half of J.v: ((p0 + p1) + p2) + ((p3 + p4) + p5), each run of three
// products by FMAs
__device__ __forceinline__ float half_dot(const float* j, const float* x) {
  const float s = fmaf(j[2], x[2], fmaf(j[1], x[1], j[0] * x[0]));
  const float t = fmaf(j[5], x[5], fmaf(j[4], x[4], j[3] * x[3]));
  return s + t;
}

// The chain of row c, its stores, and the hand-over to row n, whose loads
// were issued before these stores. Where n shares a body with c in the same
// slot (SAME_A, SAME_B) it takes c's new velocities from registers, and c
// stores that body only if told (STORE_A, STORE_B): n carries it otherwise,
// and stores it itself or hands it on. So shared memory holds every body's
// current velocities except those of the row about to be visited, which
// are in its registers. The rare cases (a body in the other slot, n bounded
// by c's impulse, a single row: RARE) take a branch, only in the kernel
// instance for row sets that have them: c stores everything and n reloads.
template <bool kRareRows>
__device__ __forceinline__ void solve(const Visit& c, Visit& n) {
  const float ja = half_dot(c.j, c.va);
  const float jb = half_dot(c.j + 6, c.vb);
  const float jv = c.m.fl & kBoth ? ja + jb : ja;
  const float cand = c.old + (c.rhs - jv) * c.ie;
  const float lim = c.m.mu * c.par;
  const bool fric = c.m.fl & kFric;
  const float nl = clip(cand, fric ? -lim : c.lo, fric ? lim : c.hi);
  const float d = nl - c.old;
  float na[6], nb[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    na[k] = c.va[k] + c.dva[k] * d;
    nb[k] = c.vb[k] + c.dvb[k] * d;
  }
  const int fl = n.m.fl;
  if (fl & kStoreA) store_body(c.m.a, na);
  if (fl & kStoreB) store_body(c.m.b, nb);
  store_f(c.m.row, nl);
  if (kRareRows && (fl & kRare)) {
    load_state(n);
    return;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    n.va[k] = fl & kSameA ? na[k] : n.va[k];
    n.vb[k] = fl & kSameB ? nb[k] : n.vb[k];
  }
}

// The visits of one stage, `count` of them: visit k issues the loads of
// the next row (its metadata `nm` read in visit k - 1), reads that row's
// data from place k + 1 and the metadata of the row after it from entry
// k + 2, then runs its chain. `c` and `nm` hold the stage's first row and
// the metadata of its second on entry, the next stage's on exit.
template <bool kRareRows, bool kFull>
__device__ __forceinline__ void visit_stage(Visit& c, Meta& nm, const unsigned char* st,
                                            int count, const Base& sb) {
  Visit w[2];
  w[0] = c;
#pragma unroll
  for (int k = 0; k < kStageRows; ++k) {
    if (!kFull && k >= count) break;
    Visit& n = w[(k + 1) & 1];
    n.m = nm;
    load_state(n);
    read_row(n, st, k + 1);
    nm = read_meta(st, k + 2, sb);
    solve<kRareRows>(w[k & 1], n);
    if (kFull ? k == kStageRows - 1 : k == count - 1) c = n;
  }
}

template <bool kRareRows>
__global__ void __launch_bounds__(kFatThreads, 1) solver_sweep_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int env = blockIdx.x;
  const int nb = a.nb, nr = a.nr, nb6 = nb * 6;
  unsigned char* base = smem + ((kAlign - (smem_u32(smem) & (kAlign - 1))) & (kAlign - 1));
  Ring ring;
  ring.base = base;
  ring.stage_bytes = kStageBytes;
  ring.stages = a.stages;
  ring.full = reinterpret_cast<uint64_t*>(base + (size_t)a.stages * kStageBytes);
  ring.empty = ring.full + a.stages;
  float* v = reinterpret_cast<float*>(base + (size_t)a.stages * kStageBytes + kAlign);
  float* lam = v + kSlot * (nb + 1);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * a.stages; ++i) bar_init(&ring.full[i], 1);  // full, empty
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < kSlot * (nb + 1); i += blockDim.x) {
    const int body = i / kSlot, k = i - body * kSlot;
    v[i] = body < nb && k < 6 ? a.vel_in[(size_t)env * nb6 + body * 6 + k] : 0.f;
  }
  for (int r = threadIdx.x; r < nr; r += blockDim.x) lam[r] = a.lam_in[(size_t)env * nr + r];
  __syncthreads();

  const int n_chunks = (nr + kStageRows - 1) / kStageRows;
  const long long total = (long long)a.n_iters * n_chunks;  // stages
  const int lane = threadIdx.x % 32;

  if (threadIdx.x >= 32) {  // producer warp: lane 0 fills the stages
    if (lane == 0) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(a.rows) + (size_t)env * nr * kRowBytes;
      int r0 = 0;
      for (long long t = 0; t < total; ++t) {
        bar_wait(&ring.empty[ring.slot], ring.phase ^ 1u);
        unsigned char* st = ring.stage();
        uint64_t* full = &ring.full[ring.slot];
        bar_arrive_tx(full, kRowSpan * kRowBytes + kMetaSpan * kMeta * 4);
        // rows r0 .. r0 + kRowSpan - 1 in visit order: to the last row, then from row 0
        for (int done = 0, r = r0; done < kRowSpan; r = 0) {
          const int seg = min(kRowSpan - done, nr - r);
          bulk_load(st + done * kRowBytes, src + (size_t)r * kRowBytes, seg * kRowBytes, full);
          done += seg;
        }
        bulk_load(st + kRowBox, a.table + r0 * kMeta, kMetaSpan * kMeta * 4, full);
        ring.advance();
        r0 = r0 + kStageRows >= nr ? 0 : r0 + kStageRows;
      }
    }
    return;
  }

  // consumer warp: lane 0 runs the chain
  if (lane == 0 && total > 0) {
    const Base sb{smem_u32(v), smem_u32(lam), nb};
    Visit c;
    bar_wait(&ring.full[0], 0);
    c.m = read_meta(ring.stage(), 0, sb);
    read_row(c, ring.stage(), 0);
    load_state(c);
    Meta nm = read_meta(ring.stage(), 1, sb);
    int r0 = 0;
    for (long long s = 0; s < total; ++s) {
      if (s > 0) bar_wait(&ring.full[ring.slot], ring.phase);
      const int count = min(kStageRows, nr - r0);
      if (count == kStageRows)
        visit_stage<kRareRows, true>(c, nm, ring.stage(), count, sb);
      else
        visit_stage<kRareRows, false>(c, nm, ring.stage(), count, sb);
      bar_arrive(&ring.empty[ring.slot]);
      ring.advance();
      r0 = r0 + kStageRows >= nr ? 0 : r0 + kStageRows;
    }
    store_body(c.m.a, c.va);  // what the last visit handed over
    store_body(c.m.b, c.vb);
  }
  __syncwarp();
  for (int i = lane; i < nb6; i += 32)
    a.vel_out[(size_t)env * nb6 + i] = v[(i / 6) * kSlot + i % 6];
  for (int r = lane; r < nr; r += 32) a.lam_out[(size_t)env * nr + r] = lam[r];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Lets both instances take up to the card's opt-in of dynamic shared
// memory: once per library and device, not once per launch.
cudaError_t allow_optin() {
  static int done_for = -1;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == done_for) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(solver_sweep_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(solver_sweep_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done_for = dev;
  return err;
}

}  // namespace

// Shared-memory bytes of a launch plan (the wrapper's planner sums the same).
extern "C" long long solver_sweep_smem_bytes(int stages, int nb6, int nr) {
  return (long long)fat_smem_bytes(stages, nb6, nr);
}

// Launch on `stream`, one block per env, with the wrapper's plan: `stages`
// ring stages, `smem` bytes (must equal the plan's sum); `rare_rows` picks
// the instance that takes RARE hand-overs (the meta has some). Returns the
// CUDA error code of the launch (0 on success; cudaErrorInvalidValue for a
// plan or layout it does not take).
extern "C" int solver_sweep_launch(const void* rows, const void* vel_in, const void* lam_in,
                                   const void* table, void* vel_out, void* lam_out, int B,
                                   int nb6, int nr, int n_iters, int rare_rows, int stages,
                                   int smem, void* stream) {
  if (stages < 2 || stages > kFatMaxStages || B < 1 || nb6 < 6 || nb6 % 6 || nr < 0 ||
      n_iters < 0 || (long long)smem != solver_sweep_smem_bytes(stages, nb6, nr) ||
      !aligned16(rows) || !aligned16(table))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_optin();
  if (err != cudaSuccess) return (int)err;
  Args a{};
  a.rows = static_cast<const float*>(rows);
  a.vel_in = static_cast<const float*>(vel_in);
  a.lam_in = static_cast<const float*>(lam_in);
  a.table = static_cast<const int*>(table);
  a.vel_out = static_cast<float*>(vel_out);
  a.lam_out = static_cast<float*>(lam_out);
  a.nb = nb6 / 6;
  a.nr = nr;
  a.n_iters = n_iters;
  a.stages = stages;
  auto kern = rare_rows ? solver_sweep_kernel<true> : solver_sweep_kernel<false>;
  kern<<<B, kFatThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at `smem` bytes on the current card, as the CUDA
// runtime reckons them; negative on an error.
extern "C" int solver_sweep_blocks_per_sm(int smem, int rare_rows) {
  cudaError_t err = allow_optin();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rare_rows ? solver_sweep_kernel<true> : solver_sweep_kernel<false>, kFatThreads,
        smem);
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" int solver_sweep_max_smem_per_block() {
  int dev = 0, val = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return val;
}

// Fused sequential-impulse sweep over fat env-last rows, with the split-impulse
// push pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sweep_kernel_envlast` behind `solver_sweep_envlast`
// in evomotion_tpu/physics/solver_pallas.py (pallas_call at :375). It computes
// the same function: `n_iters` passes over the first `n_rows` constraint rows,
// visited strictly in order within each env, envs independent. Each row
// carries 29 floats computed by the caller: J (12: a_lin, a_ang, b_lin,
// b_ang), dv_a = Minv_a J_a^T (6), dv_b (6), rhs, lo, hi, inv_eff, rhs_push.
// Per row:
//   jv   = J_a . v_a (+ J_b . v_b unless skip_b)
//   cand = lam + (rhs - jv) * inv_eff, clamped by kind:
//          joint [lo, hi], normal >= 0, friction +-mu * lam[parent] (read live)
//   v_a += dv_a * (new - old), v_b likewise unless skip_b.
// A contact normal row also advances an independent push accumulator that
// starts from zero: new_pl = max(pl + (rhs_push - J . pv) * inv_eff, 0),
// pv += dv * (new_pl - pl); its impulse sits in a compact slot (the normal
// rows before it). Rows at or beyond n_rows are not visited and keep lam0.
//
// The TPU wrapper accepts `groups` but this TPU kernel ignores them (it walks
// every row of a chunk one at a time), so there is no groups mode here.
//
// What bounds it on an H100. Counted as the contract counts it (each input
// read once), a spider call at B=2048 (1,920 padded rows) moves ~0.49 GB and
// does ~2.6 GFLOP of fp32 work: ~0.15 ms at 3.35 TB/s, more than the ~0.04
// ms the operations need at 67 TFLOP/s. This design streams the rows once
// per iteration (~0.45 GB each, ~1.3 ms of device-memory time over 10
// iterations), but what bounds it is the dependent chain of 18,960 row
// visits per env plus the push pass's 5,480; and, for a design that keeps
// the chain's data on chip, the shared memory of one SM.
//
// What this design does (envlast_ring.cuh): velocities, push velocities,
// impulses and push impulses sit in shared memory for the whole call, as
// the TPU kernel keeps them in VMEM (11,840 B per env of the spider); a
// producer warp streams the 29-float rows ([8*29][E] per stage, with the
// rows' block of the metadata table) through a ring of 8-row stages by TMA,
// or by plain loads where B is not a multiple of 4; the consumer warp runs
// 2 threads per env (body A, body B) and reads each row one row ahead of
// the chain. E = 16 envs (128 blocks at B=2048, one per SM) leaves room for
// 2 stages of 15,104 B; the wrapper's planner (kernels/sweep_envlast.py
// `plan`) takes fewer envs per block where a row set needs more
// (prof_kernel's 2,048-row contact case: 8). Each E a plan can take (16,
// 8, 4, 2, 1) has its own instance, with E a constant.
//
// What is left: the chain and what the one consumer warp per SM issues
// beside it (3.5-3.9 ms per spider call at B=2048 on an H100 at 700 W,
// ~6-7x an estimate of the chain's fp32 latency alone); rows that would
// stay in shared memory across iterations do not fit beside the resident
// arrays.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (evomotion_tpu_torch/kernels/sweep_envlast.py).

#include "envlast_ring.cuh"

namespace {

using namespace ring;

constexpr int kRowF = 29;
constexpr int kDva = 12, kRhs = 24, kLo = 25, kHi = 26, kIe = 27, kRhsP = 28;
// metadata words per row (kernels/ring.py stage_table): body A, body B or -1
// (skip_b), kind, bounding row, push slot or -1, 0 | mu, 0: two 16-byte words
constexpr int kMeta = 8;

// bytes of one stage: the row box and the metadata, each aligned for TMA
inline size_t stage_bytes(int envs) {
  return align_up((size_t)kStageRows * kRowF * envs * 4, kAlign) +
         align_up((size_t)kStageRows * kMeta * 4, kAlign);
}

struct Args {
  const float* rows;    // [nr_pad, 29, B]
  const float* vel_in;  // [nb6, B]
  const float* lam_in;  // [nr_pad, B]
  const int* table;     // [ceil8(n_rows), 8]: see kMeta
  float* vel_out;       // [nb6, B]
  float* lam_out;       // [nr_pad, B]
  float* push_out;      // [nb6, B]
  int B, nb, nr_pad, n_rows, n_iters, n_push, envs, stages, use_tma;
  size_t stage_bytes, row_box;  // stage layout: rows at 0, meta at row_box
};

// The consumer thread's view of a stage: its half of a row (J and dv of its
// body), the row's scalars and metadata, and where the row's loads and
// stores go.
template <int E>
struct Reader {
  size_t row_box;    // the metadata's offset in a stage
  int e, side, nb;

  __device__ __forceinline__ void read(Row& w, const unsigned char* st, int rr, int r) const {
    const float* x = reinterpret_cast<const float*>(st) + rr * kRowF * E + e;
    const int4* mi = reinterpret_cast<const int4*>(st + row_box) + rr * (kMeta / 4);
    const int4 m0 = mi[0], m1 = mi[1];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      w.j[c] = x[(side * 6 + c) * E];
      w.dv[c] = x[(kDva + side * 6 + c) * E];
    }
    w.rhs = x[kRhs * E];
    w.ie = x[kIe * E];
    w.rhs_push = x[kRhsP * E];
    w.mu = __int_as_float(m1.z);
    set_kind(w, m0.z, x[kLo * E], x[kHi * E]);
    w.both = m0.y >= 0;
    w.push = m1.x >= 0;
    w.vo = (side == 0 ? m0.x : w.both ? m0.y : nb) * E + e;
    w.lam_at = r * E + e;
    w.par_at = m0.w * E + e;
    w.plam_at = (w.push ? m1.x : 0) * E + e;
  }
};

// E: envs per block, the plan's (a.envs), as a constant
template <int E>
__global__ void __launch_bounds__(kThreads, 1)
    solver_sweep_envlast_kernel(const Args a, const __grid_constant__ CUtensorMap tm_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = a.nb;
  const int env0 = blockIdx.x * E;
  Ring ring;
  Resident s;
  carve(smem, ring, s, a.stages, a.stage_bytes, nb, a.n_rows, a.n_push, E);
  load_resident(s, a.vel_in, a.lam_in, a.lam_out, nb, a.nr_pad, a.n_rows, a.n_push, a.B, env0);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int n_chunks = (a.n_rows + kStageRows - 1) / kStageRows;

  if (threadIdx.x >= 32) {  // producer warp
    const unsigned tx = kStageRows * (kRowF * sizeof(float) * E + kMeta * 4);
    for (int it = 0; it < a.n_iters; ++it) {
      for (int c = 0; c < n_chunks; ++c) {
        bar_wait(&ring.empty[ring.slot], ring.phase ^ 1u);
        unsigned char* st = ring.stage();
        uint64_t* full = &ring.full[ring.slot];
        const int row0 = c * kStageRows;
        int* mt = reinterpret_cast<int*>(st + a.row_box);
        const int* table = a.table + row0 * kMeta;
        if (a.use_tma) {
          if (lane == 0) {
            bar_arrive_tx(full, tx);
            tma_load_2d(st, &tm_rows, env0, row0 * kRowF, full);
            bulk_load(mt, table, kStageRows * kMeta * 4, full);
          } else {
            bar_arrive(full);
          }
        } else {
          copy_box(reinterpret_cast<unsigned*>(st), reinterpret_cast<const unsigned*>(a.rows),
                   row0, kRowF, a.nr_pad, a.B, env0, E, lane);
          copy_words(mt, table, kStageRows * kMeta, lane);
          bar_arrive(full);
        }
        ring.advance();
      }
    }
    return;
  }

  // consumer warp
  const int e = lane % E;
  const Reader<E> rd{a.row_box, e, (lane / E) & 1, nb};
  consume(ring, rd, s, a.n_rows, a.n_iters);
  store_resident(s, a.vel_out, a.push_out, a.lam_out, nb, a.n_rows, a.B, env0, lane);
}

template <int E>
int launch(const Args& a, const CUtensorMap& tm, int smem, cudaStream_t stream) {
  auto kern = solver_sweep_envlast_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(a.B + E - 1) / E, kThreads, smem, stream>>>(a, tm);
  return (int)cudaGetLastError();
}

// the card's resident blocks per SM of the instance for E at `smem` bytes,
// or a negative CUDA error code
template <int E>
int occupancy(int smem) {
  auto kern = solver_sweep_envlast_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Shared-memory bytes of a launch plan (the wrapper's planner sums the same).
extern "C" long long solver_sweep_envlast_smem_bytes(int envs, int stages, int nb6, int n_rows,
                                                     int n_push) {
  return (long long)smem_bytes(envs, stages, stage_bytes(envs), nb6, n_rows, n_push, 0);
}

// Launch on `stream` with the wrapper's plan: `envs` envs per block,
// `stages` ring stages, `smem` bytes (must equal the plan's sum), rows by TMA
// where `use_tma` (B and the box width a multiple of 4 envs, the rows
// 16-byte aligned). Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue for a plan or layout it does not take).
extern "C" int solver_sweep_envlast_launch(
    const void* rows, const void* vel_in, const void* lam_in, const void* table, void* vel_out,
    void* lam_out, void* push_out, int B, int nb6, int nr_pad, int n_rows, int n_iters,
    int n_push, int envs, int stages, int smem, int use_tma, void* stream) {
  if (!valid_plan(envs, stages) || B < 1 || nb6 < 6 || nb6 % 6 || n_rows > nr_pad ||
      n_push < 1 ||
      (long long)smem != solver_sweep_envlast_smem_bytes(envs, stages, nb6, n_rows, n_push))
    return (int)cudaErrorInvalidValue;
  if (use_tma && (B % 4 || envs % 4 || !aligned16(rows) || !aligned16(table)))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.rows = static_cast<const float*>(rows);
  a.vel_in = static_cast<const float*>(vel_in);
  a.lam_in = static_cast<const float*>(lam_in);
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
  a.row_box = align_up((size_t)kStageRows * kRowF * envs * 4, kAlign);
  a.stage_bytes = stage_bytes(envs);
  CUtensorMap tm{};
  if (use_tma) {
    const cudaError_t err = encode_rows(&tm, rows, 4, nr_pad, kRowF, B, envs);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_envs(envs, [&](auto e) { return launch<decltype(e)::value>(a, tm, smem, st); });
}

// Resident blocks per SM of a plan on the current card, as the CUDA runtime
// reckons them (cudaOccupancyMaxActiveBlocksPerMultiprocessor); negative on
// an error.
extern "C" int solver_sweep_envlast_blocks_per_sm(int envs, int smem) {
  if (!valid_plan(envs, 2)) return -(int)cudaErrorInvalidValue;
  return with_envs(envs, [&](auto e) { return occupancy<decltype(e)::value>(smem); });
}

extern "C" int solver_sweep_envlast_max_smem_per_block() {
  int dev = 0, val = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return val;
}

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
// Layout: every array is env-LAST ([rows, cols, B]), so thread `env` reading
// element (r, c) touches address (r * cols + c) * B + env and neighbouring
// threads read neighbouring addresses (coalesced). One thread walks one env.
// Its body velocities and push velocities sit in shared memory (2 * NB * 6
// floats per thread, [k][thread] so a warp hits 32 distinct banks: 64.5 kB
// for 32 envs of the 42-body spider, above the 48 kB default, so the launch
// opts in); impulses and push impulses stay in device memory, in the same
// coalesced layout. Any B: the last block's spare threads return at once.
//
// What bounds it on an H100: counted as the contract counts it (each input
// read once), a spider call at B=2048 (1,920 padded rows) moves ~0.49 GB and
// does ~2.6 GFLOP of fp32 work: ~0.15 ms at 3.35 TB/s, more than the ~0.04 ms
// the operations need at 67 TFLOP/s. This simple design is far from that:
// the rows do not fit the 50 MB L2, so they are streamed from device memory
// once per solver iteration, and with one thread per env only B threads are
// in flight, so each row visit waits out its loads. Row prefetch, several threads per env
// and rows kept across iterations are left for the PRs that make it fast.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (evomotion_tpu_torch/kernels/sweep_envlast.py).

#include <cuda_runtime.h>

namespace {

constexpr int kRowF = 29;
constexpr int kDva = 12, kDvb = 18, kRhs = 24, kLo = 25, kHi = 26, kIe = 27, kRhsP = 28;
constexpr int kMetaI = 6;  // ia6, ib6, kind, parent, skip_b, push_slot
constexpr int kJoint = 0;
constexpr int kNormal = 1;
constexpr int kThreads = 32;

// clamp that keeps a NaN candidate NaN (jnp.clip / torch.clamp semantics)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__global__ void __launch_bounds__(kThreads) solver_sweep_envlast_kernel(
    const float* __restrict__ rows,     // [nr_pad, 29, B]
    const float* __restrict__ vel_in,   // [nb6, B]
    const float* __restrict__ lam_in,   // [nr_pad, B]
    const int* __restrict__ meta_i,     // [n_rows, 6]
    const float* __restrict__ mu,       // [n_rows]
    float* __restrict__ vel_out,        // [nb6, B]
    float* __restrict__ lam_out,        // [nr_pad, B]
    float* __restrict__ push_out,       // [nb6, B]
    float* __restrict__ plam,           // [n_push, B] scratch
    int B, int nb6, int nr_pad, int n_rows, int n_iters, int n_push) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int env = blockIdx.x * kThreads + t;
  if (env >= B) return;  // no block-wide barrier below
  float* v = smem;                    // [nb6][kThreads]
  float* pv = smem + nb6 * kThreads;  // [nb6][kThreads]

  for (int k = 0; k < nb6; ++k) {
    v[k * kThreads + t] = vel_in[(size_t)k * B + env];
    pv[k * kThreads + t] = 0.f;
  }
  for (int r = 0; r < nr_pad; ++r) lam_out[(size_t)r * B + env] = lam_in[(size_t)r * B + env];
  for (int p = 0; p < n_push; ++p) plam[(size_t)p * B + env] = 0.f;

  for (int it = 0; it < n_iters; ++it) {
    for (int r = 0; r < n_rows; ++r) {
      const int* mi = meta_i + r * kMetaI;
      const int ia6 = __ldg(mi + 0), ib6 = __ldg(mi + 1), kind = __ldg(mi + 2);
      const int parent = __ldg(mi + 3), skip_b = __ldg(mi + 4), pslot = __ldg(mi + 5);

      float x[kRowF];
      const float* xr = rows + (size_t)r * kRowF * B + env;
#pragma unroll
      for (int c = 0; c < kRowF; ++c) x[c] = __ldg(xr + (size_t)c * B);

      float va[6], vb[6];
      float jv = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        va[c] = v[(ia6 + c) * kThreads + t];
        jv += x[c] * va[c];
      }
      if (!skip_b) {
        float jv_b = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          vb[c] = v[(ib6 + c) * kThreads + t];
          jv_b += x[6 + c] * vb[c];
        }
        jv += jv_b;
      }
      const float ie = x[kIe];

      float* lam_r = lam_out + (size_t)r * B + env;
      const float old = *lam_r;
      const float cand = old + (x[kRhs] - jv) * ie;
      float nl;
      if (kind == kJoint) {
        nl = clip(cand, x[kLo], x[kHi]);
      } else if (kind == kNormal) {
        nl = cand < 0.f ? 0.f : cand;
      } else {
        const float lim = __ldg(mu + r) * lam_out[(size_t)parent * B + env];
        nl = clip(cand, -lim, lim);
      }
      const float d = nl - old;
      *lam_r = nl;
#pragma unroll
      for (int c = 0; c < 6; ++c) v[(ia6 + c) * kThreads + t] = va[c] + x[kDva + c] * d;
      if (!skip_b) {
#pragma unroll
        for (int c = 0; c < 6; ++c) v[(ib6 + c) * kThreads + t] = vb[c] + x[kDvb + c] * d;
      }

      if (pslot >= 0) {
        float pa[6], pb[6], jvp = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          pa[c] = pv[(ia6 + c) * kThreads + t];
          jvp += x[c] * pa[c];
        }
        if (!skip_b) {
          float jvp_b = 0.f;
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            pb[c] = pv[(ib6 + c) * kThreads + t];
            jvp_b += x[6 + c] * pb[c];
          }
          jvp += jvp_b;
        }
        float* pl_r = plam + (size_t)pslot * B + env;
        const float pold = *pl_r;
        float pnew = pold + (x[kRhsP] - jvp) * ie;
        pnew = pnew < 0.f ? 0.f : pnew;
        const float dp = pnew - pold;
        *pl_r = pnew;
#pragma unroll
        for (int c = 0; c < 6; ++c) pv[(ia6 + c) * kThreads + t] = pa[c] + x[kDva + c] * dp;
        if (!skip_b) {
#pragma unroll
          for (int c = 0; c < 6; ++c) pv[(ib6 + c) * kThreads + t] = pb[c] + x[kDvb + c] * dp;
        }
      }
    }
  }

  for (int k = 0; k < nb6; ++k) {
    vel_out[(size_t)k * B + env] = v[k * kThreads + t];
    push_out[(size_t)k * B + env] = pv[k * kThreads + t];
  }
}

}  // namespace

// Launch on `stream`, 32 envs per block; returns the CUDA error code of the
// launch (0 on success).
extern "C" int solver_sweep_envlast_launch(
    const void* rows, const void* vel_in, const void* lam_in, const void* meta_i,
    const void* mu, void* vel_out, void* lam_out, void* push_out, void* plam, int B,
    int nb6, int nr_pad, int n_rows, int n_iters, int n_push, void* stream) {
  const size_t smem = 2 * (size_t)nb6 * kThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      solver_sweep_envlast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kThreads - 1) / kThreads;
  solver_sweep_envlast_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(vel_in),
      static_cast<const float*>(lam_in), static_cast<const int*>(meta_i),
      static_cast<const float*>(mu), static_cast<float*>(vel_out),
      static_cast<float*>(lam_out), static_cast<float*>(push_out),
      static_cast<float*>(plam), B, nb6, nr_pad, n_rows, n_iters, n_push);
  return (int)cudaGetLastError();
}

extern "C" int solver_sweep_envlast_max_smem_per_block() {
  int dev = 0, val = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return val;
}

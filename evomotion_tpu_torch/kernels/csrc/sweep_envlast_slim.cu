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
// kernel computes. A body that overlaps a group's loads is left for a PR
// that makes the kernel fast.
//
// Layout: every array is env-LAST ([rows, cols, B]), so thread `env` reading
// element (r, c) touches address (r * cols + c) * B + env and neighbouring
// threads read neighbouring addresses (coalesced). One thread walks one env.
// Its body velocities and push velocities sit in shared memory (2 * NB * 6
// floats per thread, [k][thread] so a warp hits 32 distinct banks); impulses
// and push impulses stay in device memory, in the same coalesced layout.
//
// What bounds it on an H100: counted as the contract counts it (each input
// read once), a spider call at B=2048 moves ~0.2 GB and does ~5 GFLOP of
// fp32 work, both well under 0.1 ms at the card's peaks. This simple design
// is far from that: the row set (~157 MB of bf16 J at spider scale) does not
// fit the 50 MB L2, so it is streamed from device memory once per solver
// iteration, and with one thread per env only 2048 threads are in flight, so
// each row visit waits out its load latency. Row prefetch, several threads
// per env, and keeping rows in shared memory across iterations are left for
// the PRs that make it fast.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (evomotion_tpu_torch/kernels/sweep.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowJ = 12;
constexpr int kRowS = 4;
constexpr int kMetaI = 6;  // ia6, ib6, kind, parent, skip_b, push_slot
constexpr int kMetaF = 3;  // mu, inv_mass_a, inv_mass_b
constexpr int kJoint = 0;
constexpr int kNormal = 1;
constexpr int kThreads = 32;

__device__ __forceinline__ float load_j(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_j(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// clamp that keeps a NaN candidate NaN (jnp.clip / torch.clamp semantics)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// dv = [im * j_lin, Iinv * j_ang]; Iinv is row-major 3x3 at ii[k * B]
__device__ __forceinline__ void body_dv(const float* ii, int B, float im,
                                        const float* j, float* dv) {
  dv[0] = im * j[0];
  dv[1] = im * j[1];
  dv[2] = im * j[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    dv[3 + r] = __ldg(ii + (3 * r) * B) * j[3] + __ldg(ii + (3 * r + 1) * B) * j[4] +
                __ldg(ii + (3 * r + 2) * B) * j[5];
  }
}

template <typename JT>
__global__ void __launch_bounds__(kThreads) sweep_envlast_slim_kernel(
    const JT* __restrict__ row_j,       // [nr_pad, 12, B]
    const float* __restrict__ row_s,    // [nr_pad, 4, B]: rhs, lo, hi, rhs_push
    const float* __restrict__ vel_in,   // [nb6, B]
    const float* __restrict__ lam_in,   // [nr_pad, B]
    const float* __restrict__ iinv9,    // [nb * 9, B]
    const int* __restrict__ meta_i,     // [n_rows, 6]
    const float* __restrict__ meta_f,   // [n_rows, 3]
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
      const float mu = __ldg(meta_f + r * kMetaF + 0);
      const float im_a = __ldg(meta_f + r * kMetaF + 1);
      const float im_b = __ldg(meta_f + r * kMetaF + 2);

      float j[kRowJ];
      const JT* jr = row_j + (size_t)r * kRowJ * B + env;
#pragma unroll
      for (int c = 0; c < kRowJ; ++c) j[c] = load_j(jr + (size_t)c * B);
      const float* sr = row_s + (size_t)r * kRowS * B + env;
      const float rhs = __ldg(sr), lo = __ldg(sr + B), hi = __ldg(sr + 2 * (size_t)B);
      const float rhs_push = __ldg(sr + 3 * (size_t)B);

      float dva[6], dvb[6], va[6], vb[6];
      body_dv(iinv9 + (size_t)(ia6 / 6 * 9) * B + env, B, im_a, j, dva);
      float eff = 0.f, jv = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        va[c] = v[(ia6 + c) * kThreads + t];
        eff += j[c] * dva[c];
        jv += j[c] * va[c];
      }
      if (!skip_b) {
        body_dv(iinv9 + (size_t)(ib6 / 6 * 9) * B + env, B, im_b, j + 6, dvb);
        float eff_b = 0.f, jv_b = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          vb[c] = v[(ib6 + c) * kThreads + t];
          eff_b += j[6 + c] * dvb[c];
          jv_b += j[6 + c] * vb[c];
        }
        eff += eff_b;
        jv += jv_b;
      }
      const float ie = eff > 1e-12f ? 1.f / fmaxf(eff, 1e-12f) : 0.f;

      float* lam_r = lam_out + (size_t)r * B + env;
      const float old = *lam_r;
      const float cand = old + (rhs - jv) * ie;
      float nl;
      if (kind == kJoint) {
        nl = clip(cand, lo, hi);
      } else if (kind == kNormal) {
        nl = cand < 0.f ? 0.f : cand;
      } else {
        const float lim = mu * lam_out[(size_t)parent * B + env];
        nl = clip(cand, -lim, lim);
      }
      const float d = nl - old;
      *lam_r = nl;
#pragma unroll
      for (int c = 0; c < 6; ++c) v[(ia6 + c) * kThreads + t] = va[c] + dva[c] * d;
      if (!skip_b) {
#pragma unroll
        for (int c = 0; c < 6; ++c) v[(ib6 + c) * kThreads + t] = vb[c] + dvb[c] * d;
      }

      if (pslot >= 0) {
        float pa[6], pb[6], jvp = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          pa[c] = pv[(ia6 + c) * kThreads + t];
          jvp += j[c] * pa[c];
        }
        if (!skip_b) {
          float jvp_b = 0.f;
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            pb[c] = pv[(ib6 + c) * kThreads + t];
            jvp_b += j[6 + c] * pb[c];
          }
          jvp += jvp_b;
        }
        float* pl_r = plam + (size_t)pslot * B + env;
        const float pold = *pl_r;
        float pnew = pold + (rhs_push - jvp) * ie;
        pnew = pnew < 0.f ? 0.f : pnew;
        const float dp = pnew - pold;
        *pl_r = pnew;
#pragma unroll
        for (int c = 0; c < 6; ++c) pv[(ia6 + c) * kThreads + t] = pa[c] + dva[c] * dp;
        if (!skip_b) {
#pragma unroll
          for (int c = 0; c < 6; ++c) pv[(ib6 + c) * kThreads + t] = pb[c] + dvb[c] * dp;
        }
      }
    }
  }

  for (int k = 0; k < nb6; ++k) {
    vel_out[(size_t)k * B + env] = v[k * kThreads + t];
    push_out[(size_t)k * B + env] = pv[k * kThreads + t];
  }
}

template <typename JT>
int launch(const void* row_j, const void* row_s, const void* vel_in, const void* lam_in,
           const void* iinv9, const void* meta_i, const void* meta_f, void* vel_out,
           void* lam_out, void* push_out, void* plam, int B, int nb6, int nr_pad,
           int n_rows, int n_iters, int n_push, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)nb6 * kThreads * sizeof(float);
  auto kern = sweep_envlast_slim_kernel<JT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kThreads - 1) / kThreads;
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const JT*>(row_j), static_cast<const float*>(row_s),
      static_cast<const float*>(vel_in), static_cast<const float*>(lam_in),
      static_cast<const float*>(iinv9), static_cast<const int*>(meta_i),
      static_cast<const float*>(meta_f), static_cast<float*>(vel_out),
      static_cast<float*>(lam_out), static_cast<float*>(push_out),
      static_cast<float*>(plam), B, nb6, nr_pad, n_rows, n_iters, n_push);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sweep_envlast_slim_launch(
    const void* row_j, int j_is_bf16, const void* row_s, const void* vel_in,
    const void* lam_in, const void* iinv9, const void* meta_i, const void* meta_f,
    void* vel_out, void* lam_out, void* push_out, void* plam, int B, int nb6,
    int nr_pad, int n_rows, int n_iters, int n_push, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (j_is_bf16)
    return launch<__nv_bfloat16>(row_j, row_s, vel_in, lam_in, iinv9, meta_i, meta_f,
                                 vel_out, lam_out, push_out, plam, B, nb6, nr_pad,
                                 n_rows, n_iters, n_push, s);
  return launch<float>(row_j, row_s, vel_in, lam_in, iinv9, meta_i, meta_f, vel_out,
                       lam_out, push_out, plam, B, nb6, nr_pad, n_rows, n_iters,
                       n_push, s);
}

extern "C" int sweep_envlast_slim_max_smem_per_block() {
  int dev = 0, val = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return val;
}

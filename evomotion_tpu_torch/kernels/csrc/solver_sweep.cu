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
// The per-env physics step calls it twice per step: once over the contact
// normal rows with the split-impulse rhs (push pass), once over all rows.
//
// Groups (the `scheduled` row order, TPU kernel :133-181): as in
// sweep_envlast_slim.cu, `make_fat_meta` (kernels/sweep_fat.py) accepts only
// groups whose rows write pairwise disjoint bodies and whose friction rows'
// parents lie in earlier groups, so visiting the permuted rows one at a time
// here computes what the TPU kernel's load-then-store groups compute.
//
// Layout: rows [B, NR, 28], vel [B, NB * 6], lam [B, NR], all f32, batch
// FIRST as the TPU kernel's wrapper takes them. One thread walks one env: a
// row is 112 contiguous bytes it reads as seven float4 loads. Its body
// velocities and impulses live in shared memory ([k][thread], T threads a
// block, as many as the shared memory holds); rows and the per-row metadata
// come from device memory through the read-only path.
//
// What bounds it on an H100: at B=1 (the per-env path) a spider call reads
// ~0.2 MB and does ~0.8 MFLOP, well under a microsecond at the card's peaks.
// What holds it back is the chain: every row visit reads velocities the
// previous visit may have written, so 18,960 visits (10 iterations of 1,896
// rows) run one after another, each waiting out its shared-memory round trip
// and ~12 dependent fp32 operations. The design keeps that chain short: the
// next row and its metadata are loaded into registers while the current one
// is solved, so no row visit waits for device memory.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (evomotion_tpu_torch/kernels/sweep_fat.py).

#include <cuda_runtime.h>

namespace {

constexpr int kRowF = 28;
constexpr int kRowF4 = kRowF / 4;
constexpr int kDva = 12, kDvb = 18, kRhs = 24, kLo = 25, kHi = 26, kIe = 27;
constexpr int kJoint = 0;
constexpr int kNormal = 1;

__device__ __forceinline__ void load_row(const float4* __restrict__ p, float* f) {
#pragma unroll
  for (int i = 0; i < kRowF4; ++i) {
    const float4 x = __ldg(p + i);
    f[4 * i + 0] = x.x;
    f[4 * i + 1] = x.y;
    f[4 * i + 2] = x.z;
    f[4 * i + 3] = x.w;
  }
}

// clamp that keeps a NaN candidate NaN (jnp.clip / torch.clamp semantics)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__global__ void solver_sweep_kernel(
    const float* __restrict__ rows,    // [B, nr, 28]
    const float* __restrict__ vel_in,  // [B, nb6]
    const float* __restrict__ lam_in,  // [B, nr]
    const int4* __restrict__ meta,     // [nr]: ia6, ib6 (-1: body B static), kind, parent
    const float* __restrict__ mu,      // [nr] friction coefficient
    float* __restrict__ vel_out,       // [B, nb6]
    float* __restrict__ lam_out,       // [B, nr]
    int B, int nb6, int nr, int n_iters) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int env = blockIdx.x * T + t;
  if (env >= B) return;  // no block-wide barrier below
  float* v = smem;             // [nb6][T]
  float* lam = smem + nb6 * T;  // [nr][T]

  for (int k = 0; k < nb6; ++k) v[k * T + t] = vel_in[(size_t)env * nb6 + k];
  for (int r = 0; r < nr; ++r) lam[r * T + t] = lam_in[(size_t)env * nr + r];

  if (nr > 0 && n_iters > 0) {
    const float4* rb = reinterpret_cast<const float4*>(rows + (size_t)env * nr * kRowF);
    float cur[kRowF], nxt[kRowF];
    load_row(rb, cur);
    int4 mc = __ldg(meta);
    float muc = __ldg(mu);
    int r = 0;
    const long long total = (long long)n_iters * nr;
    for (long long s = 0; s < total; ++s) {
      // prefetch the next visit's row (row 0 again after the last row)
      const int rn = (r + 1 == nr) ? 0 : r + 1;
      load_row(rb + (size_t)rn * kRowF4, nxt);
      const int4 mn = __ldg(meta + rn);
      const float mun = __ldg(mu + rn);

      const int ia6 = mc.x, ib6 = mc.y, kind = mc.z, parent = mc.w;
      float va[6], vb[6];
      float jv = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        va[c] = v[(ia6 + c) * T + t];
        jv += cur[c] * va[c];
      }
      if (ib6 >= 0) {
        float jv_b = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          vb[c] = v[(ib6 + c) * T + t];
          jv_b += cur[6 + c] * vb[c];
        }
        jv += jv_b;
      }
      float* lam_r = lam + r * T + t;
      const float old = *lam_r;
      const float cand = old + (cur[kRhs] - jv) * cur[kIe];
      float nl;
      if (kind == kJoint) {
        nl = clip(cand, cur[kLo], cur[kHi]);
      } else if (kind == kNormal) {
        nl = cand < 0.f ? 0.f : cand;
      } else {
        const float lim = muc * lam[parent * T + t];
        nl = clip(cand, -lim, lim);
      }
      const float d = nl - old;
      *lam_r = nl;
#pragma unroll
      for (int c = 0; c < 6; ++c) v[(ia6 + c) * T + t] = va[c] + cur[kDva + c] * d;
      if (ib6 >= 0) {
#pragma unroll
        for (int c = 0; c < 6; ++c) v[(ib6 + c) * T + t] = vb[c] + cur[kDvb + c] * d;
      }

#pragma unroll
      for (int c = 0; c < kRowF; ++c) cur[c] = nxt[c];
      mc = mn;
      muc = mun;
      r = rn;
    }
  }

  for (int k = 0; k < nb6; ++k) vel_out[(size_t)env * nb6 + k] = v[k * T + t];
  for (int r = 0; r < nr; ++r) lam_out[(size_t)env * nr + r] = lam[r * T + t];
}

}  // namespace

// Launch on `stream` with `threads` envs per block; returns the CUDA error
// code of the launch (0 on success).
extern "C" int solver_sweep_launch(const void* rows, const void* vel_in, const void* lam_in,
                                   const void* meta, const void* mu, void* vel_out,
                                   void* lam_out, int B, int nb6, int nr, int n_iters,
                                   int threads, void* stream) {
  const size_t smem = (size_t)(nb6 + nr) * threads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      solver_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + threads - 1) / threads;
  solver_sweep_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(vel_in),
      static_cast<const float*>(lam_in), static_cast<const int4*>(meta),
      static_cast<const float*>(mu), static_cast<float*>(vel_out),
      static_cast<float*>(lam_out), B, nb6, nr, n_iters);
  return (int)cudaGetLastError();
}

extern "C" int solver_sweep_max_smem_per_block() {
  int dev = 0, val = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return val;
}

// The member contact phase of the batched physics step in one launch, for
// Hopper (sm_90a): kernel #4.
//
// It replaces no Pallas kernel. The JAX package computes this phase,
// `_member_contact_rows` (evomotion_tpu/physics/batched.py:1031), in plain
// jnp, and so does the port's plain version, `_member_contact_rows` in
// evomotion_tpu_torch/physics/batched.py. There it is ~1,400 PyTorch
// operators per physics step, the largest phase of the step by launches,
// device time and idle time: its `deepest` step alone builds [M, V, F, B]
// float32 tensors (377 MB at B = 4,096) that a dozen element-wise and
// reduce kernels write and read again. This kernel computes the same
// function for every env in one launch, per env:
//
//   1. the top-M cull: each member pair's conservative clearance (centre
//      distance minus bounding radii), and its rank in the order of a
//      stable ascending sort (NaN last, ties by pair index); the pairs of
//      rank < M are narrowphased, a dense model (M = P) takes every pair;
//   2. the narrowphase of each selected pair: the V test points of each
//      body against the other's F faces in the vertex body's frame (argmax
//      over faces), the K deepest of each side by iterated argmin (first
//      index on ties, a pick set to 1e9), the K deepest of the 2K, the
//      DEDUP_TOL near-duplicate test, and with edge contacts the edge-edge
//      SAT whose closest-points contact replaces slot 0;
//   3. the rows of every contact point at its canonical pair slot (an
//      unselected pair gets gap 1e9, vid -1 and a +z normal): the normal
//      row and the two friction rows (batched._friction_dirs, its strict
//      branch too) in the slim two-stream layout of batched._pack, J in
//      bf16 or f32 and scalars (rhs, lo, hi, rhs_push) in f32;
//   4. the warm start: feature ids matched against the cached ones within
//      each pair, the cached impulses x WARMSTART for active points, and
//      their velocity change imp6 [NB, 6] summed per env in a fixed order.
//
// Decision values (clearances, plane distances, candidate gaps, SAT
// overlaps) and every value that reaches the rows are computed in the plain
// version's operation order, and the file is built with --fmad=false, so
// that each f32 operation rounds as PyTorch's one-operator kernels round on
// the card: the argmin and argmax choices, and J before its bf16 rounding,
// come out as the plain version's. That order includes PyTorch's own for
// its small sums: a sum over 3 components that lie next to each other in
// memory (as the step's env-first states put them) takes (x + z) + y, any
// other left to right (`dot3_xzy` below: the clearances, the face offsets,
// the strict slip direction). rhs divides by dt as PyTorch divides by a
// Python scalar on the card: a multiply by 1/dt rounded to f32. imp6 is
// summed in another order than the plain version's index_add (atomics, in
// no fixed order there).
//
// What bounds it on an H100. Per env it reads ~42 x 13 state floats and
// the warm caches (480 ids, 480 x 3 impulses) and writes 1,440 rows of 40
// bytes (12 bf16 J values and 4 f32 scalars) with act, vid, lam_n0,
// lam_t0 and imp6: ~67 KB, 275 MB at B = 4,096, 0.08 ms at 3.35 TB/s;
// ~0.4 MFLOP per env (2 x 48 x 24 x 20 plane tests and the edge SAT), 1.6
// GFLOP at 4,096, 0.025 ms at 67 TFLOP/s. So it is bound by memory, and
// what it must not do is move the [M, V, F] intermediates through memory.
//
// What this design does. A block takes E envs (a power of two, at most
// 16) with 16 groups of E threads; thread = group * E + env, so a group's
// lanes are neighbouring envs and every env-last load and row store is one
// contiguous run of E values. The model's statics (the member bodies'
// test points, masks, face planes and edge directions, the pairs' bodies,
// radii and margins: ~17 KB for the spider, rows padded to an odd length
// of words against bank conflicts) and the E envs' states of the member
// bodies (pos, quat, velocities, world inverse inertia) are loaded into
// shared memory once per block, from either layout the step hands over
// (env-last, or the env-last view of a env-first tensor). Phases, between
// barriers:
//   - clearances [P][E] and ranks -> slot of each pair [P][E], pair of each
//     slot [M][E];
//   - narrowphase, one (slot, env) per thread: per face plane the test
//     points' distances go to the thread's own column of a [V][threads]
//     array in shared memory (the running max and its face), so nothing of
//     [M, V, F] leaves the SM; the K picks of each side stay in registers;
//     each slot's K points (point, normal, gap, vid) go to a per-block
//     scratch in device memory, written in runs of E;
//   - rows, one (pair, env) per thread in rounds of 16 pairs: the pair's
//     slot's points (or the unselected defaults), its K normal and 2K
//     friction rows, act, vid, lam_n0 and lam_t0, each stored in runs of
//     E; the pair's summed impulse change goes to a [16][12][E] stage, and
//     6E threads add the round's stage into imp6 [U][6][E] in pair order
//     (each env's sums in one fixed order);
//   - imp6 stored, zero for bodies in no pair.
// Shapes (P, M, K, V, F, edge directions, support points), the flags (edge
// contacts, strict_bullet, the J dtype) and E are runtime parameters. The
// kernel launches on the caller's stream, allocates nothing (the wrapper
// passes outputs and the scratch) and reads nothing back to the host.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (evomotion_tpu_torch/kernels/member.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 4;         // manifold points per pair (the floor's MAX_CONTACTS_PER_PAIR)
constexpr int kMaxV = 48;        // test points per hull (shapes.reduce_to_hull's default limit)
constexpr int kMaxF = 255;       // face planes per hull (a face id is one byte)
constexpr int kMaxEdges = 8;     // edge directions per hull
constexpr int kMaxPairs = 32767; // member pairs (a slot id is an int16)
constexpr int kMaxEnvs = 16;     // envs per block
constexpr int kGroups = 16;      // thread groups per block: threads = kGroups * envs
constexpr int kPoint = 8;        // scratch floats per manifold point: point, normal, gap, vid
constexpr int kState = 22;       // staged floats per body: pos 3, quat 4, lin 3, ang 3, iinv 9
constexpr int kPos = 0, kQuat = 3, kLin = 7, kAng = 10, kIinv = 13;
constexpr float kBig = 1e9f;

__host__ __device__ inline int odd(int n) { return n | 1; }

// Word offsets of the statics table (kernels/member.py `meta_layout` packs
// the same): pairs [P][2] (member-body slots u of A and B), brad [P],
// marg [P], u_of [NB] (slot of each body, -1 outside every pair), body [U],
// inv_mass [U], then per member body, each row padded to an odd length:
// test points [V][3], mask [V], face planes [F][4], edge dirs [NE][3],
// edge mask [NE].
struct MetaLayout {
  int pair, brad, marg, u_of, body, inv_mass, hull, hmask, face, edir, emask, words;
  int hs, ms, fs, es, ems;
  __host__ __device__ MetaLayout(int nb, int u, int p, int v, int f, int ne) {
    hs = odd(3 * v);
    ms = odd(v);
    fs = odd(4 * f);
    es = odd(3 * ne);
    ems = odd(ne);
    pair = 0;
    brad = pair + 2 * p;
    marg = brad + p;
    u_of = marg + p;
    body = u_of + nb;
    inv_mass = body + u;
    hull = inv_mass + u;
    hmask = hull + u * hs;
    face = hmask + u * ms;
    edir = face + u * fs;
    emask = edir + u * es;
    words = emask + u * ems;
  }
};

// Shared-memory words of a block: the statics, the staged states
// [U][22][E + 1], the slot of each pair [P][E] and the pair of each slot
// [M][E] (int16), and one work area that the phases take in turn: the
// clearances [P][E]; each thread's running plane distances [V][threads]
// (f32) and faces (bytes); the rows' stage [16][12][E] and imp6 [U][6][E].
struct SmemLayout {
  int state, slot, sel, work, sface, stage, acc, words;
  __host__ __device__ SmemLayout(const MetaLayout& ml, int u, int p, int m, int v, int envs) {
    const int threads = kGroups * envs;
    state = ml.words;
    slot = state + u * kState * (envs + 1);
    sel = slot + (p * envs + 1) / 2;
    work = sel + (m * envs + 1) / 2;
    sface = work + v * threads;  // bytes from here
    stage = work;
    acc = stage + kGroups * 12 * envs;
    int need = p * envs;
    const int np = v * threads + (v * threads + 3) / 4;
    if (np > need) need = np;
    const int rows = kGroups * 12 * envs + u * 6 * envs;
    if (rows > need) need = rows;
    words = work + need;
  }
};

struct Args {
  // inputs: element (body * C + c) of env e at [elem * se + e * sv]
  const float* pos;
  const float* quat;
  const float* lin;
  const float* ang;
  const float* iinv;
  const int* dvid;
  const float* dlam;
  int pos_se, pos_sv, quat_se, quat_sv, lin_se, lin_sv, ang_se, ang_sv, iinv_se, iinv_sv;
  int dvid_se, dvid_sv, dlam_se, dlam_sv;
  const int* meta;
  // outputs, env-last and contiguous
  void* nj;      // [P*K, 12, B] normal rows' J (bf16 or f32)
  float* ns;     // [P*K, 4, B] their rhs, lo, hi, rhs_push
  void* fj;      // [2*P*K, 12, B] friction rows' J, contact-major, direction-minor
  float* fs;     // [2*P*K, 4, B]
  float* act;    // [P*K, B]
  int* vid;      // [P*K, B]
  float* imp6;   // [NB, 6, B]
  float* lam_n;  // [P*K, B]
  float* lam_t;  // [P*K, 2, B]
  float* scratch;  // [blocks][M][K][8][E]
  int B, NB, U, P, M, K, V, F, NE, nsupp, edge, strict, bf16, envs;
  float inv_dt, erp2, warm, cbreak, dedup2;
};

struct V3 {
  float x, y, z;
};
struct Q4 {
  float x, y, z, w;
};

// batched.py's env-last maths, operation for operation
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
// PyTorch's order for a sum over 3 components that lie next to each other
// in memory (two threads, the first adding components 0 and 2)
__device__ __forceinline__ float dot3_xzy(V3 a, V3 b) {
  return (a.x * b.x + a.z * b.z) + a.y * b.y;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ Q4 conj(Q4 q) { return {-q.x, -q.y, -q.z, q.w}; }
__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
          a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  const V3 qv{q.x, q.y, q.z};
  const V3 t = mul(cross(qv, v), 2.0f);
  const V3 c = cross(qv, t);
  return {(v.x + q.w * t.x) + c.x, (v.y + q.w * t.y) + c.y, (v.z + q.w * t.z) + c.z};
}
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }

// One block's views of its shared memory and its envs.
struct Blk {
  const int* pair;
  const float *brad, *marg, *inv_mass, *hull, *hmask, *face, *edir, *emask;
  const int *u_of, *body;
  int hs, ms, fs, es, ems;
  float* state;
  short* slot;
  short* sel;
  float* work;
  unsigned char* sface;
  float* stage;
  float* acc;
  int env0, threads, es_state;
  float* scratch;

  __device__ Blk(const Args& a, int* smem, int bid) {
    const MetaLayout ml(a.NB, a.U, a.P, a.V, a.F, a.NE);
    const SmemLayout sl(ml, a.U, a.P, a.M, a.V, a.envs);
    const float* f = reinterpret_cast<const float*>(smem);
    pair = smem + ml.pair;
    brad = f + ml.brad;
    marg = f + ml.marg;
    u_of = smem + ml.u_of;
    body = smem + ml.body;
    inv_mass = f + ml.inv_mass;
    hull = f + ml.hull;
    hmask = f + ml.hmask;
    face = f + ml.face;
    edir = f + ml.edir;
    emask = f + ml.emask;
    hs = ml.hs;
    ms = ml.ms;
    fs = ml.fs;
    es = ml.es;
    ems = ml.ems;
    state = reinterpret_cast<float*>(smem + sl.state);
    slot = reinterpret_cast<short*>(smem + sl.slot);
    sel = reinterpret_cast<short*>(smem + sl.sel);
    work = reinterpret_cast<float*>(smem + sl.work);
    sface = reinterpret_cast<unsigned char*>(smem + sl.sface);
    stage = reinterpret_cast<float*>(smem + sl.stage);
    acc = reinterpret_cast<float*>(smem + sl.acc);
    env0 = bid * a.envs;
    threads = kGroups * a.envs;
    es_state = a.envs + 1;
    scratch = a.scratch + (size_t)bid * a.M * a.K * kPoint * a.envs;
  }
  __device__ float st(int u, int ch, int e) const {
    return state[(u * kState + ch) * es_state + e];
  }
  __device__ V3 st3(int u, int ch, int e) const {
    return {st(u, ch, e), st(u, ch + 1, e), st(u, ch + 2, e)};
  }
  __device__ Q4 quat(int u, int e) const {
    return {st(u, kQuat, e), st(u, kQuat + 1, e), st(u, kQuat + 2, e), st(u, kQuat + 3, e)};
  }
  __device__ V3 hull_pt(int u, int v) const {
    const float* h = hull + u * hs + 3 * v;
    return {h[0], h[1], h[2]};
  }
  __device__ V3 face_n(int u, int f) const {
    const float* p = face + u * fs + 4 * f;
    return {p[0], p[1], p[2]};
  }
  __device__ V3 edge_dir(int u, int i) const {
    const float* p = edir + u * es + 3 * i;
    return {p[0], p[1], p[2]};
  }
};

// ---- phase 0: statics and the envs' states into shared memory ----

__device__ void stage_one(const Args& a, const Blk& k, int tid, const float* src, int se, int sv,
                          int C, int ch0) {
  const int E = a.envs;
  const int n = a.U * C * E;
  for (int i = tid; i < n; i += k.threads) {
    int e, r;
    if (sv == 1) {  // env-last: neighbouring threads read neighbouring envs
      e = i % E;
      r = i / E;
    } else {  // env-first: neighbouring threads read one env's neighbouring elements
      e = i / (a.U * C);
      r = i % (a.U * C);
    }
    const int env = k.env0 + e;
    if (env >= a.B) continue;
    const int u = r / C, c = r % C;
    const long long at = (long long)(k.body[u] * C + c) * se + (long long)env * sv;
    k.state[(u * kState + ch0 + c) * k.es_state + e] = src[at];
  }
}

__device__ void load_block(const Args& a, const Blk& k, int* smem, int tid) {
  const MetaLayout ml(a.NB, a.U, a.P, a.V, a.F, a.NE);
  for (int i = tid; i < ml.words; i += k.threads) smem[i] = a.meta[i];
}

__device__ void stage_states(const Args& a, const Blk& k, int tid) {
  stage_one(a, k, tid, a.pos, a.pos_se, a.pos_sv, 3, kPos);
  stage_one(a, k, tid, a.quat, a.quat_se, a.quat_sv, 4, kQuat);
  stage_one(a, k, tid, a.lin, a.lin_se, a.lin_sv, 3, kLin);
  stage_one(a, k, tid, a.ang, a.ang_se, a.ang_sv, 3, kAng);
  stage_one(a, k, tid, a.iinv, a.iinv_se, a.iinv_sv, 9, kIinv);
}

// ---- phase 1: the top-M cull ----

// batched._select_pairs: sqrt(sum((ca - cb) ** 2)) - brad
__device__ void clearances(const Args& a, const Blk& k, int tid) {
  const int E = a.envs;
  for (int i = tid; i < a.P * E; i += k.threads) {
    const int p = i / E, e = i % E;
    if (k.env0 + e >= a.B) continue;
    const V3 d = sub(k.st3(k.pair[2 * p], kPos, e), k.st3(k.pair[2 * p + 1], kPos, e));
    k.work[i] = sqrtf(dot3_xzy(d, d)) - k.brad[p];
  }
}

// Each pair's rank in a stable ascending sort of its env's clearances
// (NaN last): the slot of rank < M, -1 beyond. Dense: slot = pair.
__device__ void rank_pairs(const Args& a, const Blk& k, int tid) {
  const int E = a.envs;
  const bool dense = a.M >= a.P;
  for (int i = tid; i < a.P * E; i += k.threads) {
    const int p = i / E, e = i % E;
    int r = p;
    if (!dense && k.env0 + e < a.B) {
      const float ci = k.work[i];
      const bool ni = ci != ci;
      r = 0;
      for (int j = 0; j < a.P; ++j) {
        const float cj = k.work[j * E + e];
        const bool nj = cj != cj;
        r += (ni != nj) ? ni : (ni ? j < p : (cj < ci || (cj == ci && j < p)));
      }
    }
    k.slot[i] = (short)(r < a.M ? r : -1);
    if (r < a.M) k.sel[r * E + e] = (short)p;
  }
}

// ---- phase 2: the narrowphase of the selected pairs ----

// batched._dyn_narrowphase_sel's `deepest`: the test points of body uw
// (pose qw, pw) against the face planes of body uf (pose qf, pf), in uw's
// frame. Writes the K picks (gap as picked, test point, its face) to
// cg/cv/cf[0..K) and returns -max_f min_v d (the face SAT's penetration).
__device__ __forceinline__ float deepest(const Args& a, const Blk& k, int tid, Q4 qw, V3 pw, int uw,
                                         Q4 qf, V3 pf, int uf, float* cg, int* cv, int* cf) {
  const int T = k.threads;
  float* sd = k.work + tid;
  unsigned char* sf = k.sface + tid;
  const Q4 cqf = conj(qf);
  const Q4 q_rel = qmul(cqf, qw);
  const V3 t_rel = qrot(cqf, sub(pw, pf));
  const Q4 cq = conj(q_rel);
  const float* hull = k.hull + uw * k.hs;
  float pen = 0.0f;
  for (int f = 0; f < a.F; ++f) {
    const V3 nl = k.face_n(uf, f);
    const float dl = k.face[uf * k.fs + 4 * f + 3];
    const V3 nr = qrot(cq, nl);
    const float doff = dot3_xzy(nl, t_rel) + dl;
    float mn = 0.0f;
    for (int v = 0; v < a.V; ++v) {
      const float* h = hull + 3 * v;
      const float d = ((h[0] * nr.x + h[1] * nr.y) + h[2] * nr.z) + doff;
      if (f == 0 || d > sd[v * T]) {  // amax and argmax over faces, first index on ties
        sd[v * T] = d;
        sf[v * T] = (unsigned char)f;
      }
      mn = (v == 0 || d < mn) ? d : mn;
    }
    pen = (f == 0 || mn > pen) ? mn : pen;
  }
  const float* hm = k.hmask + uw * k.ms;
  for (int v = 0; v < a.V; ++v)
    if (!(hm[v] > 0.0f)) sd[v * T] = kBig;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < a.K) {
      float best = sd[0];
      int bi = 0;
      for (int v = 1; v < a.V; ++v) {
        const float x = sd[v * T];
        if (x < best) {
          best = x;
          bi = v;
        }
      }
      cg[j] = best;
      cv[j] = bi;
      cf[j] = sf[bi * T];
      sd[bi * T] = kBig;
    }
  }
  return -pen;
}

// batched._dyn_narrowphase_sel's sat_overlap for one axis (world frame)
__device__ __forceinline__ float sat_overlap(const Args& a, const Blk& k, V3 ax, Q4 qa, V3 pa,
                                             int ua, Q4 qb, V3 pb, int ub) {
  float lo[2], hi[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int u = s ? ub : ua;
    const V3 al = qrot(conj(s ? qb : qa), ax);
    const float* hm = k.hmask + u * k.ms;
    float mn = kBig, mx = -kBig;
    for (int v = 0; v < a.nsupp; ++v) {
      const V3 h = k.hull_pt(u, v);
      const float pr = (h.x * al.x + h.y * al.y) + h.z * al.z;
      const bool m = hm[v] > 0.0f;
      const float p_lo = m ? pr : kBig, p_hi = m ? pr : -kBig;
      mn = (v == 0 || p_lo < mn) ? p_lo : mn;
      mx = (v == 0 || p_hi > mx) ? p_hi : mx;
    }
    lo[s] = mn;
    hi[s] = mx;
  }
  const float oa = dot(ax, pa), ob = dot(ax, pb);
  return fminf(oa + hi[0], ob + hi[1]) - fmaxf(oa + lo[0], ob + lo[1]);
}

// the edge axis of edge pair idx = i * NE + j: cross(ea_i, eb_j) over its
// length, and whether it counts
__device__ __forceinline__ V3 edge_axis(const Args& a, const Blk& k, int idx, Q4 qa, int ua, Q4 qb,
                                        int ub, bool* ok) {
  const int i = idx / a.NE, j = idx % a.NE;
  const V3 ea = qrot(qa, k.edge_dir(ua, i));
  const V3 eb = qrot(qb, k.edge_dir(ub, j));
  const V3 cr = cross(ea, eb);
  const float len = sqrtf((cr.x * cr.x + cr.y * cr.y) + cr.z * cr.z);
  *ok = len > 1e-6f && k.emask[ua * k.ems + i] > 0.0f && k.emask[ub * k.ems + j] > 0.0f;
  const float l = clamp_min(len, 1e-12f);
  return {cr.x / l, cr.y / l, cr.z / l};
}

// the support point of body u along a local axis: argmin (or argmax) of
// the masked projections over the first nsupp test points, in world
__device__ __forceinline__ V3 support_pt(const Args& a, const Blk& k, int u, V3 axl, bool take_max,
                                         Q4 q, V3 p) {
  const float* hm = k.hmask + u * k.ms;
  float best = 0.0f;
  int bi = 0;
  for (int v = 0; v < a.nsupp; ++v) {
    const V3 h = k.hull_pt(u, v);
    float pr = (h.x * axl.x + h.y * axl.y) + h.z * axl.z;
    if (!(hm[v] > 0.0f)) pr = take_max ? -kBig : kBig;
    if (v == 0 || (take_max ? pr > best : pr < best)) {
      best = pr;
      bi = v;
    }
  }
  return add(p, qrot(q, k.hull_pt(u, bi)));
}

__device__ void narrowphase(const Args& a, const Blk& k, int tid) {
  const int E = a.envs;
  for (int i = tid; i < a.M * E; i += k.threads) {
    const int m = i / E, e = i % E;
    if (k.env0 + e >= a.B) continue;
    const int p = k.sel[i];
    const int ua = k.pair[2 * p], ub = k.pair[2 * p + 1];
    const V3 pa = k.st3(ua, kPos, e), pb = k.st3(ub, kPos, e);
    const Q4 qa = k.quat(ua, e), qb = k.quat(ub, e);

    // candidates: side 0 (B's points in A's faces) at [0, K), side 1 (A's
    // points in B's faces) at [kMaxK, kMaxK + K): the plain version's order
    float cg[2 * kMaxK];
    int cv[2 * kMaxK], cf[2 * kMaxK];
    const float pen1 = deepest(a, k, tid, qb, pb, ub, qa, pa, ua, cg, cv, cf);
    const float pen2 =
        deepest(a, k, tid, qa, pa, ua, qb, pb, ub, cg + kMaxK, cv + kMaxK, cf + kMaxK);

    // the K deepest of the 2K, iterated argmin, first index on ties
    int pick[kMaxK];
    float gap[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      pick[j] = 0;
      gap[j] = kBig;
      if (j < a.K) {
        float best = 0.0f;
        int bi = -1;
#pragma unroll
        for (int c = 0; c < 2 * kMaxK; ++c) {
          if (c % kMaxK < a.K && (bi < 0 || cg[c] < best)) {
            best = cg[c];
            bi = c;
          }
        }
#pragma unroll
        for (int c = 0; c < 2 * kMaxK; ++c)
          if (c == bi) cg[c] = kBig;
        pick[j] = bi;
        gap[j] = best;
      }
    }
    V3 pt[kMaxK], nrm[kMaxK];
    float vid[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      int v = 0, f = 0;
#pragma unroll
      for (int c = 0; c < 2 * kMaxK; ++c)
        if (c == pick[j]) {
          v = cv[c];
          f = cf[c];
        }
      if (pick[j] < kMaxK) {  // B's point, A's face; the normal points from B toward A
        pt[j] = add(pb, qrot(qb, k.hull_pt(ub, v)));
        nrm[j] = neg(qrot(qa, k.face_n(ua, f)));
        vid[j] = (float)v;
      } else {
        pt[j] = add(pa, qrot(qa, k.hull_pt(ua, v)));
        nrm[j] = qrot(qb, k.face_n(ub, f));
        vid[j] = (float)a.V + (float)v;
      }
    }
    // near-duplicate dedup against every earlier (deeper) pick
#pragma unroll
    for (int j = 1; j < kMaxK; ++j) {
      bool dup = false;
#pragma unroll
      for (int i2 = 0; i2 < j; ++i2) {
        const V3 d = sub(pt[j], pt[i2]);
        dup |= ((d.x * d.x + d.y * d.y) + d.z * d.z) < a.dedup2;
      }
      if (j < a.K && dup) gap[j] = kBig;
    }

    if (a.edge) {
      const float pen_f = fminf(pen1, pen2);
      float pen_e = 0.0f;
      int best = 0;
      for (int idx = 0; idx < a.NE * a.NE; ++idx) {
        bool ok;
        const V3 ax = edge_axis(a, k, idx, qa, ua, qb, ub, &ok);
        const float pen = ok ? sat_overlap(a, k, ax, qa, pa, ua, qb, pb, ub) : kBig;
        if (idx == 0 || pen < pen_e) {
          pen_e = pen;
          best = idx;
        }
      }
      bool ok;
      V3 ax = edge_axis(a, k, best, qa, ua, qb, ub, &ok);
      const float sgn_in = dot(ax, sub(pa, pb));
      const float sgn = sgn_in > 0.0f ? 1.0f : (sgn_in < 0.0f ? -1.0f : 1.0f);
      ax = mul(ax, sgn);
      const V3 sa = support_pt(a, k, ua, qrot(conj(qa), ax), false, qa, pa);
      const V3 sb = support_pt(a, k, ub, qrot(conj(qb), ax), true, qb, pb);
      const V3 da = qrot(qa, k.edge_dir(ua, best / a.NE));
      const V3 db = qrot(qb, k.edge_dir(ub, best % a.NE));
      const V3 r_ab = sub(sa, sb);
      const float b_dd = dot(da, db), d_dr = dot(da, r_ab), e_dr = dot(db, r_ab);
      const float denom = 1.0f - b_dd * b_dd;
      const bool safe = fabsf(denom) > 1e-9f;
      const float t1 = safe ? (b_dd * e_dr - d_dr) / denom : 0.0f;
      const float t2 = safe ? (e_dr - b_dd * d_dr) / denom : 0.0f;
      const V3 s = add(add(add(sa, mul(da, t1)), sb), mul(db, t2));
      if (pen_e < 5e8f && pen_e > 0.0f && pen_e < 0.95f * pen_f) {
        pt[0] = mul(s, 0.5f);
        nrm[0] = ax;
        vid[0] = (float)(2 * a.V) + (float)best;
        gap[0] = -pen_e;
#pragma unroll
        for (int j = 1; j < kMaxK; ++j) gap[j] = kBig;
      }
    }

    const float marg = k.marg[p];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < a.K) {
        float* o = k.scratch + ((m * a.K + j) * kPoint) * E + e;
        o[0] = pt[j].x;
        o[E] = pt[j].y;
        o[2 * E] = pt[j].z;
        o[3 * E] = nrm[j].x;
        o[4 * E] = nrm[j].y;
        o[5 * E] = nrm[j].z;
        o[6 * E] = gap[j] - marg;
        o[7 * E] = gap[j] > 1e8f ? -1.0f : vid[j];
      }
    }
  }
}

// ---- phase 3: rows, warm start and imp6, by pair ----

__device__ __forceinline__ void put_j(const Args& a, void* base, int row, int col, int env,
                                      float x) {
  const size_t at = ((size_t)row * 12 + col) * a.B + env;
  if (a.bf16)
    static_cast<__nv_bfloat16*>(base)[at] = __float2bfloat16(x);
  else
    static_cast<float*>(base)[at] = x;
}

// J of one row (batched._member_contact_rows' rows_for), gated: [d, rel_a x d,
// -d, -(rel_b x d)] * gate
__device__ __forceinline__ void put_row(const Args& a, void* base, int row, int env, V3 d, V3 ja,
                                        V3 jb, float gate, float en) {
  const V3 nd = neg(d);
  const float v[12] = {d.x, d.y, d.z, ja.x, ja.y, ja.z, nd.x, nd.y, nd.z, jb.x, jb.y, jb.z};
#pragma unroll
  for (int c = 0; c < 12; ++c) put_j(a, base, row, c, env, (v[c] * gate) * en);
}

// rows r of imp6's 6-vector of one side: [inv_m * d, iinv . j] * lam
__device__ __forceinline__ void imp_side(float* out, float inv_m, V3 d, const float* ii, V3 j,
                                         float lam, bool first) {
  const float x[6] = {inv_m * d.x, inv_m * d.y, inv_m * d.z,
                      (ii[0] * j.x + ii[1] * j.y) + ii[2] * j.z,
                      (ii[3] * j.x + ii[4] * j.y) + ii[5] * j.z,
                      (ii[6] * j.x + ii[7] * j.y) + ii[8] * j.z};
#pragma unroll
  for (int c = 0; c < 6; ++c) out[c] = first ? x[c] * lam : out[c] + x[c] * lam;
}

__device__ void pair_rows(const Args& a, const Blk& k, int tid, int round) {
  const int E = a.envs;
  const int g = tid / E, e = tid % E;
  const int p = round * kGroups + g;
  if (round == 0)
    for (int i = tid; i < a.U * 6 * E; i += k.threads) k.acc[i] = 0.0f;
  float sum[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) sum[c] = 0.0f;
  const int env = k.env0 + e;
  if (p < a.P && env < a.B) {
    const int ua = k.pair[2 * p], ub = k.pair[2 * p + 1];
    const int s = k.slot[p * E + e];
    const V3 pa = k.st3(ua, kPos, e), pb = k.st3(ub, kPos, e);
    const float inv_ma = k.inv_mass[ua], inv_mb = -k.inv_mass[ub];
    float iia[9], iib[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      iia[c] = k.st(ua, kIinv + c, e);
      iib[c] = k.st(ub, kIinv + c, e);
    }
    for (int j = 0; j < a.K; ++j) {
      const int cidx = p * a.K + j;
      V3 pt{0.0f, 0.0f, 0.0f}, n{0.0f, 0.0f, 1.0f};
      float gap = kBig, vidf = -1.0f;
      if (s >= 0) {
        const float* o = k.scratch + ((s * a.K + j) * kPoint) * E + e;
        pt = {o[0], o[E], o[2 * E]};
        n = {o[3 * E], o[4 * E], o[5 * E]};
        gap = o[6 * E];
        vidf = o[7 * E];
      }
      const float act = gap < a.cbreak ? 1.0f : 0.0f;
      const int vid = __float2int_rn(vidf);
      const V3 rel_a = sub(pt, pa), rel_b = sub(pt, pb);

      // the normal row and its scalars (rhs, lo, hi, rhs_push)
      const V3 ja_n = cross(rel_a, n), jb_n = neg(cross(rel_b, n));
      put_row(a, a.nj, cidx, env, n, ja_n, jb_n, act, 1.0f);
      float* ns = a.ns + (size_t)cidx * 4 * a.B + env;
      ns[0] = gap > 0.0f ? -gap * a.inv_dt : 0.0f;
      ns[a.B] = 0.0f;
      ns[2 * a.B] = __int_as_float(0x7f800000);
      ns[3 * a.B] = gap < 0.0f ? (-gap * a.erp2) * a.inv_dt : 0.0f;

      // friction directions: btPlaneSpace1, or (strict) the lateral slip
      V3 t1, t2;
      const bool use_z = fabsf(n.z) > 0.70710678f;
      if (use_z) {
        const float az = n.y * n.y + n.z * n.z;
        const float kz = rsqrtf(clamp_min(az, 1e-18f));
        t1 = {0.0f, -n.z * kz, n.y * kz};
        t2 = {az * kz, -n.x * t1.z, n.x * t1.y};
      } else {
        const float ax = n.x * n.x + n.y * n.y;
        const float kx = rsqrtf(clamp_min(ax, 1e-18f));
        t1 = {-n.y * kx, n.x * kx, 0.0f};
        t2 = {-n.z * t1.y, n.z * t1.x, ax * kx};
      }
      float en2 = 1.0f;
      if (a.strict) {
        const V3 lin_a = k.st3(ua, kLin, e), ang_a = k.st3(ua, kAng, e);
        const V3 lin_b = k.st3(ub, kLin, e), ang_b = k.st3(ub, kAng, e);
        const V3 rv = sub(sub(add(lin_a, cross(ang_a, rel_a)), lin_b), cross(ang_b, rel_b));
        const float dn = dot3_xzy(rv, n);
        const V3 lat{rv.x - n.x * dn, rv.y - n.y * dn, rv.z - n.z * dn};
        const float lat2 = dot3_xzy(lat, lat);
        if (lat2 > 1.19209290e-07f) t1 = mul(lat, rsqrtf(clamp_min(lat2, 1e-30f)));
        en2 = 0.0f;
      }
      const V3 ja_1 = cross(rel_a, t1), jb_1 = neg(cross(rel_b, t1));
      const V3 ja_2 = cross(rel_a, t2), jb_2 = neg(cross(rel_b, t2));
      put_row(a, a.fj, 2 * cidx, env, t1, ja_1, jb_1, act, 1.0f);
      put_row(a, a.fj, 2 * cidx + 1, env, t2, ja_2, jb_2, act, en2);
      float* fs = a.fs + (size_t)2 * cidx * 4 * a.B + env;
#pragma unroll
      for (int c = 0; c < 8; ++c) fs[c * a.B] = 0.0f;
      a.act[(size_t)cidx * a.B + env] = act;
      a.vid[(size_t)cidx * a.B + env] = vid;

      // warm start: the cached impulses of the pair's matching feature ids
      float lam[3] = {0.0f, 0.0f, 0.0f};
      for (int o = 0; o < a.K; ++o) {
        const int oc = p * a.K + o;
        const int ov = a.dvid[(long long)oc * a.dvid_se + (long long)env * a.dvid_sv];
        const float mt = (vid == ov && ov >= 0) ? 1.0f : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float l = a.dlam[(long long)(oc * 3 + c) * a.dlam_se + (long long)env * a.dlam_sv];
          lam[c] = o == 0 ? mt * l : lam[c] + mt * l;
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) lam[c] = act > 0.0f ? lam[c] * a.warm : 0.0f;
      a.lam_n[(size_t)cidx * a.B + env] = lam[0];
      a.lam_t[((size_t)cidx * 2) * a.B + env] = lam[1];
      a.lam_t[((size_t)cidx * 2 + 1) * a.B + env] = lam[2];

      // their velocity change: normal, then t1, then t2 (x en2)
      float ia6[6], ib6[6];
      imp_side(ia6, inv_ma, n, iia, ja_n, lam[0], true);
      imp_side(ib6, inv_mb, n, iib, jb_n, lam[0], true);
      imp_side(ia6, inv_ma, t1, iia, ja_1, lam[1], false);
      imp_side(ib6, inv_mb, t1, iib, jb_1, lam[1], false);
      imp_side(ia6, inv_ma, mul(t2, en2), iia, mul(ja_2, en2), lam[2], false);
      imp_side(ib6, inv_mb, mul(t2, en2), iib, mul(jb_2, en2), lam[2], false);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        sum[c] += ia6[c];
        sum[6 + c] += ib6[c];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 12; ++c) k.stage[(g * 12 + c) * E + e] = sum[c];
}

// imp6 += the round's 16 pairs' sums, in pair order, side A then side B
__device__ void add_stage(const Args& a, const Blk& k, int tid, int round) {
  const int E = a.envs;
  if (tid >= 6 * E) return;
  const int c = tid / E, e = tid % E;
  for (int g = 0; g < kGroups; ++g) {
    const int p = round * kGroups + g;
    if (p >= a.P) break;
    const int ua = k.pair[2 * p], ub = k.pair[2 * p + 1];
    k.acc[(ua * 6 + c) * E + e] += k.stage[(g * 12 + c) * E + e];
    k.acc[(ub * 6 + c) * E + e] += k.stage[(g * 12 + 6 + c) * E + e];
  }
}

__device__ void store_imp6(const Args& a, const Blk& k, int tid) {
  const int E = a.envs;
  for (int i = tid; i < a.NB * 6 * E; i += k.threads) {
    const int e = i % E, r = i / E;
    const int env = k.env0 + e;
    if (env >= a.B) continue;
    const int u = k.u_of[r / 6];
    a.imp6[(size_t)r * a.B + env] = u >= 0 ? k.acc[(u * 6 + r % 6) * E + e] : 0.0f;
  }
}

// ---- the kernel and its C interface ----

__global__ void __launch_bounds__(kGroups * kMaxEnvs, 2) member_contacts_kernel(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const Blk k(a, smem, blockIdx.x);
  const int tid = threadIdx.x;
  load_block(a, k, smem, tid);
  __syncthreads();
  stage_states(a, k, tid);
  __syncthreads();
  if (a.M < a.P) {
    clearances(a, k, tid);
    __syncthreads();
  }
  rank_pairs(a, k, tid);
  __syncthreads();
  narrowphase(a, k, tid);
  __syncthreads();
  for (int r = 0; r * kGroups < a.P; ++r) {
    pair_rows(a, k, tid, r);
    __syncthreads();
    add_stage(a, k, tid, r);
    __syncthreads();
  }
  store_imp6(a, k, tid);
}

bool valid_envs(int envs) { return envs == 1 || envs == 2 || envs == 4 || envs == 8 || envs == 16; }

}  // namespace

// Words of the statics table for these shapes (the wrapper packs as many).
extern "C" int member_meta_words(int nb, int u, int p, int v, int f, int ne) {
  return MetaLayout(nb, u, p, v, f, ne).words;
}

// Shared-memory bytes of a block of `envs` envs (the wrapper's planner sums the same).
extern "C" long long member_smem_bytes(int nb, int u, int p, int m, int v, int f, int ne,
                                       int envs) {
  const MetaLayout ml(nb, u, p, v, f, ne);
  return 4LL * SmemLayout(ml, u, p, m, v, envs).words;
}

// Launch on `stream` with the wrapper's plan: `envs` envs per block, `smem`
// bytes (must equal member_smem_bytes). Returns the CUDA error code of the
// launch (0 on success; cudaErrorInvalidValue for shapes or a plan it does
// not take).
extern "C" int member_contacts_launch(
    const void* pos, int pos_se, int pos_sv, const void* quat, int quat_se, int quat_sv,
    const void* lin, int lin_se, int lin_sv, const void* ang, int ang_se, int ang_sv,
    const void* iinv, int iinv_se, int iinv_sv, const void* dvid, int dvid_se, int dvid_sv,
    const void* dlam, int dlam_se, int dlam_sv, const void* meta, int meta_words, void* nj,
    void* ns, void* fj, void* fs, void* act, void* vid, void* imp6, void* lam_n, void* lam_t,
    void* scratch, int B, int NB, int U, int P, int M, int K, int V, int F, int NE, int nsupp,
    int edge, int strict, int bf16, float inv_dt, float erp2, float warm, float cbreak,
    float dedup2, int envs, int smem, void* stream) {
  if (!valid_envs(envs) || B < 1 || NB < 1 || U < 1 || U > NB || P < 1 || P > kMaxPairs ||
      M < 1 || M > P || K < 1 || K > kMaxK || V < 1 || V > kMaxV || F < 1 || F > kMaxF ||
      NE < 1 || NE > kMaxEdges || nsupp < 1 || nsupp > V ||
      meta_words != member_meta_words(NB, U, P, V, F, NE) ||
      (long long)smem != member_smem_bytes(NB, U, P, M, V, F, NE, envs))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.pos = static_cast<const float*>(pos);
  a.quat = static_cast<const float*>(quat);
  a.lin = static_cast<const float*>(lin);
  a.ang = static_cast<const float*>(ang);
  a.iinv = static_cast<const float*>(iinv);
  a.dvid = static_cast<const int*>(dvid);
  a.dlam = static_cast<const float*>(dlam);
  a.pos_se = pos_se;
  a.pos_sv = pos_sv;
  a.quat_se = quat_se;
  a.quat_sv = quat_sv;
  a.lin_se = lin_se;
  a.lin_sv = lin_sv;
  a.ang_se = ang_se;
  a.ang_sv = ang_sv;
  a.iinv_se = iinv_se;
  a.iinv_sv = iinv_sv;
  a.dvid_se = dvid_se;
  a.dvid_sv = dvid_sv;
  a.dlam_se = dlam_se;
  a.dlam_sv = dlam_sv;
  a.meta = static_cast<const int*>(meta);
  a.nj = nj;
  a.ns = static_cast<float*>(ns);
  a.fj = fj;
  a.fs = static_cast<float*>(fs);
  a.act = static_cast<float*>(act);
  a.vid = static_cast<int*>(vid);
  a.imp6 = static_cast<float*>(imp6);
  a.lam_n = static_cast<float*>(lam_n);
  a.lam_t = static_cast<float*>(lam_t);
  a.scratch = static_cast<float*>(scratch);
  a.B = B;
  a.NB = NB;
  a.U = U;
  a.P = P;
  a.M = M;
  a.K = K;
  a.V = V;
  a.F = F;
  a.NE = NE;
  a.nsupp = nsupp;
  a.edge = edge;
  a.strict = strict;
  a.bf16 = bf16;
  a.envs = envs;
  a.inv_dt = inv_dt;
  a.erp2 = erp2;
  a.warm = warm;
  a.cbreak = cbreak;
  a.dedup2 = dedup2;
  cudaError_t err = cudaFuncSetAttribute(member_contacts_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  member_contacts_kernel<<<(B + envs - 1) / envs, kGroups * envs, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a block of `envs` envs at `smem` bytes, as the
// CUDA runtime reckons them; negative on an error.
extern "C" int member_blocks_per_sm(int envs, int smem) {
  if (!valid_envs(envs)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(member_contacts_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, member_contacts_kernel,
                                                         kGroups * envs, smem);
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" int member_max_smem_per_block() {
  int dev = 0, val = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return val;
}

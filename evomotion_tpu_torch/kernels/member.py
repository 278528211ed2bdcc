"""The member contact phase of the batched physics step: CUDA kernel #4 + plain version.

Kernel #4 replaces no Pallas kernel: the JAX package computes this phase,
``_member_contact_rows`` (evomotion_tpu/physics/batched.py:1031), in plain
jnp. The port's plain version is :func:`..physics.batched._member_contact_rows`
(the top-M cull, the member-member narrowphase, the member contact rows and
their warm start), some 1,400 PyTorch operators per physics step; the
kernel computes the same function in one launch (see
``csrc/member_contacts.cu`` for what it computes, what bounds it and its
design).

:func:`member_contact_rows` takes the plain version's arguments and returns
what it returns, ``(normal (j, s), friction (j, s), extras)`` with
``extras`` = ``act``, ``vid``, ``imp6``, ``lam_n0``, ``lam_t0``, and
dispatches on where its tensors lie:

- CUDA tensors: launches the hand-written kernel (built by ``nvcc`` into a
  shared library with a plain C interface at first use, loaded with ctypes)
  with the launch :func:`plan` of the batch, or raises. There is no
  fallback. The outputs come back env-last and contiguous.
- CPU tensors: runs the plain version, unchanged.

Both take the state tensors in either layout the batched step hands over:
contiguous env-last (``[NB, C, B]``), or the env-last view of a contiguous
env-first tensor (``x.movedim(0, -1)`` of ``[B, NB, C]``).

Launch plan: a block takes ``envs`` envs (16 where the batch fills the card
at 16, else the largest of 8, 4, 2, 1 that does, else 1) with 16 groups of
``envs`` threads, and the shared memory :func:`smem_bytes` sums; the
spider at B=4096 gets 256 blocks of 16 envs and 256 threads.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..physics import engine as E
from .build import NvccLibrary

# the kernel's caps (csrc/member_contacts.cu)
MAX_K = 4  # manifold points per pair
MAX_V = 48  # test points per hull: shapes.reduce_to_hull's default limit
MAX_F = 255  # face planes per hull
MAX_EDGES = 8  # edge directions per hull
MAX_PAIRS = 32767  # member pairs
GROUPS = 16  # thread groups per block
ENVS = (16, 8, 4, 2, 1)  # envs per block a plan can take
POINT = 8  # scratch floats per manifold point
STATE = 22  # staged floats per member body and env
N_SUPPORT = 12  # test points the edge SAT projects (batched._dyn_narrowphase_sel)


def _odd(n: int) -> int:
    return n | 1


def meta_layout(nb: int, u: int, p: int, v: int, f: int, ne: int) -> dict:
    """Word offsets of the statics table (the kernel's ``MetaLayout``):
    pairs [P][2] (member-body slots), brad [P], marg [P], u_of [NB], body
    [U], inv_mass [U], then per member body, each row padded to an odd
    length: test points [V][3], mask [V], faces [F][4], edge dirs [NE][3],
    edge mask [NE]."""
    lay = {"hs": _odd(3 * v), "ms": _odd(v), "fs": _odd(4 * f), "es": _odd(3 * ne),
           "ems": _odd(ne), "pair": 0}
    lay["brad"] = 2 * p
    lay["marg"] = lay["brad"] + p
    lay["u_of"] = lay["marg"] + p
    lay["body"] = lay["u_of"] + nb
    lay["inv_mass"] = lay["body"] + u
    lay["hull"] = lay["inv_mass"] + u
    lay["hmask"] = lay["hull"] + u * lay["hs"]
    lay["face"] = lay["hmask"] + u * lay["ms"]
    lay["edir"] = lay["face"] + u * lay["fs"]
    lay["emask"] = lay["edir"] + u * lay["es"]
    lay["words"] = lay["emask"] + u * lay["ems"]
    return lay


def smem_bytes(nb: int, u: int, p: int, m: int, v: int, f: int, ne: int, envs: int) -> int:
    """Shared-memory bytes of a block of ``envs`` envs (the kernel's
    ``SmemLayout``): the statics, the staged states [U][22][envs + 1], the
    slot of each pair and the pair of each slot (int16), and the larger of
    the clearances [P][envs], the running plane distances and faces
    [V][threads], and the rows' stage and imp6."""
    threads = GROUPS * envs
    words = meta_layout(nb, u, p, v, f, ne)["words"]
    words += u * STATE * (envs + 1) + (p * envs + 1) // 2 + (m * envs + 1) // 2
    words += max(p * envs, v * threads + (v * threads + 3) // 4,
                 GROUPS * 12 * envs + u * 6 * envs)
    return 4 * words


class Plan(NamedTuple):
    envs: int  # envs per block
    threads: int
    smem_bytes: int

    def blocks(self, b: int) -> int:
        return -(-b // self.envs)

    def describe(self, b: int) -> dict:
        return {"blocks": self.blocks(b), "envs_per_block": self.envs,
                "threads": self.threads, "smem_bytes": self.smem_bytes}


def plan(b: int, n_sms: int, smem_for, optin: int) -> Plan:
    """The launch plan of a batch of ``b`` envs on a card of ``n_sms`` SMs
    and ``optin`` bytes of shared memory per block; ``smem_for(envs)`` gives
    a block's bytes. Raises ValueError when no block fits."""
    fits = [e for e in ENVS if smem_for(e) <= optin]
    if not fits:
        raise ValueError(f"member contact kernel: a block of one env needs {smem_for(1)} B of "
                         f"shared memory, the card allows {optin}")
    envs = next((e for e in fits if -(-b // e) >= n_sms), fits[-1])
    return Plan(envs, GROUPS * envs, smem_for(envs))


class MemberMeta(NamedTuple):
    """The statics table in the kernel's layout and its shapes."""

    words: torch.Tensor  # int32 [words]: f32 values stored by their bits
    nb: int
    u: int  # member bodies (bodies in some pair)
    p: int
    v: int
    f: int
    ne: int


def make_member_meta(pair_body, inv_mass, hull, hmask, face, edirs, emask, brad, marg,
                     device) -> MemberMeta:
    """The statics table of a model's member pairs, from numpy arrays:
    pair_body [P, 2], inv_mass [NB], hull [NB, V, 3], hmask [NB, V], face
    [NB, F, 4], edirs [NB, NE, 3], emask [NB, NE], brad [P], marg [P]."""
    pair_body = np.asarray(pair_body, np.int64)
    nb, v = np.asarray(hull).shape[:2]
    f = np.asarray(face).shape[1]
    ne = np.asarray(edirs).shape[1]
    p = len(pair_body)
    body = np.unique(pair_body)
    u = len(body)
    u_of = np.full(nb, -1, np.int64)
    u_of[body] = np.arange(u)
    lay = meta_layout(nb, u, p, v, f, ne)
    w = np.zeros(lay["words"], np.int32)
    wf = w.view(np.float32)
    w[:2 * p] = u_of[pair_body].reshape(-1)
    wf[lay["brad"]:lay["brad"] + p] = brad
    wf[lay["marg"]:lay["marg"] + p] = marg
    w[lay["u_of"]:lay["u_of"] + nb] = u_of
    w[lay["body"]:lay["body"] + u] = body
    wf[lay["inv_mass"]:lay["inv_mass"] + u] = np.asarray(inv_mass)[body]
    for name, arr, width in (("hull", hull, 3 * v), ("hmask", hmask, v), ("face", face, 4 * f),
                             ("edir", edirs, 3 * ne), ("emask", emask, ne)):
        stride = lay[{"hull": "hs", "hmask": "ms", "face": "fs", "edir": "es",
                      "emask": "ems"}[name]]
        rows = wf[lay[name]:lay[name] + u * stride].reshape(u, stride)
        rows[:, :width] = np.asarray(arr, np.float32)[body].reshape(u, width)
    return MemberMeta(torch.as_tensor(w, device=device), nb, u, p, v, f, ne)


class Shapes(NamedTuple):
    """What one call runs: the model's member shapes and flags."""

    p: int
    m: int  # pairs narrowphased per env: member_topm, or every pair
    k: int
    v: int
    f: int
    ne: int
    nsupp: int
    edge: bool
    strict: bool


def shapes(model, st) -> Shapes:
    p = len(model.dyn_pair_body)
    topm = int(getattr(model, "member_topm", 0) or 0)
    v = st.np_hull.shape[1]
    return Shapes(p, topm if 0 < topm < p else p, int(model.member_manifold_k), v,
                  st.np_face.shape[1], st.edirs.shape[1], min(N_SUPPORT, v),
                  bool(model.member_edge_contacts), bool(model.strict_bullet))


def check_caps(sh: Shapes):
    """Raises ValueError for shapes above the kernel's caps."""
    for name, val, lo, hi in (("member_manifold_k", sh.k, 1, MAX_K),
                              ("proxy-hull test points", sh.v, 1, MAX_V),
                              ("proxy-hull faces", sh.f, 1, MAX_F),
                              ("hull edge directions", sh.ne, 1, MAX_EDGES),
                              ("member pairs", sh.p, 1, MAX_PAIRS)):
        if not lo <= val <= hi:
            raise ValueError(f"member contact kernel: {name} = {val}, it takes {lo} to {hi}")


def env_strides(name: str, t: torch.Tensor):
    """(element stride, env stride) of ``t [N, C..., B]`` in either layout
    the kernel reads; raises ValueError for any other."""
    if t.is_contiguous():
        return t.shape[-1], 1
    if t.movedim(-1, 0).is_contiguous():
        return 1, t[..., 0].numel()
    raise ValueError(f"{name} must be contiguous env-last, or the env-last view of a "
                     f"contiguous env-first tensor (strides {t.stride()})")


def check(model, st, pos, quat, lin_vel, ang_vel, iinv_world, warm_cache, j_dtype) -> Shapes:
    """Device, dtypes, shapes, layouts and caps of one call; returns its shapes."""
    sh = shapes(model, st)
    check_caps(sh)
    if j_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"j_dtype {j_dtype}: float32 or bfloat16")
    nb, b = model.n_bodies, pos.shape[-1]
    ndc = sh.p * sh.k
    want = {"pos": (pos, (nb, 3, b), torch.float32), "quat": (quat, (nb, 4, b), torch.float32),
            "lin_vel": (lin_vel, (nb, 3, b), torch.float32),
            "ang_vel": (ang_vel, (nb, 3, b), torch.float32),
            "iinv_world": (iinv_world, (nb, 3, 3, b), torch.float32)}
    if warm_cache is not None:
        want["dyn_vid"] = (warm_cache[0], (ndc, b), torch.int32)
        want["dyn_lambda"] = (warm_cache[1], (ndc, 3, b), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.device != pos.device:
            raise ValueError(f"{name} on {t.device}, pos on {pos.device}")
        env_strides(name, t)
    return sh


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


class MemberKernel(NvccLibrary):
    """The nvcc-built member contact library and its launch count.

    ``launches`` is a plain integer that :meth:`launch` raises by one per
    kernel launch and nothing else touches, so a run can show that its main
    path went through the kernel: one per batched physics step. ``last``
    holds the plan and batch of the latest launch."""

    def __init__(self):
        # no FMA contraction: each f32 operation rounds as PyTorch's one-operator kernels do
        super().__init__("member_contacts.cu", flags=("--fmad=false",))
        self.launches = 0
        self.last = None
        self._lib = None
        self._card = {}

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.member_contacts_launch.argtypes = (
                [p, i, i] * 7 + [p, i] + [p] * 10 + [i] * 13 + [f] * 5 + [i, i, p])
            lib.member_contacts_launch.restype = i
            lib.member_meta_words.argtypes = [i] * 6
            lib.member_meta_words.restype = i
            lib.member_smem_bytes.argtypes = [i] * 8
            lib.member_smem_bytes.restype = ctypes.c_longlong
            lib.member_blocks_per_sm.argtypes = [i, i]
            lib.member_blocks_per_sm.restype = i
            lib.member_max_smem_per_block.argtypes = []
            lib.member_max_smem_per_block.restype = i
            self._lib = lib
        return self._lib

    def card(self, device):
        """(SMs, shared-memory opt-in bytes per block) of the card."""
        key = torch.device(device).index
        key = torch.cuda.current_device() if key is None else key
        if key not in self._card:
            with torch.cuda.device(key):
                optin = self.lib().member_max_smem_per_block()
            self._card[key] = (torch.cuda.get_device_properties(key).multi_processor_count, optin)
        return self._card[key]

    def plan_for(self, meta: MemberMeta, sh: Shapes, b: int, device) -> Plan:
        n_sms, optin = self.card(device)
        return plan(b, n_sms, lambda e: smem_bytes(meta.nb, meta.u, sh.p, sh.m, sh.v, sh.f,
                                                   sh.ne, e), optin)

    def blocks_per_sm(self, pl: Plan) -> int:
        """Resident blocks per SM of the plan on the current card, as the
        CUDA runtime reckons them."""
        n = self.lib().member_blocks_per_sm(pl.envs, pl.smem_bytes)
        if n < 0:
            raise RuntimeError(f"member kernel occupancy query failed: cudaError {-n} ({pl})")
        return n

    def launch(self, model, st, sh: Shapes, dt, pos, quat, lin_vel, ang_vel, iinv_world,
               dyn_vid, dyn_lambda, j_dtype):
        meta = st.member_meta
        b, dev = pos.shape[-1], pos.device
        ndc = sh.p * sh.k
        pl = self.plan_for(meta, sh, b, dev)
        nj = torch.empty((ndc, 12, b), dtype=j_dtype, device=dev)
        ns = torch.empty((ndc, 4, b), device=dev)
        fj = torch.empty((2 * ndc, 12, b), dtype=j_dtype, device=dev)
        fs = torch.empty((2 * ndc, 4, b), device=dev)
        act = torch.empty((ndc, b), device=dev)
        vid = torch.empty((ndc, b), dtype=torch.int32, device=dev)
        imp6 = torch.empty((model.n_bodies, 6, b), device=dev)
        lam_n0 = torch.empty((ndc, b), device=dev)
        lam_t0 = torch.empty((ndc, 2, b), device=dev)
        scratch = torch.empty((pl.blocks(b) * sh.m * sh.k * POINT * pl.envs,), device=dev)
        ins = []
        for name, t in (("pos", pos), ("quat", quat), ("lin_vel", lin_vel),
                        ("ang_vel", ang_vel), ("iinv_world", iinv_world), ("dyn_vid", dyn_vid),
                        ("dyn_lambda", dyn_lambda)):
            ins += [t.data_ptr(), *env_strides(name, t)]
        f32 = np.float32
        err = self.lib().member_contacts_launch(
            *ins, meta.words.data_ptr(), meta.words.numel(),
            nj.data_ptr(), ns.data_ptr(), fj.data_ptr(), fs.data_ptr(), act.data_ptr(),
            vid.data_ptr(), imp6.data_ptr(), lam_n0.data_ptr(), lam_t0.data_ptr(),
            scratch.data_ptr(),
            b, meta.nb, meta.u, sh.p, sh.m, sh.k, sh.v, sh.f, sh.ne, sh.nsupp, int(sh.edge),
            int(sh.strict), int(j_dtype == torch.bfloat16),
            float(f32(1.0 / dt)), float(f32(E.ERP2)), float(f32(E.WARMSTART)),
            float(f32(E.CONTACT_BREAKING)), float(f32(E.DEDUP_TOL ** 2)),
            pl.envs, pl.smem_bytes, torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"member contact kernel launch failed: cudaError {err} ({pl}, "
                               f"{sh})")
        self.launches += 1
        self.last = (pl, b)
        extras = {"act": act, "vid": vid, "imp6": imp6, "lam_n0": lam_n0, "lam_t0": lam_t0}
        return (nj, ns), (fj, fs), extras


KERNEL = MemberKernel()


def member_contact_rows(model, st, pos, quat, lin_vel, ang_vel, iinv_world, dt,
                        warm_cache=None, j_dtype=torch.float32):
    """Member-member contact rows (pairs x member_manifold_k points,
    pair-major) and their warm start: ``(normal (j, s), friction (j, s),
    extras)`` as :func:`..physics.batched._member_contact_rows` returns
    them. On CUDA tensors this launches kernel #4 or raises (it needs the
    warm cache ``(dyn_vid, dyn_lambda)``); on CPU tensors it runs the plain
    version."""
    sh = check(model, st, pos, quat, lin_vel, ang_vel, iinv_world, warm_cache, j_dtype)
    if pos.device.type == "cuda":
        if warm_cache is None:
            raise ValueError("member contact kernel: needs the warm cache (dyn_vid, dyn_lambda)")
        return KERNEL.launch(model, st, sh, dt, pos, quat, lin_vel, ang_vel, iinv_world,
                             *warm_cache, j_dtype)
    if pos.device.type == "cpu":
        from ..physics import batched

        return batched._member_contact_rows(model, st, pos, quat, lin_vel, ang_vel, iinv_world,
                                            dt, warm_cache=warm_cache, j_dtype=j_dtype)
    raise ValueError(f"member contact rows: unsupported device {pos.device}")

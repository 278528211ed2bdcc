"""Kernel #4's wrapper (``kernels/member.py``) on the CPU.

On CPU tensors ``member_contact_rows`` runs the plain version,
``physics.batched._member_contact_rows``, unchanged: its outputs are held
equal, bit for bit, to a direct call of the plain version on the spider's
member-call inputs (B=3), with the top-M cull and dense. The checks the
wrapper makes before it dispatches (caps, dtypes, layouts) raise here as on
the card; the launch counter stays 0 on the CPU; the statics table, the
shared-memory sums and the launch plan are checked against the shapes
they pack. The kernel itself is held against the plain version on the card
by tests/test_torch_gpu.py and chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from evomotion_tpu_torch.envs.robot import RobotWalk, RobotWalkParams
from evomotion_tpu_torch.kernels import member as km
from evomotion_tpu_torch.physics import batched as bt

B = 3


def capture_member_call(env, state, action, gen):
    """The arguments of the member-phase call of one env step."""
    calls = []
    orig = km.member_contact_rows

    def spy(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bt.km, "member_contact_rows", spy)
        env.step(state, action, gen)
    assert len(calls) == 1
    return calls[0]


@pytest.fixture(scope="module")
def spider():
    """The spider env (reset_frames 1) at B=3 and the member call of the
    third step after its reset (random actions): (env, args, kwargs)."""
    gen = torch.Generator().manual_seed(0)
    env = RobotWalk(RobotWalkParams(reset_frames=1), device="cpu")
    state, _ = env.reset(B, gen)
    for _ in range(2):
        action = torch.rand((B, env.action_size), generator=gen) * 2 - 1
        state = env.step(state, action, gen)[0]
    action = torch.rand((B, env.action_size), generator=gen) * 2 - 1
    args, kw = capture_member_call(env, state, action, gen)
    return env, args, kw


def _equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) or torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("topm", [48, 0])
def test_wrapper_on_cpu_is_the_plain_version(spider, topm):
    """Bit for bit: the wrapper's CPU path is the plain version (the
    spider's top-48 cull, and dense)."""
    env, args, kw = spider
    args = (dataclasses.replace(args[0], member_topm=topm), *args[1:])
    assert args[0].member_topm == topm and kw["warm_cache"] is not None
    assert kw["j_dtype"] == torch.bfloat16
    before = km.KERNEL.launches
    got = km.member_contact_rows(*args, **kw)
    ref = bt._member_contact_rows(*args, **kw)
    _equal(got, ref)
    assert float(got[2]["act"].sum()) > 0 and float(got[2]["lam_n0"].abs().sum()) > 0
    assert km.KERNEL.launches == before == 0


def test_step_goes_through_the_wrapper_and_launches_nothing_on_cpu(spider):
    """Every batched spider step calls the wrapper once (the fixture's
    capture checks it); on the CPU the launch counter stays 0."""
    env, args, kw = spider
    assert args[2].device.type == "cpu" and args[0] is env.model
    assert km.KERNEL.launches == 0


@pytest.mark.parametrize("field, value", [
    ("k", km.MAX_K + 1), ("v", km.MAX_V + 1), ("f", km.MAX_F + 1),
    ("ne", km.MAX_EDGES + 1), ("p", km.MAX_PAIRS + 1), ("k", 0), ("ne", 0),
])
def test_caps_raise(field, value):
    ok = km.Shapes(p=120, m=48, k=4, v=48, f=20, ne=4, nsupp=12, edge=True, strict=False)
    km.check_caps(ok)
    with pytest.raises(ValueError, match="member contact kernel"):
        km.check_caps(ok._replace(**{field: value}))


def test_model_above_the_caps_raises(spider):
    """A model with more manifold points per pair than the kernel takes is
    refused before anything runs."""
    env, args, kw = spider
    model = dataclasses.replace(args[0], member_manifold_k=km.MAX_K + 1)
    with pytest.raises(ValueError, match="member_manifold_k"):
        km.member_contact_rows(model, *args[1:], **kw)


@pytest.mark.parametrize("which", ["pos", "iinv_world", "dyn_vid", "dyn_lambda", "j_dtype"])
def test_wrong_dtype_raises(spider, which):
    env, args, kw = spider
    args, kw = list(args), dict(kw)
    if which == "pos":
        args[2] = args[2].double()
    elif which == "iinv_world":
        args[6] = args[6].half()
    elif which == "dyn_vid":
        kw["warm_cache"] = (kw["warm_cache"][0].long(), kw["warm_cache"][1])
    elif which == "dyn_lambda":
        kw["warm_cache"] = (kw["warm_cache"][0], kw["warm_cache"][1].double())
    else:
        kw["j_dtype"] = torch.float16
    with pytest.raises(TypeError):
        km.member_contact_rows(*args, **kw)


@pytest.mark.parametrize("which", ["pos", "quat", "iinv_world", "dyn_lambda"])
def test_non_contiguous_raises(spider, which):
    """Only the two layouts the kernel reads pass: contiguous env-last and
    the env-last view of a contiguous env-first tensor."""
    env, args, kw = spider
    args, kw = list(args), dict(kw)

    def strided(t):  # every other element of a twice-as-wide buffer
        wide = torch.zeros(t.shape[:-1] + (2 * t.shape[-1],), dtype=t.dtype)
        wide[..., ::2] = t
        return wide[..., ::2]

    if which == "dyn_lambda":
        kw["warm_cache"] = (kw["warm_cache"][0], strided(kw["warm_cache"][1]))
    else:
        i = {"pos": 2, "quat": 3, "iinv_world": 6}[which]
        args[i] = strided(args[i])
    with pytest.raises(ValueError, match="contiguous"):
        km.member_contact_rows(*args, **kw)


def test_both_layouts_pass(spider):
    """Env-last contiguous and env-first views give the same (plain) rows."""
    env, args, kw = spider
    assert not args[2].is_contiguous() and args[6].is_contiguous()  # the step's own
    flipped = list(args)
    flipped[2] = args[2].contiguous()
    flipped[6] = args[6].movedim(-1, 0).contiguous().movedim(0, -1)
    _equal(km.member_contact_rows(*flipped, **kw), km.member_contact_rows(*args, **kw))


def test_statics_table_packs_the_model(spider):
    env = spider[0]
    st = bt.Statics(env.model, "cpu")
    meta = st.member_meta
    m = env.model
    lay = km.meta_layout(meta.nb, meta.u, meta.p, meta.v, meta.f, meta.ne)
    w = meta.words.numpy()
    wf = w.view(np.float32)
    assert len(w) == lay["words"] and meta.p == len(m.dyn_pair_body)
    body = np.unique(m.dyn_pair_body)
    assert meta.u == len(body) and list(w[lay["body"]:lay["body"] + meta.u]) == list(body)
    u_of = w[lay["u_of"]:lay["u_of"] + meta.nb]
    assert list(body[w[:2 * meta.p:2]]) == list(m.dyn_pair_body[:, 0])
    assert list(body[w[1:2 * meta.p:2]]) == list(m.dyn_pair_body[:, 1])
    assert (u_of[body] == np.arange(meta.u)).all() and (np.delete(u_of, body) == -1).all()
    for u, b in enumerate(body):
        hull = wf[lay["hull"] + u * lay["hs"]:][:3 * meta.v].reshape(meta.v, 3)
        np.testing.assert_array_equal(hull, m.np_hull[b])
        face = wf[lay["face"] + u * lay["fs"]:][:4 * meta.f].reshape(meta.f, 4)
        np.testing.assert_array_equal(face, m.np_face[b])
        assert lay["hs"] % 2 == lay["fs"] % 2 == 1
    np.testing.assert_array_equal(wf[lay["marg"]:lay["marg"] + meta.p], st.dp_marg.numpy())


def test_plan_fills_the_card(spider):
    """256 blocks of 16 envs for the spider at B=4096 on 132 SMs within
    the H100's 227 KB per block; smaller batches take fewer envs a block;
    a card that fits no block raises."""
    env = spider[0]
    st = bt.Statics(env.model, "cpu")
    meta = st.member_meta
    sh = km.shapes(env.model, st)
    assert (sh.p, sh.m, sh.k, sh.v, sh.f, sh.ne, sh.nsupp) == (120, 48, 4, 24, 20, 4, 12)

    def smem(e):
        return km.smem_bytes(meta.nb, meta.u, sh.p, sh.m, sh.v, sh.f, sh.ne, e)

    assert smem(16) <= 232_448 // 2  # two blocks a SM
    pl = km.plan(4096, 132, smem, 232_448)
    assert (pl.envs, pl.threads, pl.blocks(4096)) == (16, 256, 256)
    assert km.plan(8192, 132, smem, 232_448).blocks(8192) == 512
    assert km.plan(1024, 132, smem, 232_448).envs == 4
    assert km.plan(4, 132, smem, 232_448).envs == 1
    assert km.plan(4096, 132, smem, smem(8)).envs == 8
    with pytest.raises(ValueError, match="shared memory"):
        km.plan(4096, 132, smem, smem(1) - 4)

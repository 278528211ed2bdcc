"""The port's liquid (LTC) networks against the JAX package's
``networks/liquid.py``.

JAX params are built by the JAX package's init functions and carried into
the port's modules (``convert.load_params``); the same numpy-made hidden
states and inputs go through both at the JAX tests' small widths (16
neurons, 3 unfoldings; ``tests/test_liquid_trainer.py``). The forwards
agree at 1e-6, the gradients of a scalar loss of every output at 1e-5
(f32 summation order). Then the param trees and optax Adam states (plain
``adam`` and the ``chain(clip_by_global_norm, adam)`` of the liquid PPOs)
go both ways through ``convert`` exactly, and the port's init has JAX's
shapes and statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from evomotion_tpu.networks import liquid as JL
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.networks import liquid as L
from evomotion_tpu_torch.train.checkpoint import _flatten

FWD_TOL, GRAD_TOL = 1e-6, 1e-5
S, A, NEURONS, STEPS, B = 7, 3, 16, 3, 9


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _nets(key):
    """(name, JAX params, port module, JAX apply(params, x, s, a), port
    apply(module, x, s, a)) of each liquid network, the port holding JAX's
    weights."""
    kc, ka, kr, kq = jax.random.split(key, 4)
    cell = JL.liquid_cell_init(kc, S, NEURONS, STEPS)
    actor = JL.liquid_actor_init(ka, S, A, NEURONS, STEPS)
    critic = JL.liquid_critic_init(kr, S, NEURONS, STEPS)
    q = JL.liquid_q_net_init(kq, S, A, NEURONS, STEPS)
    return [
        ("cell", cell, L.LiquidCell(S, NEURONS, STEPS),
         lambda p, x, s, a: (JL.liquid_cell_apply(p, x, s, STEPS),),
         lambda m, x, s, a: (m(x, s),)),
        ("actor", actor, L.LiquidActor(S, A, NEURONS, STEPS),
         lambda p, x, s, a: JL.liquid_actor_apply(p, x, s, STEPS),
         lambda m, x, s, a: m(x, s)),
        ("critic", critic, L.LiquidCritic(S, NEURONS, STEPS),
         lambda p, x, s, a: JL.liquid_critic_apply(p, x, s, STEPS),
         lambda m, x, s, a: m(x, s)),
        ("q", q, L.LiquidQNet(S, A, NEURONS, STEPS),
         lambda p, x, s, a: JL.liquid_q_net_apply(p, x, s, a, STEPS),
         lambda m, x, s, a: m(x, s, a)),
    ]


def _inputs(seed, lead=(B,)):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal(lead + (NEURONS,))).astype(np.float32)
    s = (2.0 * rng.standard_normal(lead + (S,))).astype(np.float32)
    a = rng.uniform(-1, 1, lead + (A,)).astype(np.float32)
    return x, s, a


def _trained(jp, seed):
    """JAX's params moved off their init (a, tau and b no longer 1, 1 and
    N(0, 0.1) exactly): every leaf plus small noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: np.asarray(v) + (0.05 * rng.standard_normal(v.shape)).astype(np.float32), jp)


@pytest.mark.parametrize("lead", [(B,), (4, 5)], ids=["batch", "time_batch"])
def test_forwards_match_jax(lead):
    """Each net on [B, ...] inputs and on the trainers' [T, N, ...] ones;
    the new hidden state too."""
    x, s, a = _inputs(1, lead)
    for name, jp, module, japply, papply in _nets(jax.random.PRNGKey(0)):
        jp = _trained(jp, 2)
        convert.load_params(module, jp)
        got = papply(module, *map(torch.as_tensor, (x, s, a)))
        ref = japply(jp, x, s, a)
        assert len(got) == len(ref), name
        for g, r in zip(got, ref):
            assert tuple(g.shape) == r.shape, name
            _close(g, r, FWD_TOL)


def test_gradients_match_jax():
    """d/d(params, x) of sum(outputs * fixed weights), the loss any trainer
    builds on these outputs, through every unfolding."""
    x, s, a = _inputs(3)
    rng = np.random.default_rng(4)
    for name, jp, module, japply, papply in _nets(jax.random.PRNGKey(5)):
        jp = _trained(jp, 6)
        convert.load_params(module, jp)
        ref_out = japply(jp, x, s, a)
        ws = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in ref_out]

        def jloss(p, xx):
            return sum((o * w).sum() for o, w in zip(japply(p, xx, s, a), ws))

        jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        loss = sum((o * torch.as_tensor(w)).sum()
                   for o, w in zip(papply(module, xt, *map(torch.as_tensor, (s, a))), ws))
        params = dict(module.named_parameters())
        grads = torch.autograd.grad(loss, [*params.values(), xt])
        for (pname, _), g in zip(params.items(), grads):
            ref = jg
            for k in pname.split("."):
                ref = ref[k]
            _close(g, ref, GRAD_TOL)
        _close(grads[-1], jgx, GRAD_TOL)


def test_first_x_is_zeros():
    x = L.first_x(NEURONS, 5, "cpu")
    assert tuple(x.shape) == (5, NEURONS) and not x.any()
    np.testing.assert_array_equal(x.numpy(), np.asarray(JL.liquid_cell_first_x(NEURONS, (5,))))


def test_init_has_jax_shapes_and_statistics():
    """The port draws its own init (JAX's stream cannot be replayed): the
    same tree, shapes and dtypes, a = tau = 1, W and R with std 0.1/steps."""
    gen = torch.Generator().manual_seed(0)
    for name, jp, module, _, _ in _nets(jax.random.PRNGKey(7)):
        got = convert.params_tree(type(module)(*_ctor_args(name), generator=gen))
        jax.tree.map(lambda g, r: (g.shape, g.dtype) == (r.shape, r.dtype) or pytest.fail(name),
                     got, _np(jp))
    big = L.LiquidCell(200, 300, 6, generator=torch.Generator().manual_seed(1))
    big.requires_grad_(False)
    for p in (big.w, big.r):
        assert abs(float(p.std()) - 0.1 / 6) < 1e-3
    assert abs(float(big.b.std()) - 0.1) < 2e-2
    assert bool((big.a == 1).all() and (big.tau == 1).all())


def _ctor_args(name):
    return {"cell": (S, NEURONS, STEPS), "actor": (S, A, NEURONS, STEPS),
            "critic": (S, NEURONS, STEPS), "q": (S, A, NEURONS, STEPS)}[name]


@pytest.mark.parametrize("clip", [False, True], ids=["adam", "clip_adam"])
def test_params_and_adam_states_carry_both_ways(clip):
    """A liquid actor's params and an optax Adam state after two steps
    (plain ``adam``: liquid SAC and A2C; ``chain(clip_by_global_norm,
    adam)``: the liquid PPOs) go into the port's module and
    ``torch.optim.Adam`` and come back as the same trees, exactly."""
    jp = JL.liquid_actor_init(jax.random.PRNGKey(8), S, A, NEURONS, STEPS)
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3)) if clip else (
        optax.adam(1e-3))
    st = opt.init(jp)
    x, s, _ = _inputs(9)
    for _ in range(2):
        g = jax.grad(lambda p: JL.liquid_actor_apply(p, x, s, STEPS)[0].sum())(jp)
        up, st = opt.update(g, st, jp)
        jp = optax.apply_updates(jp, up)
    module = convert.load_params(L.LiquidActor(S, A, NEURONS, STEPS), _np(jp))
    topt = torch.optim.Adam(module.parameters(), lr=1e-3)
    convert.load_adam(topt, module, _np(st))
    jax.tree.map(np.testing.assert_array_equal, convert.params_tree(module), _np(jp))
    back, ref = _flatten(convert.adam_tree(topt, module, clip=clip)), _flatten(_np(st))
    assert back.keys() == ref.keys() and ("1/0/count" if clip else "0/count") in ref
    for k in ref:
        assert back[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)

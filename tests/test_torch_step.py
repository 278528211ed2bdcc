"""Batched physics step: the PyTorch port against the JAX package on the CPU.

The same model (built once with the JAX package's ModelBuilder and carried
across by ``evomotion_tpu_torch.convert``) and the same numpy-made states go
through JAX's vmapped ``physics_step`` (solver="pallas": the env-last path,
its sweep kernel in interpret mode) and the port's ``BatchedStep`` on the
CPU (the sweep's plain version). Tolerances are those of the JAX package's
own vmapped-vs-per-env check (tests/test_batched_step.py ``_compare``), in
every row visit order (``canonical``, ``scheduled`` with the sweep's
groups, ``shuffled:7``): each order of the port is held against the same
order of JAX.

The fixture builders are copies of tests/test_batched_step.py's; the other
``test_torch_step_*`` files import them from here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.physics.engine import init_state, physics_step
from evomotion_tpu.physics.model import ModelBuilder
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.physics.batched import BatchedStep

DT = 1.0 / 60.0


def _cube():
    h = 0.5
    return np.array(
        [[sx * h, sy * h, sz * h] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )


def _cartpole_like_model():
    """Slider + hinge chain, no contacts (all pairs ignored)."""
    b = ModelBuilder()
    ident = (0.0, 0.0, 0.0, 1.0)
    base = b.add_body("base", _cube(), (10, 2, 10), 0.0, (0, -4, 10), ident)
    cart = b.add_body("cart", _cube(), (0.5, 0.25, 0.5), 1.0, (0, -1.75, 10), ident)
    pole = b.add_body("pole", _cube(), (0.1, 0.7, 0.1), 1.0, (0, -0.975, 10), ident)
    b.set_ignore_collision(base, cart)
    b.set_ignore_collision(cart, pole)
    b.set_ignore_collision(base, pole)
    b.add_slider(
        base, cart, (0, 2, 0), ident, (0, -0.25, 0), ident,
        lin_lo=-10.0, lin_hi=10.0, max_motor_force=64.0, motor_index=0,
    )
    b.add_hinge(cart, pole, (0, 0.25, 0), (0, -0.525, 0), (0, 0, 1), (0, 0, 1))
    return dataclasses.replace(b.finalize(), solver="pallas", row_dtype="f32")


def _contact_model():
    """Two boxes over a static floor: floor contacts + a dyn-dyn pair."""
    b = ModelBuilder()
    ident = (0.0, 0.0, 0.0, 1.0)
    b.add_body("floor", _cube(), (20, 1, 20), 0.0, (0, -1, 0), ident, friction=0.5)
    b.add_body("boxa", _cube(), (0.4, 0.2, 0.6), 1.0, (0, 0.0, 0), ident, friction=0.6)
    b.add_body(
        "boxb", _cube(), (0.5, 0.2, 0.3), 2.0, (0.2, 0.55, 0.1),
        (0.0, 0.19866933, 0.0, 0.98006658), friction=0.4,
    )
    return dataclasses.replace(
        b.finalize(), solver="pallas", member_contacts=True, row_dtype="f32"
    )


def _dyn_only_model():
    """Two overlapping DYNAMIC boxes, no static body at all: zero floor
    manifold pairs but one dyn-dyn pair."""
    b = ModelBuilder()
    ident = (0.0, 0.0, 0.0, 1.0)
    b.add_body("boxa", _cube(), (0.4, 0.3, 0.4), 1.0, (0, 0.0, 0), ident, friction=0.6)
    b.add_body(
        "boxb", _cube(), (0.3, 0.3, 0.3), 2.0, (0.1, 0.25, 0.05),
        (0.0, 0.19866933, 0.0, 0.98006658), friction=0.4,
    )
    return dataclasses.replace(
        b.finalize(), solver="pallas", member_contacts=True, row_dtype="f32"
    )


def _cluster_model(**over):
    """Six dynamic boxes over a floor: a tight 3-box cluster (touching) plus
    three isolated far boxes => 15 dyn pairs of which only the cluster's 3
    can ever be active."""
    b = ModelBuilder()
    ident = (0.0, 0.0, 0.0, 1.0)
    b.add_body("floor", _cube(), (30, 1, 30), 0.0, (0, -1, 0), ident, friction=0.5)
    tilt = (0.0, 0.19866933, 0.0, 0.98006658)
    b.add_body("c0", _cube(), (0.4, 0.3, 0.4), 1.0, (0, 0.0, 0), ident, friction=0.6)
    b.add_body("c1", _cube(), (0.3, 0.3, 0.3), 2.0, (0.1, 0.25, 0.05), tilt, friction=0.4)
    b.add_body("c2", _cube(), (0.35, 0.2, 0.3), 1.5, (-0.15, 0.45, -0.1), ident, friction=0.5)
    b.add_body("f0", _cube(), (0.3, 0.3, 0.3), 1.0, (5, 0.0, 5), ident)
    b.add_body("f1", _cube(), (0.3, 0.3, 0.3), 1.0, (-5, 0.0, 5), tilt)
    b.add_body("f2", _cube(), (0.3, 0.3, 0.3), 1.0, (5, 0.0, -5), ident)
    return dataclasses.replace(
        b.finalize(), solver="pallas", member_contacts=True, row_dtype="f32",
        **over,
    )


def perturbed_states(model, n, seed=3, scale=0.02):
    """n copies of the build pose with numpy-made position noise and random
    velocities, as a dict of env-first numpy arrays."""
    rng = np.random.default_rng(seed)
    s0 = {f: np.asarray(v) for f, v in init_state(model)._asdict().items()}
    out = {f: np.repeat(v[None], n, 0) for f, v in s0.items()}
    out["pos"] = (out["pos"] + rng.normal(size=out["pos"].shape) * scale).astype(np.float32)
    out["lin_vel"] = (rng.normal(size=out["lin_vel"].shape) * 0.2).astype(np.float32)
    out["ang_vel"] = (rng.normal(size=out["ang_vel"].shape) * 0.2).astype(np.float32)
    return out


def compare_steps(model, n_steps=3, batch=3, atol=2e-4, topm_atol=None):
    """Step JAX and the port from the same states; assert agreement after
    every step. topm_atol, when given, is the tighter bound held on pos,
    quat, velocities and dyn_lambda (the JAX package's top-M check)."""
    states = perturbed_states(model, batch)
    ns = model.n_slider
    rng = np.random.default_rng(11)
    tgt = (rng.normal(size=(batch, ns)) * 0.5).astype(np.float32)
    en = np.ones((batch, ns), bool)

    step_v = jax.jit(jax.vmap(lambda s, t, e: physics_step(model, s, t, e, DT)))
    sj = type(init_state(model))(**{f: jnp.asarray(v) for f, v in states.items()})
    port = BatchedStep(convert.model_from_arrays(model), DT, device="cpu")
    sp = convert.physics_state(states, "cpu")
    tt, te = torch.as_tensor(tgt), torch.as_tensor(en)
    for _ in range(n_steps):
        sj, dj = step_v(sj, jnp.asarray(tgt), jnp.asarray(en))
        sp, dp = port(sp, tt, te)
        for name in ("pos", "quat", "lin_vel", "ang_vel", "contact_lambda",
                     "joint_lambda", "dyn_lambda"):
            np.testing.assert_allclose(
                getattr(sp, name).numpy(), np.asarray(getattr(sj, name)),
                atol=atol, rtol=0, err_msg=name,
            )
        for name in ("contact_vid", "dyn_vid"):
            np.testing.assert_array_equal(
                getattr(sp, name).numpy(), np.asarray(getattr(sj, name)), err_msg=name
            )
        for name in dj._fields:
            np.testing.assert_allclose(
                getattr(dp, name).numpy(), np.asarray(getattr(dj, name)),
                atol=5e-3, rtol=0, err_msg=name,
            )
        if topm_atol is not None:
            for name in ("pos", "quat", "lin_vel", "ang_vel", "dyn_lambda"):
                np.testing.assert_allclose(
                    getattr(sp, name).numpy(), np.asarray(getattr(sj, name)),
                    atol=topm_atol, rtol=0, err_msg=name,
                )
    return sp


ROW_ORDERS = ("canonical", "scheduled", "shuffled:7")


def order_cases(builds):
    """(build, extra, row_order) cases over ROW_ORDERS; the canonical case
    keeps the plain id."""
    return [
        pytest.param(build, extra, order,
                     id=name if order == "canonical" else f"{name}-{order}")
        for name, build, extra in builds for order in ROW_ORDERS
    ]


@pytest.mark.parametrize(
    "build, member_contact, row_order",
    order_cases([("joint_only", _cartpole_like_model, False),
                 ("contact", _contact_model, False), ("dyn_only", _dyn_only_model, True)]),
)
def test_step_matches_jax(build, member_contact, row_order):
    sp = compare_steps(dataclasses.replace(build(), row_order=row_order))
    assert all(torch.isfinite(x).all() for x in (sp.pos, sp.quat, sp.lin_vel))
    if member_contact:  # the overlapping boxes' member rows really engage
        assert float(sp.dyn_lambda.abs().sum()) > 0.0

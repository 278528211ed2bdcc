"""Per-env physics step: the PyTorch port against the JAX package on the CPU.

One world (no env axis) goes through JAX's ``physics_step`` (solver="pallas":
the per-env step, its fat-row sweep ``solver_sweep`` in interpret mode, once
for the split-impulse push pass and once for the velocity sweep) and the
port's ``physics_step`` (the per-env step, the fat-row sweep's plain
version). The same numpy-made state is fed to both and stepped 3 times; the
state and the diagnostics must agree at 2e-4 after every step (the
tolerance of the JAX package's own per-env check, tests/test_batched_step.py
``_compare``) and the contact and member feature ids exactly, in every row
visit order of the full sweep (canonical, scheduled with the sweep's groups,
shuffled:7), each against the same order of JAX.

Fixtures: a hinge + slider model (tests/test_solver_pallas.py ``_build``),
two boxes stacked on a floor (floor contacts and member contacts: both
sweeps run), two members wedged edge on edge (the SAT edge axis), and the
hinge + slider model under strict_bullet (joint warm start, uncapped limit
bias). The other fixtures are in test_torch_perenv_contact.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.physics.engine import init_state, physics_step
from evomotion_tpu.physics.model import ModelBuilder
from evomotion_tpu.physics.shapes import get_shape
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.kernels import sweep_fat
from evomotion_tpu_torch.physics import engine as tengine
from test_torch_step import ROW_ORDERS, perturbed_states

DT = 1.0 / 60.0
ATOL = 2e-4


def hinge_slider_model(**over):
    """Floor, a box with a hinged arm (limits +-0.5), and a slider cart on a
    static base (tests/test_solver_pallas.py ``_build``)."""
    b = ModelBuilder()
    cube = get_shape("cube").hull_verts
    b.add_body("floor", cube, (100, 1, 100), 0.0, (0, -1, 0), (0, 0, 0, 1))
    box = b.add_body("box", cube, (0.5, 0.5, 0.5), 1.0, (0, 1.0, 0), (0, 0, 0, 1))
    arm = b.add_body("arm", cube, (0.3, 0.1, 0.1), 0.5, (0.8, 1.0, 0), (0, 0, 0, 1))
    b.set_ignore_collision(box, arm)
    b.add_hinge(box, arm, (0.5, 0, 0), (-0.3, 0, 0), (0, 0, 1), (0, 0, 1), -0.5, 0.5)
    base = b.add_body("base", cube, (0.1, 0.1, 0.1), 0.0, (3, 0.5, 0), (0, 0, 0, 1))
    cart = b.add_body("cart", cube, (0.2, 0.2, 0.2), 1.0, (3, 0.5, 0), (0, 0, 0, 1))
    b.set_ignore_collision(base, cart)
    b.add_slider(
        base, cart, (0, 0, 0), (0, 0, 0, 1), (0, 0, 0), (0, 0, 0, 1),
        lin_lo=-2.0, lin_hi=2.0, max_motor_force=32.0, motor_index=0,
    )
    return dataclasses.replace(b.finalize(), solver="pallas", **over)


def stacked_boxes_model(**over):
    """A box resting on the floor and a tilted box resting on it, both just
    inside the contact margin: active floor contacts and member contacts."""
    b = ModelBuilder()
    cube = get_shape("cube").hull_verts
    b.add_body("floor", cube, (20, 1, 20), 0.0, (0, -1, 0), (0, 0, 0, 1), friction=0.5)
    b.add_body("box1", cube, (0.4, 0.4, 0.4), 1.0, (0, -0.31, 0), (0, 0, 0, 1), friction=0.6)
    b.add_body("box2", cube, (0.3, 0.3, 0.3), 2.0, (0.05, 0.03, 0.02),
               (0.0, 0.19866933, 0.0, 0.98006658), friction=0.4)
    return dataclasses.replace(b.finalize(), solver="pallas", member_contacts=True, **over)


def wedge_model(**over):
    """Two members wedged edge on edge over a floor
    (tests/test_solver_pallas.py ``test_edge_on_edge_wedge_resolves``)."""
    b = ModelBuilder()
    cube = get_shape("cube").hull_verts
    b.add_body("floor", cube, (100, 1, 100), 0.0, (0, -1, 0), (0, 0, 0, 1))
    s2, c2 = math.sin(math.pi / 8), math.cos(math.pi / 8)
    b.add_body("leg1", cube, (0.6, 0.1, 0.1), 5.0, (0.0, 0.3, 0), (s2, 0, 0, c2))
    b.add_body("leg2", cube, (0.1, 0.1, 0.6), 1.0, (0.0, 0.5328, 0), (0, 0, s2, c2))
    return dataclasses.replace(b.finalize(), solver="pallas", **over)


def compare_perenv(model, n_steps=3, seed=3):
    """Step one world in JAX and in the port from the same numpy-made state;
    assert agreement after every step. Returns the port's last state and the
    fat-sweep launches-or-calls it made (CPU: plain version calls)."""
    st = {f: v[0] for f, v in perturbed_states(model, 1, seed=seed, scale=0.01).items()}
    ns = model.n_slider
    tgt = (np.random.default_rng(11).normal(size=ns) * 0.5).astype(np.float32)
    en = np.ones(ns, bool)
    step_j = jax.jit(lambda s, t, e: physics_step(model, s, t, e, DT))
    sj = type(init_state(model))(**{f: jnp.asarray(v) for f, v in st.items()})
    tmodel = convert.model_from_arrays(model)
    sp = convert.physics_state(st, "cpu")
    tt, te = torch.as_tensor(tgt), torch.as_tensor(en)
    for i in range(n_steps):
        sj, dj = step_j(sj, jnp.asarray(tgt), jnp.asarray(en))
        sp, dp = tengine.physics_step(tmodel, sp, tt, te, DT)
        for name in ("pos", "quat", "lin_vel", "ang_vel", "contact_lambda",
                     "joint_lambda", "dyn_lambda"):
            np.testing.assert_allclose(getattr(sp, name).numpy(), np.asarray(getattr(sj, name)),
                                       atol=ATOL, rtol=0, err_msg=f"step {i} {name}")
        for name in ("contact_vid", "dyn_vid"):
            np.testing.assert_array_equal(getattr(sp, name).numpy(),
                                          np.asarray(getattr(sj, name)),
                                          err_msg=f"step {i} {name}")
        for name in dj._fields:
            np.testing.assert_allclose(getattr(dp, name).numpy(), np.asarray(getattr(dj, name)),
                                       atol=ATOL, rtol=0, err_msg=f"step {i} {name}")
    assert sp.pos.shape == (model.n_bodies, 3)
    return sp


def test_hinge_slider_matches_jax(monkeypatch):
    check_hinge_slider(monkeypatch, "canonical")


@pytest.mark.parametrize("row_order", [o for o in ROW_ORDERS if o != "canonical"])
def test_hinge_slider_matches_jax_in_row_order(monkeypatch, row_order):
    check_hinge_slider(monkeypatch, row_order)


def check_hinge_slider(monkeypatch, row_order):
    calls = []
    plain = sweep_fat.sweep_fat_plain
    monkeypatch.setattr(sweep_fat, "sweep_fat_plain",
                        lambda rd, *a: calls.append(rd.shape[1]) or plain(rd, *a))
    model = hinge_slider_model(row_order=row_order)
    sp = compare_perenv(model)
    assert all(torch.isfinite(x.float()).all() for x in sp)
    # each step: the push pass over the floor and member normal rows, then the
    # velocity sweep over the 13 joint rows and every contact's 3 rows
    n_normal = 4 * tengine.n_manifold_pairs(model) + tengine._n_dyn_contacts(model)
    assert model.n_rows == 13 and n_normal > 0
    assert calls == [n_normal, 13 + 3 * n_normal] * 3


def test_strict_hinge_slider_matches_jax():
    """strict_bullet: joint rows warm-start from the cached impulses from the
    second step on, and the limit rows' bias is uncapped."""
    sp = compare_perenv(hinge_slider_model(strict_bullet=True))
    assert float(sp.joint_lambda.abs().sum()) > 0.0


def test_physics_step_dispatch_and_batched_call_shape():
    """physics_step routes one world to the per-env step and a batch to the
    batched step; the per-env step on a batch (the JAX per-env solver's vmap
    shape) steps each world as it steps it alone, without building the slim
    sweep's metadata. solver='xla' is not ported."""
    import pytest

    from evomotion_tpu_torch.physics.batched import BatchedStep
    from evomotion_tpu_torch.physics.perenv import PerEnvStep

    model = convert.model_from_arrays(stacked_boxes_model())
    batch = convert.physics_state(perturbed_states(model, 2, seed=5, scale=0.01), "cpu")
    tgt, en = torch.zeros((2, 0)), torch.ones((2, 0), dtype=torch.bool)
    got, _ = tengine.physics_step(model, batch, tgt, en, DT)
    ref, _ = BatchedStep(model, DT, device="cpu")(batch, tgt, en)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    perenv = PerEnvStep(model, DT, device="cpu")
    both, _ = perenv(batch, tgt, en)
    # the per-env step never builds the slim sweep's metadata
    assert "sweep_meta" not in vars(perenv.statics)
    for i in range(2):
        one, _ = tengine.physics_step(model, type(batch)(*(x[i] for x in batch)), tgt[i],
                                      en[i], DT)
        for a, b in zip(one, both):
            torch.testing.assert_close(a, b[i], atol=1e-6, rtol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PerEnvStep(dataclasses.replace(model, solver="xla"), DT, device="cpu")

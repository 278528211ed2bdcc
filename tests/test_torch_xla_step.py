"""The colored-phase ``solver="xla"`` step: the PyTorch port against the JAX
package on the CPU.

One world goes through JAX's ``physics_step`` with ``solver="xla"`` (the XLA
path of ``_physics_step_impl``: the floor push pass by K-slot, the member
push and velocity passes by color and slot, the joint rows by phase) and
through the port's ``physics_step`` (the per-env step with the phase solves
of ``physics/phases.py``). Same numpy-made state, 3 steps, state and
diagnostics within 2e-4 after every step and feature ids exact
(``compare_perenv``, the tolerance of JAX's own per-env check). Fixtures: the
hinge + slider model, stacked boxes (floor and member contacts), the
edge-on-edge wedge, the strict hinge + slider (joint warm start, uncapped
limit bias) and two boxes in free space (member pairs, no floor pairs).

The batched call is held against ``jax.vmap`` in test_torch_xla_batched.py.
"""

import dataclasses

import pytest
import torch

from evomotion_tpu.physics.model import ModelBuilder
from evomotion_tpu.physics.shapes import get_shape
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.physics import engine as tengine
from evomotion_tpu_torch.physics import phases
from evomotion_tpu_torch.physics.batched import BatchedStep
from evomotion_tpu_torch.physics.perenv import FatSolver, PerEnvStep
from test_torch_perenv_step import (
    DT,
    compare_perenv,
    hinge_slider_model,
    stacked_boxes_model,
    wedge_model,
)


def xla(model):
    return dataclasses.replace(model, solver="xla")


def members_only_model():
    """Two boxes in free space, the upper one tilted and just inside the
    contact margin of the lower: member pairs, no floor pairs."""
    b = ModelBuilder()
    cube = get_shape("cube").hull_verts
    b.add_body("box1", cube, (0.4, 0.4, 0.4), 1.0, (0, 0, 0), (0, 0, 0, 1), friction=0.6)
    b.add_body("box2", cube, (0.3, 0.3, 0.3), 2.0, (0.05, 0.34, 0.02),
               (0.0, 0.19866933, 0.0, 0.98006658), friction=0.4)
    return xla(dataclasses.replace(b.finalize(), member_contacts=True))


FIXTURES = {
    "hinge_slider": lambda: xla(hinge_slider_model()),
    "stacked_boxes": lambda: xla(stacked_boxes_model()),
    "wedge": lambda: xla(wedge_model()),
    "strict_hinge_slider": lambda: xla(hinge_slider_model(strict_bullet=True)),
    "members_only": members_only_model,
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_xla_step_matches_jax(name):
    model = FIXTURES[name]()
    sp = compare_perenv(model)
    assert all(torch.isfinite(x.float()).all() for x in sp)
    if name == "stacked_boxes":
        assert float(sp.contact_lambda[..., 0].sum()) > 0.0
        assert float(sp.dyn_lambda[:, 0].sum()) > 0.0
    if name == "members_only":
        assert tengine.n_manifold_pairs(model) == 0 and tengine._n_dyn_contacts(model) > 0
        assert int((sp.dyn_vid >= 0).sum()) > 0
    if name == "strict_hinge_slider":
        assert float(sp.joint_lambda.abs().sum()) > 0.0


def test_solver_dispatch():
    """Both step classes take their solves from model.solver: the fat-row
    sweep for "pallas", the phase solves for "xla" (a batch of xla worlds
    included); any other name raises."""
    model = convert.model_from_arrays(stacked_boxes_model())
    for cls in (PerEnvStep, BatchedStep):
        step = cls(xla(model), DT, device="cpu")
        assert isinstance(step.solve_push, phases.PhaseSolver)
        assert isinstance(step.solve_full, phases.PhaseSolver)
    assert BatchedStep(model, DT, device="cpu").solve_full is None
    perenv = PerEnvStep(model, DT, device="cpu")
    assert isinstance(perenv.solve_push, FatSolver) and isinstance(perenv.solve_full, FatSolver)
    with pytest.raises(ValueError, match="solver='jacobi'"):
        PerEnvStep(dataclasses.replace(model, solver="jacobi"), DT, device="cpu")
    assert tengine.default_solver() == "pallas"


def test_phase_schedule():
    """The xla solves visit every row once per iteration in JAX's order:
    joint phases without their padding slots, floor normals by slot, floor
    friction by (slot, direction), then the member normals, first and
    second friction directions by (color, slot); the push pass runs the
    floor slots' iterations, then the members'."""
    model = convert.model_from_arrays(xla(stacked_boxes_model()))
    n_pair, n_dyn = tengine.n_manifold_pairs(model), tengine._n_dyn_contacts(model)
    k, kd = 4, model.member_manifold_k
    n_colors = len(model.dyn_pair_color)
    pt = model.phase_table
    n_phases = int(sum((row < model.n_rows).any() for row in pt))
    full = phases.full_solver(model, n_pair, n_dyn, "cpu")
    per_iter = n_phases + 3 * k + 3 * n_colors * kd
    assert full.n_groups == model.n_iterations * per_iter
    assert int(full.order.numel()) == model.n_rows + 3 * (n_pair * k + n_dyn)
    push = phases.push_solver(model, n_pair, n_dyn, "cpu")
    assert [len(steps) for _, steps in push.blocks] == [k, n_colors * kd]
    # padding slots move nothing: a phase table padded with n_rows builds
    # the same joint groups
    hinge = convert.model_from_arrays(xla(hinge_slider_model()))
    sizes = [int((row < hinge.n_rows).sum()) for row in hinge.phase_table]
    groups = phases.full_solver(hinge, tengine.n_manifold_pairs(hinge), 0, "cpu").blocks[0][1]
    assert [s.n for s in groups[:len(sizes)]] == [n for n in sizes if n]
    assert sum(sizes) == hinge.n_rows

"""The operation and byte counts against hand-worked values."""

from __future__ import annotations

import collections

import pytest

from portbench import harness
from portbench.counts import networks, sweep
from portbench.reference.sim.sweep import KIND_FRICTION, KIND_JOINT, KIND_NORMAL
from portbench.reference.sim.walk import RobotWalk

CONFIGS = ["walk_ppo", "walk_ppo_liquid"]


def _config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def test_sweep_at_2048_envs():
    """Kernel #1 at B=2048 on the spider: 4.99 GFLOP, 195.8 MB, bound by
    its operations at 0.0745 ms (the kernel table's figures)."""
    s = _config("walk_ppo")["sweep"]
    assert sweep.n_rows(s) == 1896
    assert sweep.flops(s, 2048) == pytest.approx(4.99171328e9, rel=1e-9)
    assert sweep.bytes_moved(s, 2048) == pytest.approx(195.76512e6, rel=1e-9)
    assert sweep.least_seconds(s, 2048) == pytest.approx(0.0745e-3, rel=1e-3)


def test_sweep_scales_with_the_batch():
    s = _config("walk_ppo")["sweep"]
    assert sweep.flops(s, 4096) == 2 * sweep.flops(s, 2048)


@pytest.mark.parametrize("name", CONFIGS)
def test_sweep_rows_are_the_spiders(name):
    """The configuration's row counts are those of the spider's model as
    the reference compiles it."""
    env = RobotWalk(device="cpu")
    kinds = {KIND_JOINT: "joint", KIND_NORMAL: "normal", KIND_FRICTION: "friction"}
    rows = collections.Counter(
        f"{kinds[kind]}_{'a' if skip_b else 'ab'}" + ("_push" if push >= 0 else "")
        for _a, _b, kind, _p, skip_b, push, *_ in env.physics_step.statics.sweep_meta.rows)
    s = _config(name)["sweep"]
    assert s["rows"] == dict(rows)
    assert s["bodies"] == env.model.n_bodies
    assert s["n_iterations"] == env.model.n_iterations == _config(name)["physics"]["n_iterations"]


def test_mlp_counts_by_hand():
    """obs 371, act 12, hidden 256: actor forward 2(371*256 + 256*256 +
    2*256*12) = 333,312 per sample, critic 2(371*256 + 256*256 + 256) =
    321,536; backward skips the observation's gradient."""
    c = _config("walk_ppo")
    f = networks.iteration_flops(c, 371, 12, 4096)
    actor_f, critic_f = 333_312, 321_536
    actor_b = 2 * 333_312 - 2 * 371 * 256
    critic_b = 2 * 321_536 - 2 * 371 * 256
    samples = 64 * 4096
    assert f["rollout"] == samples * (actor_f + critic_f)
    assert f["update"] == 4096 * critic_f + 8 * samples * (actor_f + actor_b + critic_f + critic_b)


def test_liquid_counts_by_hand():
    """64 neurons, 6 unfolding steps: the input product once, the recurrent
    one 6 times; backward has no input gradient for the observation nor for
    the first step's stored hidden state."""
    c = _config("walk_ppo_liquid")
    f = networks.iteration_flops(c, 371, 12, 2)
    cell_f = 2 * 371 * 64 + 6 * 2 * 64 * 64
    cell_b = 2 * 371 * 64 + 2 * 64 * 64 + 5 * 4 * 64 * 64
    actor_f, critic_f = cell_f + 2 * 2 * 64 * 12, cell_f + 2 * 64
    actor_b, critic_b = cell_b + 2 * 4 * 64 * 12, cell_b + 4 * 64
    samples = 64 * 2
    assert f["rollout"] == samples * (actor_f + critic_f)
    assert f["update"] == 2 * critic_f + 8 * samples * (actor_f + actor_b + critic_f + critic_b)

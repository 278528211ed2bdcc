"""The operation and byte counts against hand-worked values."""

from __future__ import annotations

import collections

import numpy as np
import pytest

from portbench import harness
from portbench.counts import member, networks, sweep
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


@pytest.mark.parametrize("name,envs,rollout,update", [
    ("walk_ppo", 4096, 171664474112.0, 3324547956736.0),
    ("walk_ppo", 8192, 343328948224.0, 6649095913472.0),
    ("walk_ppo_liquid", 4096, 51506053120.0, 1003002789888.0),
    ("walk_ppo_liquid", 8192, 103012106240.0, 2006005579776.0),
])
def test_network_counts_at_the_cells_batches(name, envs, rollout, update):
    """The PPO families' counts at the cells' batches, as they read before
    the counts were split by family (so ``mfu_pct`` reads the same)."""
    assert networks.iteration_flops(_config(name), 371, 12, envs) == {
        "rollout": rollout, "update": update}


def test_member_at_4096_and_8192_envs():
    """Kernel #4 on the spider: per env, 1,496 B of staged state (17 bodies
    x 22 floats) and 7,680 B of warm caches (480 points x (4 + 12)) read;
    1,440 rows x 40 B (12 bf16 J, 4 f32 scalars), 480 x 20 B of act, vid,
    lam_n0 and lam_t0, and 42 x 24 B of imp6 written: 77,384 B. Operations:
    2 x 48 x 24 x 20 x 6 plane tests and 48 x 4 x 4 x 2 x 12 x 5 SAT
    projections, 368,640. So 317.0 / 633.9 MB and 1.51 / 3.02 GFLOP at
    4,096 / 8,192 (the kernel table's figures), bound by bytes at
    0.0946 / 0.1892 ms."""
    m = _config("walk_ppo")["member"]
    assert member.bytes_moved(m, 4096) == 77_384 * 4096 == pytest.approx(317.0e6, rel=1e-3)
    assert member.flops(m, 4096) == 368_640 * 4096 == pytest.approx(1.51e9, rel=1e-3)
    assert member.bytes_moved(m, 8192) == 2 * member.bytes_moved(m, 4096)
    assert member.flops(m, 8192) == 2 * member.flops(m, 4096)
    assert member.bytes_moved(m, 8192) == pytest.approx(633.9e6, rel=1e-3)
    assert member.flops(m, 8192) == pytest.approx(3.02e9, rel=1e-3)
    assert member.least_seconds(m, 4096) == pytest.approx(0.0946e-3, rel=1e-3)
    assert member.least_seconds(m, 8192) == 2 * member.least_seconds(m, 4096)


@pytest.mark.parametrize("name", CONFIGS)
def test_member_shapes_are_the_spiders(name):
    """The configuration's ``member`` block is the spider's member shapes as
    the reference builds them."""
    env = RobotWalk(device="cpu")
    model, st = env.model, env.physics_step.statics
    pairs = np.asarray(model.dyn_pair_body)
    v = st.np_hull.shape[1]
    want = {"p": len(pairs), "m": int(model.member_topm), "k": int(model.member_manifold_k),
            "v": v, "f": st.np_face.shape[1], "ne": st.edirs.shape[1], "nsupp": min(12, v),
            "edge": bool(model.member_edge_contacts), "u": len(np.unique(pairs)),
            "nb": model.n_bodies, "row_dtype": model.row_dtype}
    assert _config(name)["member"] == want
    assert 0 < want["m"] < want["p"]  # the top-M cull is on: M pairs narrowphased per env

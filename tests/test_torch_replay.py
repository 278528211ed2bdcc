"""The port's replay buffers against the JAX package's, at atol 0.

Both are fed the same seeded sequence of ``add``/``update_last`` calls (and,
for the trajectory buffers, ``new_trajectory``) with numpy-made items, and
must then hold the same items in the same order (FIFO eviction), answer
``has_enough``/``enough_trajectory``/``empty`` alike and sample the same
indices: both shuffle with ``np.random.default_rng(seed).permutation``.
"""

import numpy as np
import pytest
import torch

from evomotion_tpu.buffers import replay as JR
from evomotion_tpu_torch.buffers import replay as PR


def _step(mod, rng):
    s = rng.standard_normal(3).astype(np.float32)
    return mod.EpisodeStep(torch.as_tensor(s) if mod is PR else s,
                           rng.uniform(-1, 1, 2).astype(np.float32), 0.0, False, s)


def _key(item):
    """An item's contents as plain tuples (tensor or array alike)."""
    step = item.step if hasattr(item, "step") else item
    return tuple(np.asarray(getattr(step, f)).tobytes() if not isinstance(getattr(step, f),
                 (float, bool)) else getattr(step, f) for f in ("state", "action", "reward",
                                                                "done", "next_state"))


@pytest.mark.parametrize("size,batch", [(8, 4), (40, 5)])
def test_step_buffer_matches_jax(size, batch):
    jb, pb = JR.ReplayBuffer(size, 7), PR.ReplayBuffer(size, 7)
    assert jb.empty() and pb.empty()
    rng_j, rng_p = np.random.default_rng(3), np.random.default_rng(3)
    sampled = 0
    for t in range(30):
        for buf, mod, rng in ((jb, JR, rng_j), (pb, PR, rng_p)):
            if not buf.empty():
                buf.update_last(reward=float(t), done=t % 7 == 0)
            buf.add(_step(mod, rng))
        assert len(jb.memory) == len(pb.memory) == min(t + 1, size)
        assert [_key(x) for x in jb.memory] == [_key(x) for x in pb.memory]
        assert jb.has_enough(batch) == pb.has_enough(batch)
        if jb.has_enough(batch):
            js, ps = jb.sample(batch), pb.sample(batch)
            assert [_key(x) for x in js] == [_key(x) for x in ps]
            # the newest element is never sampled (its reward is a placeholder)
            assert all(x is not pb.memory[-1] for x in ps)
            sampled += 1
    assert sampled > 0
    # FIFO: the oldest kept item was added at t = max(30 - size, 0), and the
    # next act patched its reward to t + 1
    assert pb.memory[0].reward == float(max(30 - size, 0) + 1)


def test_liquid_step_update_last_patches_inner_step():
    for mod in (JR, PR):
        buf = mod.ReplayBuffer(4, 0)
        buf.add(mod.LiquidEpisodeStep(mod.EpisodeStep(1, 2, 0.0, False, 1), {"a": 0}))
        buf.update_last(reward=2.5, done=True)
        assert buf.memory[-1].step.reward == 2.5 and buf.memory[-1].step.done
    ppo = PR.LiquidPpoEpisodeStep(PR.PpoEpisodeStep(1, 2, 0.0, False, 0.1, 0.2, 0.3), {})
    assert [f for f in vars(ppo.step)] == [f for f in vars(
        JR.PpoEpisodeStep(1, 2, 0.0, False, 0.1, 0.2, 0.3))]


@pytest.mark.parametrize("size,batch", [(3, 2), (6, 3)])
def test_trajectory_buffer_matches_jax(size, batch):
    jb, pb = JR.TrajectoryReplayBuffer(size, 11), PR.TrajectoryReplayBuffer(size, 11)
    rng = np.random.default_rng(5)
    lengths = rng.integers(1, 5, 12)
    checked = 0
    for n, length in enumerate(lengths):
        assert jb.trajectory_empty() == pb.trajectory_empty()
        for buf in (jb, pb):
            buf.new_trajectory()
            for i in range(length):
                buf.add(PR.PpoEpisodeStep(n, i, 0.0, False, 0.0, 0.0, 0.0))
                buf.update_last(reward=float(n * 10 + i))
        assert [[(x.state, x.action, x.reward) for x in t] for t in jb.memory] == \
            [[(x.state, x.action, x.reward) for x in t] for t in pb.memory]
        assert len(pb.memory) == min(n + 1, size)
        assert jb.enough_trajectory(batch) == pb.enough_trajectory(batch)
        assert jb.trajectory_empty() == pb.trajectory_empty()
        if pb.enough_trajectory(batch) and len(pb._filtered()) > 1:
            js, ps = jb.sample(batch), pb.sample(batch)
            assert [t[0].state for t in js] == [t[0].state for t in ps]
            checked += 1
    assert checked > 0

"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny size, once for each fault a training cell can have on
one card (the exchange between cards does not exist here)."""

from __future__ import annotations

import dataclasses

import pytest

from portbench import harness

from .tiny import measure, tiny_cell

CELLS = ["walk_ppo.train_4096", "walk_ppo_liquid.train_4096"]


def _frozen_step(monkeypatch):
    """Each update returns the networks unchanged."""
    from evomotion_tpu_torch.train import ppo_batched, ppo_liquid_batched

    def step(opt, module, loss, max_norm):
        opt.zero_grad(set_to_none=True)

    monkeypatch.setattr(ppo_batched, "_step", step)
    monkeypatch.setattr(ppo_liquid_batched, "_step", step)


def _half_batch(monkeypatch):
    """The update sees half of the env batch, its means over the rest."""
    from evomotion_tpu_torch.train.ppo_batched import BatchedPpo
    from evomotion_tpu_torch.train.ppo_liquid_batched import BatchedPpoLiquid

    for cls in (BatchedPpo, BatchedPpoLiquid):
        orig = cls._update

        def update(self, state, traj, *rest, orig=orig):
            n = traj.obs.shape[1] // 2
            cut = {f: getattr(state, f)[:n] for f in ("obs", "actor_x", "critic_x")
                   if hasattr(state, f)}
            part = dataclasses.replace(state, **cut)
            m = orig(self, part, type(traj)(*(x[:, :n] for x in traj)), *rest)
            state.iteration = part.iteration
            return m

        monkeypatch.setattr(cls, "_update", update)


def _reward_altered(monkeypatch):
    """The env step's reward is off by 0.01 where it is produced."""
    from evomotion_tpu_torch.envs import robot

    orig = robot.RobotWalk._reward_velocity
    monkeypatch.setattr(robot.RobotWalk, "_reward_velocity",
                        lambda self, physics: orig(self, physics) + 0.01)


def _action_altered(monkeypatch):
    """The sampled actions are off by 0.01 where they are drawn."""
    from evomotion_tpu_torch.networks import distributions

    orig = distributions.truncated_normal_sample
    monkeypatch.setattr(distributions, "truncated_normal_sample",
                        lambda *a, **k: (orig(*a, **k) * 0.99).clamp(-1, 1))


FAULTS = [_frozen_step, _half_batch, _reward_altered, _action_altered]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__.strip("_") for f in FAULTS])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    fault(monkeypatch)
    _run, readings = measure(cell)
    ok, rows = harness.judge(readings, cell.limits)
    assert not ok, rows

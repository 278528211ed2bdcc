"""The plain reference against the port on the CPU at a tiny size, and the
control (the reference one precision below the configuration's) failing
the comparison."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import calibrate, harness
from portbench.reference import nets
from portbench.reference.sim import walk

from .tiny import measure, small_program, tiny_cell

CELLS = ["walk_ppo.train_4096", "walk_ppo_liquid.train_4096"]


def test_frozen_step_equals_the_ports():
    """The frozen physics copy steps the spider exactly as the port's
    batched step does on the CPU (both run the sweep's plain version)."""
    from evomotion_tpu_torch.envs.robot import RobotWalk as PortWalk, RobotWalkParams

    port = PortWalk(RobotWalkParams(reset_frames=1), device="cpu")
    ref = walk.RobotWalk(walk.RobotWalkParams(reset_frames=1), device="cpu")
    port.model = dataclasses.replace(port.model, n_iterations=2)
    ref.model = dataclasses.replace(ref.model, n_iterations=2)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    s1, r1 = port.reset(2, g1)
    s2, r2 = ref.reset(2, g2)
    act = torch.Generator().manual_seed(4)
    for _ in range(3):
        a = torch.rand((2, port.action_size), generator=act) * 2 - 1
        s1, r1 = port.step(s1, a, g1)
        s2, r2 = ref.step(s2, a, g2)
        for x, y in zip(r1, r2):
            assert torch.equal(x, y)
        for x, y in zip(s1.physics, s2.physics):
            assert torch.equal(x, y)


@pytest.mark.parametrize("family", ["ppo_gae", "ppo_gae_liquid"])
def test_networks_equal_the_ports(family):
    """On the benchmark's weights, the reference's networks give what the
    port's modules give."""
    from evomotion_tpu_torch.networks import liquid, modules

    agent = {"hidden_size": 32, "neuron_number": 8, "unfolding_steps": 3}
    specs = nets.leaves(family, 371, 12, agent)
    g = torch.Generator().manual_seed(5)
    pa, pc = nets.init(specs[0], g, "cpu"), nets.init(specs[1], g, "cpu")
    obs = torch.randn((5, 371), generator=g)
    if family == "ppo_gae":
        actor, critic = modules.Actor(371, 12, 32), modules.Critic(371, 32)
        actor.load_state_dict(pa)
        critic.load_state_dict(pc)
        got = (*actor(obs), critic(obs))
        want = (*nets.mlp_actor(pa, obs), nets.mlp_critic(pc, obs))
    else:
        actor, critic = liquid.LiquidActor(371, 12, 8, 3), liquid.LiquidCritic(371, 8, 3)
        actor.load_state_dict(pa)
        critic.load_state_dict(pc)
        x = torch.randn((5, 8), generator=g)
        got = (*actor(x, obs), *critic(x, obs))
        want = (*nets.liquid_actor(pa, x, obs, 3), *nets.liquid_critic(pc, x, obs, 3))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    """The port, driven through the timed call, agrees with the reference
    within the cell's limits."""
    cell = tiny_cell(name)
    _run, readings = measure(cell)
    ok, rows = harness.judge(readings, cell.limits)
    assert ok, rows


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference one precision below the configuration's (TF32 matrix
    products, fp8 J columns) in the program's place is not correct."""
    cell = tiny_cell(name)
    with small_program():
        r = calibrate.readings(cell, 11, torch.device("cpu"))
    assert harness.judge(r["program"], cell.limits)[0]
    assert not harness.judge(r["control"], cell.limits)[0], r["control"]
    assert not harness.judge(r["half_batch"], cell.limits)[0], r["half_batch"]

"""The off-policy tools on the CPU, small.

``tools.train_walk_offpolicy`` for two iterations of CrossQ and of SAC on
the spider (B=2, two steps per iteration, narrow networks; one solver
iteration, ``reset_frames=1`` and a 3-step eval horizon inside
``tools.rehearsal.small_walker``), its outputs laid out as the JAX tool's;
then a ``--resume`` (agent only, ring refilled) and a ``--resume-full``
(exact); then ``tools.eval_walk``'s ``crossq`` and ``sac`` tiers on the
saved actors. ``tools.train_offpolicy_cartpole`` for two iterations of its
fixed config, CrossQ's and the liquid SAC's. On the card ``chip_smoke.py``
runs the walker's config at full width through the CLI.
"""

import csv
import json
import os

import numpy as np
import pytest

from evomotion_tpu_torch.tools import eval_walk, train_offpolicy_cartpole, train_walk_offpolicy
from evomotion_tpu_torch.tools.rehearsal import small_walker

TINY = ["--n-envs", "2", "--steps-per-iter", "2", "--actor-hidden", "8", "--critic-hidden",
        "8", "--batch-size", "4", "--epoch", "1", "--buffer", "64", "--eval-every", "1",
        "--eval-envs", "2", "--save-every", "2", "--device", "cpu"]


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("algo,tier", [("cross_q", "crossq"), ("soft_actor_critic", "sac")])
def test_train_walk_offpolicy_then_resume_and_eval(algo, tier, tmp_path, capsys):
    out = str(tmp_path / "run")
    with small_walker(3):
        assert train_walk_offpolicy.main([out, "--algo", algo, "--iters", "2", *TINY]) == 0
        rows = _rows(os.path.join(out, "curve.csv"))
        assert rows[0] == train_walk_offpolicy.CURVE_COLUMNS
        assert [r[0] for r in rows[1:]] == ["1"]  # logged at it 1 and every 10th
        assert rows[1][2] == str(2 * 1)  # grad steps: 2 events x 1 epoch
        assert rows[1][11] != ""  # the greedy eval ran
        with open(os.path.join(out, "config.json")) as f:
            cfg = json.load(f)
        assert cfg["tier"] == "offpolicy_batched" and cfg["critic_hidden"] == 8
        for d in ("save_2", "save_final", "save_latest_full"):
            assert os.path.isdir(os.path.join(out, d)), d
        with open(os.path.join(out, "save_final", "meta.json")) as f:
            assert json.load(f)["algo"] == algo

        full = os.path.join(out, "save_latest_full")
        assert train_walk_offpolicy.main(
            [out, "--algo", algo, "--iters", "1", "--resume-full", full, *TINY]) == 0
        assert f"full-resume from {full} at it 2" in capsys.readouterr().out
        assert train_walk_offpolicy.main(
            [out, "--algo", algo, "--iters", "1", "--resume", os.path.join(out, "save_2"),
             "--refill-iters", "1", *TINY]) == 0
        assert "refilling the ring for 1 iters" in capsys.readouterr().out

        assert eval_walk.main([tier, os.path.join(out, "save_final"), "--hidden", "8",
                               "--episodes", "2"], device="cpu") == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res["tier"] == tier and res["envs"] == 2 and np.isfinite(res["mean_return"])


def test_train_offpolicy_cartpole_two_iterations(tmp_path, capsys):
    out = str(tmp_path / "cp")
    assert train_offpolicy_cartpole.main([out, "cross_q", "2", "--device", "cpu"]) == 0
    rows = _rows(os.path.join(out, "curve.csv"))
    assert rows[0] == train_offpolicy_cartpole.CURVE_COLUMNS
    assert [r[:2] for r in rows[1:]] == [["1", str(16 * 64)], ["2", str(2 * 16 * 64)]]
    assert all(np.isfinite(float(x)) for r in rows[1:] for x in r)
    assert sorted(os.listdir(os.path.join(out, "save_final")))[:2] == [
        "actor.npz", "actor_optimizer.npz"]


def test_train_offpolicy_cartpole_liquid_two_iterations(tmp_path):
    """The liquid SAC branch with the JAX tool's config (32 neurons, 6
    unfoldings, an 8,192-transition ring): two iterations, the curve, and
    the JAX agent's ten components in ``save_final``."""
    from evomotion_tpu_torch.agents.liquid_agents import SoftActorCriticLiquidAgent

    out = str(tmp_path / "cp")
    assert train_offpolicy_cartpole.main([out, "soft_actor_critic_liquid", "2", "--device",
                                          "cpu"]) == 0
    rows = _rows(os.path.join(out, "curve.csv"))
    assert rows[0] == train_offpolicy_cartpole.CURVE_COLUMNS
    assert [r[:2] for r in rows[1:]] == [["1", str(16 * 64)], ["2", str(2 * 16 * 64)]]
    assert all(np.isfinite(float(x)) for r in rows[1:] for x in r)
    save = os.path.join(out, "save_final")
    assert sorted(os.listdir(save)) == sorted(
        f"{c}.npz" for c in SoftActorCriticLiquidAgent.SAVE)
    with np.load(os.path.join(save, "actor.npz")) as f:
        assert f["cell/w"].shape == (32, 7) and f["cell/r"].shape == (32, 32)

"""A new agent family's cell through new modules and files alone: a stub
family registered under the names the harness looks up
(``portbench.trainers.<agent>``, ``portbench.counts.agents.<agent>``), its
configuration, traffic and limits in a tree of their own, and manifest
entries, read by the unchanged harness, metric readers and manifest checks;
and a family that lacks one of its modules stops the cell before set-up."""

from __future__ import annotations

import contextlib
import json
import sys
import time
import types

import pytest
import torch

from portbench import harness
from portbench.counts import sweep

from .test_portbench_manifest import MANIFEST, check_cell

AGENT = "stub_walk"
CELL = "walk_stub.train_stub"


class _Env:
    observation_size, action_size = 371, 12


class StubAdapter:
    """A trainer that does a little work per iteration in the two phases."""

    def __init__(self, config, traffic, seed, device):
        self.device = torch.device(device)
        self.horizon = config["agent_parameters"]["horizon"]
        self.env_steps_per_iteration = self.horizon * traffic["num_envs"]

    def setup(self):
        self.trainer = types.SimpleNamespace(env=_Env())
        self.x = torch.ones(64, device=self.device)

    def iteration(self, timer=None):
        for phase in ("rollout", "update"):
            with timer.phase(phase, self.device) if timer else contextlib.nullcontext():
                self.x = (self.x * 0.5 + 0.5).contiguous()

    def failed(self):
        return 0

    def release(self):
        del self.trainer

    def readings(self):
        return {"stub_gap": float((self.x - 1).abs().max())}


def _stub_flops(config, obs, act, num_envs):
    h = config["agent_parameters"]["hidden_size"]
    return {"rollout": float(2 * obs * h * num_envs), "update": float(6 * obs * h * num_envs)}


def _modules(monkeypatch, trainer=True, counts=True):
    if trainer:
        mod = types.ModuleType(f"portbench.trainers.{AGENT}")
        mod.NUMBERS, mod.Adapter = ("stub_gap",), StubAdapter
        monkeypatch.setitem(sys.modules, mod.__name__, mod)
    if counts:
        mod = types.ModuleType(f"portbench.counts.agents.{AGENT}")
        mod.iteration_flops = _stub_flops
        monkeypatch.setitem(sys.modules, mod.__name__, mod)


def _files(tmp_path, monkeypatch) -> dict:
    """The family's configuration, traffic and limits in a tree of their
    own, and a manifest with the new configuration and cell added."""
    config = harness.load_json(harness.HERE / "configs" / "walk_ppo.json")
    config.update(name="walk_stub", agent=AGENT)
    config["agent_parameters"] = {"hidden_size": 32, "horizon": 4}
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "walk_stub.json").write_text(json.dumps(config))
    (tmp_path / "traffic" / "train_stub.json").write_text(
        json.dumps({"num_envs": 8, "checked_iterations": 3, "checked_env_steps": 2}))
    (tmp_path / "limits" / f"{CELL}.json").write_text(json.dumps({"stub_gap": 0.0}))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "walk_stub", "source": "https://example.org/stub",
                                "file": str(tmp_path / "walk_stub.json"), "reduced": [],
                                "why": "a stub family"})
    manifest["workloads"].append({"name": CELL, "config": "walk_stub", "traffic": "train_stub",
                                  "chips": 1, "why": "a stub family's cell"})
    return manifest


def test_a_new_family_through_new_modules_only(tmp_path, monkeypatch):
    _modules(monkeypatch)
    manifest = _files(tmp_path, monkeypatch)
    w = manifest["workloads"][-1]
    check_cell(w, manifest)
    cell = harness.Cell(CELL, manifest)
    run, readings = harness.measure(cell, 2**31 + 11, 0.01, True, torch.device("cpu"),
                                    time.perf_counter(), log=lambda _msg: None)
    assert harness.judge(readings, cell.limits) == (True, {"stub_gap": {"value": 0.0,
                                                                        "limit": 0.0}})
    # every reader runs on the new family; those with nothing to read
    # (kernels #1 and #4, the physics spans: none on the CPU) are left out
    metrics = harness.read_metrics(run, cell.end_to_end + cell.per_layer)
    assert {"env_steps_per_s", "setup_s", "mfu_pct", "rollout_step_ms", "update_ms"} <= set(
        metrics)
    assert not {"member_roofline", "sweep_roofline", "physics_launches_per_step"} & set(metrics)
    n = 8
    per_it = 8 * 371 * 32 * n + 4 * sweep.flops(cell.config["sweep"], n)
    want = per_it * len(run.iteration_s) / sum(run.iteration_s) / sweep.H100_FP32_FLOPS * 100
    assert metrics["mfu_pct"]["value"] == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("missing", ["trainers", "counts/agents"])
def test_a_family_without_its_module_stops_the_cell(tmp_path, monkeypatch, missing):
    _modules(monkeypatch, trainer=missing != "trainers", counts=missing != "counts/agents")
    manifest = _files(tmp_path, monkeypatch)
    with pytest.raises(SystemExit, match=f"portbench/{missing}/{AGENT}.py"):
        harness.Cell(CELL, manifest)

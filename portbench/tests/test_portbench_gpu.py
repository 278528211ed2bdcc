"""The benchmark's command on the card: each cell runs, is correct, and
prints the contract's result line. Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable if w == "python3" else w for w in MANIFEST["command"]]
    out = subprocess.run(cmd + ["--workload", name, "--seed", str(2**31 + 99), "--seconds", "1",
                                "--trace", str(trace)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    cell = harness.Cell(name, MANIFEST)
    assert set(res["metrics"]) == set(cell.per_layer if trace else cell.end_to_end)
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert len(res["breakdown"]["device_ops"]) <= 10

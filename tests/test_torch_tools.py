"""The port's profilers on the CPU at a tiny size: ``tools.prof_kernel``
(the env-last fat-row sweep per row visit, TPU kernel #3's port) and
``tools.prof_step`` (phases of the batched spider step). Each must print
its phase lines and one JSON line whose numbers agree with them; on the
card the same tools time the CUDA kernel (chip_smoke.py runs them)."""

import json
import re

from evomotion_tpu_torch.kernels import sweep_envlast as se
from evomotion_tpu_torch.tools import prof_kernel, prof_step

LINE = re.compile(r"^(\S.{33}) nr=\s*(\d+) time=\s*([\d.]+)ms per-visit=\s*([\d.]+)ns$")
PHASE = re.compile(r"^(\s*[a-z/_ ]+):\s+(-?[\d.]+) ms")


def test_prof_kernel_prints_every_case(capsys):
    before = se.KERNEL.launches
    assert prof_kernel.main(["--device", "cpu", "--envs", "3", "--sizes", "8,16",
                             "--size", "16"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "per row visit = time / (rows x iterations)" in out[0]
    rows = [LINE.match(x) for x in out[1:-1]]
    assert all(rows), out
    labels = [m.group(1).strip() for m in rows]
    assert labels == ["joint blocks-of-6", "joint blocks-of-6", "joint all-same-body",
                      "joint round-robin bodies", "normal+friction (split pass on)"]
    assert [int(m.group(2)) for m in rows] == [8, 16, 16, 16, 16]
    res = json.loads(out[-1])
    # one warm-up call and 5 timed calls per case
    assert res["device"] == "cpu" and res["iters"] == 10 and res["sweep_calls"] == 5 * 6
    for m, r in zip(rows, res["results"]):
        assert r["ms"] > 0 and abs(float(m.group(4)) - r["ns_per_visit"]) < 0.1
        assert abs(r["ns_per_visit"] - r["ms"] * 1e6 / (r["rows"] * 10)) < 1e-6
    assert se.KERNEL.launches == before  # CPU: the plain version, no launch


def test_prof_kernel_rows_of_every_case():
    """The synthetic row sets are the TPU tool's: bodies, kinds, parents."""
    from evomotion_tpu_torch.kernels import sweep as sp

    ia, ib, parent, mu, kind, skip = prof_kernel.case_meta("blocks6", 14, 42)
    assert ia.tolist() == [0] * 6 + [12] * 6 + [24] * 2 and (ib == ia + 6).all()
    ia, ib, *_ = prof_kernel.case_meta("roundrobin", 23, 42)
    assert ia.tolist()[:3] == [0, 12, 24] and ia[21] == 0 and (ib == ia + 6).all()
    ia, ib, *_ = prof_kernel.case_meta("same", 5, 42)
    assert set(ia.tolist()) == {0} and set(ib.tolist()) == {6}
    ia, ib, parent, mu, kind, skip = prof_kernel.case_meta("contact", 6, 42)
    assert kind.tolist() == [sp.KIND_NORMAL, sp.KIND_FRICTION, sp.KIND_FRICTION] * 2
    assert parent.tolist() == [-1, 0, 1, -1, 3, 4] and mu.tolist() == [0, .5, .5] * 2
    assert not skip.any()


def test_prof_step_prints_every_phase(capsys):
    assert prof_step.main(["--device", "cpu", "--envs", "2", "--reps", "1",
                           "--reset-frames", "1", "--iterations", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("card: cpu; B=2, row order canonical")
    names = [PHASE.match(x).group(1).strip() for x in out[1:-1]]
    assert names == ["full env step", "physics step", "iinv_world", "floor contacts",
                     "joint rows", "member narrowphase", "member rows", "sweep kernel",
                     "obs/env overhead"], out
    res = json.loads(out[-1])
    assert [p["phase"] for p in res["phases"]] == names[:-1]
    assert all(p["ms"] > 0 and p["launches"] is None for p in res["phases"])  # CPU
    assert res["sweep_rows"] == 1896 and res["sweep_calls"] == 2
    assert "(1896 rows, 1 iters)" in out[-3]
    env, phys = res["phases"][0]["ms"], res["phases"][1]["ms"]
    assert abs(res["obs_env_overhead_ms"] - (env - phys)) < 1e-9

"""The benchmark's reading of a device trace, on a hand-built chrome trace:
the phases' window, busy time and kernels as before the program's spans
were kept, and :meth:`Trace.launched_in` against the port's own
``train.profiling.span_table`` for every span; and the span names the
metric readers read, against the names the program opens."""

from __future__ import annotations

import importlib
import json
import pathlib

import pytest

from evomotion_tpu_torch.train import profiling as P
from portbench import trace as tr

# host spans (name, start, end), microseconds: two phases, program spans
# nested in them (two physics steps, the second with nested phases), and a
# user annotation that is no program span
SPANS = [("rollout", 0, 100), ("rollout.policy", 0, 10), ("env.step", 10, 60),
         ("physics.step", 20, 50), ("physics.sweep", 30, 40), ("env.step", 60, 95),
         ("physics.step", 62, 90), ("physics.member", 63, 70), ("physics.integrate", 80, 90),
         ("update", 100, 150), ("update.actor", 110, 140),
         ("Optimizer.step#Adam.step", 120, 130)]
# (correlation, launch time or None, device category, device start, end)
DEVICE = [(1, 5, "kernel", 6, 8), (2, 25, "kernel", 26, 30), (3, 35, "kernel", 36, 46),
          (4, 55, "kernel", 56, 58), (5, 96, "kernel", 97, 99),
          (6, 72, "gpu_memcpy", 76, 78), (7, None, "kernel", 80, 85),
          (8, 121, "kernel", 121, 130), (9, 145, "kernel", 146, 149),
          (10, 36, "gpu_memset", 47, 48), (11, 64, "kernel", 100, 104),
          (12, 90, "kernel", 104, 106), (13, 62, "kernel", 63, 64), (14, 85, "kernel", 86, 88)]


def _hand_trace(path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a, "tid": 1}
          for n, a, b in SPANS]
    for c, t, cat, a, b in DEVICE:
        if t is not None:
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
                       "dur": 1, "tid": 1, "args": {"correlation": c}})
        ev.append({"ph": "X", "cat": cat, "name": f"k{c}", "ts": a, "dur": b - a, "tid": 7,
                   "args": {"correlation": c}})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 150, "tid": 1})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


@pytest.fixture
def hand(tmp_path):
    path = tmp_path / "trace.json"
    _hand_trace(path)
    return str(path)


def test_phases_read_as_before(hand):
    """The window, the busy time and the kernels inside a phase come from
    the two phases alone, whatever program spans the trace holds."""
    t = tr._read(hand)
    assert [e.name for e in t.spans] == ["rollout", "update"]
    assert t.window() == (0.0, 150.0) and t.window_s() == pytest.approx(150e-6)
    # the union of the device's intervals: 2+4+10+1+2+2+2+5+9+3+4+2+1+2 us
    assert t.busy_s() == pytest.approx(49e-6)
    # kernels that ran on the card inside each phase's interval
    assert t.kernels_in("rollout") == 8 and t.kernels_in("update") == 4
    assert {e.name for e in t.program_spans} == {n for n, *_ in SPANS} - {"rollout", "update"}
    assert len(t.launches) == sum(c[1] is not None for c in DEVICE)


def test_launched_in_agrees_with_the_span_table(hand):
    """Kernels and device seconds launched inside each span, its nested
    spans included, as the port's span table charges them."""
    rows = P.span_table(hand)["rows"]
    t = tr._read(hand)
    names = {n for n, *_ in SPANS if n in P.SPANS or n in P.PHASES}
    assert names <= set(rows)
    for name in names:
        kernels, seconds = t.launched_in(name)
        assert kernels == rows[name]["kernels_in"], name
        assert seconds * 1e3 == pytest.approx(rows[name]["device_ms_in"]), name
    # by hand: the two physics steps launched kernels 2, 3, 13, 11 and 14,
    # the fill and the copy (21 + 1 + 2 us); a launch at a span's end
    # (kernel 12 at 90) is outside it, one at its start (13 at 62) inside
    assert t.launched_in("physics.step") == (5, pytest.approx(24e-6))
    assert t.launched_in("physics.member") == (1, pytest.approx(4e-6))
    assert t.launched_in("no.such.span") == (0, 0.0)


def _reader_spans():
    out = {}
    for p in sorted((pathlib.Path(tr.__file__).parent / "metrics").glob("[a-z]*.py")):
        mod = importlib.import_module(f"portbench.metrics.{p.stem}")
        if hasattr(mod, "SPAN"):
            out[p.stem] = mod.SPAN
    return out


def test_readers_read_spans_the_program_opens():
    """Every span or phase a metric reader reads is one the program opens, so
    renaming a span in the program fails here instead of silently leaving
    the metric out."""
    spans = _reader_spans()
    assert {"physics_launches_per_step", "launches_per_env_step", "rollout_step_ms",
            "update_ms", "launches_per_update"} <= set(spans)
    assert tr.PHASES == P.PHASES
    for reader, name in spans.items():
        assert name in P.SPANS or name in P.PHASES, (reader, name)

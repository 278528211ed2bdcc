"""The port's program spans (``train.profiling.span``) and the reader that
charges a chrome trace's card work and idle time to them
(``train.profiling.span_table``), on the CPU.

The spider runs at B=2 with a two-step horizon inside
``tools.rehearsal.small_walker`` (one settle frame per loop, one solver
iteration): the span tree of one batched PPO-GAE iteration and of the
set-up before it, read from a CPU ``torch.profiler`` trace and from the
recorder, and the step's outputs with the spans on and off. The reader is
checked on a hand-built trace against a brute-force count and against the
benchmark's own reading of idle time and rollout launches.
"""

import contextlib
import json

import pytest
import torch

from evomotion_tpu_torch.envs.robot import RobotWalkFactory
from evomotion_tpu_torch.tools.rehearsal import small_walker
from evomotion_tpu_torch.train import ppo_batched, ppo_liquid_batched
from evomotion_tpu_torch.train import profiling as P
from evomotion_tpu_torch.train.driver import make_batched_trainer

B, T, EPOCH = 2, 2, 2
PARAMS = {
    "ppo_gae": {"hidden_size": "16", "horizon": str(T), "epoch": str(EPOCH)},
    "ppo_gae_liquid": {"neuron_number": "8", "unfolding_steps": "2", "horizon": str(T),
                       "epoch": str(EPOCH)},
}
# each span's parent: the spans with no parent open at top level
PARENT = {
    "env.observe": "env.step", "env.autoreset": "env.step",
    "physics.contacts": "physics.step", "physics.joint_rows": "physics.step",
    "physics.contact_rows": "physics.step", "physics.member": "physics.step",
    "physics.sweep": "physics.step", "physics.integrate": "physics.step",
}
PHYSICS_PARENTS = {"env.step", "env.reset"}


def _build(agent, seed=5):
    params = {**PARAMS[agent], "seed": str(seed)}
    trainer, horizon, _, _ = make_batched_trainer(seed, RobotWalkFactory({}), params, B,
                                                  agent, "cpu")
    assert horizon == T
    return trainer


def _spans(path):
    """(name, start, end) of every program span in a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"] in P.SPANS]


def _parent(span, spans):
    """The innermost other span that holds ``span``."""
    name, a, b = span
    holders = [s for s in spans if s is not span and s[1] <= a and b <= s[2]]
    return min(holders, key=lambda s: s[2] - s[1])[0] if holders else None


def test_span_is_the_shared_no_op_when_nothing_records(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert P._recorder is None and not torch.autograd._profiler_enabled()
    assert P.span("env.step") is P.span("physics.step", block_on=torch.device("cpu"))
    with P.span("env.step"):
        torch.ones(2).add_(1)
    assert calls == []

    timer = P.StepTimer()
    with P.recording(timer):
        with P.span("env.step", block_on=torch.device("cpu")):
            with P.span("physics.step"):
                pass
    assert calls == [] and P._recorder is None
    assert dict(timer.counts) == {"env.step": 1, "physics.step": 1}
    assert timer.totals["env.step"] >= timer.totals["physics.step"] >= 0.0

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("env.step"):
            pass
    assert calls == ["env.step"]


@pytest.mark.parametrize("agent", ["ppo_gae", "ppo_gae_liquid"])
def test_span_tree_of_one_iteration(agent, tmp_path):
    """Set-up and one iteration under a CPU profiler and a recorder: every
    span of the table but ``kernels.build`` (no nvcc runs on the CPU), the
    same calls in the trace as in the recorder, each span under its
    parent."""
    timer = P.StepTimer()
    with small_walker(3), P.trace(str(tmp_path)), P.recording(timer):
        trainer = _build(agent)
        state = trainer.init()
        state, metrics = trainer.train_step_fn()(state)
    assert torch.isfinite(metrics.actor_loss)
    settle = trainer.env.settle_total
    spans = _spans(tmp_path / "trace.json")
    calls = {}
    for name, _, _ in spans:
        calls[name] = calls.get(name, 0) + 1
    physics = ("physics.contacts", "physics.joint_rows", "physics.contact_rows",
               "physics.member", "physics.sweep", "physics.integrate")
    want = {"setup.trainer": 1, "env.reset": 1, "rollout.policy": T, "env.step": T,
            "env.observe": T, "env.autoreset": T, "physics.step": settle + T,
            **dict.fromkeys(physics, settle + T), "update.gae": 1,
            "update.actor": EPOCH, "update.critic": EPOCH}
    assert calls == want
    assert dict(timer.counts) == want
    assert set(want) == set(P.SPANS) - {"kernels.build"}

    parents = {}
    for s in spans:
        parents.setdefault(s[0], []).append(_parent(s, spans))
    for name, got in parents.items():
        if name == "physics.step":
            assert got.count("env.step") == T and got.count("env.reset") == settle
            assert set(got) == PHYSICS_PARENTS
        else:
            assert set(got) == {PARENT.get(name)}, (name, got)


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in _flat(y)]
    return []


@pytest.mark.parametrize("agent", ["ppo_gae", "ppo_gae_liquid"])
def test_outputs_bit_identical_with_spans_on_and_off(agent, tmp_path):
    """One iteration and one more env step from the same seed, with the
    profiler and the recorder on and with both off: the same bits."""
    outs = []
    for on in (False, True):
        with small_walker(3), contextlib.ExitStack() as spans_on:
            if on:
                spans_on.enter_context(P.trace(str(tmp_path)))
                spans_on.enter_context(P.recording(P.StepTimer()))
            trainer = _build(agent)
            state = trainer.init()
            state, metrics = trainer.train_step_fn()(state)
            act = torch.linspace(-1, 1, B * trainer.env.action_size).reshape(B, -1)
            env_out = trainer.env.step(state.env_state, act, state.generator)
        params = [p.detach().clone() for m in (state.actor, state.critic)
                  for p in m.parameters()]
        outs.append(_flat(tuple(metrics)) + _flat(tuple(env_out)) + params
                    + _flat(tuple(state.env_state)) + [state.obs])
    off, on = outs
    assert len(off) == len(on) > 20
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("agent,module", [("ppo_gae", ppo_batched),
                                          ("ppo_gae_liquid", ppo_liquid_batched)])
def test_benchmark_hook_targets_are_kept(agent, module, monkeypatch):
    """The benchmark's adapter wraps the env's ``step`` (an instance
    attribute over the method), the trainer's ``_update``, the module-level
    ``_step`` of both PPO trainers and the optimizers' step hooks: each is
    still where it was and still called."""
    counts = {"env": 0, "update": 0, "opt": 0, "hook": 0}
    with small_walker(3):
        trainer = _build(agent)
        state = trainer.init()
        env, orig_step, orig_update = trainer.env, trainer.env.step, trainer._update
        orig_opt = module._step

        def step(*a):
            counts["env"] += 1
            return orig_step(*a)

        def update(*a):
            counts["update"] += 1
            return orig_update(*a)

        def opt_step(*a):
            counts["opt"] += 1
            return orig_opt(*a)

        def hook(*_):
            counts["hook"] += 1

        env.step, trainer._update = step, update
        monkeypatch.setattr(module, "_step", opt_step)
        handle = state.actor_opt.register_step_post_hook(hook)
        trainer.train_step_fn()(state)
        handle.remove()
    assert counts == {"env": T, "update": 1, "opt": 2 * EPOCH, "hook": EPOCH}


# -- the reader, on a hand-built trace -------------------------------------

# host spans (name, start, end), microseconds: two phases, program spans
# nested in them
SPANS = [("rollout", 0, 100), ("rollout.policy", 0, 10), ("env.step", 10, 60),
         ("physics.step", 20, 50), ("physics.sweep", 30, 40), ("update", 100, 150),
         ("update.actor", 110, 140), ("Optimizer.step#Adam.step", 120, 130)]
# (correlation, launch time or None, device category, device start, end)
DEVICE = [(1, 5, "kernel", 6, 8), (2, 25, "kernel", 26, 30), (3, 35, "kernel", 36, 46),
          (4, 55, "kernel", 56, 58), (5, 70, "kernel", 71, 75),
          (6, 72, "gpu_memcpy", 76, 78), (7, None, "kernel", 80, 85),
          (8, 121, "kernel", 121, 130), (9, 145, "kernel", 146, 149),
          (10, 36, "gpu_memset", 47, 48)]


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


def _brute(t):
    """The label of host instant ``t`` (innermost span, phases as
    ``(<phase> self)``) and whether the card is busy there."""
    open_ = [s for s in SPANS if s[1] <= t < s[2] and (s[0] in P.SPANS
                                                         or s[0] in ("rollout", "update"))]
    if not open_:
        label = P.UNATTRIBUTED
    else:
        name = min(open_, key=lambda s: s[2] - s[1])[0]
        label = name if name in P.SPANS else f"({name} self)"
    busy = any(a <= t < b for _, _, _, a, b in DEVICE)
    return label, busy


def test_span_table_charges_launches_and_idle_to_the_innermost_span(tmp_path):
    path = tmp_path / "trace.json"
    _hand_trace(path)
    table = P.span_table(str(path))
    rows = table["rows"]
    # kernels to the span open at their launch, whatever the card's clock
    assert {k: r["kernels"] for k, r in rows.items() if r["kernels"]} == {
        "rollout.policy": 1, "physics.step": 1, "physics.sweep": 1, "env.step": 1,
        "(rollout self)": 1, P.UNATTRIBUTED: 1, "update.actor": 1, "(update self)": 1}
    assert rows["physics.step"]["kernels_in"] == 2 and rows["env.step"]["kernels_in"] == 3
    assert rows["rollout.policy"]["device_ms"] == pytest.approx(2e-3)
    # the sweep's kernel and the fill it launched, though both ran after it closed
    assert rows["physics.sweep"]["device_ms"] == pytest.approx(11e-3)
    assert rows["(rollout self)"]["device_ms"] == pytest.approx(6e-3)  # kernel and copy
    assert rows[P.UNATTRIBUTED]["device_ms"] == pytest.approx(5e-3)  # no launch in the trace
    assert rows["physics.step"]["calls"] == 1
    assert rows["env.step"]["host_ms"] == pytest.approx(50e-3)
    assert "Optimizer.step#Adam.step" not in rows

    # idle: every instant of the window, by brute force at each microsecond
    want = {}
    for t in range(0, 150):
        label, busy = _brute(t + 0.5)
        if not busy:
            want[label] = want.get(label, 0) + 1e-3
    got = {k: r["idle_ms"] for k, r in rows.items() if r["idle_ms"]}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k]), k
    assert table["window_ms"] == pytest.approx(0.150)
    assert sum(got.values()) == pytest.approx(table["idle_ms"])
    assert rows["physics.step"]["idle_ms_in"] == pytest.approx(
        rows["physics.step"]["idle_ms"] + rows["physics.sweep"]["idle_ms"])

    # the benchmark's reading of the same trace: device idle and the
    # kernels inside the rollout phase
    from portbench import trace as bench_trace

    tr = bench_trace._read(str(path))
    idle_pct = 100.0 * (1.0 - tr.busy_s() / tr.window_s())
    assert 100.0 * table["idle_ms"] / table["window_ms"] == pytest.approx(idle_pct)
    in_rollout = sum(r["kernels"] for k, r in rows.items()
                     if k in ("rollout.policy", "env.step", "physics.step", "physics.sweep",
                              "(rollout self)", P.UNATTRIBUTED))
    assert in_rollout == tr.kernels_in("rollout") == rows["(rollout self)"]["kernels"] + \
        rows["rollout.policy"]["kernels_in"] + rows["env.step"]["kernels_in"] + \
        rows[P.UNATTRIBUTED]["kernels"]


def test_span_table_command_prints_the_rows(tmp_path, capsys):
    path = tmp_path / "trace.json"
    _hand_trace(path)
    assert P.main([str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("window 0.150 ms")
    labels = [line[:22].strip() for line in out[2:]]
    assert set(labels) == set(P.span_table(str(path))["rows"])
    assert P.main([]) == 2

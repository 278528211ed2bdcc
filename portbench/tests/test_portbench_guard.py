"""The whole-name check for JAX modules, the reference's independence from
the program, and the command's refusal to run without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness


def test_banned_names_compare_whole():
    mods = {"jax": object(), "jaxlib.xla": object(), "evomotion_tpu.physics": object(),
            "flax": object(), "evomotion_tpu_torch.envs": object(), "jaxtyping": object(),
            "numpy": object(), "blocked": None}
    assert harness.banned_modules(mods) == ["evomotion_tpu", "flax", "jax", "jaxlib"]
    assert harness.banned_modules({"evomotion_tpu_torch": object(), "jax": None}) == []


def test_reference_imports_neither_jax_nor_the_program():
    """The reference and everything it imports load with ``jax``, the JAX
    package and the port blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'evomotion_tpu', 'evomotion_tpu_torch'):\n"
            "    sys.modules[m] = None\n"
            "import portbench.reference.compare, portbench.counts.sweep\n"
            "import portbench.counts.member, portbench.counts.networks\n"
            "import portbench.counts.agents.ppo_gae, portbench.counts.agents.ppo_gae_liquid\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_harness_run_loads_no_jax():
    """Importing the harness, its metrics and adapters and the port they
    drive loads no module the benchmark forbids."""
    code = ("import sys, importlib, pathlib\n"
            "from portbench import harness, trace\n"
            "for p in pathlib.Path('portbench/metrics').glob('[a-z]*.py'):\n"
            "    importlib.import_module('portbench.metrics.' + p.stem)\n"
            "import portbench.trainers.ppo_gae, portbench.trainers.ppo_gae_liquid\n"
            "import evomotion_tpu_torch.train.driver, evomotion_tpu_torch.envs.robot\n"
            "print(harness.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_the_command_fails_without_a_card():
    """No CPU fallback: without a card the command exits non-zero and prints
    no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cmd = [sys.executable if w == "python3" else w for w in bench["command"]]
    out = subprocess.run(cmd + ["--workload", bench["workloads"][0]["name"], "--seed", "1",
                                "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr

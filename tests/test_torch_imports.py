"""The port runs where JAX is not installed: importing it, every module
under it (the ``tools`` subpackage of profilers and walker tools, the
networks, the agents, the replay buffers and the trainers too, the liquid
tier's among them), and
chip_smoke.py
must import neither ``jax`` nor any module of the JAX package
``evomotion_tpu``."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import evomotion_tpu_torch
names = [m.name for m in pkgutil.walk_packages(evomotion_tpu_torch.__path__,
                                               "evomotion_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "evomotion_tpu" or m.startswith("evomotion_tpu.")
             or (m.startswith("jax") and sys.modules[m] is not None))
print(len(names), bad)
assert not bad, bad
assert {"evomotion_tpu_torch.tools.prof_kernel",
        "evomotion_tpu_torch.tools.prof_step",
        "evomotion_tpu_torch.tools.eval_walk",
        "evomotion_tpu_torch.tools.train_walk",
        "evomotion_tpu_torch.networks.modules",
        "evomotion_tpu_torch.networks.distributions",
        "evomotion_tpu_torch.train.checkpoint",
        "evomotion_tpu_torch.train.metrics",
        "evomotion_tpu_torch.train.profiling",
        "evomotion_tpu_torch.train.ppo_batched",
        "evomotion_tpu_torch.train.offpolicy_batched",
        "evomotion_tpu_torch.buffers.replay",
        "evomotion_tpu_torch.agents.soft_actor_critic",
        "evomotion_tpu_torch.agents.cross_q",
        "evomotion_tpu_torch.agents.actor_critic",
        "evomotion_tpu_torch.agents.ppo_vanilla",
        "evomotion_tpu_torch.agents.ppo_gae",
        "evomotion_tpu_torch.agents.factory",
        "evomotion_tpu_torch.envs.robot",
        "evomotion_tpu_torch.envs.registry",
        "evomotion_tpu_torch.train.onpolicy_step_batched",
        "evomotion_tpu_torch.train.driver",
        "evomotion_tpu_torch.tools.train_offpolicy_cartpole",
        "evomotion_tpu_torch.tools.train_walk_offpolicy",
        "evomotion_tpu_torch.networks.liquid",
        "evomotion_tpu_torch.agents.liquid_agents",
        "evomotion_tpu_torch.train.ppo_liquid_batched"} <= set(names), names
"""


def test_port_and_chip_smoke_import_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 15, res.stdout

"""The port's data parallelism over the env batch (``parallel.mesh``) against
the JAX package's sharded train step, on the CPU.

The ranks are spawned processes of a gloo group (``tests/torch_dp_ranks.py``,
which imports no ``jax``); the JAX side runs in this process on the 8
virtual devices of ``tests/conftest.py``, as ``tests/test_parallel.py``
runs it.

(a) ``BatchedPpo`` at W = 1, 2 and 4 ranks against JAX's
``shard_train_state`` + jitted ``train_step_fn()`` on an 8-device mesh, on
``tests/test_torch_ppo.py``'s tiny deterministic env (N=16, T=8, hidden 16,
2 epochs, obs normalization, the sigma scale, the entropy decay and the
survival bonus on). JAX's init state reaches the ranks through its
checkpoint files, JAX's uniforms [T, N, A] with each rank taking its
columns. The tolerances are test_torch_ppo.py's: metrics at 1e-5, the
actor at 1e-6 with its Adam moments at 1e-4 of each tensor's largest
magnitude, the critic by its last-epoch rule (trap 11: the first epoch's
output-bias gradients are f32 noise that Adam's first step turns into
+-lr), but for the critic's loss, held at tests/test_parallel.py's rtol
1e-4 (see the test). The ranks' networks and optimizer states are
bit-equal.
(d) W=1 under a mesh is the one-process trainer, bit for bit.
(e) W must divide N.
(f) ``torch.distributed.run`` of the worker (``tools/multihost_worker.py``)
on cartpole exits 0 with equal checksums on both ranks.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import test_torch_ppo as TP
import torch_dp_ranks as R

from evomotion_tpu.parallel.mesh import make_env_mesh, shard_train_state
from evomotion_tpu.train import ppo_batched as JP
from evomotion_tpu_torch.parallel import mesh as M
from evomotion_tpu_torch.train import ppo_batched as PP

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """JAX's toy PPO: the init state, one sharded train step and its
    metrics, and the sharded step with one epoch fewer (the critic's
    last-epoch rule), the two states saved by the JAX package."""
    d = tmp_path_factory.mktemp("jax_ppo")
    trainer = JP.BatchedPpo(TP.JaxToyEnv(), JP.PpoConfig(**TP.CFG), seed=3)
    prev_trainer = JP.BatchedPpo(TP.JaxToyEnv(), JP.PpoConfig(**dict(TP.CFG, epoch=1)), seed=3)
    s0 = trainer.init()
    step = jax.jit(trainer.train_step_fn())
    mesh = make_env_mesh(jax.devices()[:8])
    with mesh:
        s1, m1 = step(shard_train_state(s0, mesh))
        prev, _ = jax.jit(prev_trainer.train_step_fn())(shard_train_state(s0, mesh))
        jax.block_until_ready((s1, prev))
    assert len(s1.obs.sharding.device_set) == 8
    single, _ = step(s0)
    gap = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree.leaves(s1.actor_params), jax.tree.leaves(single.actor_params)))
    print(f"JAX sharded vs unsharded step: actor params differ by {gap:.3e}")
    JP.save_train_state(str(d / "start"), s0)
    JP.save_train_state(str(d / "prev"), prev)
    np.save(d / "uniforms.npy", TP._uniforms(s0).numpy())
    return s0, s1, m1, d


def test_toy_env_is_test_torch_ppo_s():
    for name in ("W", "U", "C", "X0"):
        np.testing.assert_array_equal(getattr(R, name), getattr(TP, name))
    assert (R.N, R.T, R.S, R.A, R.PPO_CFG) == (TP.N, TP.T, TP.S, TP.A, TP.CFG)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ppo_on_w_ranks_matches_jax_sharded_step(world, jax_sharded, tmp_path):
    s0, s1, m1, d = jax_sharded
    R.spawn("ppo_toy", world, tmp_path, str(d / "start"), str(d / "prev"),
            str(d / "uniforms.npy"), str(tmp_path))
    assert len({(tmp_path / f"sum1_{r}").read_text() for r in range(world)}) == 1

    def fresh():
        return PP.BatchedPpo(R.TorchToyEnv(), PP.PpoConfig(**TP.CFG), seed=0).init()

    with np.load(tmp_path / "m1.npz") as m:
        pm = PP.PpoMetrics(**{k: torch.as_tensor(m[k]) for k in m.files})
    for f in JP.PpoMetrics._fields:
        if f != "critic_loss":
            TP._close(getattr(pm, f), getattr(m1, f))
    # the critic's loss is the mean over epochs, the second one run by a
    # critic whose trap-11 biases moved by +-lr in the first: JAX's own
    # sharded step parts from its unsharded one there (its critic by 2.5e-4),
    # so the loss falls back to tests/test_parallel.py's rtol 1e-4
    print(f"critic loss: port {float(pm.critic_loss)}, JAX sharded {float(m1.critic_loss)}")
    np.testing.assert_allclose(float(pm.critic_loss), float(m1.critic_loss), rtol=1e-4)
    pstate = PP.load_train_state(str(tmp_path / "r1"), fresh())
    TP._compare_after_update(pstate, s1, s0, TP.CFG["epoch"])
    TP._close(pstate.obs, s1.obs)
    np.testing.assert_array_equal(pstate.ep_steps.numpy(), np.asarray(s1.ep_steps))
    last = PP.load_train_state(str(tmp_path / "r2"), fresh())
    TP._compare_net(last.critic, last.critic_opt, s1.critic_params, s1.critic_opt_state)


@pytest.mark.parametrize("kind", ["ppo_gae", "cross_q"])
def test_one_rank_mesh_is_the_one_process_trainer(kind, tmp_path):
    R.spawn("trainers", 1, tmp_path, [kind], 2, str(tmp_path))
    ref, ref_metrics = R.run_trainer(kind, 2)
    with np.load(tmp_path / f"{kind}.npz") as got:
        np.testing.assert_array_equal(got["metrics"], ref_metrics.numpy())
        want = R.state_arrays(ref)
        assert set(got.files) == set(want) | {"metrics"}
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_ranks_must_divide_the_env_batch():
    state = PP.BatchedPpo(R.TorchToyEnv(), PP.PpoConfig(**TP.CFG), seed=0).init()
    with pytest.raises(ValueError, match="do not split evenly"):
        M.shard_train_state(state, M.EnvMesh(None, 0, 3, torch.device("cpu")))
    shard = M.shard_train_state(state, M.EnvMesh(None, 1, 4, torch.device("cpu")))
    assert shard.obs.shape[0] == 4 and shard.env_state[0].shape[0] == 4
    assert shard.actor is state.actor and state.obs.shape[0] == 16


def test_collectives_are_identities_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert M.current() is None
    assert M.psum(x) is x and M.gather_env([x], 0)[0] is x
    gen = torch.Generator().manual_seed(1)
    u = M.env_rand((4, 2), gen, "cpu")
    assert torch.equal(u, torch.rand((4, 2), generator=torch.Generator().manual_seed(1)))


def test_worker_under_torchrun_on_two_cpu_ranks(tmp_path):
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "evomotion_tpu_torch.tools.multihost_worker", "--env", "cartpole",
           "--algo", "ppo_gae", "--num_envs", "8", "--iterations", "2", "--device", "cpu",
           "--agent_parameters", "hidden_size=16", "horizon=8", "epoch=2",
           "--check-update", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=60,
                         stdin=subprocess.DEVNULL)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = sorted((json.loads(x) for x in res.stdout.splitlines() if x.startswith('{"rank"')),
                   key=lambda x: x["rank"])
    assert [x["rank"] for x in lines] == [0, 1]
    a, b = lines
    assert a["checksums"] == b["checksums"] and len(a["checksums"]) == 2
    assert (a["world"], a["backend"], a["local_envs"]) == (2, "gloo", 4)
    assert all(np.isfinite(a["losses"]).flat) and a["losses"] == b["losses"]
    assert max(a["update_check"].values()) <= 1e-5, a["update_check"]
    assert {"actor.npz", "critic.npz", "actor_optimizer.npz",
            "critic_optimizer.npz"} <= set(os.listdir(out / "save_0"))
    state = PP.load_train_state(str(out / "train"), R.make_trainer("ppo_gae").init())
    assert state.iteration == 2 and state.obs.shape[0] == 8

"""Rank processes of the data-parallel tests (``tests/test_torch_parallel*.py``).

Each test spawns W processes (``torch.multiprocessing``, the ``spawn`` start
method) that join a gloo group at ``file://<tmp>/store`` (so that parallel
test workers never share a TCP port), make the port's env mesh on the CPU,
run one job of :data:`JOBS` and write what they computed under the test's
``tmp_path``; the test process compares it. This module imports no ``jax``:
the ranks run the port alone, as on the card's machine.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from evomotion_tpu_torch.convert import adam_tree, load_adam
from evomotion_tpu_torch.envs.cartpole import CartPoleFactory
from evomotion_tpu_torch.parallel import mesh as M
from evomotion_tpu_torch.physics.batched import BatchedStep
from evomotion_tpu_torch.tools.multihost_worker import checksum, networks_tree
from evomotion_tpu_torch.train import offpolicy_batched as PO
from evomotion_tpu_torch.train import onpolicy_step_batched as PS
from evomotion_tpu_torch.train import ppo_batched as PP
from evomotion_tpu_torch.train import ppo_liquid_batched as PL
from evomotion_tpu_torch.train.checkpoint import _flatten, load_component

# -- the tiny deterministic env of tests/test_torch_ppo.py (its torch half) -------

S, A, N, T, H = 4, 2, 16, 8, 16
_rng = np.random.default_rng(42)
W = (_rng.standard_normal((S, S)) * 0.6).astype(np.float32)
U = (_rng.standard_normal((S, A)) * 0.8).astype(np.float32)
C = (_rng.standard_normal(S) * 0.1).astype(np.float32)
X0 = np.array([0.1, -0.2, 0.3, 0.05], np.float32)
WIN_AT, FAIL_BELOW = 5, -0.3
PPO_CFG = dict(hidden_size=H, horizon=T, n_envs=N, epoch=2, obs_norm=True, sigma_scale_end=0.5,
               sigma_scale_steps=4, entropy_steps=4, entropy_end=1e-3, survival_bonus=0.05)


class Res(NamedTuple):
    obs: object
    reward: object
    done: object
    valid: object
    win: object


class TorchToyEnv:
    """test_torch_ppo.py's env, batch first, on the CPU."""

    observation_size, action_size = S, A
    device = torch.device("cpu")

    def reset(self, n_envs, generator=None):
        x = torch.as_tensor(X0).expand(n_envs, S).clone()
        z = torch.zeros(n_envs, dtype=torch.int32)
        true = torch.ones(n_envs, dtype=torch.bool)
        return (x, z, z.clone()), Res(x, torch.zeros(n_envs), ~true, true, ~true)

    def step(self, state, a, generator=None):
        x, t, settle = state
        settling = settle > 0
        xn = torch.tanh(x @ torch.as_tensor(W).T + a @ torch.as_tensor(U).T + torch.as_tensor(C))
        r = xn[:, 0] - 0.1 * (a * a).sum(-1)
        tn = t + 1
        win = tn >= WIN_AT
        done = win | (xn[:, 1] < FAIL_BELOW)
        x0 = torch.as_tensor(X0).expand_as(x)
        run = (torch.where(done[:, None], x0, xn), torch.where(done, 0, tn),
               torch.where(done, 1, 0).to(torch.int32))
        sets = (x, t, settle - 1)
        new = (torch.where(settling[:, None], sets[0], run[0]),
               *(torch.where(settling, s, r_) for s, r_ in zip(sets[1:], run[1:])))
        res = Res(torch.where(settling[:, None], x, xn), torch.where(settling, 0.0, r),
                  ~settling & done, ~settling, ~settling & win)
        return new, res


# -- spawning ---------------------------------------------------------------------


def _rank(rank, world, store, job, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        JOBS[job](M.make_env_mesh("cpu"), *args)
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, tmp, *args) -> None:
    """Runs ``JOBS[job](mesh, *args)`` on ``world`` spawned ranks of a gloo
    group; raises if a rank fails."""
    store = os.path.join(str(tmp), f"store_{job}_{world}")
    mp.start_processes(_rank, args=(world, store, job, args), nprocs=world, join=True,
                       start_method="spawn")


def _save(path, **arrays):
    np.savez(path, **{k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                      for k, v in arrays.items()})


def carry_arrays(state) -> dict:
    """The replicated networks and optimizer states as ``{path: array}``."""
    return _flatten(networks_tree(state))


# -- (a) PPO against JAX's sharded step --------------------------------------------


def ppo_toy(mesh, start, prev, uniforms, out):
    """One train step of the toy PPO from the state in ``start`` (JAX's,
    saved by the JAX package), each rank on its rows and its columns of
    the uniforms: rank 0 writes the gathered state to ``out/r1`` and the
    metrics to ``out/m1.npz``; every rank its checksum. Then the same step
    with the critic overwritten by ``prev``'s after its first epoch (the
    last-epoch rule of test_torch_ppo.py), rank 0 writing ``out/r2``."""
    rows = mesh.rows(N)
    u = torch.as_tensor(np.load(uniforms))[:, rows]
    trainer = PP.BatchedPpo(TorchToyEnv(), PP.PpoConfig(**PPO_CFG), seed=0)

    def run(trainer):
        state = M.shard_train_state(PP.load_train_state(start, trainer.init()), mesh)
        with mesh:
            state, metrics = trainer.train_step_fn()(state, u)
        return M.unshard_train_state(state, mesh), metrics

    state, metrics = run(trainer)
    with open(os.path.join(out, f"sum1_{mesh.rank}"), "w") as f:
        f.write(checksum(state))
    if mesh.rank == 0:
        PP.save_train_state(os.path.join(out, "r1"), state)
        _save(os.path.join(out, "m1.npz"), **metrics._asdict())

    own, steps = trainer.critic_step, []

    def critic_step(state, *a):
        loss = own(state, *a)
        steps.append(loss)
        if len(steps) == PPO_CFG["epoch"] - 1:
            load_component(prev, "train_critic_params", state.critic)
            load_adam(state.critic_opt, state.critic, load_component(
                prev, "train_critic_opt_state", adam_tree(state.critic_opt, state.critic)))
        return loss

    trainer.critic_step = critic_step
    state, _ = run(trainer)
    if mesh.rank == 0:
        PP.save_train_state(os.path.join(out, "r2"), state)


# -- (b) SAC and CrossQ ---------------------------------------------------------------

OFF_N, OFF_T, OFF_B = 8, 8, 16
OFF_CFG = dict(actor_hidden_size=16, critic_hidden_size=16, batch_size=OFF_B, epoch=2,
               train_every=4, steps_per_iter=OFF_T, n_envs=OFF_N, buffer_capacity=OFF_N * OFF_T * 4)
CARTPOLE = {"reset_frame_nb": "2"}


def cartpole(mt_parity=True):
    """test_torch_offpolicy_parity.py's port cartpole: the batched step with
    f32 rows (with the mt19937 reset table, or drawing its resets from the
    trainer's generator)."""
    env = CartPoleFactory(CARTPOLE).make(1234, mt_parity=mt_parity, device="cpu",
                                         per_env_step=False)
    env.model = dataclasses.replace(env.model, row_dtype="f32")
    env.physics_step = BatchedStep(env.model, env.physics_step.dt, "cpu")
    return env


def offpolicy_on_jax(mesh, algo, job, out):
    """One iteration of the port's SAC or CrossQ from JAX's init carry, on
    JAX's transitions (each rank its rows) with JAX's draws (the rollout's:
    each rank its columns), as test_torch_offpolicy_parity.py's second run:
    rank 0 writes the ring, the carry, the metrics, the sampled indices and
    the final obs; every rank its checksum."""
    data = torch.load(job, weights_only=False)
    rows = mesh.rows(OFF_N)
    env = cartpole()
    trainer = PO.BatchedOffPolicy(env, algo, PO.OffPolicyConfig(**OFF_CFG), seed=0)
    state = M.shard_train_state(trainer.init(), mesh)
    state.agent.load_carry_tree(data["carry"])
    results = iter([type(r)(*(x[rows] for x in r)) for r in data["results"]])
    env.step = lambda st, action, generator=None: (st, next(results))
    picked = []

    def sample(ring, cdf, total, u):
        idx, batch = PO.BatchedOffPolicy.sample(ring, cdf, total, u)
        picked.append(idx)
        return idx, batch

    trainer.sample = sample
    draws = data["draws"]
    with mesh:
        state, metrics = trainer.train_step_fn()(state, draws._replace(
            rollout=draws.rollout[:, rows]))
    full = M.unshard_train_state(state, mesh)
    with open(os.path.join(out, f"sum_{mesh.rank}"), "w") as f:
        f.write(checksum(state))
    if mesh.rank == 0:
        ring = full.ring
        _save(os.path.join(out, "run.npz"), **{f"ring_{f}": getattr(ring, f) for f in
                                               ("obs", "action", "reward", "done", "next_obs",
                                                "valid")},
              cursor=ring.cursor, filled=ring.filled,
              picked=torch.stack(picked), obs=full.obs, prev_valid=full.prev_valid,
              ep_steps=full.ep_steps, **{f"m_{k}": v for k, v in metrics._asdict().items()},
              **{f"carry/{k}": v for k, v in carry_arrays(full).items()})


# -- (b), (c), (d): the port at W ranks against its own one-process run ---------------

LIQ = dict(neurons=8, unfolding_steps=3)


def make_trainer(kind, mt_parity=False):
    """A trainer of each kind on cartpole drawing its resets from the
    trainer's generator."""
    env = cartpole(mt_parity)
    if kind in ("soft_actor_critic", "cross_q"):
        return PO.BatchedOffPolicy(env, kind, PO.OffPolicyConfig(**OFF_CFG), seed=0)
    if kind == "soft_actor_critic_liquid":
        return PO.BatchedOffPolicyLiquid(env, PO.OffPolicyLiquidConfig(
            **{**OFF_CFG, "buffer_capacity": OFF_N * OFF_T * 4}, **LIQ), seed=0)
    if kind in ("actor_critic", "ppo_vanilla"):
        return PS.BatchedStepTrainer(env, kind, PS.StepTrainerConfig(
            hidden_size=16, batch_size=OFF_B, epoch=2, train_every=4, steps_per_iter=OFF_T,
            n_envs=OFF_N, buffer_capacity=OFF_N * OFF_T * 4), seed=0)
    if kind == "ppo_gae_liquid":
        return PL.BatchedPpoLiquid(env, PL.PpoLiquidConfig(
            horizon=OFF_T, n_envs=OFF_N, epoch=2, **LIQ), seed=0)
    return PP.BatchedPpo(env, PP.PpoConfig(hidden_size=16, horizon=OFF_T, n_envs=OFF_N,
                                           epoch=2), seed=0)


def run_trainer(kind, iterations, mesh=None):
    """``iterations`` train steps of :func:`make_trainer`'s ``kind``, sharded
    over ``mesh`` where given: (gathered state, metrics of each step). On one
    CPU thread, as every rank runs (the thread count can change the
    rounding of a reduction)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _run_trainer(kind, iterations, mesh)
    finally:
        torch.set_num_threads(threads)


def _run_trainer(kind, iterations, mesh):
    trainer = make_trainer(kind)
    if mesh is None:
        step, state = trainer.train_step_fn(), trainer.init()
    else:
        step, state = M.make_sharded_train_step(trainer, mesh)
    metrics = []
    for _ in range(iterations):
        state, m = step(state)
        metrics.append(torch.stack([x.float() for x in m]))
    if mesh is not None:
        state = M.unshard_train_state(state, mesh)
    return state, torch.stack(metrics)


def state_arrays(state) -> dict:
    """The replicated networks and optimizer states, the ring (where the
    trainer has one) and the env-batch fields, as ``{name: array}``."""
    out = {f"carry/{k}": v for k, v in carry_arrays(state).items()}
    ring = getattr(state, "ring", None)
    if ring is not None:
        out.update({f"ring/{k}": v for k, v in _flatten(ring._replace(
            cursor=np.int32(ring.cursor), filled=np.int32(ring.filled))).items()})
    out["obs"] = state.obs.numpy()
    out["ep_steps"] = state.ep_steps.numpy()
    return out


def trainers(mesh, kinds, iterations, out):
    """Each trainer of ``kinds`` at W ranks for ``iterations`` steps: rank 0
    writes ``out/<kind>.npz`` (:func:`state_arrays`, metrics); every rank
    its checksum ``out/<kind>_sum_<rank>``."""
    for kind in kinds:
        state, metrics = run_trainer(kind, iterations, mesh)
        with open(os.path.join(out, f"{kind}_sum_{mesh.rank}"), "w") as f:
            f.write(checksum(state))
        if mesh.rank == 0:
            np.savez(os.path.join(out, f"{kind}.npz"), metrics=metrics.numpy(),
                     **state_arrays(state))


JOBS = {"ppo_toy": ppo_toy, "offpolicy_on_jax": offpolicy_on_jax, "trainers": trainers}

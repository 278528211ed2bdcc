"""One rank of data-parallel batched training over the env axis (the
counterpart of the repo's ``tools/multihost_worker.py`` and of
``tools/scaling_bench.py``'s child).

    python -m torch.distributed.run --standalone --nproc_per_node W \\
        -m evomotion_tpu_torch.tools.multihost_worker --env robot_walk \\
        --algo ppo_gae --num_envs N --iterations K [--agent_parameters k=v ...] \\
        [--env_parameters k=v ...] [--seed S] [--device cpu] [--backend gloo] \\
        [--out DIR] [--deterministic] [--check-update]

Each rank joins the process group (``parallel.mesh.initialize_multihost``:
NCCL on the card, gloo on the CPU or when named; two ranks on one card need
``--backend gloo``, NCCL refuses them), builds the env and the batched
trainer as ``cli ... train --num_envs N`` does (``train.driver.
make_batched_trainer``: the same agents, keys and defaults), keeps its N / W
rows of the env batch and takes K train steps. Each rank prints one JSON
line: its rank, world, backend, per iteration the losses, the global
env-steps/s (N x horizon over the step's wall time) and a sha256 of its
networks and optimizer states, the ms per iteration of the rollout and the
update (``train.profiling.StepTimer``), the sweep kernels' launch counts
(set to 0 just before the trainer's init), and for the ring trainers on
W > 1 ranks the ms that one update's replication of gradients and buffers
takes alone (one broadcast per optimizer, ``mesh.replicate``, timed over 5
updates' worth). Rank 0 alone writes ``--out``:
``save_0/`` in the CLI's layout, and for ``ppo_gae`` the full train state
gathered from every rank (``train/``, ``ppo_batched.save_train_state``).

``--no-mesh`` runs the same steps in one process without a process group:
the one-process trainer the ranks are held to. ``--deterministic`` turns on
``torch.use_deterministic_algorithms`` (the batched step is not
reproducible run to run without it). ``--check-update`` (``ppo_gae``) also
runs the last iteration's update once more outside the mesh, on the whole
trajectory gathered from every rank and a copy of the networks and Adam
states it started from, and prints the largest difference from the sharded
update's parameters and losses.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch


def _arrays(tree):
    """The numpy arrays of a tree (dicts, sequences, tensors, arrays,
    numbers), depth first."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _arrays(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for x in tree for a in _arrays(x)]
    if torch.is_tensor(tree):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


def networks_tree(state):
    """What the ranks replicate, as numpy trees: the PPOs' actor and critic
    with their Adam states, else the agent's JAX carry (parameters, Adam
    states, BatchRenorm statistics, target critics)."""
    from ..convert import adam_tree, params_tree

    if hasattr(state, "agent"):
        return state.agent.carry_tree()
    return tuple((params_tree(m), adam_tree(o, m))
                 for m, o in ((state.actor, state.actor_opt), (state.critic, state.critic_opt)))


def checksum(state) -> str:
    h = hashlib.sha256()
    for a in _arrays(networks_tree(state)):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def replicate_ms(agent, mesh, reps: int = 5) -> float:
    """ms per update of the broadcasts that ``agents.base.ComponentAgent.
    _step`` makes inside ``mesh``: one per optimizer of ``agent``, of its
    module's gradients and f32 buffers."""
    from ..parallel.mesh import replicate

    groups = []
    for name in sorted(n[:-4] for n in vars(agent) if n.endswith("_opt")):
        module = getattr(agent, name)
        groups.append([p.detach().clone() for p in module.parameters()]
                      + [b.clone() for b in module.buffers() if b.dtype == torch.float32])
    dev = groups[0][0].device
    with mesh:
        replicate(groups[0])  # warm
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            for g in groups:
                replicate(g)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps * 1e3


class UpdateCheck:
    """Wraps a ``BatchedPpo``'s update: each call also gathers the rollout
    and the final observations from every rank and copies the networks and
    Adam states it starts from; :meth:`compare` then runs the one-process
    update on them (outside any mesh) and returns the largest |difference|
    from the sharded update's parameters and losses."""

    def __init__(self, trainer):
        from ..parallel.mesh import gather_env
        from ..train.ppo_batched import Trajectory

        own = trainer._update
        self.own, self.last = own, None

        def update(state, traj, it):
            pre = copy.deepcopy((state.actor, state.critic, state.actor_opt, state.critic_opt))
            stats = [state.obs_mean.clone(), state.obs_var.clone(), state.obs_count.clone()]
            full = Trajectory(*gather_env(traj, 1))
            last_obs = gather_env([state.obs], 0)[0]
            metrics = own(state, traj, it)
            self.last = (state, pre, stats, full, last_obs, it, metrics)
            return metrics

        trainer._update = update

    def compare(self) -> dict:
        state, (actor, critic, a_opt, c_opt), stats, traj, last_obs, it, metrics = self.last
        ref = copy.copy(state)
        ref.actor, ref.critic, ref.actor_opt, ref.critic_opt = actor, critic, a_opt, c_opt
        ref.obs_mean, ref.obs_var, ref.obs_count = stats
        ref.obs = last_obs
        ref_metrics = self.own(ref, traj, it)

        def diff(a, b):
            return max(float((p.detach() - q.detach()).abs().max())
                       for p, q in zip(a.parameters(), b.parameters()))

        return {"actor": diff(state.actor, actor), "critic": diff(state.critic, critic),
                "losses": max(abs(float(metrics.actor_loss) - float(ref_metrics.actor_loss)),
                              abs(float(metrics.critic_loss) - float(ref_metrics.critic_loss)))}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("multihost_worker", description=__doc__.split("\n")[0])
    ap.add_argument("--env", required=True)
    ap.add_argument("--algo", required=True)
    ap.add_argument("--num_envs", type=int, required=True, help="the global env batch N")
    ap.add_argument("--iterations", type=int, default=1)
    ap.add_argument("--seed", type=int, default=1234, help="the env seed (and agent seed)")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--backend", default=None, help="default: nccl on the card, gloo on cpu")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-mesh", action="store_true",
                    help="one process without a process group: the reference run")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--check-update", action="store_true")
    return ap


def main(argv=None) -> int:
    from ..cli import _extract_kv_flags
    from ..device import resolve
    from ..envs.registry import get_environment_factory
    from ..kernels import sweep, sweep_envlast, sweep_fat
    from ..parallel import mesh as M
    from ..train.driver import make_batched_trainer
    from ..train.ppo_batched import BatchedPpo, save_train_state
    from ..train.profiling import StepTimer

    agent_kv, env_kv, rest = _extract_kv_flags(list(sys.argv[1:] if argv is None else argv))
    args = build_parser().parse_args(rest)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    if args.no_mesh:
        dev, mesh = resolve(args.device), None
        rank, world, backend = 0, 1, None
    else:
        dev = M.initialize_multihost(backend=args.backend, device=args.device)
        mesh = M.make_env_mesh(dev)
        rank, world = mesh.rank, mesh.world
        backend = torch.distributed.get_backend()
    trainer, horizon, critic_loss, save = make_batched_trainer(
        args.seed, get_environment_factory(args.env, env_kv), agent_kv, args.num_envs,
        args.algo, dev)
    check = None
    if args.check_update:
        if not isinstance(trainer, BatchedPpo):
            raise SystemExit("--check-update takes the plain batched PPO (ppo_gae)")
        check = UpdateCheck(trainer)
    kernels = {"sweep_envlast_slim": sweep.KERNEL, "solver_sweep": sweep_fat.KERNEL,
               "solver_sweep_envlast": sweep_envlast.KERNEL}
    for k in kernels.values():
        k.launches = 0
    timer = StepTimer()
    if mesh is None:
        step, state = trainer.train_step_fn(timer=timer), trainer.init()
    else:
        step, state = M.make_sharded_train_step(trainer, mesh, timer=timer)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, rates, sums = [], [], []
    for _ in range(args.iterations):
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state)
        sync()
        wall = time.perf_counter() - t0
        losses.append([float(metrics.actor_loss), float(critic_loss(metrics))])
        rates.append(horizon * args.num_envs / wall)
        sums.append(checksum(state))
    line = {"rank": rank, "world": world, "backend": backend, "device": str(dev),
            "env": args.env, "algo": args.algo, "num_envs": args.num_envs,
            "local_envs": state.obs.shape[0], "horizon": horizon, "losses": losses,
            "env_steps_s": rates, "checksums": sums,
            "phase_ms": {k: timer.totals[k] / timer.counts[k] * 1e3 for k in timer.counts},
            "launches": {name: k.launches for name, k in kernels.items()}}
    if mesh is not None and world > 1 and hasattr(state, "agent"):
        line["replicate_ms_per_update"] = replicate_ms(state.agent, mesh)
    if check is not None:
        line["update_check"] = check.compare()
    # one write: the ranks share the launcher's stdout, and a pipe keeps a
    # write of up to 4,096 bytes whole
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (json.dumps(line) + "\n").encode())

    if args.out:
        full = state if mesh is None else M.unshard_train_state(state, mesh)
        if rank == 0:
            save(os.path.join(args.out, "save_0"), state)
            if isinstance(trainer, BatchedPpo):
                save_train_state(os.path.join(args.out, "train"), full)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

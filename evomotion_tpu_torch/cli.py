"""Command-line interface of the port (mirrors ``evomotion_tpu/cli.py``).

The reference CLI surface (src/main.cpp:25-152):

    python -m evomotion_tpu_torch.cli cli <env> <agent> [--agent_parameters k=v ...]
        [--env_parameters k=v ...] [--env_seed N] run <save_dir> [--episodes N]

    python -m evomotion_tpu_torch.cli cli robot_walk ppo_gae --num_envs 2048
        [--agent_parameters k=v ...] train <out_dir> [-e ITERS_PER_SAVE] [-n SAVES]

``run`` is ported (the sequential tier: one world, the per-env physics step,
on the card), and so are ``train --num_envs N`` with N > 1 for ``ppo_gae``,
``ppo_gae_liquid``, ``actor_critic``, ``ppo_vanilla``, ``soft_actor_critic``,
``soft_actor_critic_liquid`` and ``cross_q`` (the batched tier:
``train.driver.train_batched``) and the sequential ``train``
(``--num_envs 1``, ``train.driver.train``) for every learning agent of the
reference (those and ``actor_critic_liquid``); ``run`` then loads the
trained agent, a ``ppo_gae`` or ``ppo_gae_liquid`` checkpoint of the
batched tier too. ``gui`` and run's viewer options (--record, --html,
--live) parse but raise NotImplementedError naming their ROADMAP item
(A11). --cuda and --env_num_threads are accepted for surface parity and
ignored.
"""

from __future__ import annotations

import argparse
import sys


def _extract_kv_flags(argv: list[str]) -> tuple[dict[str, str], dict[str, str], list[str]]:
    """Pull `--agent_parameters k=v ...` / `--env_parameters k=v ...` groups
    out of argv before argparse sees it: a greedy nargs='*' would otherwise
    swallow the `train`/`run` subcommand. A group ends at the first token
    without '=' (the reference's argparse lib scans the same way)."""
    agent: dict[str, str] = {}
    env: dict[str, str] = {}
    rest: list[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("--agent_parameters", "--env_parameters"):
            target = agent if tok == "--agent_parameters" else env
            i += 1
            while i < len(argv) and "=" in argv[i] and not argv[i].startswith("--"):
                k, v = argv[i].split("=", 1)
                target[k] = v
                i += 1
        else:
            rest.append(tok)
            i += 1
    return agent, env, rest


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("evomotion_tpu_torch")
    sub = parser.add_subparsers(dest="mode", required=True)

    cli = sub.add_parser("cli", help="train or run an agent")
    cli.add_argument("env_name")
    cli.add_argument("agent_name")
    cli.add_argument("--env_seed", type=int, default=1234)
    cli.add_argument("--env_num_threads", type=int, default=8)  # parity; unused
    cli.add_argument("--cuda", action="store_true")  # parity; unused
    cli.add_argument("--num_envs", type=int, default=1)
    cli_sub = cli.add_subparsers(dest="action", required=True)

    train_p = cli_sub.add_parser("train")
    train_p.add_argument("output_path")
    train_p.add_argument("-e", "--episodes", type=int, default=1000)
    train_p.add_argument("-n", "--nb_saves", type=int, default=100)

    run_p = cli_sub.add_parser("run")
    run_p.add_argument("input_path")
    run_p.add_argument("-w", "--width", type=int, default=1024)
    run_p.add_argument("-h2", "--height", type=int, default=1024)
    run_p.add_argument("--episodes", type=int, default=1)
    run_p.add_argument("--record", default=None, help="record trajectory .npz")
    run_p.add_argument("--html", default=None,
                       help="also render the recording into a self-playing HTML viewer")
    run_p.add_argument("--live", action="store_true", help="serve a live view at --port")
    run_p.add_argument("--port", type=int, default=8800)

    gui_p = sub.add_parser("gui", help="web robot-builder editor")
    gui_p.add_argument("--port", type=int, default=8801)
    gui_p.add_argument("--robot", default=None)
    gui_p.add_argument("--workspace", default=None)
    gui_p.add_argument("--max-requests", type=int, default=None)
    return parser


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line) and run it on ``device``
    (default ``cuda``; the tests pass ``"cpu"``)."""
    argv = sys.argv[1:] if argv is None else argv
    agent_kv, env_kv, rest = _extract_kv_flags(list(argv))
    args = build_parser().parse_args(rest)
    if args.mode == "gui":
        raise NotImplementedError("gui (the web robot builder) is not ported yet (ROADMAP A11)")

    from .agents.factory import get_agent_factory
    from .envs.registry import get_environment_factory

    agent_factory = get_agent_factory(args.agent_name, agent_kv)
    env_factory = get_environment_factory(args.env_name, env_kv)
    from .train.driver import infer, train, train_batched

    if args.action == "train":
        if args.num_envs > 1:
            return train_batched(args.env_seed, env_factory, agent_kv, args.num_envs,
                                 args.episodes, args.nb_saves, args.output_path,
                                 agent_name=args.agent_name, device=device)
        return train(args.env_seed, agent_factory, env_factory, args.episodes, args.nb_saves,
                     args.output_path, device=device)
    if args.live or args.html:
        raise NotImplementedError("run --live / --html are not ported yet (ROADMAP A11)")

    return infer(args.env_seed, agent_factory, env_factory, args.input_path,
                 episodes=args.episodes, record_path=args.record, device=device)


if __name__ == "__main__":
    sys.exit(main())

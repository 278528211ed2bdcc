"""Long-run robot_walk training with the batched off-policy tier, SAC or
CrossQ (port of ``tools/train_walk_offpolicy.py``).

    python -m evomotion_tpu_torch.tools.train_walk_offpolicy OUT [--algo cross_q]
        [--iters 4000] [--n-envs 256] [--critic-hidden 1024] [--grad-clip 1.0] ...

The reference's own shipped walk artifact is CrossQ
(resources/robot_walk_crossq_save_34/), and its GUI infer window hardcodes
CrossQAgent(actor_hidden=256, critic_hidden=1024, batch=128, epoch=1,
lr=3e-4, gamma=0.99) for robot_walk inference
(src/gui/widget/infer/infer_settings.cpp:56-59). The defaults are the JAX
tool's: 256 envs x 64 steps per iteration, actor hidden 256, critic hidden
1,024, batch 256, 4 updates per train event and one event per env step
(256 gradient steps per iteration), lr 3e-4, gamma 0.99, tau 0.005, a
1,048,576-transition ring, and the nan guard always on.

Every run writes OUT/config.json and OUT/curve.csv rows:
  iter,env_steps,grad_steps,wall_s,r_per_step,ep_len,win_rate,
  actor_loss,critic_loss,greedy_len,greedy_return,greedy_win,greedy_win_alt
Greedy eval = the deterministic policy clip(mu, -1, 1) on ``--eval-envs``
fresh envs for the full 1800-step win horizon (``tools.eval_walk``), under
``--eval-order`` and ``--eval-order-alt``. The agent's components land in
OUT/save_<iter>/ every ``--save-every`` iterations, with a rolling full
train state (the ring included) in OUT/save_latest_full/; OUT/save_final/
keeps the best agent by greedy win rate. ``--resume SAVE_DIR`` reloads the
agent and refills the ring for ``--refill-iters`` iterations without
updates; ``--resume-full DIR`` restores a full train state exactly.
``--order-cycle`` cycles solver row orders per iteration. Runs on the card
unless given ``--device cpu`` (or ``main(..., device="cpu")``).
"""

from __future__ import annotations

import argparse
import copy
import csv
import dataclasses
import json
import os
import sys
import time

import torch

from ..device import resolve
from ..envs.robot import RobotWalkFactory
from ..train.offpolicy_batched import BatchedOffPolicy, OffPolicyConfig
from .eval_walk import greedy_action, greedy_eval

WIN_STEPS = 1800
CURVE_COLUMNS = [
    "iter", "env_steps", "grad_steps", "wall_s", "r_per_step", "ep_len",
    "win_rate", "actor_loss", "critic_loss", "greedy_len",
    "greedy_return", "greedy_win", "greedy_win_alt",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out")
    p.add_argument("--algo", default="cross_q", choices=["cross_q", "soft_actor_critic"])
    p.add_argument("--iters", type=int, default=4000)
    p.add_argument("--n-envs", type=int, default=256)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--epoch", type=int, default=4,
                   help="sampled batches per train event (reference epoch)")
    p.add_argument("--train-every", type=int, default=1,
                   help="env time-steps between train events")
    p.add_argument("--steps-per-iter", type=int, default=64)
    p.add_argument("--buffer", type=int, default=1 << 20)
    p.add_argument("--tau", type=float, default=0.005)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--actor-hidden", type=int, default=256)
    p.add_argument("--critic-hidden", type=int, default=1024)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--save-every", type=int, default=250)
    p.add_argument("--eval-envs", type=int, default=64)
    p.add_argument("--resume", default=None, help="save dir to reload the agent from")
    p.add_argument("--resume-full", default=None,
                   help="save_full dir (exact resume incl. the replay ring)")
    p.add_argument("--refill-iters", type=int, default=16,
                   help="ring-refill iterations (no updates) after a params-only "
                        "--resume, so the critic never trains on a near-empty ring")
    p.add_argument("--order-cycle", default="",
                   help="comma list of solver row orders cycled per iteration")
    p.add_argument("--eval-order", default="canonical")
    p.add_argument("--eval-order-alt", default="scheduled")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="optional global grad-norm clip")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve(args.device or device)
    os.makedirs(args.out, exist_ok=True)
    env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev, per_env_step=False)

    def env_variant(order):
        e = copy.copy(env)
        e.model = dataclasses.replace(env.model, row_order=order)
        return e

    orders = [o for o in args.order_cycle.split(",") if o] or [env.model.row_order]
    solver_meta = {
        "row_orders": orders,
        "eval_order": args.eval_order,
        "eval_order_alt": args.eval_order_alt,
        "row_dtype": env.model.row_dtype,
    }
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump({**vars(args), "win_steps": WIN_STEPS, **solver_meta, "env": "robot_walk",
                   "tier": "offpolicy_batched"}, f, indent=1)
    cfg = OffPolicyConfig(
        actor_hidden_size=args.actor_hidden, critic_hidden_size=args.critic_hidden,
        batch_size=args.batch_size, epoch=args.epoch, learning_rate=args.lr,
        gamma=args.gamma, tau=args.tau, train_every=args.train_every,
        steps_per_iter=args.steps_per_iter, n_envs=args.n_envs,
        buffer_capacity=args.buffer, grad_norm_clip=args.grad_clip, nan_guard=True,
    )
    trainers = [BatchedOffPolicy(env_variant(o), args.algo, cfg, seed=args.seed)
                for o in orders]
    trainer = trainers[0]
    train_steps = [t.train_step_fn() for t in trainers]
    state = trainer.init()
    if args.resume_full:
        state = trainer.load_full(args.resume_full, state)
        print(f"full-resume from {args.resume_full} at it {state.iteration}", flush=True)
    elif args.resume:
        state.agent = trainer.load_carry(args.resume)
        print(f"resumed the agent from {args.resume}; refilling the ring for "
              f"{args.refill_iters} iters (no updates)", flush=True)
        refill = trainer.train_step_fn(learn=False)
        for _ in range(args.refill_iters):
            state, _ = refill(state)

    eval_envs = {o: env_variant(o) for o in (args.eval_order, args.eval_order_alt)}

    def policy(obs):
        return greedy_action(state.agent.actor, obs)

    def save_final(score, it):
        d = os.path.join(args.out, "save_final")
        trainer.save(d, state)
        with open(os.path.join(d, "meta.json"), "w") as mf:
            json.dump({**solver_meta, "greedy_win": score, "iter": it, "seed": args.seed,
                       "algo": args.algo}, mf, indent=1)

    curve_path = os.path.join(args.out, "curve.csv")
    new = not os.path.exists(curve_path)
    best_win = -1.0
    t0 = time.time()
    egen = torch.Generator(device=dev).manual_seed(args.seed + 777)
    with open(curve_path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(CURVE_COLUMNS)
        for it in range(1, args.iters + 1):
            state, m = train_steps[(it - 1) % len(train_steps)](state)
            if it % 10 == 0 or it == 1:
                mm = type(m)(*(float(x) for x in m))
                grad_steps = it * trainer.updates_per_iter * cfg.epoch
                glen = gret = gwin = gwin_alt = ""
                if it % args.eval_every == 0 or it == 1:
                    r = greedy_eval(eval_envs[args.eval_order], policy, args.eval_envs,
                                    WIN_STEPS, egen)
                    r_alt = greedy_eval(eval_envs[args.eval_order_alt], policy,
                                        args.eval_envs, WIN_STEPS, egen)
                    glen = float(r.steps.float().mean())
                    gret = float(r.ret.mean())
                    gwin = float(r.won.float().mean())
                    gwin_alt = float(r_alt.won.float().mean())
                    score = min(gwin, gwin_alt) if args.order_cycle else gwin
                    if score > best_win:
                        best_win = score
                        save_final({"eval_order": gwin, "alt": gwin_alt}, it)
                steps_done = it * cfg.steps_per_iter * cfg.n_envs
                w.writerow([
                    it, steps_done, grad_steps, round(time.time() - t0, 1),
                    round(mm.mean_reward, 5), round(mm.mean_ep_len, 1),
                    round(mm.win_rate, 4), round(mm.actor_loss, 5),
                    round((mm.critic_1_loss + mm.critic_2_loss) / 2, 5),
                    glen, gret, gwin, gwin_alt,
                ])
                f.flush()
                print(
                    f"it {it} steps {steps_done:.2e} grad {grad_steps} "
                    f"r/step {mm.mean_reward:.4f} ep_len {mm.mean_ep_len:.0f} "
                    f"win {mm.win_rate:.3f} greedy_len {glen} greedy_win {gwin} "
                    f"alt {gwin_alt}", flush=True,
                )
            if it % args.save_every == 0 or it == args.iters:
                trainer.save(os.path.join(args.out, f"save_{it}"), state)
                # rolling exact-resume checkpoint (ring included) for crash recovery
                trainer.save_full(os.path.join(args.out, "save_latest_full"), state)
    print("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Long-run robot_walk PPO training with learning-curve and greedy-eval
logging (port of ``tools/train_walk.py``).

    python -m evomotion_tpu_torch.tools.train_walk OUT [--iters 3000] [--n-envs 2048]
        [--obs-norm 1] [--survival-bonus 0.02] [--order-cycle scheduled] ...

The BASELINE parity config (BASELINE.md): seed 1234, hidden 256, gamma .99,
lambda .95, epsilon .2, epoch 8, lr 1e-3, entropy 0.01, critic 0.5, grad
clip 0.5, on the batched tier (n_envs lockstep, fixed-horizon rollouts).
Knobs: ``--entropy-steps`` decays the entropy bonus to 1e-4;
``--obs-norm`` turns on running observation normalization;
``--sigma-end/--sigma-steps`` anneal the sampling-std scale; ``--horizon``
sets the rollout length; ``--survival-bonus`` adds a constant per valid step
inside GAE; ``--gamma`` sets the discount; ``--order-cycle`` is a comma list
of solver row orders (canonical / scheduled / shuffled:<seed>) cycled every
``--order-block`` iterations. Greedy evals run under ``--eval-order`` and
``--eval-order-alt``.

Every run writes OUT/config.json and OUT/curve.csv rows:
  iter,env_steps,wall_s,r_per_step,ep_return,ep_len,win_rate,actor_loss,
  critic_loss,greedy_len,greedy_return,greedy_win,greedy_win_alt
(greedy_* from a deterministic-mu eval over the 1800-step win horizon every
``--eval-every`` iterations). Full train states go to OUT/save_<k>/ every
``--save-every`` iterations, and OUT/save_final/ keeps the best one by the
primary order's greedy win rate, with the solver metadata and the score in
its meta.json. ``--resume DIR`` continues from a train state saved by this
tool or by the JAX one. Runs on the card unless ``main`` is given
``device="cpu"``.
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
from ..train.ppo_batched import (
    BatchedPpo,
    PpoConfig,
    load_train_state,
    normalize_obs,
    save_train_state,
)
from .eval_walk import greedy_action, greedy_eval

WIN_STEPS = 1800
CURVE_COLUMNS = [
    "iter", "env_steps", "wall_s", "r_per_step", "ep_return", "ep_len",
    "win_rate", "actor_loss", "critic_loss", "greedy_len",
    "greedy_return", "greedy_win", "greedy_win_alt",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out")
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--n-envs", type=int, default=2048)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--entropy", type=float, default=0.01)
    p.add_argument("--entropy-steps", type=int, default=0)
    p.add_argument("--obs-norm", type=int, default=0)
    p.add_argument("--sigma-end", type=float, default=1.0)
    p.add_argument("--sigma-steps", type=int, default=0)
    p.add_argument("--survival-bonus", type=float, default=0.0)
    p.add_argument("--horizon", type=int, default=64)
    p.add_argument("--epoch", type=int, default=8)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--save-every", type=int, default=250)
    p.add_argument("--eval-envs", type=int, default=64)
    p.add_argument("--order-cycle", default="",
                   help="comma list of row orders cycled per iteration")
    p.add_argument("--order-block", type=int, default=1,
                   help="iterations per row order before cycling to the next")
    p.add_argument("--eval-order", default="canonical",
                   help="row order for the primary greedy eval")
    p.add_argument("--eval-order-alt", default="scheduled",
                   help="row order for the robustness greedy eval")
    p.add_argument("--resume", default=None, help="save dir (full train state)")
    return p


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve(device)
    os.makedirs(args.out, exist_ok=True)

    base_env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev,
                                         per_env_step=False)
    orders = [o for o in args.order_cycle.split(",") if o] or [base_env.model.row_order]

    def env_variant(order):
        e = copy.copy(base_env)
        e.model = dataclasses.replace(base_env.model, row_order=order)
        return e

    solver_meta = {
        "row_orders": orders,
        "eval_order": args.eval_order,
        "eval_order_alt": args.eval_order_alt,
        "row_dtype": base_env.model.row_dtype,
    }
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump({**vars(args), "win_steps": WIN_STEPS, "env": "robot_walk",
                   **solver_meta, "tier": "ppo_batched"}, f, indent=1)

    cfg = PpoConfig(
        hidden_size=args.hidden, gamma=args.gamma, lam=0.95, epsilon=0.2,
        entropy_factor=args.entropy, critic_loss_factor=0.5, epoch=args.epoch,
        learning_rate=args.lr, clip_grad_norm=0.5, horizon=args.horizon,
        n_envs=args.n_envs, entropy_steps=args.entropy_steps,
        obs_norm=bool(args.obs_norm), sigma_scale_end=args.sigma_end,
        sigma_scale_steps=args.sigma_steps, survival_bonus=args.survival_bonus,
    )
    trainers = [BatchedPpo(env_variant(o), cfg, seed=args.seed) for o in orders]
    train_steps = [t.train_step_fn() for t in trainers]
    state = trainers[0].init()
    if args.resume:
        state = load_train_state(args.resume, state)
        print(f"resumed from {args.resume} at iteration {state.iteration}", flush=True)

    eval_envs = {o: env_variant(o) for o in (args.eval_order, args.eval_order_alt)}

    def policy(obs):
        return greedy_action(state.actor, normalize_obs(state, obs) if cfg.obs_norm else obs)

    def save_ckpt(d, score=None, it=None):
        os.makedirs(d, exist_ok=True)
        save_train_state(d, state)
        with open(os.path.join(d, "meta.json"), "w") as mf:
            json.dump({**solver_meta, "greedy_win": score, "iter": it, "seed": args.seed},
                      mf, indent=1)

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
            state, m = train_steps[((it - 1) // args.order_block) % len(train_steps)](state)
            if it % 10 == 0 or it == 1:
                mm = type(m)(*(float(x) for x in m))
                glen = gret = gwin = gwin_alt = ""
                if it % args.eval_every == 0 or it == 1:
                    r = greedy_eval(eval_envs[args.eval_order], policy, args.eval_envs,
                                    WIN_STEPS, egen)
                    r_alt = greedy_eval(eval_envs[args.eval_order_alt], policy, args.eval_envs,
                                        WIN_STEPS, egen)
                    glen = float(r.steps.float().mean())
                    gret = float(r.ret.mean())
                    gwin = float(r.won.float().mean())
                    gwin_alt = float(r_alt.won.float().mean())
                    # rolling best-greedy checkpoint, selected by the PRIMARY
                    # order's win rate; the alt-order score is recorded too
                    if gwin > best_win:
                        best_win = gwin
                        save_ckpt(os.path.join(args.out, "save_final"),
                                  score={"eval_order": gwin, "alt": gwin_alt}, it=it)
                steps_done = it * cfg.horizon * args.n_envs
                w.writerow([
                    it, steps_done, round(time.time() - t0, 1),
                    round(mm.mean_reward, 5), round(mm.mean_episode_return, 3),
                    round(mm.mean_ep_len, 1), round(mm.win_rate, 4),
                    round(mm.actor_loss, 5), round(mm.critic_loss, 5),
                    glen, gret, gwin, gwin_alt,
                ])
                f.flush()
                print(
                    f"it {it} steps {steps_done:.2e} r/step {mm.mean_reward:.4f} "
                    f"ep_len {mm.mean_ep_len:.0f} win {mm.win_rate:.3f} "
                    f"greedy_len {glen} greedy_win {gwin} alt {gwin_alt}", flush=True,
                )
            if it % args.save_every == 0 or it == args.iters:
                save_ckpt(os.path.join(args.out, f"save_{it}"), it=it)
    print("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())

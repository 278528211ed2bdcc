"""Off-policy (SAC / CrossQ) cartpole learning curves on the batched tier
(port of ``tools/train_offpolicy_cartpole.py``).

    python -m evomotion_tpu_torch.tools.train_offpolicy_cartpole OUT [algo] [iters] [--device cpu]

``algo`` is ``soft_actor_critic`` (default) or ``cross_q``;
``soft_actor_critic_liquid`` waits for the liquid trainer (ROADMAP A7).
``iters`` defaults to 250. The JAX tool's config: 64 envs x 16 steps per
iteration, hidden 64, batch 128, one update per env step, lr 1e-3, a
16,384-transition ring, seed 1234.

Writes OUT/curve.csv: iter,env_steps,r_per_step,episodes_done,actor_loss,
critic_1_loss. The discriminative signal on cartpole is episodes_done per
iteration (the failure rate): the reward starts near its maximum because
the pole begins upright after the settle phase. The agent's components go
to OUT/save_final/. Runs on the card unless given ``--device cpu`` (or
``main(..., device="cpu")``).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

from ..device import resolve
from ..envs.cartpole import CartPoleFactory
from ..train.offpolicy_batched import BatchedOffPolicy, OffPolicyConfig

CURVE_COLUMNS = ["iter", "env_steps", "r_per_step", "episodes_done", "actor_loss",
                 "critic_1_loss"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out")
    p.add_argument("algo", nargs="?", default="soft_actor_critic",
                   choices=["soft_actor_critic", "cross_q", "soft_actor_critic_liquid"])
    p.add_argument("iters", nargs="?", type=int, default=250)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)
    if args.algo == "soft_actor_critic_liquid":
        raise NotImplementedError("the liquid SAC trainer is not ported yet (ROADMAP A7)")
    dev = resolve(args.device or device)
    os.makedirs(args.out, exist_ok=True)
    env = CartPoleFactory({}).make(1234, mt_parity=False, device=dev, per_env_step=False)
    cfg = OffPolicyConfig(
        actor_hidden_size=64, critic_hidden_size=64, batch_size=128, epoch=1,
        steps_per_iter=16, n_envs=64, buffer_capacity=16384, train_every=1,
        learning_rate=1e-3,
    )
    trainer = BatchedOffPolicy(env, args.algo, cfg, seed=1234)
    step = trainer.train_step_fn()
    state = trainer.init()
    with open(os.path.join(args.out, "curve.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CURVE_COLUMNS)
        for it in range(1, args.iters + 1):
            state, m = step(state)
            mm = type(m)(*(float(x) for x in m))
            w.writerow([
                it, it * cfg.steps_per_iter * cfg.n_envs,
                round(mm.mean_reward, 5), int(mm.episodes_done),
                round(mm.actor_loss, 5), round(mm.critic_1_loss, 5),
            ])
            if it % 50 == 0:
                print(f"{args.algo} it {it} eps/iter {mm.episodes_done:.0f} "
                      f"r/step {mm.mean_reward:.3f}", flush=True)
    trainer.save(os.path.join(args.out, "save_final"), state)
    print("DONE ->", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""PPO-GAE as the configurations state it, in plain PyTorch: done-aware
masked GAE with the published normalized-advantage returns
(ppo_gae.cpp:134-152), ``epoch`` full-batch epochs of the clipped surrogate
with an entropy bonus and of the critic's squared error, each network's
gradient clipped to a global norm (scaled only when the norm reaches the
limit), and Adam (PyTorch's defaults: betas 0.9 and 0.999, eps 1e-8).

:class:`Follower` follows the program's first training iterations: from
the benchmark's initial weights, on each trajectory that the program rolled
out (observations, actions, rewards, flags and, for the liquid networks,
the hidden states the rollout fed), it recomputes the policy's outputs,
then runs the update with its own weights and optimizer state.
"""

from __future__ import annotations

import torch

from . import dist, nets

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """Adam over a dict of leaves, updated in place."""

    def __init__(self, leaves: dict, lr: float):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    def step(self, leaves: dict, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - BETA1 ** self.t, 1.0 - BETA2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
            self.v[k].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + EPS
            leaves[k] = leaves[k] - (self.lr / bc1) * self.m[k] / denom


def clip_global(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    if float(norm) < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


def gae(values, rewards, dones, valids, bootstrap, gamma: float, lam: float):
    """values [T, N, 1], rewards / dones / valids [T, N], bootstrap [N, 1]:
    (advantages, returns, mask [T, N, 1], valid count)."""
    mask = valids[..., None].float()
    donef = dones[..., None].float()
    nxt = torch.cat([values[1:], bootstrap[None]], 0)
    deltas = (rewards[..., None] + gamma * (1.0 - donef) * nxt - values) * mask
    adv = torch.empty_like(deltas)
    g = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        g = deltas[t] + gamma * lam * (1.0 - donef[t]) * mask[t] * g
        adv[t] = g
    n = torch.clamp_min(mask.sum(), 1.0)
    mean = (adv * mask).sum() / n
    var = (((adv - mean) ** 2) * mask).sum() / torch.clamp_min(n - 1.0, 1.0)
    adv = (adv - mean) / (torch.sqrt(var) + 1e-8)
    return adv, adv + values, mask, n


class Follower:
    """The reference trainer of one configuration (``family`` ``ppo_gae``
    or ``ppo_gae_liquid``; ``agent`` its agent parameters as numbers)."""

    def __init__(self, family: str, agent: dict, actor: dict, critic: dict, mm=nets.matmul):
        self.mm = mm
        self.family = family
        self.agent = agent
        self.liquid = family == "ppo_gae_liquid"
        self.actor = {k: v.clone() for k, v in actor.items()}
        self.critic = {k: v.clone() for k, v in critic.items()}
        lr = float(agent["learning_rate"])
        self.opt_a, self.opt_c = Adam(self.actor, lr), Adam(self.critic, lr)
        self.first_grad = None  # {"actor.<leaf>": g, "critic.<leaf>": g} of the first step

    # -- forward passes -------------------------------------------------

    def pi(self, actor, obs, x=None):
        if self.liquid:
            return nets.liquid_actor(actor, x, obs, self.agent["unfolding_steps"], self.mm)
        return (*nets.mlp_actor(actor, obs, self.mm), None)

    def v(self, critic, obs, x=None):
        if self.liquid:
            return nets.liquid_critic(critic, x, obs, self.agent["unfolding_steps"], self.mm)
        return nets.mlp_critic(critic, obs, self.mm), None

    @torch.no_grad()
    def policy(self, traj: dict) -> dict:
        """The rollout's policy outputs over a trajectory under the current
        weights: ``mu``, ``sigma``, ``log_prob`` of the program's actions,
        ``value`` and, for liquid networks, the carried hidden states after
        each step (``actor_x_next``, ``critic_x_next``)."""
        mu, sigma, nax = self.pi(self.actor, traj["obs"], traj.get("actor_x"))
        value, ncx = self.v(self.critic, traj["obs"], traj.get("critic_x"))
        out = {"mu": mu, "sigma": sigma, "value": value,
               "log_prob": dist.log_pdf(traj["action"], mu, sigma)}
        if self.liquid:
            validf = traj["valid"][..., None].float()
            donef = traj["done"][..., None].float()
            out["actor_x_next"] = (1.0 - donef) * (validf * nax + (1.0 - validf) * traj["actor_x"])
            out["critic_x_next"] = (1.0 - donef) * (validf * ncx + (1.0 - validf) * traj["critic_x"])
        return out

    # -- the update ------------------------------------------------------

    def _grad_step(self, which: str, loss_fn) -> tuple[float, float]:
        leaves, opt = (self.actor, self.opt_a) if which == "actor" else (self.critic, self.opt_c)
        params = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        loss, scale = loss_fn(params)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grads = clip_global(grads, float(self.agent["clip_grad_norm"]))
        if opt.t == 0:
            self.first_grad = dict(self.first_grad or {})
            self.first_grad.update({f"{which}.{k}": g.detach().clone() for k, g in grads.items()})
        for k in leaves:
            leaves[k] = leaves[k].detach()
        opt.step(leaves, grads)
        return float(loss.detach()), float(scale)

    def update(self, traj: dict, pol: dict) -> list[tuple[float, float]]:
        """One iteration's update on ``traj`` (with ``last_obs`` [N, S], the
        observation the rollout ended on) and ``pol``, its policy outputs
        under the weights that rolled it out (:meth:`policy`). Returns, for
        each optimizer step in order (each epoch's actor step, then its
        critic step), the loss and the scale of its terms: the loss with
        each element's term taken by its magnitude, which bounds the
        rounding of a loss whose terms cancel."""
        a = self.agent
        obs, actions = traj["obs"], traj["action"]
        with torch.no_grad():
            if self.liquid:
                bootstrap, _ = self.v(self.critic, traj["last_obs"], pol["critic_x_next"][-1])
            else:
                bootstrap, _ = self.v(self.critic, traj["last_obs"])
            adv, returns, mask, n = gae(pol["value"], traj["reward"], traj["done"],
                                        traj["valid"], bootstrap, a["gamma"], a["lambda"])
        old_lp = pol["log_prob"]
        n_act = n * actions.shape[-1]
        eps, ent, cf = a["epsilon"], a["entropy_factor"], a["critic_loss_factor"]
        ax, cx = traj.get("actor_x"), traj.get("critic_x")

        def actor_loss(p):
            mu, sigma, _ = self.pi(p, obs, ax)
            ratios = torch.exp(dist.log_pdf(actions, mu, sigma) - old_lp)
            obj = (torch.minimum(ratios * adv, torch.clamp(ratios, 1.0 - eps, 1.0 + eps) * adv)
                   + ent * dist.entropy(mu, sigma))
            return -(obj * mask).sum() / n_act, (obj.detach().abs() * mask).sum() / n_act

        def critic_loss(p):
            v, _ = self.v(p, obs, cx)
            loss = cf * (((v - returns) ** 2) * mask).sum() / n
            return loss, loss.detach()

        losses = []
        for _ in range(int(a["epoch"])):
            losses.append(self._grad_step("actor", actor_loss))
            losses.append(self._grad_step("critic", critic_loss))
        return losses

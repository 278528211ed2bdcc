"""The comparison that decides ``correct`` for the PPO training cells.

The program's captures (``cap``, plain tensors on the host) hold what its
set-up iterations produced through the timed call: each iteration's
trajectory and mean losses, one env step in each of the first iterations
(the env state before it, its action and result, and the generator's states
before the step's reset draws and before the action draw), the optimizer's
state after its first step, and the weights after the iterations. ``cap["init"]`` holds the
benchmark's own initial weights, which both sides started from.

:func:`reference_outputs` works out the same quantities with the plain
reference; :func:`program_outputs` reads them from the captures; :func:`gaps`
turns a pair into the numbers compared:

- ``env_step``: the checked env steps' observations (but their angles),
  rewards, and the bodies' positions and velocities after the step, each
  column's largest gap over max(1, the column's largest magnitude), and the
  largest gap of the bodies' orientations as unit quaternions;
- ``env_flags``: env steps whose done, valid or win flag differs (exact);
- ``action``: the largest gap of the first checked step's sampled actions
  (drawn by the initial weights on both sides);
- ``policy``: over the first trajectory (rolled out by the initial weights
  that both sides share), the largest gap of the log-probability of the
  taken action, of the value and of the liquid networks' carried hidden
  states, each over 1 + the reference's magnitude;
- ``loss``: the larger gap of the first optimizer step's actor and critic
  losses, each over the scale of its terms (the loss with every element's
  term by its magnitude: the actor's terms cancel, its advantages having
  mean 0), from one set of weights on both sides; the later steps' losses
  part by PPO's clipping, which is not smooth in f32, and are kept as
  ``loss_all``, not compared;
- ``grad``: the worst leaf's gap of first-gradient norms, over the larger
  of the reference leaf's norm and the median leaf's;
- ``change``: the median leaf's gap of the weights' change over the
  iterations, each over the larger of the reference leaf's change and the
  median leaf's, among the leaves whose first gradient is at least a
  thousandth of the median leaf's (the worst leaf's is kept as
  ``change_worst``, not compared: it swings with the clipping, above).
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from . import dist, nets
from .ppo import BETA1, Follower
from .sim import engine, walk

NUMBERS = ("env_step", "env_flags", "action", "policy", "loss", "grad", "change")


def _to(d, device):
    return {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in d.items()}


def _env_state(flat: dict, device):
    phys = {k.split(".", 1)[1]: v.to(device) for k, v in flat.items() if k.startswith("physics.")}
    rest = {k: v.to(device) for k, v in flat.items() if not k.startswith("physics.")}
    return walk.RobotEnvState(physics=engine.PhysicsState(**phys), **rest)


def make_env(config: dict, device, row_dtype: str | None = None):
    """The reference env of ``config`` (its env parameters and physics)."""
    env_p = config["env_parameters"]
    ph = config["physics"]
    env = walk.RobotWalk(walk.RobotWalkParams(
        initial_remaining_seconds=float(env_p["initial_remaining_seconds"]),
        max_episode_seconds=float(env_p["max_episode_seconds"]),
        target_velocity=float(env_p["target_velocity"]),
        minimal_velocity=float(env_p["minimal_velocity"]),
        reset_frames=int(env_p["reset_frames"]),
    ), device=device)
    env.model = dataclasses.replace(env.model, row_dtype=row_dtype or ph["row_dtype"],
                                    n_iterations=int(ph["n_iterations"]),
                                    row_order=ph["row_order"])
    return env


def _generator(state, device):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def reference_outputs(config: dict, cap: dict, device, *, tf32: bool = False,
                      row_dtype: str | None = None, half: bool = False,
                      physics: bool = True) -> dict:
    """The reference's quantities on the program's inputs. ``tf32`` and
    ``row_dtype="fp8"`` compute them one precision below the
    configuration's (the control); ``half`` leaves out half of the env batch
    from the updates (a planted fault); ``physics=False`` skips the env
    steps."""
    family, agent = config["agent"], config["agent_parameters"]
    mm = nets.matmul_tf32 if tf32 else nets.matmul
    f = Follower(family, agent, _to(cap["init"]["actor"], device),
                 _to(cap["init"]["critic"], device), mm)
    env = make_env(config, device, row_dtype) if physics else None
    out = {"policy": [], "losses": [], "steps": [], "actions": []}
    if physics:
        out["angle_cols"] = angle_columns(len(env.meta.member_bodies))
    for it in cap["iterations"]:
        traj = _to(it["traj"], device)
        pol = f.policy(traj)
        keep = {"log_prob": pol["log_prob"], "value": pol["value"]}
        if f.liquid:  # the program records the carried state after each step but the last
            keep.update(actor_x_next=pol["actor_x_next"][:-1],
                        critic_x_next=pol["critic_x_next"][:-1])
        out["policy"].append({k: v.cpu() for k, v in keep.items()})
        st = it["step"]
        if st:
            t = st["t"]
            u = torch.rand(pol["mu"][t].shape, generator=_generator(st["gen_action"], device),
                           device=device)
            out["actions"].append(dist.sample(pol["mu"][t], pol["sigma"][t], u).cpu())
        if half:
            n = traj["obs"].shape[1] // 2
            traj = {k: (v[:, :n] if v.dim() > 1 and k != "last_obs" else v[:n])
                    for k, v in traj.items()}
            pol = {k: v[:, :n] for k, v in pol.items()}
        out["losses"].append(f.update(traj, pol))
        if physics and st:
            with torch.no_grad():
                state, res = env.step(_env_state(st["before"], device), st["action"].to(device),
                                      _generator(st["gen"], device))
            step = {k: getattr(res, k).cpu() for k in res._fields}
            step["state"] = {f"physics.{k}": v.cpu() for k, v in state.physics._asdict().items()}
            out["steps"].append(step)
        del traj, pol
    out["first_grad"] = {k: v.cpu() for k, v in f.first_grad.items()}
    init = {f"actor.{k}": v for k, v in cap["init"]["actor"].items()}
    init.update({f"critic.{k}": v for k, v in cap["init"]["critic"].items()})
    now = {f"actor.{k}": v.cpu() for k, v in f.actor.items()}
    now.update({f"critic.{k}": v.cpu() for k, v in f.critic.items()})
    out["change"] = {k: now[k] - init[k] for k in init}
    return out


def program_outputs(cap: dict) -> dict:
    """The same quantities as the program produced them."""
    out = {"policy": [], "losses": [], "steps": [], "actions": []}
    for it in cap["iterations"]:
        traj = it["traj"]
        pol = {"log_prob": traj["log_prob"], "value": traj["value"]}
        if "actor_x" in traj:
            # the state carried after step t is the one step t + 1 fed
            pol.update(actor_x_next=traj["actor_x"][1:], critic_x_next=traj["critic_x"][1:])
        out["policy"].append(pol)
        out["losses"].append(it["losses"])
        if it["step"]:
            out["steps"].append({**it["step"]["result"], "state": it["step"]["after"]})
            out["actions"].append(traj["action"][it["step"]["t"]])
    out["first_grad"] = {k: v / (1.0 - BETA1) for k, v in cap["first_exp_avg"].items()}
    init = {f"actor.{k}": v for k, v in cap["init"]["actor"].items()}
    init.update({f"critic.{k}": v for k, v in cap["init"]["critic"].items()})
    out["change"] = {k: cap["params_after"][k] - init[k] for k in init}
    return out


def angle_columns(members: int) -> list[int]:
    """The observation's angles: each member's yaw, pitch and roll over pi
    (19 columns per member, the root first) and the root's heading
    (column 18). They wrap at +-pi and turn fast near pitch +-pi/2; the
    step's orientations are compared as quaternions instead."""
    return [19 * m + j for m in range(members) for j in range(3)] + [18]


def _columns(step: dict, keep) -> torch.Tensor:
    st = step["state"]
    parts = [step["obs"][:, keep], step["reward"][:, None]]
    parts += [st[f"physics.{k}"].flatten(1) for k in ("pos", "lin_vel", "ang_vel")]
    return torch.cat(parts, 1).double()


def _step_gap(s: dict, r: dict, angles) -> float:
    keep = [c for c in range(r["obs"].shape[1]) if c not in set(angles)]
    cs, cr = _columns(s, keep), _columns(r, keep)
    scale = torch.clamp_min(cr.abs().max(0).values, 1.0)
    gap = float(((cs - cr).abs() / scale).max())
    qs, qr = s["state"]["physics.quat"].double(), r["state"]["physics.quat"].double()
    sign = torch.where((qs * qr).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return max(gap, float((qs * sign - qr).abs().max()))


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max()) if a.numel() else 0.0


def _leaf_gaps(side: dict, ref: dict, keys) -> list[float]:
    """Each leaf's gap of norms, over the larger of the reference leaf's
    norm and the median leaf's."""
    if any(k not in side for k in keys):
        return [float("inf")]
    norms = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(norms.values())
    return [abs(float(side[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in keys]


def gaps(side: dict, ref: dict) -> dict:
    """The numbers compared, of ``side`` (the program, or a control or a
    fault in its place) against ``ref``."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for s, r in zip(side["steps"], ref["steps"]):
        out["env_step"] = max(out["env_step"], _step_gap(s, r, ref["angle_cols"]))
        flags = (s["done"] != r["done"]) | (s["valid"] != r["valid"]) | (s["win"] != r["win"])
        out["env_flags"] += float(flags.sum())
    if not ref["steps"]:
        out["env_step"] = out["env_flags"] = None
    # the first checked step's actions: drawn by one set of weights on both sides
    out["action"] = float((side["actions"][0] - ref["actions"][0]).abs().max())
    s, r = side["policy"][0], ref["policy"][0]  # the first iteration: one set of weights
    for k in r:
        out["policy"] = max(out["policy"], _rel(s[k], r[k]))

    def rel(a, b):  # b, and a where a reference stands in: (loss, scale of its terms)
        return abs((a[0] if isinstance(a, tuple) else a) - b[0]) / max(b[1], 1e-12)

    if [len(x) for x in side["losses"]] != [len(x) for x in ref["losses"]]:
        out["loss"] = out["loss_all"] = float("inf")  # optimizer steps missing or extra
    else:
        out["loss"] = max(rel(a, b) for a, b in zip(side["losses"][0][:2], ref["losses"][0][:2]))
        out["loss_all"] = max(rel(a, b) for s, r in zip(side["losses"], ref["losses"])
                              for a, b in zip(s, r))
    grads = ref["first_grad"]
    out["grad"] = max(_leaf_gaps(side["first_grad"], grads, list(grads)))
    gnorm = {k: float(v.double().norm()) for k, v in grads.items()}
    med = statistics.median(gnorm.values())
    moved = [k for k in grads if gnorm[k] >= 1e-3 * med]
    change = _leaf_gaps(side["change"], ref["change"], moved)
    out["change"], out["change_worst"] = statistics.median(change), max(change)
    return out

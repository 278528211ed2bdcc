"""The adapter of the batched PPO-GAE trainers (plain and liquid networks).

The timed entry is the trainer that ``train.driver.make_batched_trainer``
builds for ``cli robot_walk <agent> train --num_envs N`` and the call its
``train_step_fn()`` returns. Set-up builds that one trainer, loads the
benchmark's initial weights into its networks, and drives it from the seed
through the checked iterations with the same call, capturing what the
comparison needs (:mod:`portbench.reference.compare`); the window then
continues the same state.
"""

from __future__ import annotations

import random
import time

import torch

from ..reference import compare, nets

NUMBERS = compare.NUMBERS  # the numbers compared, as limits/<cell>.json names them


def _flat_state(env_state) -> dict:
    out = {f"physics.{k}": v.detach().cpu().clone() for k, v in env_state.physics._asdict().items()}
    out.update({k: v.detach().cpu().clone() for k, v in env_state._asdict().items()
                if k != "physics"})
    return out


class Adapter:
    """One cell's trainer: :meth:`setup`, then :meth:`iteration` in the
    window, :meth:`failed`, :meth:`release`, and :meth:`readings`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.family = config["agent"]
        self.num_envs = int(traffic["num_envs"])
        self.checked = int(traffic["checked_iterations"])
        self.horizon = int(config["agent_parameters"]["horizon"])
        self.env_steps_per_iteration = self.horizon * self.num_envs
        self._steps_fns = {}
        self.metrics = []

    # -- set-up ----------------------------------------------------------

    def _build(self):
        from evomotion_tpu_torch.envs.robot import RobotWalkFactory
        from evomotion_tpu_torch.train.driver import make_batched_trainer

        c = self.config
        params = {k: str(v) for k, v in c["agent_parameters"].items()}
        params["seed"] = str(self.seed)
        factory = RobotWalkFactory({k: str(v) for k, v in c["env_parameters"].items()})
        trainer, horizon, _, _ = make_batched_trainer(self.seed, factory, params, self.num_envs,
                                                      self.family, self.device)
        model = trainer.env.model
        want = c["physics"]
        got = {"row_dtype": model.row_dtype, "n_iterations": model.n_iterations,
               "row_order": model.row_order, "solver": model.solver}
        if any(str(got[k]) != str(want[k]) for k in got) or horizon != self.horizon:
            raise RuntimeError(f"the program departs from the configuration: physics {got}, "
                               f"horizon {horizon}; the configuration states {want}, "
                               f"horizon {self.horizon}")
        return trainer

    def setup(self) -> None:
        """Builds the trainer and its state, loads the benchmark's weights
        and runs the checked iterations through the timed call."""
        self.trainer = trainer = self._build()
        self.state = state = trainer.init()
        env = trainer.env
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        specs = nets.leaves(self.family, env.observation_size, env.action_size,
                            self.config["agent_parameters"])
        init = {"actor": nets.init(specs[0], g, self.device),
                "critic": nets.init(specs[1], g, self.device)}
        state.actor.load_state_dict(init["actor"])
        state.critic.load_state_dict(init["critic"])
        self.cap = {"init": {n: {k: v.cpu() for k, v in d.items()} for n, d in init.items()},
                    "iterations": []}
        draw = random.Random(self.seed)
        steps = int(self.traffic["checked_env_steps"])
        self._check_t = [draw.randrange(1, self.horizon) if k < steps else -2
                         for k in range(self.checked)]
        undo = self._install()
        try:
            for k in range(self.checked):
                self._it, self._t = k, 0
                self.iteration()
        finally:
            undo()
        self.metrics = []
        self.cap["params_after"] = {
            f"{n}.{k}": v.detach().cpu().clone()
            for n, mod in (("actor", state.actor), ("critic", state.critic))
            for k, v in mod.state_dict().items()}

    def _install(self):
        """Wraps the env step, the update and the optimizers' first steps to
        capture what the comparison reads; returns the undo."""
        trainer, state, cap = self.trainer, self.state, self.cap
        env = trainer.env
        orig_step, orig_update = env.step, trainer._update
        pending = {}

        def step(env_state, action, generator):
            t, k = self._t, self._it
            self._t += 1
            want = self._check_t[k]
            if t == want:
                pending.update(t=t, before=_flat_state(env_state), action=action.cpu(),
                               gen=generator.get_state())
            out_state, res = orig_step(env_state, action, generator)
            if t == want - 1:
                pending["gen_action"] = generator.get_state()
            if t == want:
                pending["result"] = {f: getattr(res, f).detach().cpu() for f in res._fields}
                pending["after"] = _flat_state(out_state)
            return out_state, res

        def update(st, traj, *rest):
            keep = {f: getattr(traj, f).detach().cpu() for f in traj._fields}
            keep["last_obs"] = st.obs.detach().cpu()
            cap["iterations"].append({"traj": keep, "step": dict(pending), "losses": []})
            pending.clear()
            return orig_update(st, traj, *rest)

        first = {}

        def hook_for(name, module):
            names = {id(p): k for k, p in module.named_parameters()}

            def hook(opt, _args, _kwargs):
                if name in first:
                    return
                first[name] = {f"{name}.{names[id(p)]}": opt.state[p]["exp_avg"].detach().cpu()
                               .clone() for group in opt.param_groups for p in group["params"]}
            return hook

        handles = [state.actor_opt.register_step_post_hook(hook_for("actor", state.actor)),
                   state.critic_opt.register_step_post_hook(hook_for("critic", state.critic))]
        env.step, trainer._update = step, update
        # every optimizer step's loss, in order (the trainers' shared _step)
        from evomotion_tpu_torch.train import ppo_batched, ppo_liquid_batched

        orig_opt_step = ppo_batched._step

        def opt_step(opt, module, loss, max_norm):
            cap["iterations"][-1]["losses"].append(float(loss.detach()))
            return orig_opt_step(opt, module, loss, max_norm)

        ppo_batched._step = ppo_liquid_batched._step = opt_step

        def undo():
            ppo_batched._step = ppo_liquid_batched._step = orig_opt_step
            del env.step, trainer._update
            for h in handles:
                h.remove()
            cap["first_exp_avg"] = {k: v for d in first.values() for k, v in d.items()}

        return undo

    # -- the window --------------------------------------------------------

    def iteration(self, timer=None) -> None:
        """One call of the timed entry (rollout, then update)."""
        fn = self._steps_fns.get(id(timer))
        if fn is None:
            fn = self._steps_fns[id(timer)] = self.trainer.train_step_fn(timer=timer)
        self.state, m = fn(self.state)
        self.metrics.append(m)

    def failed(self) -> int:
        """Window iterations whose losses are not finite."""
        return sum(not (torch.isfinite(m.actor_loss) and torch.isfinite(m.critic_loss))
                   for m in self.metrics)

    def release(self) -> None:
        del self.trainer, self.state
        self._steps_fns.clear()
        self.metrics = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correct -----------------------------------------------------------

    def readings(self) -> dict:
        """The numbers compared, of the program against the reference."""
        ref = compare.reference_outputs(self.config, self.cap, self.device)
        return compare.gaps(compare.program_outputs(self.cap), ref)

    def calibration(self) -> dict:
        """What the limits are set from (``calibrate.py``), each the numbers
        compared against the reference: ``program`` (sound runs: the lower
        readings), ``control`` (the reference one precision below the
        configuration's, TF32 matrix products and J columns in fp8 e4m3, in
        the program's place) and ``half_batch`` (the reference's updates
        with half of the env batch left out, the mean over the rest: a
        planted fault); and ``reference_s``, the seconds of one reference
        run. A state left unchanged reads 1 on ``change`` by its definition
        and needs no run."""
        t0 = time.perf_counter()
        ref = compare.reference_outputs(self.config, self.cap, self.device)
        out = {"reference_s": time.perf_counter() - t0,
               "program": compare.gaps(compare.program_outputs(self.cap), ref)}
        out["control"] = compare.gaps(compare.reference_outputs(
            self.config, self.cap, self.device, tf32=True, row_dtype="fp8"), ref)
        out["half_batch"] = compare.gaps(compare.reference_outputs(
            self.config, self.cap, self.device, half=True, physics=False), ref)
        return out

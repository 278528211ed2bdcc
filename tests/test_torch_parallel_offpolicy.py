"""The port's ring trainers and liquid PPO-GAE under data parallelism over
the env batch (``parallel.mesh``), on the CPU, the ranks spawned as in
``tests/test_torch_parallel.py`` (``tests/torch_dp_ranks.py``).

(b) SAC and CrossQ at W=2 against the JAX package's unsharded train step on
``tests/test_torch_offpolicy_parity.py``'s setup (cartpole with f32 rows,
N=8, T=8, batch 16, 2 epochs of 2 update events): on JAX's transitions,
each rank its rows, and JAX's draws, each rank its columns of the
rollout's, the gathered ring, the agent's whole carry, the metrics and the
final state agree at that test's 1e-5 and the sampled indices exactly
(JAX's own slow ``test_dp_offpolicy_matches_single_device`` equates its
sharded step with this unsharded one). Then 3 iterations on the port's own
cartpole, its resets drawn from the generator: the gathered ring equals the
one-process ring entry for entry, the carry agrees within 1e-6, and the two
replicas are bit-equal.
(c) Liquid PPO-GAE (1 iteration), A2C, PPO-vanilla and liquid SAC (3
iterations each) at W=2 against the port's own one-process run on the same
seed, within 1e-6; liquid PPO-GAE's critic as
tests/test_torch_liquid_batched.py holds it (trap 11: its output bias's
first-epoch gradient is f32 noise that Adam turns into +-lr, which every
critic parameter inherits from the second epoch on, so the critic is held
within 2 lr per epoch, its loss and Adam moments not held). The replicas
are bit-equal. The ring trainers update on the gathered, replicated batch, so
only the sharded rollouts' f32 rounding can part them from one process.
"""

import jax
import numpy as np
import pytest
import torch
import test_torch_offpolicy_parity as OP
import torch_dp_ranks as R

from evomotion_tpu.train import offpolicy_batched as JO
from evomotion_tpu.train.checkpoint import _flatten as jflatten
from evomotion_tpu_torch.train import offpolicy_batched as PO
from evomotion_tpu_torch.train.checkpoint import _unflatten_like

OWN_TOL = 1e-6  # the port against itself; OP.TOL (1e-5) against JAX


def _ranks_agree(tmp_path, name, world=2):
    sums = {(tmp_path / f"{name}_{r}").read_text() for r in range(world)}
    assert len(sums) == 1, f"the replicas' {name} checksums differ: {sums}"


@pytest.mark.parametrize("algo", ["soft_actor_critic", "cross_q"])
def test_offpolicy_on_two_ranks_matches_jax(algo, tmp_path):
    assert (R.OFF_N, R.OFF_T, R.OFF_B, R.OFF_CFG, R.CARTPOLE) == (
        OP.N, OP.T, OP.B, OP.CFG, OP.ENV)
    jenv, tenv = OP._envs()
    jtrainer = JO.BatchedOffPolicy(jenv, algo, JO.OffPolicyConfig(**OP.CFG), seed=0)
    agent = PO.BatchedOffPolicy(tenv, algo, PO.OffPolicyConfig(**OP.CFG), seed=0).make_agent()
    n_updates = 2 * OP.CFG["epoch"]
    js0 = jtrainer.init()
    js1, jm = jax.jit(jtrainer.train_step_fn())(js0)
    jring = js1.ring
    draws = OP._jax_draws(js0.key, n_updates, tenv.action_size)
    weights = jring.valid.at[(jring.cursor - 1) % jtrainer.capacity].set(0.0)
    cdf = jax.numpy.cumsum(weights)
    jidx = [np.asarray(jax.numpy.searchsorted(cdf, u.numpy() * cdf[-1], side="left"))
            for u in draws.sample]
    job = tmp_path / "job.pt"
    torch.save({"carry": _unflatten_like(jflatten(js0.carry), agent.carry_tree()),
                "draws": draws, "results": OP._jax_transitions(jenv, js0)}, job)

    R.spawn("offpolicy_on_jax", 2, tmp_path, algo, str(job), str(tmp_path))
    _ranks_agree(tmp_path, "sum")
    with np.load(tmp_path / "run.npz") as got:
        for f in ("obs", "action", "reward", "done", "next_obs", "valid"):
            OP._close(got[f"ring_{f}"], getattr(jring, f), f"ring {f}")
        assert (int(got["cursor"]), int(got["filled"])) == (OP.N * OP.T, OP.N * OP.T)
        np.testing.assert_array_equal(got["picked"], np.stack(jidx))
        ref = jflatten(js1.carry)
        assert {k for k in got.files if k.startswith("carry/")} == {f"carry/{k}" for k in ref}
        for k in ref:
            OP._close(got[f"carry/{k}"], ref[k], k)
        for f in PO.OffPolicyMetrics._fields:
            OP._close(got[f"m_{f}"], getattr(jm, f), f)
        OP._close(got["obs"], js1.obs, "obs")
        np.testing.assert_array_equal(got["prev_valid"], np.asarray(js1.prev_valid))
        np.testing.assert_array_equal(got["ep_steps"], np.asarray(js1.ep_steps))


def _against_one_process(tmp_path, kinds, iterations, critic_atol=None):
    """``kinds`` at W=2 against the one-process run: everything within
    OWN_TOL, but with ``critic_atol`` the PPO critic's parameters
    (``carry/1/0/...``) within it and its Adam moments (``carry/1/1/...``)
    not held, as tests/test_torch_liquid_batched.py holds them."""
    R.spawn("trainers", 2, tmp_path, kinds, iterations, str(tmp_path))
    for kind in kinds:
        _ranks_agree(tmp_path, f"{kind}_sum")
        ref, ref_metrics = R.run_trainer(kind, iterations)
        want = R.state_arrays(ref)
        with np.load(tmp_path / f"{kind}.npz") as got:
            assert set(got.files) == set(want) | {"metrics"}
            # a PPO's metrics: its critic loss (column 1) is the critic's
            cols = [i for i in range(ref_metrics.shape[1]) if critic_atol is None or i != 1]
            np.testing.assert_allclose(got["metrics"][:, cols], ref_metrics.numpy()[:, cols],
                                       rtol=OWN_TOL, atol=OWN_TOL, err_msg=f"{kind} metrics")
            for k, v in want.items():
                tol = OWN_TOL
                if critic_atol is not None and k.startswith("carry/1/"):
                    if k.startswith("carry/1/1/"):
                        continue
                    tol = critic_atol
                np.testing.assert_allclose(got[k], v, rtol=0, atol=tol, err_msg=f"{kind} {k}")


def test_offpolicy_on_two_ranks_matches_one_process(tmp_path):
    _against_one_process(tmp_path, ["soft_actor_critic", "cross_q"], 3)


def test_liquid_ppo_on_two_ranks_matches_one_process(tmp_path):
    cfg = R.make_trainer("ppo_gae_liquid").config
    _against_one_process(tmp_path, ["ppo_gae_liquid"], 1,
                         critic_atol=2 * cfg.learning_rate * cfg.epoch)


def test_step_and_liquid_sac_trainers_on_two_ranks_match_one_process(tmp_path):
    _against_one_process(tmp_path, ["actor_critic", "ppo_vanilla", "soft_actor_critic_liquid"],
                         3)

"""The port's batched SAC/CrossQ trainer on the CPU: each test of
``tests/test_offpolicy_batched.py`` mirrored on the port's cartpole (the
batched step, its sweep's plain version), then the CLI's batched and
sequential ``train`` and ``run`` of both agents. Exact checks only here
(bit-equal resumes and checkpoints); the JAX parity of one iteration is in
``test_torch_offpolicy_parity.py``.
"""

import os

import numpy as np
import pytest
import torch

from evomotion_tpu_torch import cli
from evomotion_tpu_torch.envs.cartpole import CartPoleFactory
from evomotion_tpu_torch.train.offpolicy_batched import BatchedOffPolicy, OffPolicyConfig

ALGOS = ["soft_actor_critic", "cross_q"]


def _env():
    return CartPoleFactory({"reset_frame_nb": "2"}).make(0, mt_parity=False, device="cpu",
                                                         per_env_step=False)


def _trainer(algo, n_envs=8, steps=8, **kw):
    cfg = OffPolicyConfig(
        actor_hidden_size=16, critic_hidden_size=16, batch_size=16, epoch=2,
        train_every=4, steps_per_iter=steps, n_envs=n_envs,
        buffer_capacity=n_envs * steps * 4, **kw,
    )
    return BatchedOffPolicy(_env(), algo, cfg, seed=0)


def _tensors(state):
    """Every tensor of a train state: the agent's, the ring's, the envs'."""
    out = list(state.agent.tensors()) + list(state.ring[:6]) + [state.obs, state.prev_valid,
                                                               state.ep_steps]
    stack = [state.env_state]
    while stack:
        x = stack.pop()
        if isinstance(x, tuple):
            stack.extend(x)
        else:
            out.append(x)
    return out


@pytest.mark.parametrize("algo", ALGOS)
def test_train_step_runs_and_updates(algo):
    trainer = _trainer(algo)
    step = trainer.train_step_fn()
    state = trainer.init()
    p0 = state.agent.actor.h1.lin.w.detach().clone()
    for _ in range(3):
        state, metrics = step(state)
    assert state.iteration == 3
    assert np.isfinite(float(metrics.actor_loss))
    assert np.isfinite(float(metrics.critic_1_loss))
    assert float(metrics.updates_done) == trainer.updates_per_iter * trainer.config.epoch == 4
    assert not torch.allclose(p0, state.agent.actor.h1.lin.w)


def test_ring_write_and_wrap():
    trainer = _trainer("soft_actor_critic", n_envs=4, steps=4)
    step = trainer.train_step_fn()
    state = trainer.init()
    cap, block = trainer.capacity, 16
    assert cap == 64
    for i in range(1, 6):
        before = state.ring.obs.clone()
        state, _ = step(state)
        assert state.ring.cursor == (i * block) % cap
        assert state.ring.filled == min(i * block, cap)
        # each iteration writes its block at the old cursor and nowhere else
        start = ((i - 1) * block) % cap
        written = torch.zeros(cap, dtype=torch.bool)
        written[start:start + block] = True
        assert torch.equal(state.ring.obs[~written], before[~written])
        assert not torch.equal(state.ring.obs[written], before[written])


def test_settle_frames_never_sampled():
    """Transitions touching settle frames are weight-0 in the sampler: a
    done at (t, n) is followed by settle frames at (t+1.., n), invalid."""
    trainer = _trainer("soft_actor_critic", n_envs=4, steps=32)
    state, _ = trainer.train_step_fn()(trainer.init())
    t_steps, n_envs = 32, 4
    done2 = state.ring.done[: t_steps * n_envs].view(t_steps, n_envs).numpy()
    valid2 = state.ring.valid[: t_steps * n_envs].view(t_steps, n_envs).numpy()
    hits = 0
    for t, n in zip(*np.nonzero(done2)):
        if t + 1 < t_steps:
            assert valid2[t + 1, n] == 0.0
            hits += 1
    assert hits > 0  # an episode ended inside the block


def test_checkpoint_roundtrip(tmp_path):
    trainer = _trainer("cross_q")
    step = trainer.train_step_fn()
    state, _ = step(trainer.init())
    trainer.save(str(tmp_path), state)
    agent = trainer.load_carry(str(tmp_path))
    a, b = state.agent.tensors(), agent.tensors()
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("algo", ALGOS)
def test_full_state_resume_is_exact(algo, tmp_path):
    """save_full/load_full checkpoint the ring, the env batch and the
    generator: resumed training continues bit-exactly."""
    trainer = _trainer(algo)
    step = trainer.train_step_fn()
    state = trainer.init()
    for _ in range(3):
        state, _ = step(state)
    trainer.save_full(str(tmp_path), state)
    resumed = trainer.load_full(str(tmp_path), BatchedOffPolicy(
        _env(), algo, trainer.config, seed=7).init())
    assert (resumed.iteration, resumed.ring.cursor, resumed.ring.filled) == (
        state.iteration, state.ring.cursor, state.ring.filled)
    a, ma = step(state)
    b, mb = step(resumed)
    assert all(torch.equal(x, y) for x, y in zip(ma, mb))
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_params_resume_with_refill_keeps_learning(tmp_path):
    """A params-only resume REFILLS the ring (train_step_fn(learn=False))
    before updates: the refill writes transitions without touching the
    agent, and the next learning step sees a populated ring."""
    trainer = _trainer("cross_q")
    step = trainer.train_step_fn()
    refill = trainer.train_step_fn(learn=False)
    state = trainer.init()
    for _ in range(3):
        state, _ = step(state)
    trainer.save(str(tmp_path), state)

    fresh = trainer.init()
    fresh.agent = trainer.load_carry(str(tmp_path))
    p0 = [x.clone() for x in fresh.agent.tensors()]
    for _ in range(2):
        fresh, m = refill(fresh)
        assert float(m.updates_done) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(p0, fresh.agent.tensors()))
    assert fresh.ring.filled >= trainer.config.batch_size
    fresh, m = step(fresh)
    assert float(m.updates_done) > 0
    assert np.isfinite(float(m.critic_1_loss)) and np.isfinite(float(m.actor_loss))


@pytest.mark.parametrize("algo", ALGOS)
def test_cli_train_num_envs(algo, tmp_path):
    """``cli cartpole <algo> --num_envs 4 ... train`` on the batched tier:
    two saves of the agent's components, Adam counts of the updates run."""
    rc = cli.main(["cli", "cartpole", algo, "--num_envs", "4", "--agent_parameters",
                   "hidden_size=16", "critic_hidden_size=8", "horizon=8", "batch_size=8",
                   "train_every=4", "epoch=2", "nan_guard=true", "train", str(tmp_path),
                   "-e", "2", "-n", "2"], device="cpu")
    assert rc == 0
    names = {"soft_actor_critic": "target_critic_1", "cross_q": "critic_1_state"}
    for s in ("save_0", "save_1"):
        files = os.listdir(tmp_path / s)
        assert len(files) == 10 and f"{names[algo]}.npz" in files
    with np.load(tmp_path / "save_1" / "actor_optimizer.npz") as f:
        assert int(f["0/count"]) == 2 * 2 * 2 * 2  # events x epochs x iterations x saves
        assert f["0/mu/h1/lin/w"].shape == (16, 7) and np.isfinite(f["0/mu/h1/lin/w"]).all()
    with np.load(tmp_path / "save_1" / "critic_1.npz") as f:
        assert f["out/w"].shape == (1, 8)


@pytest.mark.parametrize("algo", ALGOS)
def test_cli_train_then_run(algo, tmp_path, capsys):
    """The sequential tier, as ``tests/test_cli.py::test_cli_train_then_run``:
    ``train -e 2 -n 1`` with one env, then ``run`` of ``save_0``."""
    params = ["seed=1", "actor_hidden_size=8", "critic_hidden_size=8", "batch_size=4",
              "epoch=1", "learning_rate=1e-3", "gamma=0.99", "replay_buffer_size=64",
              "train_every=2"] + (["tau=0.005"] if algo == "soft_actor_critic" else [])
    base = ["cli", "cartpole", algo, "--agent_parameters", *params,
            "--env_parameters", "mas_steps=30", "reset_frame_nb=2"]
    out = tmp_path / "out"
    assert cli.main(base + ["train", str(out), "-e", "2", "-n", "1"], device="cpu") == 0
    assert os.path.exists(out / "save_0" / "actor.npz")
    text = capsys.readouterr().out
    assert "[2/2]" in text and "critic_1 = " in text
    with np.load(out / "save_0" / "critic_1_optimizer.npz") as f:
        assert int(f["0/count"]) > 0  # it trained
    assert cli.main(base + ["run", str(out / "save_0"), "--episodes", "1"], device="cpu") == 0
    assert "episode 0: " in capsys.readouterr().out
    strict = [x for x in params if not x.startswith("train_every")]  # no defaults
    with pytest.raises(ValueError, match="train_every"):
        cli.main(base[:4] + strict + ["train", str(out)], device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("algo", ALGOS)
def test_offpolicy_learns_cartpole(algo):
    """The episode-failure rate drops as SAC/CrossQ learn to balance, with
    the JAX test's config and bar (120 iterations, late < 0.5 * early).
    Slow: 130-150 s per agent on the CPU (the batched cartpole step's plain
    sweep takes ~30 ms per step at 64 envs)."""
    cfg = OffPolicyConfig(
        actor_hidden_size=64, critic_hidden_size=64, batch_size=128, epoch=1,
        steps_per_iter=16, n_envs=64, buffer_capacity=16384, train_every=1,
        learning_rate=1e-3,
    )
    trainer = BatchedOffPolicy(_env(), algo, cfg, seed=0)
    step = trainer.train_step_fn()
    state = trainer.init()
    eps = []
    for _ in range(120):
        state, metrics = step(state)
        eps.append(float(metrics.episodes_done))
    early, late = np.mean(eps[5:30]), np.mean(eps[-20:])
    assert late < 0.5 * early, (early, late)

"""The port's networks and truncated normal against the JAX package.

JAX params are built by the JAX package's init functions and carried into
the port's modules (``convert.load_params`` / ``load_state``); the same
numpy-made inputs go through both. Tolerance 1e-5, as
``tests/test_networks.py`` uses, unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.networks import distributions as JD
from evomotion_tpu.networks import modules as JM
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.networks import distributions as D
from evomotion_tpu_torch.networks import modules as M

TOL = 1e-5
S, A = 7, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("hidden", [16, 256])
def test_actor_critic_q_match_jax(hidden):
    rng = np.random.default_rng(hidden)
    s = rng.standard_normal((9, S)).astype(np.float32) * 2
    a = rng.uniform(-1, 1, (9, A)).astype(np.float32)
    key = jax.random.PRNGKey(hidden)
    ka, kc, kq = jax.random.split(key, 3)

    jp = JM.actor_init(ka, S, A, hidden)
    actor = convert.load_params(M.Actor(S, A, hidden), _np(jp))
    mu, sigma = actor(torch.as_tensor(s))
    jmu, jsigma = JM.actor_apply(jp, s)
    _close(mu, jmu)
    _close(sigma, jsigma)
    # the carried weights come back as the same pytree, exactly
    back = convert.params_tree(actor)
    jax.tree.map(np.testing.assert_array_equal, back, _np(jp))

    jc = JM.critic_init(kc, S, hidden)
    critic = convert.load_params(M.Critic(S, hidden), _np(jc))
    _close(critic(torch.as_tensor(s)), JM.critic_apply(jc, s))

    jq = JM.q_net_init(kq, S, A, hidden)
    q = convert.load_params(M.QNetwork(S, A, hidden), _np(jq))
    _close(q(torch.as_tensor(s), torch.as_tensor(a)), JM.q_net_apply(jq, s, a))
    assert M.count_parameters(q) == JM.count_parameters(jq)


@pytest.mark.parametrize("hidden", [16, 256])
def test_bn_q_net_train_and_eval_match_jax(hidden):
    """Three training-mode calls (the running statistics and step move each
    time), then eval mode on the final state; the state agrees after each."""
    rng = np.random.default_rng(7 + hidden)
    jp, js = JM.bn_q_net_init(jax.random.PRNGKey(3), S, A, hidden)
    net = convert.load_params(M.BatchNormQNetwork(S, A, hidden), _np(jp))
    convert.load_state(net, _np(js))
    net.train()
    for i in range(3):
        s = rng.standard_normal((32, S)).astype(np.float32) * (1 + i)
        a = rng.uniform(-1, 1, (32, A)).astype(np.float32)
        jq, js = JM.bn_q_net_apply(jp, js, s, a, True)
        _close(net(torch.as_tensor(s), torch.as_tensor(a)), jq)
        got = convert.state_tree(net)
        jax.tree.map(lambda x, y: np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL),
                     got, _np(js))
    assert int(got["bn0"]["step"]) == 3
    net.eval()
    jq, js2 = JM.bn_q_net_apply(jp, js, s[:5], a[:5], False)
    _close(net(torch.as_tensor(s[:5]), torch.as_tensor(a[:5])), jq)
    assert int(convert.state_tree(net)["bn0"]["step"]) == 3


def test_batch_renorm_past_warmup_matches_jax():
    """A late step (r and d clamps open) in training mode, then eval."""
    rng = np.random.default_rng(11)
    jp, js = JM.batch_renorm_init(4)
    js = {"running_mean": jnp.asarray(rng.standard_normal(4).astype(np.float32)),
          "running_std": jnp.asarray(rng.uniform(0.5, 2, 4).astype(np.float32)),
          "step": jnp.int32(60_000)}
    jp = {"weight": jnp.asarray(rng.uniform(0.5, 2, 4).astype(np.float32)),
          "bias": jnp.asarray(rng.standard_normal(4).astype(np.float32))}
    bn = convert.load_state(convert.load_params(M.BatchRenorm(4), _np(jp)), _np(js))
    x = (rng.standard_normal((16, 4)) * 3 + 1).astype(np.float32)
    jy, js2 = JM.batch_renorm_apply(jp, js, x, training=True)
    _close(bn(torch.as_tensor(x)), jy)
    jax.tree.map(lambda g, r: np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL),
                 convert.state_tree(bn), _np(js2))
    bn.eval()
    jy, _ = JM.batch_renorm_apply(jp, js2, x, training=False)
    _close(bn(torch.as_tensor(x)), jy)


def _dist_inputs():
    """mu in [-1, 1] (the actor's tanh range), with its ends; sigma from
    1e-8 (below the 1e-6 clamp) to 1e7 (above 1e6), so alpha and beta reach
    their +-5 clamps, as the reference's stress test draws them
    (test_functions.cpp:85-86)."""
    rng = np.random.default_rng(0)
    mu = rng.uniform(-1, 1, (6, 40)).astype(np.float32)
    mu[0, :4] = [-1.0, 1.0, -0.999999, 0.999999]
    sigma = np.exp(rng.uniform(np.log(1e-8), np.log(1e7), (6, 40))).astype(np.float32)
    x = rng.uniform(-1, 1, (6, 40)).astype(np.float32)
    return mu, sigma, x


def test_distribution_functions_match_jax():
    mu, sigma, x = _dist_inputs()
    tm, ts, tx = map(torch.as_tensor, (mu, sigma, x))
    # the densities grow as 1/sigma (1e6 at the clamp): relative tolerance
    for port, ref in (
        (D.truncated_normal_pdf(tx, tm, ts), JD.truncated_normal_pdf(x, mu, sigma)),
        (D.truncated_normal_log_pdf(tx, tm, ts), JD.truncated_normal_log_pdf(x, mu, sigma)),
        (D.truncated_normal_cdf(tx, tm, ts), JD.truncated_normal_cdf(x, mu, sigma)),
        (D.truncated_normal_cdf_interval(tx, tm, ts),
         JD.truncated_normal_cdf_interval(x, mu, sigma)),
        (D.truncated_normal_entropy(tm, ts), JD.truncated_normal_entropy(mu, sigma)),
        (D.normal_pdf(tx, tm, ts), JD.normal_pdf(x, mu, sigma)),
        (D.normal_cdf(tx, tm, ts), JD.normal_cdf(x, mu, sigma)),
    ):
        ref = np.asarray(ref)
        assert np.isfinite(ref).all() == bool(torch.isfinite(port).all())
        np.testing.assert_allclose(port.numpy(), ref, rtol=TOL, atol=TOL)
    lp, lq = x, x[::-1].copy()
    _close(D.kl_divergence(torch.as_tensor(lp), torch.as_tensor(lq)), JD.kl_divergence(lp, lq))


def test_sample_with_jax_uniforms_matches_jax():
    """JAX's uniforms (the key's ``uniform`` draw) fed to the port, at
    1e-5. Near the clamp edges erfinv is steep: with alpha or beta at +-5
    its argument reaches +-(1 - 5.7e-7), where one ulp moves the quantile
    by up to ~0.04 (slope 1 / phi(5) = 6.7e5). Only a draw within ~1e-6 of
    that edge meets it; none of these 240 does (the largest difference over
    20 keys was 9.8e-7), and the clip to [-1, 1] bounds any that would."""
    mu, sigma, _ = _dist_inputs()
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, mu.shape))
    ref = np.asarray(JD.truncated_normal_sample(key, mu, sigma))
    got = D.truncated_normal_sample(torch.as_tensor(mu), torch.as_tensor(sigma),
                                    u=torch.as_tensor(u)).numpy()
    assert ((got >= -1) & (got <= 1)).all()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    # without uniforms the generator draws: same seed, same samples
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    s1 = D.truncated_normal_sample(torch.as_tensor(mu), torch.as_tensor(sigma), g1)
    s2 = D.truncated_normal_sample(torch.as_tensor(mu), torch.as_tensor(sigma), g2)
    assert torch.equal(s1, s2)
    e = D.rand_eps((1000,), torch.Generator().manual_seed(0))
    assert float(e.min()) >= 1e-7 and float(e.max()) <= 1 - 1e-7


@pytest.mark.parametrize("t", [0, 37, 100, 1000])
def test_exponential_decrease_matches_jax(t):
    got = D.exponential_decrease(t, 100, 0.1, 0.01)
    _close(got, JD.exponential_decrease(t, 100, 0.1, 0.01), 1e-7)


def test_soft_and_hard_update_and_helpers():
    rng = np.random.default_rng(2)
    jt, js = (JM.critic_init(jax.random.PRNGKey(i), S, 16) for i in (0, 1))
    tgt = convert.load_params(M.Critic(S, 16), _np(jt))
    src = convert.load_params(M.Critic(S, 16), _np(js))
    M.soft_update(tgt, src, 0.1)
    jax.tree.map(lambda g, r: np.testing.assert_allclose(g, r, rtol=TOL, atol=1e-7),
                 convert.params_tree(tgt), _np(JM.soft_update(jt, js, 0.1)))
    M.hard_update(tgt, src)
    jax.tree.map(np.testing.assert_array_equal, convert.params_tree(tgt), _np(js))
    x = rng.standard_normal(20).astype(np.float32) * 3
    _close(M.mish(torch.as_tensor(x)), JM.mish(x))
    _close(M.clamp_module(torch.as_tensor(x), -1.0, 2.0), JM.clamp_module(x, -1.0, 2.0))
    _close(M.exp_module(torch.as_tensor(x)), JM.exp_module(x))


def test_init_is_seeded_and_reference_scaled():
    """Same generator seed, same weights; xavier-normal gain 0.1 and bias
    N(0, 0.1) (init.cpp:7-13) in scale."""
    a1 = M.Actor(371, 12, 256, torch.Generator().manual_seed(4))
    a2 = M.Actor(371, 12, 256, torch.Generator().manual_seed(4))
    assert all(torch.equal(p, q) for p, q in zip(a1.parameters(), a2.parameters()))
    w = a1.h1.lin.w.detach()
    assert abs(float(w.std()) / (0.1 * np.sqrt(2 / (371 + 256))) - 1) < 0.02
    assert abs(float(a1.h1.lin.b.detach().std()) / 0.1 - 1) < 0.2
    assert torch.equal(a1.h1.ln.g, torch.ones(256)) and torch.equal(a1.h1.ln.b, torch.zeros(256))


def test_loss_meter_matches_jax(tmp_path):
    """The port's own copy of train/metrics.py: the windowed mean, the
    display string and the truncating to_csv quirk, as the JAX package's."""
    from evomotion_tpu.train.metrics import LossMeter as JLossMeter
    from evomotion_tpu_torch.train.metrics import LossMeter

    outs = []
    for cls, d in ((LossMeter, tmp_path / "port"), (JLossMeter, tmp_path / "jax")):
        d.mkdir()
        m = cls("x", 3)
        assert m.loss() == 0.0
        for v in (1.0, 2.0, 3.0, 4.0):
            m.add(v)
        m.to_csv(str(d))
        m.set_window_size(2)
        outs.append((m.loss(), m.to_string(), (d / "x.csv").read_text()))
    assert outs[0] == outs[1] == (3.5, "x = 3.500000", "4,3.000000\n")

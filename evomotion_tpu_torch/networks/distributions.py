"""Truncated-normal policy distribution on [-1, 1] (port of
``evomotion_tpu/networks/distributions.py``).

Reference: evo_motion_networks/src/functions.cpp:8-127. All clamps match:
sigma in [1e-6, 1e6], alpha/beta in [-5, 5]. Sampling is inverse-CDF of a
uniform between Theta(alpha) and Theta(beta) (functions.cpp:96-113). Plain
functions on tensors; random draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

SIGMA_MIN = 1e-6
SIGMA_MAX = 1e6
ALPHA_BETA_BOUND = 5.0

_SQRT_2 = math.sqrt(2.0)
_SQRT_2PI = math.sqrt(2.0 * math.pi)


def rand_eps(shape, generator=None, epsilon: float = 1e-7, device=None):
    """functions.cpp:13-17: uniform in [eps, 1 - eps]."""
    u = torch.rand(shape, generator=generator, device=device)
    return epsilon + u * (1.0 - 2.0 * epsilon)


def normal_pdf(x, mu, sigma):
    return torch.exp(-0.5 * ((x - mu) / sigma) ** 2) / (sigma * _SQRT_2PI)


def normal_cdf(x, mu, sigma):
    return 0.5 * (1.0 + torch.erf((x - mu) / (sigma * _SQRT_2)))


def _phi(z):
    return torch.exp(-0.5 * z * z) / _SQRT_2PI


def _theta(x):
    return 0.5 * (1.0 + torch.erf(x / _SQRT_2))


def _theta_inv(t):
    return _SQRT_2 * torch.special.erfinv(2.0 * t - 1.0)


def _safe(mu, sigma, min_value, max_value):
    safe_sigma = torch.clamp(sigma, SIGMA_MIN, SIGMA_MAX)
    b = ALPHA_BETA_BOUND
    alpha = torch.clamp((min_value - mu) / safe_sigma, -b, b)
    beta = torch.clamp((max_value - mu) / safe_sigma, -b, b)
    return safe_sigma, alpha, beta


def truncated_normal_pdf(x, mu, sigma, min_value=-1.0, max_value=1.0):
    safe_sigma, alpha, beta = _safe(mu, sigma, min_value, max_value)
    return _phi((x - mu) / safe_sigma) / ((_theta(beta) - _theta(alpha)) * safe_sigma)


def truncated_normal_log_pdf(x, mu, sigma, min_value=-1.0, max_value=1.0):
    safe_sigma, alpha, beta = _safe(mu, sigma, min_value, max_value)
    z = _theta(beta) - _theta(alpha)
    return (
        -0.5 * math.log(2.0 * math.pi)
        - torch.log(safe_sigma)
        - 0.5 * ((x - mu) / safe_sigma) ** 2
        - torch.log(z)
    )


def truncated_normal_cdf(x, mu, sigma, min_value=-1.0, max_value=1.0):
    safe_sigma, alpha, beta = _safe(mu, sigma, min_value, max_value)
    xi = (x - mu) / safe_sigma
    z = _theta(beta) - _theta(alpha)
    return (_theta(xi) - _theta(alpha)) / z


def truncated_normal_cdf_interval(x, mu, sigma, min_value=-1.0, max_value=1.0, epsilon=1e-2):
    return truncated_normal_cdf(x + epsilon, mu, sigma, min_value, max_value) - (
        truncated_normal_cdf(x - epsilon, mu, sigma, min_value, max_value)
    )


def truncated_normal_sample(mu, sigma, generator=None, u=None, min_value=-1.0, max_value=1.0):
    """One draw per element of ``mu``: from the uniforms ``u`` (shape of
    ``mu``, in [0, 1)) where given, else from ``generator``."""
    safe_sigma, alpha, beta = _safe(mu, sigma, min_value, max_value)
    if u is None:
        u = torch.rand(mu.shape, generator=generator, device=mu.device)
    cdf = torch.clamp(_theta(alpha) + u * (_theta(beta) - _theta(alpha)), 0.0, 1.0)
    return torch.clamp(_theta_inv(cdf) * safe_sigma + mu, min_value, max_value)


def truncated_normal_entropy(mu, sigma, min_value=-1.0, max_value=1.0):
    safe_sigma, alpha, beta = _safe(mu, sigma, min_value, max_value)
    z = _theta(beta) - _theta(alpha)
    return torch.log(math.sqrt(2.0 * math.pi * math.e) * safe_sigma * z) + 0.5 * (
        alpha * _phi(alpha) - beta * _phi(beta)
    ) / z


def kl_divergence(log_p, log_q):
    """functions.cpp:132-134 (pointwise integrand form)."""
    return torch.exp(log_p) * (log_p - log_q)


def exponential_decrease(t, max_t, start: float, end: float):
    """functions.cpp:141-144: exponential decay from start to end over max_t."""
    k = -math.log(end / start) / max_t
    t = torch.as_tensor(t, dtype=torch.float32)
    return torch.clamp_min(start * torch.exp(-k * t), end)

"""The truncated-normal policy on [-1, 1] (EvoMotion functions.cpp:8-127):
sigma clamped to [1e-6, 1e6], alpha and beta to [-5, 5]; sampling is the
inverse CDF of a uniform between Theta(alpha) and Theta(beta)."""

from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)


def _theta(x):
    return 0.5 * (1.0 + torch.erf(x / _SQRT2))


def _phi(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _safe(mu, sigma):
    s = torch.clamp(sigma, 1e-6, 1e6)
    return s, torch.clamp((-1.0 - mu) / s, -5.0, 5.0), torch.clamp((1.0 - mu) / s, -5.0, 5.0)


def log_pdf(x, mu, sigma):
    s, alpha, beta = _safe(mu, sigma)
    return (-0.5 * math.log(2.0 * math.pi) - torch.log(s) - 0.5 * ((x - mu) / s) ** 2
            - torch.log(_theta(beta) - _theta(alpha)))


def entropy(mu, sigma):
    s, alpha, beta = _safe(mu, sigma)
    z = _theta(beta) - _theta(alpha)
    return (torch.log(math.sqrt(2.0 * math.pi * math.e) * s * z)
            + 0.5 * (alpha * _phi(alpha) - beta * _phi(beta)) / z)


def sample(mu, sigma, u):
    """Draws from uniforms ``u`` (the shape of ``mu``)."""
    s, alpha, beta = _safe(mu, sigma)
    cdf = torch.clamp(_theta(alpha) + u * (_theta(beta) - _theta(alpha)), 0.0, 1.0)
    return torch.clamp(_SQRT2 * torch.special.erfinv(2.0 * cdf - 1.0) * s + mu, -1.0, 1.0)

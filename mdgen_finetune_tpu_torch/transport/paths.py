"""Interpolant coupling plans for stochastic-interpolant flow matching.

Counterpart of the JAX package's ``transport/paths.py`` (reference
src/mdgen/transport/path.py): each path defines x_t = alpha_t * x1 +
sigma_t * x0 with closed-form derivatives, elementwise in torch. Methods
take t of shape (B,) already expanded against x by ``expand_t``.
"""
from __future__ import annotations

import math

import torch


def expand_t(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) matching x's rank (src/mdgen/transport/path.py:4-12)."""
    return t.reshape(t.shape[0], *([1] * (x.ndim - 1)))


class LinearPath:
    """alpha_t = t, sigma_t = 1 - t (src/mdgen/transport/path.py:17-135)."""

    def alpha(self, t):
        return t, torch.ones_like(t)

    def sigma(self, t):
        return 1 - t, -torch.ones_like(t)

    def d_alpha_alpha_ratio(self, t):
        return 1 / t

    def drift(self, x, t):
        """Score-parametrized SDE drift; returns (-drift_mean, diffusion_var)."""
        ratio = self.d_alpha_alpha_ratio(t)
        sigma_t, d_sigma_t = self.sigma(t)
        return -ratio * x, ratio * sigma_t ** 2 - sigma_t * d_sigma_t

    def diffusion(self, x, t, form="SBDM", norm=1.0):
        if form == "constant":
            return torch.full_like(t, norm)
        if form == "SBDM":
            return norm * self.drift(x, t)[1]
        if form == "sigma":
            return norm * self.sigma(t)[0]
        if form == "linear":
            return norm * (1 - t)
        if form == "decreasing":
            return 0.25 * (norm * torch.cos(math.pi * t) + 1) ** 2
        if form == "increasing-decreasing":
            return norm * torch.sin(math.pi * t) ** 2
        raise NotImplementedError(form)

    def score_from_velocity(self, velocity, x, t):
        """The score of x_t from the velocity (JAX ``paths.py:56-61``)."""
        alpha_t, d_alpha_t = self.alpha(t)
        sigma_t, d_sigma_t = self.sigma(t)
        r = alpha_t / d_alpha_t
        var = sigma_t ** 2 - r * d_sigma_t * sigma_t
        return (r * velocity - x) / var

    def noise_from_velocity(self, velocity, x, t):
        """The noise x0 of x_t from the velocity (JAX ``paths.py:63-68``)."""
        alpha_t, d_alpha_t = self.alpha(t)
        sigma_t, d_sigma_t = self.sigma(t)
        r = alpha_t / d_alpha_t
        var = r * d_sigma_t - sigma_t
        return (r * velocity - x) / var

    def velocity_from_score(self, score, x, t):
        """The probability-flow velocity from the score (JAX ``paths.py:70-72``)."""
        drift, var = self.drift(x, t)
        return var * score - drift

    def interpolate(self, t, x0, x1):
        """Returns (x_t, u_t): the noisy sample and the target vector field."""
        alpha_t, d_alpha_t = self.alpha(t)
        sigma_t, d_sigma_t = self.sigma(t)
        return alpha_t * x1 + sigma_t * x0, d_alpha_t * x1 + d_sigma_t * x0


class GVPPath(LinearPath):
    """alpha_t = sin(pi t / 2), sigma_t = cos(pi t / 2), the reference default
    (src/mdgen/transport/path.py:173-191)."""

    def alpha(self, t):
        return torch.sin(t * math.pi / 2), math.pi / 2 * torch.cos(t * math.pi / 2)

    def sigma(self, t):
        return torch.cos(t * math.pi / 2), -math.pi / 2 * torch.sin(t * math.pi / 2)

    def d_alpha_alpha_ratio(self, t):
        return math.pi / (2 * torch.tan(t * math.pi / 2))


class VPPath(LinearPath):
    """Variance-preserving diffusion path (src/mdgen/transport/path.py:138-170)."""

    def __init__(self, sigma_min=0.1, sigma_max=20.0):
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def _log_mean_coeff(self, t):
        return -0.25 * (1 - t) ** 2 * (self.sigma_max - self.sigma_min) - 0.5 * (1 - t) * self.sigma_min

    def _d_log_mean_coeff(self, t):
        return 0.5 * (1 - t) * (self.sigma_max - self.sigma_min) + 0.5 * self.sigma_min

    def alpha(self, t):
        a = torch.exp(self._log_mean_coeff(t))
        return a, a * self._d_log_mean_coeff(t)

    def sigma(self, t):
        p = 2 * self._log_mean_coeff(t)
        sigma_t = torch.sqrt(1 - torch.exp(p))
        d_sigma_t = torch.exp(p) * (2 * self._d_log_mean_coeff(t)) / (-2 * sigma_t)
        return sigma_t, d_sigma_t

    def d_alpha_alpha_ratio(self, t):
        return self._d_log_mean_coeff(t)

    def drift(self, x, t):
        beta_t = self.sigma_min + (1 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2


def get_path(name: str) -> LinearPath:
    return {"Linear": LinearPath, "GVP": GVPPath, "VP": VPPath}[name]()

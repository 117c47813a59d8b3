"""Dirichlet conditional flow for the simplex channels of sequence design.

The port's copy of the JAX package's ``transport/dirichlet.py`` (reference
DirichletConditionalFlow, src/mdgen/utils.py:17-57). The derivative of the
regularized incomplete beta function I_b(alpha, K - 1) in alpha is tabulated
once, on the JAX package's grid (scipy's ``betainc``), and held on the
model's device; ``c_factor`` is then a row lookup and a linear interpolation
on tensors, so a sampler step needs no host round trip.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from scipy import special as sp_special


def simplex_proj(seq: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of the last axis onto the probability simplex
    (sorted algorithm, Wang & Carreira-Perpinan 2013;
    src/mdgen/utils.py:17-31)."""
    K = seq.shape[-1]
    x = torch.sort(seq, dim=-1, descending=True).values
    tmp = (torch.cumsum(x, dim=-1) - 1) / torch.arange(1, K + 1, dtype=seq.dtype,
                                                        device=seq.device)
    gt = (x > tmp).sum(-1, keepdim=True)
    tau = torch.gather(tmp, -1, gt - 1)
    return torch.clamp_min(seq - tau, 0.0)


@functools.lru_cache(maxsize=4)
def _dcdf_table(K: int, alpha_min: float, alpha_max: float, alpha_spacing: float):
    """(alphas, bs, d I_b(alpha, K-1) / d alpha) as f32 numpy arrays: the
    JAX package's grid, forward differences over alpha."""
    alphas = np.arange(alpha_min, alpha_max + alpha_spacing, alpha_spacing)
    bs = np.linspace(0, 1, 1000)
    cdfs = sp_special.betainc(alphas[:, None], K - 1, bs[None, :])
    dcdf = np.diff(cdfs, axis=0) / alpha_spacing
    return alphas.astype(np.float32), bs.astype(np.float32), dcdf.astype(np.float32)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values as zero, as XLA computes them: the two powers
    of ``c_factor`` reach the subnormal range near b = 1 and b = 0, where
    the JAX package's arithmetic then gives NaN or 0 instead of a huge
    finite value."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, 0.0, x)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: linear interpolation on the sorted 1-D grid
    ``xp``, clamped to ``fp[0]`` below ``xp[0]`` and to ``fp[-1]`` above
    ``xp[-1]``, in the same arithmetic order."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.shape[0] - 1)
    lo_x, lo_f = xp[i - 1], fp[i - 1]
    f = lo_f + ((x - lo_x) / (xp[i] - lo_x)) * (fp[i] - lo_f)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class DirichletConditionalFlow(torch.nn.Module):
    """The c-factor of the Dirichlet conditional flow (src/mdgen/utils.py:
    33-57). The table (``dcdf``, (n_alpha - 1, 1000) f32: 28 MB at the
    design preset's ``alpha_max`` 8 and spacing 0.001) is a non-persistent
    buffer, so it follows the model to its device and stays out of
    checkpoints."""

    def __init__(self, K: int = 20, alpha_min: float = 1.0, alpha_max: float = 100.0,
                 alpha_spacing: float = 0.01):
        super().__init__()
        self.K = K
        self.alpha_min = alpha_min
        self.alpha_max = alpha_max
        self.alpha_spacing = alpha_spacing
        _, bs, dcdf = _dcdf_table(K, alpha_min, alpha_max, alpha_spacing)
        # lgamma(K - 1) in f32, held as a Python number: a constant, not a
        # host-to-device copy at every call
        self.lgamma_km1 = float(torch.lgamma(torch.tensor(K - 1.0)))
        self.register_buffer("bs", torch.from_numpy(bs), persistent=False)
        self.register_buffer("dcdf", torch.from_numpy(dcdf), persistent=False)

    def c_factor(self, bs: torch.Tensor, alpha) -> torch.Tensor:
        """The c-factor field at the points ``bs`` (any shape, f32) for one
        concentration ``alpha`` (a 0-d tensor or a float), as the JAX
        package's ``c_factor``: alpha clipped to [alpha_min, alpha_max -
        spacing]; the beta term 0 where ``bs >= 1`` and where ``bs **
        (alpha - 1)`` is not positive (NaN for negative ``bs`` at a
        non-integer exponent, 0 at ``bs = 0``). No step reads the device
        from the host."""
        K = self.K
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=bs.device)
        alpha = alpha.clamp(self.alpha_min, self.alpha_max - self.alpha_spacing)
        log_beta = torch.lgamma(alpha) + self.lgamma_km1 - torch.lgamma(alpha + (K - 1.0))
        beta_val = torch.exp(log_beta)
        beta_div = torch.where(bs < 1, beta_val / _ftz(torch.pow(1 - bs, K - 1)), 0.0)
        pow_term = _ftz(torch.pow(bs, alpha - 1))
        beta_div_full = torch.where(pow_term > 0, beta_div / pow_term, 0.0)
        idx = torch.round((alpha - self.alpha_min) / self.alpha_spacing).long()
        row = self.dcdf[idx.clamp(0, self.dcdf.shape[0] - 1).reshape(1)][0]
        return -interp(bs, self.bs, row) * beta_div_full

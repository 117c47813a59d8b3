"""DiT-style building blocks: AdaLN modulation, timestep embedding, GELUs.

Counterpart of the JAX package's ``models/layers.py`` (reference
src/mdgen/model/layers.py:14-85) plus ``_gelu_fast`` and
``_gelu_fast_with_grad`` from its ``ops/adaln_mlp.py``. Denoiser LayerNorms carry no affine parameters
(eps 1e-6).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """erf-form GELU (src/mdgen/model/layers.py:78-85)."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


# algebraic-sigmoid erf fit: erf(a / sqrt(2)) ~ t / sqrt(1 + t^2) with
# t = a * P(a^2), P of degree 4 fitted on |a| <= 6; max |gelu_fast - gelu_erf|
# is 7.1e-5 in f32. Every fused MLP of the model uses it.
GELU_KS = (0.798055917732286, 0.12003597204164997, 0.01547196081666821,
           0.0005614901736225192, 0.00014934348411800474)


def gelu_fast(a: torch.Tensor) -> torch.Tensor:
    """erf-GELU through the fit above; clamps and the rsqrt run in f32, the
    polynomial in the input's dtype, and a < -6 pins to exactly 0."""
    a32 = a.float()
    z = a32.clamp(-6.0, 6.0).to(a.dtype)
    u = z * z
    p = GELU_KS[-1]
    for k in GELU_KS[-2::-1]:
        p = p * u + k
    t32 = (z * p).float()
    f = (t32 * torch.rsqrt(1.0 + t32 * t32)).to(a.dtype)
    return torch.where(a32 < -6.0, torch.zeros_like(a), a * (0.5 + 0.5 * f))


def gelu_fast_with_grad(a: torch.Tensor):
    """(gelu_fast(a), d gelu_fast / da) in f32 for f32 ``a``: the analytic
    derivative of the fit (df/dt = (1 + t^2)^(-3/2), dz/da = 1{|a| < 6}),
    for the backward passes that recompute the pre-activation (the JAX
    package's ``ops/adaln_mlp.py::_gelu_fast_with_grad``)."""
    deg = len(GELU_KS) - 1
    z = a.clamp(-6.0, 6.0)
    u = z * z
    p = GELU_KS[deg]
    pp = deg * GELU_KS[deg]
    for i in range(deg - 1, 0, -1):
        p = p * u + GELU_KS[i]
        pp = pp * u + i * GELU_KS[i]
    p = p * u + GELU_KS[0]
    t = z * p
    r = torch.rsqrt(1.0 + t * t)
    phi = 0.5 + 0.5 * t * r
    fp = torch.where(a.abs() < 6.0, r * r * r * (p + 2.0 * u * pp), torch.zeros_like(a))
    neg = a < -6.0
    val = torch.where(neg, torch.zeros_like(a), a * phi)
    dval = torch.where(neg, torch.zeros_like(a), phi + (0.5 * a) * fp)
    return val, dval


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Non-affine LayerNorm with f32 statistics, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _expand(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, C) -> broadcastable against x (B, ..., C)."""
    return v.reshape(v.shape[0], *([1] * (x.ndim - 2)), v.shape[-1])


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """AdaLN modulate with per-batch-element shift/scale (B, C)."""
    return x * (1 + _expand(scale, x)) + _expand(shift, x)


def gate(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return _expand(g, x) * x


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal features, cos-first (src/mdgen/model/layers.py:30-50)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedder(nn.Module):
    """t -> sinusoid -> Linear -> SiLU -> Linear (src/mdgen/model/layers.py:17-55)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp0 = nn.Linear(frequency_embedding_size, hidden_size)
        self.mlp2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, t: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        h = timestep_embedding(t, self.frequency_embedding_size).to(dtype)
        h = F.silu(F.linear(h, self.mlp0.weight.to(dtype), self.mlp0.bias.to(dtype)))
        return F.linear(h, self.mlp2.weight.to(dtype), self.mlp2.bias.to(dtype))


def sincos_pos_embed(embed_dim: int, length: int) -> np.ndarray:
    """Fixed 1D sin-cos table, sin-half then cos-half
    (src/mdgen/model/latent_model.py:22-40)."""
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.arange(length, dtype=np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


class Dropout:
    """Dropout of attention probabilities, as ``flax.linen.Dropout`` applies
    it (reference mha.py:383-386, ipa.py:204): ``where(keep, p / (1 - rate),
    0)`` with ``keep`` true at probability 1 - rate. One keep mask per call
    site, named by the site's module path in the flax tree (``layers_0/
    mha_l``, ``layers_0/ipa``, ``ipa_layers_1/mha_l``, ...) and its call
    count there (``#0``, ``#1``: the encoder's two passes under the doubled
    offsets). Masks are drawn from ``generator`` (uniform < 1 - rate, on the
    generator's device) or taken from ``masks`` {key: bool tensor, its batch
dims possibly unflattened}; every
    mask used is kept in ``drawn``, so that a step can be replayed with the
    same masks on another device. ``rows`` = (slice, B): the call sites
    hold those rows of a batch of B elements (a rank's part of a sharded
    step): each mask is drawn for the whole batch and sliced, so that it
    equals the one-process step's."""

    def __init__(self, rate: float, generator: torch.Generator | None = None,
                 masks: dict | None = None, rows: tuple | None = None):
        if not 0.0 < rate < 1.0:
            raise ValueError(f"dropout rate {rate} is not in (0, 1)")
        self.rate, self.generator, self.masks, self.rows = rate, generator, masks, rows
        self.drawn: dict = {}
        self._calls: dict = {}

    def __call__(self, path: str, p: torch.Tensor) -> torch.Tensor:
        n = self._calls.get(path, 0)
        self._calls[path] = n + 1
        key = f"{path}#{n}"
        if self.masks is not None:
            keep = self.masks[key].to(p.device)
            if keep.shape[-3:] != p.shape[-3:] or keep.numel() != p.numel():
                raise ValueError(f"dropout mask {key}: shape {tuple(keep.shape)}, "
                                 f"probabilities {tuple(p.shape)}")
            keep = keep.reshape(p.shape)  # JAX's (B, T, ...) batch dims as the port's (B*T, ...)
        else:
            dev = self.generator.device if self.generator is not None else p.device
            shape, part = p.shape, slice(None)
            if self.rows is not None:  # dim 0 flattens the batch, batch-major
                sl, B = self.rows
                k = p.shape[0] // (sl.stop - sl.start)
                shape, part = (B * k, *p.shape[1:]), slice(sl.start * k, sl.stop * k)
            keep = (torch.rand(shape, generator=self.generator, device=dev)[part]
                    < 1.0 - self.rate).to(p.device)
        self.drawn[key] = keep
        return torch.where(keep, p / (1.0 - self.rate), torch.zeros((), dtype=p.dtype,
                                                                     device=p.device))

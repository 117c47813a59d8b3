"""Hyena frame mixer (order-2 gated implicit long convolution through the FFT).

Counterpart of the JAX package's ``models/hyena.py`` (reference
src/mdgen/model/standalone_hyena.py, itself from HazyResearch/safari), the
frame stage of the ``hyena`` configuration. JAX runs it in XLA with no
Pallas kernel; here the FFT pair is ``torch.fft`` (in f32) and the short
depthwise convolution ``torch.nn.functional.conv1d``. The reference's
conventions are kept: the L - 1 output window of the long convolution, the
forward-normalised inverse FFT, the filter's positional features with
(emb_dim - 1) // 2 complex bands. Like JAX and the reference, the operator
ignores the key mask: the reference assumes batches without padded frames
(SURVEY.md:91).

Parameters carry the flax names (``in_proj``, ``short_filter``,
``filter_fn/{pos_z, bias, mlp_in, sin_i/freq, mlp_i, mlp_out}``,
``out_proj``), so ``utils.weights.from_flax`` maps them by its general
rules.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


def fftconv(u: torch.Tensor, k: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Long convolution: u (B, C, L), k (C, L), D (C,) residual gain, in f32,
    cast back to u's dtype (standalone_hyena.py:15-26)."""
    L = u.shape[-1]
    n = 2 * L
    k_f = torch.fft.rfft(k.float(), n=n) / n
    u_f = torch.fft.rfft(u.float(), n=n)
    y = torch.fft.irfft(u_f * k_f, n=n, norm="forward")[..., L - 1:2 * L - 1]
    return (y + u.float() * D.float()[:, None]).to(u.dtype)


def _positional_z(emb_dim: int, seq_len: int):
    """Complex-exponential positional features (standalone_hyena.py:60-79):
    z (seq_len, emb_dim) and t (seq_len, 1), f32."""
    t = np.linspace(0, 1, seq_len)[:, None]
    bands = (emb_dim - 1) // 2
    t_rescaled = np.linspace(0, seq_len - 1, seq_len)[:, None]
    w = 2 * math.pi * t_rescaled / seq_len
    f = np.linspace(1e-4, bands - 1, bands)[None, :]
    z = np.exp(-1j * f * w)
    return (np.concatenate([t, z.real, z.imag], axis=-1).astype(np.float32),
            t.astype(np.float32))


class Sin(nn.Module):
    def __init__(self, dim: int, w: float = 1.0):
        super().__init__()
        self.freq = nn.Parameter(torch.full((1, dim), float(w)))

    def forward(self, x):
        return torch.sin(self.freq * x)


class HyenaFilter(nn.Module):
    """Implicit MLP filter with exponential decay (standalone_hyena.py:
    112-185); computed in f32."""

    def __init__(self, d_model: int, emb_dim: int = 3, order: int = 64, seq_len: int = 1024,
                 w: float = 1.0, num_inner_mlps: int = 2, fast_decay_pct: float = 0.3,
                 slow_decay_pct: float = 1.5, target: float = 1e-2):
        super().__init__()
        z, t = _positional_z(emb_dim, seq_len)
        self.pos_z = nn.Parameter(torch.from_numpy(z))
        self.bias = nn.Parameter(torch.randn(d_model))
        self.mlp_in = nn.Linear(emb_dim, order)
        self.num_inner_mlps = num_inner_mlps
        for i in range(num_inner_mlps + 1):
            setattr(self, f"sin_{i}", Sin(order, w))
        for i in range(num_inner_mlps):
            setattr(self, f"mlp_{i}", nn.Linear(order, order))
        self.mlp_out = nn.Linear(order, d_model, bias=False)
        self.register_buffer("t", torch.from_numpy(t), persistent=False)
        max_decay = math.log(target) / fast_decay_pct
        min_decay = math.log(target) / slow_decay_pct
        self.register_buffer("deltas", torch.linspace(min_decay, max_decay, d_model)[None],
                             persistent=False)

    def filter(self, L: int) -> torch.Tensor:
        """The filter (L, d_model) over the first L positions."""
        h = self.sin_0(self.mlp_in(self.pos_z[:L]))
        for i in range(self.num_inner_mlps):
            h = getattr(self, f"sin_{i + 1}")(getattr(self, f"mlp_{i}")(h))
        h = self.mlp_out(h)
        return h * torch.exp(-self.t[:L] * self.deltas.abs())


def _lin(lin: nn.Linear, x, dt):
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))


class HyenaOperator(nn.Module):
    """(standalone_hyena.py:188-254): order 2, input and output (B, T, C).
    ``forward`` is the whole operator; ``mix`` is its middle, between the
    input and output projections, which the modular layer runs through
    ``ops/adaln_linear`` with its AdaLN and its gate and residual folded
    in."""

    def __init__(self, d_model: int, l_max: int, order: int = 2, filter_order: int = 64):
        super().__init__()
        self.d_model, self.l_max, self.order = d_model, l_max, order
        inner = d_model * (order + 1)
        self.in_proj = nn.Linear(d_model, inner)
        self.short_filter = nn.Conv1d(inner, inner, 3, padding=2, groups=inner)
        self.filter_fn = HyenaFilter(d_model * (order - 1), order=filter_order, seq_len=l_max)
        self.out_proj = nn.Linear(d_model, d_model)

    @torch.no_grad()
    def reset_parameters(self):
        """The init of what is not a Dense layer, as the JAX package's: the
        short filter N(0, 1 / fan_in) (JAX: lecun's truncated normal) with a
        zero bias, the filter's bias N(0, 1), its frequencies 1 and its
        positional features."""
        w = self.short_filter.weight
        nn.init.normal_(w, std=(1.0 / (w.shape[1] * w.shape[2])) ** 0.5)
        nn.init.zeros_(self.short_filter.bias)
        f = self.filter_fn
        nn.init.normal_(f.bias)
        f.pos_z.copy_(torch.from_numpy(_positional_z(f.pos_z.shape[1], f.pos_z.shape[0])[0]))
        for i in range(f.num_inner_mlps + 1):
            nn.init.ones_(getattr(f, f"sin_{i}").freq)

    def mix(self, u: torch.Tensor) -> torch.Tensor:
        """u (Bn, 3C, T): the input projection, channels first -> (Bn, C, T)
        before the output projection, in u's dtype."""
        T = u.shape[-1]
        Lf = min(T, self.l_max)
        C = self.d_model
        conv = self.short_filter
        uc = F.conv1d(u, conv.weight.to(u.dtype), conv.bias.to(u.dtype), padding=2,
                      groups=u.shape[1])[..., :Lf]
        parts = torch.split(uc, C, dim=1)
        x, v = parts[:-1], parts[-1]
        k = self.filter_fn.filter(Lf).t().reshape(self.order - 1, C, Lf)
        bias = self.filter_fn.bias.reshape(self.order - 1, C)
        for o, x_i in enumerate(reversed(x[1:])):
            v = fftconv(v * x_i, k[o], bias[o])
        return v * x[0]

    def forward(self, u: torch.Tensor, dtype=None) -> torch.Tensor:
        """u (Bn, T, C) -> (Bn, T, C) in ``dtype`` (default u's)."""
        dt = dtype or u.dtype
        y = self.mix(_lin(self.in_proj, u, dt).transpose(1, 2))
        return _lin(self.out_proj, y.transpose(1, 2), dt)

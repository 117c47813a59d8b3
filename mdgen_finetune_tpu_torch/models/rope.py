"""ESM-style rotary position embedding (half-split rotation).

Counterpart of the JAX package's ``models/rope.py`` (fair-esm
RotaryEmbedding as applied at reference src/mdgen/model/mha.py:356-357).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def rope_tables_np(seq_len: int, dim: int):
    """cos, sin (seq_len, dim) float32: positions 0..seq_len-1, inverse
    frequencies over the head dim, duplicated across the two halves."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(seq_len, dtype=np.float32)
    freqs = np.einsum("i,j->ij", t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb), np.sin(emb)


@functools.lru_cache(maxsize=64)
def rope_tables(seq_len: int, dim: int, device=None, dtype=torch.float32):
    """cos, sin as tensors, made once per (size, device, dtype) and shared
    by every caller: never write into them."""
    cos, sin = rope_tables_np(seq_len, dim)
    return (torch.as_tensor(cos, device=device, dtype=dtype),
            torch.as_tensor(sin, device=device, dtype=dtype))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor):
    """q (..., N_q, D), k (..., N_k, D); positions 0..N-1 along dim -2.
    Tables are sized to N_k, so an appended bias-KV key sits at position N_q."""
    cos, sin = rope_tables(k.shape[-2], k.shape[-1], device=q.device, dtype=q.dtype)

    def rot(x):
        n = x.shape[-2]
        return x * cos[:n] + rotate_half(x) * sin[:n]

    return rot(q), rot(k)

"""Multi-head self-attention with RoPE and a learned bias-KV token.

Counterpart of the JAX package's ``models/attention.py`` (reference
src/mdgen/model/mha.py:60-407):

- q is scaled by head_dim**-0.5 before RoPE (mha.py:263); the denoiser
  folds that scale into the q projection;
- learned bias_k / bias_v are appended as one extra key at the sequence end,
  always attendable (mha.py:117-121, 265-280);
- RoPE runs after the append, so the bias key sits at position N
  (mha.py:356-357);
- padded keys are masked to -1e9 before an f32 softmax.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .rope import apply_rope

NEG_INF = -1e9
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)


def attention_core(q, k, v, key_valid, base2: bool = False):
    """Masked softmax attention: q (S, H, N, D) pre-scaled and roped; k, v
    (S, H, M, D); key_valid (S, M), 1 = attendable. ``base2``: q also carries
    log2(e) (the trunk's fold), so the logits are scaled back by ln 2 and the
    probabilities equal the kernels' exp2 softmax. Returns (S, H, N, D)."""
    logits = torch.einsum("shqd,shkd->shqk", q.float(), k.float())
    if base2:
        logits = logits * LN2
    logits = torch.where(key_valid[:, None, None, :] > 0, logits, NEG_INF)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("shqk,shkd->shqd", attn, v)


def dense_attn(q, k, v, mask, bias_k, bias_v, H: int, use_rope: bool = True,
               base2: bool = False):
    """Bias-KV + RoPE + masked softmax attention on (S, N, C) projections;
    ``mask`` (S, N) with 1 = valid (the bias key is always valid)."""
    S, N, C = q.shape
    D = C // H
    k = torch.cat([k, bias_k.reshape(1, 1, C).to(k.dtype).expand(S, 1, C)], dim=1)
    v = torch.cat([v, bias_v.reshape(1, 1, C).to(v.dtype).expand(S, 1, C)], dim=1)

    def split_heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, D).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if use_rope:
        q, k = apply_rope(q, k)
    ones = torch.ones(S, 1, dtype=q.dtype, device=q.device)
    key_valid = torch.cat([mask.to(q.dtype), ones], dim=1)
    out = attention_core(q, k, v, key_valid, base2=base2)
    return out.transpose(1, 2).reshape(S, N, C)


class MHAParams(nn.Module):
    """The parameters of one attention block, named as the JAX package's
    MHAParams / MultiheadAttention tree: q/k/v/out projections and the
    learned bias-KV token (C,)."""

    def __init__(self, C: int):
        super().__init__()
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(C, C)
        self.v_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, C)
        self.bias_k = nn.Parameter(torch.zeros(C))
        self.bias_v = nn.Parameter(torch.zeros(C))

"""The masked softmax shared by every attention of the port's plain
versions, and its constants.

``attention_core`` is the plain PyTorch counterpart of the JAX package's
``ops/fused_attention.py::_attention_xla``: f32 logits and softmax, the
weights rounded to q's dtype before their product with v. The plain twins of
the kernels (``ops/rope_attention``, ``ops/fused_attention``) build on it.
"""
from __future__ import annotations

import math

import torch

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

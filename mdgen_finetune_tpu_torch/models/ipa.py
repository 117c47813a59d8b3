"""Invariant Point Attention (c_z = 0 variant).

Counterpart of the JAX package's ``models/ipa.py`` (AF2 IPA as used by the
reference, src/mdgen/model/ipa.py:34-255, pair representation removed). The
fused kv / kv-points projections of the reference are held split by
columns (``linear_k`` / ``linear_v``, ``linear_k_points`` /
``linear_v_points``), as the JAX package's ``fold_encoder_ws`` splits them;
``utils.weights.from_flax`` does the split when loading.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..geometry.rigid import Rigid
from ..ops.ipa_attention import feat_width, ipa_attention


class IPAParams(nn.Module):
    """IPA's parameters: projections (C -> H*Ch scalars, C -> 3*H*P points,
    coordinate-major), raw head weights (softplus in compute) and the
    output projection."""

    def __init__(self, c_s: int, H: int = 4, Ch: int = 32, Pq: int = 8, Pv: int = 8):
        super().__init__()
        self.H, self.Ch, self.Pq, self.Pv = H, Ch, Pq, Pv
        self.linear_q = nn.Linear(c_s, H * Ch)
        self.linear_k = nn.Linear(c_s, H * Ch)
        self.linear_v = nn.Linear(c_s, H * Ch)
        self.linear_q_points = nn.Linear(c_s, 3 * H * Pq)
        self.linear_k_points = nn.Linear(c_s, 3 * H * Pq)
        self.linear_v_points = nn.Linear(c_s, 3 * H * Pv)
        # softplus(head_weights) = 1 at init (reference ipa.py head_weights)
        self.head_weights = nn.Parameter(torch.full((H,), float(np.log(np.expm1(1.0)))))
        self.linear_out = nn.Linear(feat_width(H, Ch, Pv), c_s)

    def projections(self):
        """The six input projections as one (C, proj_width) weight and bias,
        in ipa_attention's column order."""
        lins = (self.linear_q, self.linear_k, self.linear_v,
                self.linear_q_points, self.linear_k_points, self.linear_v_points)
        return (torch.cat([lin.weight.t() for lin in lins], dim=1),
                torch.cat([lin.bias for lin in lins]))


def ipa_forward(s: torch.Tensor, r: Rigid, frame_mask: torch.Tensor, ipa: IPAParams,
                dtype=torch.float32) -> torch.Tensor:
    """IPA on s (B, L, C) with frames r (B, L) and mask (B, L)."""
    B, L, C = s.shape
    w, b = ipa.projections()
    proj = (s.to(dtype).reshape(B * L, C) @ w.to(dtype) + b.to(dtype)).view(B, L, -1)
    if proj.is_cuda:
        proj = proj.float()
    feats = ipa_attention(proj, r.rot.float().contiguous(), r.trans.float().contiguous(),
                          frame_mask.float().contiguous(), ipa.head_weights.float(),
                          H=ipa.H, Ch=ipa.Ch, Pq=ipa.Pq, Pv=ipa.Pv,
                          out_dtype=torch.bfloat16 if proj.is_cuda else dtype)
    return feats.to(dtype) @ ipa.linear_out.weight.t().to(dtype) + ipa.linear_out.bias.to(dtype)

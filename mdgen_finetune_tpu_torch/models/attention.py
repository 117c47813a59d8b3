"""Multi-head self-attention with RoPE and a learned bias-KV token.

Counterpart of the JAX package's ``models/attention.py`` (reference
src/mdgen/model/mha.py:60-407):

- q is scaled by head_dim**-0.5 before RoPE (mha.py:263); the scale is
  folded into the q projection;
- learned bias_k / bias_v are appended as one extra key at the sequence end,
  always attendable (mha.py:117-121, 265-280);
- RoPE runs after the append, so the bias key sits at position N
  (mha.py:356-357);
- padded keys are masked to -1e9 before an f32 softmax.

``MultiheadAttention`` is the module of the modular layer (the JAX
package's ``MultiheadAttention``, :34-121) with the natural softmax: the
fused (C -> 3C) projection, then the factorized routes of ``tl = (T, L)``
(``ops/time_attention.time_attention`` over frames,
``ops/residue_attention.residue_attention`` over residues) or the dense
route on (S, N, C) (``ops/fused_attention.dense_attn``, whose core is the
``fused_attention`` kernel), then the out-projection. The products run
through ``ops/adaln_linear`` (the kernel on the card, its plain version on
the CPU); the modular layer folds its LayerNorm + modulate into the qkv
product and its gate and residual into the out-projection there.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.adaln_linear import adaln_linear
from ..ops.fused_attention import dense_attn  # noqa: F401  (re-exported)
from ..ops.residue_attention import residue_attention
from ..ops.time_attention import time_attention
from .attention_core import LN2  # noqa: F401  (re-exported)


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


class MultiheadAttention(MHAParams):
    """The modular layer's attention (module docstring); parameters as
    ``MHAParams``."""

    def __init__(self, C: int, num_heads: int, use_rope: bool = True):
        super().__init__(C)
        self.num_heads = num_heads
        self.use_rope = use_rope

    def fold(self, dt) -> dict:
        """The weights in the products' (in, out) layout and dtype ``dt``:
        ``wqkv`` (C, 3C) with head_dim**-0.5 folded into the q columns only
        (the JAX module's fold, :67-77), ``bqkv``, ``wout``, ``bout`` and the
        bias key and value ``bk``, ``bv`` (C,). Built in the caller's grad
        mode."""
        C = self.out_proj.weight.shape[0]
        scale = (C // self.num_heads) ** -0.5
        return dict(
            wqkv=torch.cat([self.q_proj.weight.t() * scale, self.k_proj.weight.t(),
                            self.v_proj.weight.t()], 1).to(dt).contiguous(),
            bqkv=torch.cat([self.q_proj.bias * scale, self.k_proj.bias, self.v_proj.bias]).to(dt),
            wout=self.out_proj.weight.t().to(dt).contiguous(), bout=self.out_proj.bias.to(dt),
            bk=self.bias_k.to(dt).contiguous(), bv=self.bias_v.to(dt).contiguous())

    def forward(self, x, mask=None, *, axis: str = "time", tl=None, w=None, dtype=None,
                shift=None, scale=None, gate=None):
        """x (B, N, C) with mask (B, N); or, for the factorized routes,
        x (B, T*L, C) with ``tl=(T, L)`` and mask (B, T, L) (the trunk's
        mask for both axes; the JAX module takes its transpose for "time"):
        axis "time" attends over T with batch (B, L), "residue" over L with
        batch (B, T). 1 = valid. ``w``: ``fold``'s weights (made here when
        None); ``dtype``: the compute dtype (default x's). With ``shift`` /
        ``scale`` (nb, C) the qkv product takes modulate(LN(x)) (the layer's
        AdaLN); with ``gate`` (nb, C) it returns x + gate * out. Returns x's
        shape in the compute dtype."""
        dt = dtype or x.dtype
        w = w if w is not None else self.fold(dt)
        C, H = x.shape[-1], self.num_heads
        rows = x.reshape(-1, C).to(dt)
        qkv = adaln_linear(rows, w["wqkv"], w["bqkv"], ln=None if shift is None else "plain",
                           shift=shift, scale=scale)
        if tl is not None:
            if not self.use_rope:
                raise NotImplementedError("the factorized routes assume RoPE (the JAX module's "
                                          "contract)")
            T, L = tl
            core = time_attention if axis == "time" else residue_attention
            att = core(qkv.view(x.shape[0], T, L, 3 * C), w["bk"], w["bv"],
                       mask.float().contiguous(), num_heads=H)
        else:
            S, N = x.shape[:2]
            if mask is None:
                mask = torch.ones(S, N, device=x.device)
            q3 = qkv.view(S, N, 3 * C)
            att = dense_attn(q3[..., :C], q3[..., C:2 * C], q3[..., 2 * C:], mask, w["bk"],
                             w["bv"], H, use_rope=self.use_rope)
        if gate is None:
            out = adaln_linear(att.reshape(-1, C), w["wout"], w["bout"])
        else:
            out = adaln_linear(att.reshape(-1, C), w["wout"], w["bout"], epilogue="gate_res",
                               res=rows, gate=gate)
        return out.view(x.shape)

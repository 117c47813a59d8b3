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
(``ops/residue_attention.ResidueAttentionFn``: ``residue_attention`` over
residues, ``time_attention`` over frames) or the dense route on (S, N, C)
(``ops/fused_attention.dense_attn``, whose core is the ``fused_attention``
kernel), then the out-projection. The products run through
``ops/adaln_linear`` (the kernel on the card, its plain version on the
CPU); with the layer's AdaLN rows the stage is ``ops/modular_stage.
adaln_stage``: its LayerNorm + modulate in the qkv product's prologue, its
gate and residual in the out-projection's epilogue, and a backward on
``linear_bwd`` / ``modln_bwd`` with the core's own (the natural short body
of ``rope_attention_bwd``, ``fused_attention_bwd``).

With ``dropout`` (training with ``model.dropout > 0``) every route runs
JAX's dense-probabilities path (``dense_attn`` with ``dropout``, :137-172),
the factorized ones folded to 3-D as JAX folds them (:103-117):
``ops/fused_attention.dense_attn_dropout``, plain tensor ops (XLA's in JAX) under autograd.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.adaln_linear import adaln_linear
from ..ops.fused_attention import dense_attn, dense_attn_dropout  # noqa: F401  (re-exported)
from ..ops.modular_stage import adaln_stage
from ..ops.residue_attention import residue_attention_train
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

    def core(self, shape, mask, *, axis: str = "time", tl=None, dropout=None):
        """The attention between the products, ``core(qkv (M, 3C), bias_k,
        bias_v) -> (M, C)``, for x of ``shape`` (``forward``'s routes)."""
        C, H = shape[-1], self.num_heads
        if tl is not None:
            if not self.use_rope:
                raise NotImplementedError("the factorized routes assume RoPE (the JAX module's "
                                          "contract)")
            T, L = tl
            B = shape[0]
            mask = mask.float().contiguous()
            if dropout is None:
                def core(u, bk, bv):
                    return residue_attention_train(u.view(B, T, L, 3 * C), bk, bv, mask,
                                                   num_heads=H, axis=axis).reshape(-1, C)
                return core
            if axis == "residue":
                def fold(t):
                    return t.reshape(B * T, L, C)

                def unfold(o):
                    return o.reshape(-1, C)
                mask3 = mask.reshape(B * T, L)
            else:
                def fold(t):
                    return t.reshape(B, T, L, C).transpose(1, 2).reshape(B * L, T, C)

                def unfold(o):
                    return o.reshape(B, L, T, C).transpose(1, 2).reshape(-1, C)
                mask3 = mask.transpose(1, 2).reshape(B * L, T)

            def core(u, bk, bv):
                return unfold(dense_attn_dropout(fold(u[:, :C]), fold(u[:, C:2 * C]),
                                                 fold(u[:, 2 * C:]), mask3, bk, bv, H, True,
                                                 dropout))
            return core
        S, N = shape[:2]
        if mask is None:
            mask = torch.ones(S, N)

        def core(u, bk, bv):
            q3 = u.view(S, N, 3 * C)
            m = mask.to(u.device)
            if dropout is None:
                o = dense_attn(q3[..., :C], q3[..., C:2 * C], q3[..., 2 * C:], m, bk, bv, H,
                               use_rope=self.use_rope)
            else:
                o = dense_attn_dropout(q3[..., :C], q3[..., C:2 * C], q3[..., 2 * C:], m, bk, bv,
                                       H, self.use_rope, dropout)
            return o.reshape(-1, C)
        return core

    def forward(self, x, mask=None, *, axis: str = "time", tl=None, w=None, dtype=None,
                shift=None, scale=None, gate=None, dropout=None):
        """x (B, N, C) with mask (B, N); or, for the factorized routes,
        x (B, T*L, C) with ``tl=(T, L)`` and mask (B, T, L) (the trunk's
        mask for both axes; the JAX module takes its transpose for "time"):
        axis "time" attends over T with batch (B, L), "residue" over L with
        batch (B, T). 1 = valid. ``w``: ``fold``'s weights (made here when
        None); ``dtype``: the compute dtype (default x's). With ``shift`` /
        ``scale`` / ``gate`` (nb, C) the layer's AdaLN stage,
        x + gate * out(modulate(LN(x))) (``adaln_stage``); with ``shift`` /
        ``scale`` alone the qkv product takes modulate(LN(x)).
        ``dropout``: a function of the probabilities (S, H, N, N + 1) (the
        layer's ``Dropout`` at this module's path): the dense-probabilities
        route. Differentiable when grad mode is on. Returns x's shape in the
        compute dtype."""
        dt = dtype or x.dtype
        w = w if w is not None else self.fold(dt)
        C = x.shape[-1]
        rows = x.reshape(-1, C).to(dt)
        core = self.core(x.shape, mask, axis=axis, tl=tl, dropout=dropout)
        if gate is not None:
            out = adaln_stage(rows, shift, scale, gate, w["wqkv"], w["bqkv"], w["wout"],
                              w["bout"], core, w["bk"], w["bv"])
        else:
            qkv = adaln_linear(rows, w["wqkv"], w["bqkv"], ln=None if shift is None else "plain",
                               shift=shift, scale=scale)
            out = adaln_linear(core(qkv, w["bk"], w["bv"]).contiguous(), w["wout"], w["bout"])
        return out.view(x.shape)

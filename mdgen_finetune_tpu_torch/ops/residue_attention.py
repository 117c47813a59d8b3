"""residue_attention: the modular layer's residue-attention core, attention
over the L residues of every frame with the natural softmax.

Counterpart of the JAX package's ``ops/residue_attention.py::
residue_attention`` (:244), whose TPU kernel at L <= ``MAX_L`` = 8 is
``_pallas_fwd`` (:141, the pair loop over the L (L + 1) (query, key) pairs
with head-summed logits) and which above MAX_L runs the time kernel
``_pallas_fwd_blocked`` with the axes swapped (:287-300). Here the core is
one of two hand-written kernels over the (B*T, L, 1, 3C) view of qkv (each
frame's L rows are contiguous, so no transpose; the bias key sits at
position L):

- ``rope_attention(base2=False)`` at L <= MAX_L: its short form, one warp
  per (frame, head) with the L + 1 keys in registers and the
  max-subtracted softmax;
- ``tiled_attention(base2=False)`` above, which streams key tiles with a
  running max.

The route is by L alone. JAX's further gate, ``local_B * T <= 8192`` rows
(:273-275), works around a TPU compiler fault; the card has no such limit.
``residue_attention_plain`` is the same function through the plain twins,
in the op order of the JAX package's ``_xla_impl`` (:208).

``ResidueAttentionFn`` makes the core differentiable, the counterpart of
the JAX package's ``_residue_attention_pallas`` custom VJP (``_ra_fwd`` /
``_ra_bwd`` :222-238): the forward is ``residue_attention``, the backward
``rope_attention_bwd(base2=False)`` over the same (B*T, L, 1) view (its
natural short body at L <= 16, the ``fused_attention`` route above), where
JAX takes ``jax.vjp`` of ``_xla_impl``. With ``axis="time"`` the same
Function is the frame core (``time_attention`` over (B, T, L), the backward
over that view). ``residue_attention_plain`` under autograd is its plain
twin.

Arguments: qkv (B, T, L, 3C) bf16 contiguous, the projections with q scaled
by head_dim**-0.5 (no log2(e): this is the natural softmax); bias_k / bias_v
(C,); mask (B, T, L) f32, 1 = valid (the bias key is always attendable).
Returns (B, T, L, C) before the out-projection.
"""
from __future__ import annotations

import torch

from .rope_attention import rope_attention, rope_attention_plain
from .rope_attention_bwd import rope_attention_bwd
from .tiled_attention import tiled_attention, tiled_attention_plain
from .time_attention import MAX_L, time_attention


def _attend(short_core, long_core, qkv, bias_k, bias_v, mask, num_heads):
    B, T, L, C3 = qkv.shape
    core = short_core if L <= MAX_L else long_core
    out = core(qkv.view(B * T, L, 1, C3), bias_k, bias_v, mask.reshape(B * T, L, 1),
               num_heads=num_heads, base2=False)
    return out.view(B, T, L, C3 // 3)


def residue_attention(qkv, bias_k, bias_v, mask, *, num_heads: int):
    """Attention over residues, batch (B, T) (module docstring)."""
    return _attend(rope_attention, tiled_attention, qkv, bias_k, bias_v, mask, num_heads)


def residue_attention_plain(qkv, bias_k, bias_v, mask, *, num_heads: int):
    """``residue_attention`` through the plain twins (same arguments)."""
    return _attend(rope_attention_plain, tiled_attention_plain, qkv, bias_k, bias_v, mask,
                   num_heads)


class ResidueAttentionFn(torch.autograd.Function):
    """The natural-softmax core as a differentiable op (module docstring):
    qkv (B, T, L, 3C), bias_k / bias_v (C,), mask (B, T, L) f32; ``axis``
    "residue" (over L) or "time" (over T). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias_k, bias_v, mask, num_heads, axis):
        core = residue_attention if axis == "residue" else time_attention
        ctx.save_for_backward(qkv, bias_k, bias_v, mask)
        ctx.num_heads, ctx.axis = num_heads, axis
        return core(qkv, bias_k, bias_v, mask, num_heads=num_heads)

    @staticmethod
    def backward(ctx, gout):
        qkv, bias_k, bias_v, mask = ctx.saved_tensors
        B, T, L, C3 = qkv.shape
        view = (B * T, L, 1) if ctx.axis == "residue" else (B, T, L)
        dqkv, dbk, dbv = rope_attention_bwd(
            qkv.view(*view, C3), gout.to(qkv.dtype).reshape(*view, C3 // 3).contiguous(),
            bias_k, bias_v, mask.reshape(view).contiguous(), num_heads=ctx.num_heads,
            base2=False)
        return (dqkv.view(qkv.shape), dbk.to(bias_k.dtype), dbv.to(bias_v.dtype), None, None,
                None)


def residue_attention_train(qkv, bias_k, bias_v, mask, *, num_heads: int,
                            axis: str = "residue"):
    """``residue_attention`` (``axis="time"``: ``time_attention``),
    differentiable in qkv and the bias key and value (``ResidueAttentionFn``)."""
    return ResidueAttentionFn.apply(qkv.contiguous(), bias_k.contiguous(), bias_v.contiguous(),
                                    mask.float().contiguous(), num_heads, axis)

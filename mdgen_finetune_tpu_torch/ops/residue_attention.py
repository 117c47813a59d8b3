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

Arguments: qkv (B, T, L, 3C) bf16 contiguous, the projections with q scaled
by head_dim**-0.5 (no log2(e): this is the natural softmax); bias_k / bias_v
(C,); mask (B, T, L) f32, 1 = valid (the bias key is always attendable).
Returns (B, T, L, C) before the out-projection.
"""
from __future__ import annotations

from .rope_attention import rope_attention, rope_attention_plain
from .tiled_attention import tiled_attention, tiled_attention_plain
from .time_attention import MAX_L


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

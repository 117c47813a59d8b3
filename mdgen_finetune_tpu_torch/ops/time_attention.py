"""time_attention_block: the whole frame-attention stage of a trunk layer,
and its backward at long T.

Counterpart of the JAX package's ``ops/time_attention.py::
time_attention_block`` (:1338-1413), whose TPU kernel at long T is
``_block_pallas_fwd_blocked`` (LN, modulate, qkv, RoPE, the attention core
with a query-block loop, out-projection, gate and residual in one program
per (batch element, residue)). Here it is three hand-written kernels:

    qkv  = adaln_linear(LN + modulate)              (M, 3C)
    att  = rope_attention | tiled_attention(B, T, L) attention over frames
    out  = x + g * (att @ wout + bout)              (adaln_linear, gate_res)

The core is routed by the JAX package's gate (``MAX_L``, ``MAX_T``):
``rope_attention``, which holds every key of a head in shared memory, at
L <= 8 and T <= 256; ``tiled_attention``, which streams key tiles, above.
``time_attention_block_plain`` is the same composition through the plain
twins: the counterpart of the JAX package's ``_block_xla_tl`` (:612). The
port has no frame padding, so JAX's ``t_logical`` is always None here.

``residue_rows_block`` is the residue stage at large L (L > ``MAX_L``, the
ATLAS crop-256 preset): the counterpart of the JAX package's
``residue_rows_block`` (:879), whose TPU kernel
``_block_pallas_fwd_blocked_rows`` (:695) runs the same body as row 6
(``_block_kernel_blocked``) over each frame's contiguous residue rows. Here
it is ``residue_block``'s composition with ``tiled_attention`` as its core,
over the (B*T, L, 1, 3C) view of qkv (no transpose: each frame's L rows are
contiguous, the bias key sits at position L); ``residue_rows_block_plain``,
the same through the plain twins, is the counterpart of ``_res_rows_xla``
(:798).

``time_attention_block_bwd`` is the stage's backward where
``rope_attention_bwd`` cannot hold a head's keys (T > 128): the
counterpart of the JAX package's ``_tbb_bwd`` (:659) on its XLA-twin route,
``jax.vjp`` of ``_block_xla_tl`` with ``fused_attention(base2=True)`` as
the attention core. It recomputes the stage from its saved input and runs

    qkv          = adaln_linear(LN + modulate)
    rows         (B*L, H, T, D) q; k, v with the bias key and value appended;
                 RoPE (the bias key at position T)
    o, stat      = fused_attention_fwd(q, k, v)
    y            = adaln_linear(att @ wout + bout, f32)     (for dg)
    dwout, dbout = linear_bwd wgrad (att, dout * g)
    datt         = linear_bwd dgrad (dout * g, wout)
    dq, dk, dv   = fused_attention_bwd(..., datt)
    the RoPE transpose of dq and dk; dbk, dbv = the sums at the bias position
    dwqkv, dbqkv = linear_bwd wgrad (LN + modulate(x), dqkv)
    dh           = linear_bwd dgrad (dqkv, wqkv)
    dx, (dsh, dsc, dg) = modln_bwd(x, dh, dout, y)

The layout changes and RoPE are plain tensor ops (XLA's in JAX); every
product and the attention core are the hand-written kernels.
``time_attention_block_bwd_plain`` is the same composition through the
plain twins.

``time_attention`` is the modular layer's frame-attention core alone, with
the natural softmax: the counterpart of the JAX package's
``time_attention`` (:1052) on qkv projected outside. Its TPU kernels are
``_pallas_fwd`` (:244) at L <= 8 and T <= 256 (gates :1089, :1096) and
``_pallas_fwd_blocked`` (:343) above; here ``rope_attention(base2=False)``
over (B, T, L, 3C), whose N + 1 keys of a head fit shared memory at
T <= 256, and ``tiled_attention(base2=False)`` above.
``time_attention_plain`` is the same through the plain twins, in the op
order of the JAX package's ``_xla_impl`` (:965).

Layouts: x (M, C) rows with M = B*T*L (row (b*T + t)*L + l); sh / sc / g
(nb, C) AdaLN rows with nb = B or 1; mask (B, T, L) f32, 1 = valid (the
JAX op takes its transpose (B, L, T)); wqkv (C, 3C) with the q columns
carrying head_dim**-0.5 * log2(e). ``out``: the destination of the residual
update (``out=x``: in place).
"""
from __future__ import annotations

import torch

from ..models.rope import rope_tables, rotate_half
from .adaln_linear import adaln_linear, adaln_linear_plain
from .fused_attention import (fused_attention_bwd, fused_attention_bwd_plain,
                              fused_attention_fwd, fused_attention_fwd_plain)
from .linear_bwd import linear_bwd, linear_bwd_plain
from .modln_bwd import modln_bwd, modln_bwd_plain
from .residue_block import _block as _residue_stage
from .rope_attention import rope_attention, rope_attention_plain
from .rope_attention_bwd import _rotate_half_t
from .tiled_attention import tiled_attention, tiled_attention_plain

# the JAX package's gates of the small-L / short-T kernels
# (mdgen_finetune_tpu/ops/time_attention.py:44-45)
MAX_L = 8
MAX_T = 256


def _block(lin, attn, x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, *,
           B: int, T: int, L: int, num_heads: int, out=None):
    C = x.shape[1]
    qkv = lin(x, wqkv, bqkv, ln="plain", shift=sh, scale=sc)
    att = attn(qkv.view(B, T, L, 3 * C), bias_k, bias_v, mask, num_heads=num_heads, base2=True)
    return lin(att.view(-1, C), wout, bout, epilogue="gate_res", res=x, gate=g, out=out)


def _short(T: int, L: int) -> bool:
    return L <= MAX_L and T <= MAX_T


def time_attention_block(x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, *,
                         B: int, T: int, L: int, num_heads: int, out=None):
    """x + g * out_proj(attend_T(qkv(modulate(LN(x))))) (module docstring)."""
    attn = rope_attention if _short(T, L) else tiled_attention
    return _block(adaln_linear, attn, x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v,
                  mask, B=B, T=T, L=L, num_heads=num_heads, out=out)


def time_attention_block_plain(x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, *,
                               B: int, T: int, L: int, num_heads: int, out=None):
    """``time_attention_block`` through the plain twins (same arguments)."""
    attn = rope_attention_plain if _short(T, L) else tiled_attention_plain
    return _block(adaln_linear_plain, attn, x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k,
                  bias_v, mask, B=B, T=T, L=L, num_heads=num_heads, out=out)


def time_attention(qkv, bias_k, bias_v, mask, *, num_heads: int):
    """Attention over frames, batch (B, L), natural softmax: qkv (B, T, L, 3C)
    bf16 with q scaled by head_dim**-0.5; bias_k / bias_v (C,); mask
    (B, T, L) f32 (the JAX op takes its transpose). Returns (B, T, L, C)."""
    B, T, L, _ = qkv.shape
    attn = rope_attention if _short(T, L) else tiled_attention
    return attn(qkv, bias_k, bias_v, mask, num_heads=num_heads, base2=False)


def time_attention_plain(qkv, bias_k, bias_v, mask, *, num_heads: int):
    """``time_attention`` through the plain twins (same arguments)."""
    B, T, L, _ = qkv.shape
    attn = rope_attention_plain if _short(T, L) else tiled_attention_plain
    return attn(qkv, bias_k, bias_v, mask, num_heads=num_heads, base2=False)


def residue_rows_block(x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, *,
                       B: int, T: int, L: int, num_heads: int, out=None):
    """The residue stage at large L (module docstring): arguments as
    ``residue_block``, mask (B, T, L) f32."""
    return _residue_stage(adaln_linear, tiled_attention, x, sh, sc, g, wqkv, bqkv, wout, bout,
                          bias_k, bias_v, mask, B=B, T=T, L=L, num_heads=num_heads, out=out)


def residue_rows_block_plain(x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, *,
                             B: int, T: int, L: int, num_heads: int, out=None):
    """``residue_rows_block`` through the plain twins (same arguments)."""
    return _residue_stage(adaln_linear_plain, tiled_attention_plain, x, sh, sc, g, wqkv, bqkv,
                          wout, bout, bias_k, bias_v, mask, B=B, T=T, L=L, num_heads=num_heads,
                          out=out)


# ---------------------------------------------------------------------------
# backward at long T
# ---------------------------------------------------------------------------

def _block_bwd(plain, x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, dout, *,
               B: int, T: int, L: int, num_heads: int, dmod=None):
    lin, lbwd, mbwd, afwd, abwd = (
        (adaln_linear_plain, linear_bwd_plain, modln_bwd_plain, fused_attention_fwd_plain,
         fused_attention_bwd_plain) if plain else
        (adaln_linear, linear_bwd, modln_bwd, fused_attention_fwd, fused_attention_bwd))
    M, C = x.shape
    H = num_heads
    D = C // H
    S = B * L
    qkv = lin(x, wqkv, bqkv, ln="plain", shift=sh, scale=sc)
    # (M, 3C) -> (3, B, L, H, T, D): q, k, v per (sequence, head)
    q5 = qkv.view(B, T, L, 3, H, D).permute(3, 0, 2, 4, 1, 5)

    def with_bias(t, b):
        return torch.cat([t, b.view(1, 1, H, 1, D).expand(B, L, H, 1, D)], 3).view(S, H, T + 1, D)

    cos, sin = rope_tables(T + 1, D, device=x.device)

    def rope(t, n):
        f = t.float()
        return (f * cos[:n] + rotate_half(f) * sin[:n]).to(t.dtype).contiguous()

    q = rope(q5[0].reshape(S, H, T, D), T)
    k = rope(with_bias(q5[1], bias_k), T + 1)
    v = with_bias(q5[2], bias_v)
    del qkv, q5
    key_valid = torch.cat([mask.permute(0, 2, 1).reshape(S, T).float(),
                           torch.ones(S, 1, device=x.device)], 1)
    o, stat = afwd(q, k, v, key_valid, base2=True)
    att = o.view(B, L, H, T, D).permute(0, 3, 1, 2, 4).reshape(M, C)
    y = lin(att, wout, bout, out_dtype=torch.float32)
    dwout, dbout = lbwd("wgrad", dout, att, gate=g)
    datt = lbwd("dgrad", dout, wout, gate=g, out_dtype=x.dtype)
    del att
    do = datt.view(B, T, L, H, D).permute(0, 2, 3, 1, 4).reshape(S, H, T, D).contiguous()
    dq, dk, dv = abwd(q, k, v, key_valid, o, stat, do, base2=True)
    del q, k, v, o, do, datt
    dq = dq.float()
    dk = dk.float()
    dq = dq * cos[:T] + _rotate_half_t(dq * sin[:T])
    dk = dk * cos + _rotate_half_t(dk * sin)
    dbk = dk[:, :, T].sum(0).reshape(C)
    dbv = dv[:, :, T].float().sum(0).reshape(C)
    # (3, S, H, T, D) -> (B, T, L, 3, H, D) -> (M, 3C)
    dqkv = torch.stack([dq, dk[:, :, :T], dv[:, :, :T].float()]).view(3, B, L, H, T, D)
    dqkv = dqkv.permute(1, 4, 2, 0, 3, 5).to(x.dtype).reshape(M, 3 * C)
    del dq, dk, dv
    dwqkv, dbqkv = lbwd("wgrad", dqkv, x, ln=True, shift=sh, scale=sc)
    dh = lbwd("dgrad", dqkv, wqkv)
    dx, dmod = mbwd(x, dh, dout, y, sc, dmod)
    return (dx, dmod[:, :C], dmod[:, C:2 * C], dmod[:, 2 * C:], dwqkv, dbqkv, dwout, dbout,
            dbk, dbv)


def time_attention_block_bwd(x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, dout,
                             *, B: int, T: int, L: int, num_heads: int, dmod=None):
    """The backward of ``time_attention_block`` at any T (module docstring):
    from the saved stage input x, the AdaLN rows, the weights, mask
    (B, T, L) f32 and ``dout`` (M, C) f32 it returns (dx, dsh, dsc, dg,
    dwqkv, dbqkv, dwout, dbout, dbk, dbv): dx (M, C) f32; dsh / dsc / dg
    (nb, C) f32 views of ``dmod`` (nb, 3C), written in place when given;
    the weight and bias-KV grads f32 sums over the batch."""
    return _block_bwd(False, x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask,
                      dout, B=B, T=T, L=L, num_heads=num_heads, dmod=dmod)


def time_attention_block_bwd_plain(x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask,
                                   dout, *, B: int, T: int, L: int, num_heads: int, dmod=None):
    """``time_attention_block_bwd`` through the plain twins (same arguments)."""
    return _block_bwd(True, x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask,
                      dout, B=B, T=T, L=L, num_heads=num_heads, dmod=dmod)

"""time_attention_block: the whole frame-attention stage of a trunk layer.

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

Layouts: x (M, C) rows with M = B*T*L (row (b*T + t)*L + l); sh / sc / g
(nb, C) AdaLN rows with nb = B or 1; mask (B, T, L) f32, 1 = valid (the
JAX op takes its transpose (B, L, T)); wqkv (C, 3C) with the q columns
carrying head_dim**-0.5 * log2(e). ``out``: the destination of the residual
update (``out=x``: in place).
"""
from __future__ import annotations

from .adaln_linear import adaln_linear, adaln_linear_plain
from .rope_attention import rope_attention, rope_attention_plain
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

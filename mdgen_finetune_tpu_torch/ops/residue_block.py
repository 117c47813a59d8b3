"""residue_block: the whole residue-attention stage of a trunk layer.

Counterpart of the JAX package's ``ops/residue_block.py::residue_block``
(:281), whose TPU kernel ``_s1_block_call`` (:154) fuses LN, modulate, qkv,
RoPE, the pair-loop attention over the L residues of each frame,
out-projection, gate and residual in one program per block of frames. Here
it is three hand-written kernels:

    qkv  = adaln_linear(LN + modulate)              (M, 3C)
    att  = rope_attention(B*T, L, 1)                 attention over residues
    out  = x + g * (att @ wout + bout)              (adaln_linear, gate_res)

``residue_block_plain`` is the same composition through the plain twins:
the counterpart of the JAX package's ``_s1_xla`` (:219).

Layouts as ``time_attention.time_attention_block``: x (M, C) rows with
M = B*T*L; sh / sc / g (nb, C); mask (B, T, L) f32, 1 = valid; ``out``: the
destination of the residual update (``out=x``: in place).
"""
from __future__ import annotations

from .adaln_linear import adaln_linear, adaln_linear_plain
from .rope_attention import rope_attention, rope_attention_plain


def _block(lin, attn, x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, *,
           B: int, T: int, L: int, num_heads: int, out=None):
    C = x.shape[1]
    qkv = lin(x, wqkv, bqkv, ln="plain", shift=sh, scale=sc)
    att = attn(qkv.view(B * T, L, 1, 3 * C), bias_k, bias_v, mask.reshape(B * T, L, 1),
               num_heads=num_heads, base2=True)
    return lin(att.view(-1, C), wout, bout, epilogue="gate_res", res=x, gate=g, out=out)


def residue_block(x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, *,
                  B: int, T: int, L: int, num_heads: int, out=None):
    """x + g * out_proj(attend_L(qkv(modulate(LN(x))))) (module docstring)."""
    return _block(adaln_linear, rope_attention, x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k,
                  bias_v, mask, B=B, T=T, L=L, num_heads=num_heads, out=out)


def residue_block_plain(x, sh, sc, g, wqkv, bqkv, wout, bout, bias_k, bias_v, mask, *,
                        B: int, T: int, L: int, num_heads: int, out=None):
    """``residue_block`` through the plain twins (same arguments)."""
    return _block(adaln_linear_plain, rope_attention_plain, x, sh, sc, g, wqkv, bqkv, wout,
                  bout, bias_k, bias_v, mask, B=B, T=T, L=L, num_heads=num_heads, out=out)

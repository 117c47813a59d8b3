"""The prepend-IPA conditioning encoder: NL IPALayers over (B, L) tokens.

Counterpart of the JAX package's ``ops/ipa_encoder.py::ipa_encoder``
(reference src/mdgen/model/latent_model.py:179-214, 341-394). The TPU ran
the whole stack as one streaming kernel; here each layer is a sequence of
the hand-written kernels:

    proj  = adaln_linear(affine LN eps 1e-5)     scalar + point projections
    feats = ipa_attention(proj, frames, mask)    IPA core
    x    += feats @ linear_out                   (adaln_linear, gate_res)
    qkv   = adaln_linear(LN + modulate)          residue MHA
    att   = rope_attention(B, L, 1), natural-exp softmax
            (no_rope: dense_qkv_attention, the fused_attention kernel)
    x    += g_l * (att @ out_m)
    hid   = adaln_linear(LN + modulate, GELU)    MLP
    x    += g_m * (hid @ w2)

On CPU tensors every op runs its plain PyTorch version, so the same code is
the plain twin of the JAX package's ``encoder_xla``.

Training: ``ipa_encoder`` is differentiable. Its backward recomputes the
stack through the ops' plain math (``*_math``, counted nowhere) and
differentiates that with autograd, as the JAX package's ``_enc_bwd``
(:560-574) takes ``jax.vjp`` through ``encoder_xla``; no kernel runs in the
backward. The recompute runs in f32 (the saved inputs and weights upcast,
the gradients cast back): in bf16 on the card it carried three times the
CPU's bf16 error into the IPA gradients at T = 1000 while the gradient
arriving from the trunk was as accurate as the CPU's, and the stack is
small (B x L tokens). ``ipa_encoder.bwd_recomputes`` counts those
recomputes.

With a ``dropout`` (training with ``model.dropout > 0``) the JAX package
leaves the fused encoder for its plain ``IPALayer`` modules (:359-386),
with dropout on the IPA weights and the MHA probabilities (:103, :110):
here the same stack through the plain math in f32 under autograd, the
residue MHA on dense probabilities (``dense_attn_dropout``), each mask
named ``ipa_layers_{i}/ipa`` and ``ipa_layers_{i}/mha_l``.
"""
from __future__ import annotations

import functools

import torch

from ..geometry.rigid import Rigid
from .adaln_linear import adaln_linear, adaln_linear_math
from .fused_attention import (dense_attn_dropout, dense_qkv_attention, fused_attention,
                              fused_attention_plain)
from .ipa_attention import ipa_attention, ipa_attention_math
from .rope_attention import rope_attention, rope_attention_math

# per-layer weight names (LatentMDGen.make_encoder_pack)
ENC_KEYS = ("ln_w", "ln_b", "wproj", "bproj", "head_weights", "wo_i", "bo_i",
            "wqkv_m", "bqkv_m", "wo_m", "bo_m", "bkm", "bvm", "w1", "b1", "w2", "b2")

KERNELS = (adaln_linear, rope_attention, ipa_attention)
PLAIN_MATH = (adaln_linear_math, rope_attention_math, ipa_attention_math)


def _ops(ops, use_rope: bool):
    """``ops`` with the residue attention without RoPE under ``no_rope``
    (the JAX IPALayer's ``MultiheadAttention(use_rope=not no_rope)``): the
    ``fused_attention`` kernel's route, or for the plain math its plain
    core (``fused_attention_plain``, differentiable)."""
    if use_rope:
        return ops
    core = fused_attention_plain if ops is PLAIN_MATH else fused_attention
    return (ops[0], functools.partial(dense_qkv_attention, use_rope=False, core=core), ops[2])


def _dropout_attn(drop, use_rope: bool):
    """The residue MHA on dense probabilities with ``drop`` on them, with
    ``rope_attention``'s arguments (G, N, 1, 3C)."""
    def attn(qkv, bk, bv, key_valid, *, num_heads: int, base2: bool):
        G, N, _, C3 = qkv.shape
        C = C3 // 3
        x = qkv.view(G, N, C3)
        o = dense_attn_dropout(x[..., :C], x[..., C:2 * C], x[..., 2 * C:], key_valid.view(G, N),
                               bk, bv, num_heads, use_rope, drop)
        return o.view(G, N, 1, C)
    return attn


def _stack(x, mods, flat_ws, rot, trans, mask, ops, dims, dropout=None):
    """The encoder's layers through ``ops`` = (linear, attention, ipa);
    every residual update writes a new tensor. ``dropout(path, p)``: the
    plain IPALayer path's masks (module docstring)."""
    num_heads_mha, Hi, Ch, Pq, Pv, use_rope = dims
    lin, attn, ipa = _ops(ops, use_rope)
    Bn, L, C = x.shape
    h = x.reshape(Bn * L, C)
    n = len(ENC_KEYS)
    for i in range(len(flat_ws) // n):
        w = dict(zip(ENC_KEYS, flat_ws[i * n:(i + 1) * n]))
        mod = mods[:, i * 6 * C:(i + 1) * 6 * C]

        def m(j, mod=mod):
            return mod[:, j * C:(j + 1) * C]

        proj = lin(h, w["wproj"], w["bproj"], ln="affine", ln_weight=w["ln_w"],
                   ln_bias=w["ln_b"], out_dtype=torch.float32)
        kw = {}
        if dropout is not None:
            kw = dict(dropout=functools.partial(dropout, f"ipa_layers_{i}/ipa"))
            attn = _dropout_attn(functools.partial(dropout, f"ipa_layers_{i}/mha_l"), use_rope)
        feats = ipa(proj.view(Bn, L, -1), rot, trans, mask, w["head_weights"],
                    H=Hi, Ch=Ch, Pq=Pq, Pv=Pv, out_dtype=h.dtype, **kw)
        h = lin(feats.view(Bn * L, -1), w["wo_i"], w["bo_i"], epilogue="gate_res", res=h)
        qkv = lin(h, w["wqkv_m"], w["bqkv_m"], ln="plain", shift=m(0), scale=m(1))
        att = attn(qkv.view(Bn, L, 1, 3 * C), w["bkm"], w["bvm"], mask.view(Bn, L, 1),
                   num_heads=num_heads_mha, base2=False)
        h = lin(att.view(-1, C), w["wo_m"], w["bo_m"], epilogue="gate_res", res=h, gate=m(2))
        hid = lin(h, w["w1"], w["b1"], ln="plain", shift=m(3), scale=m(4), epilogue="gelu")
        h = lin(hid, w["w2"], w["b2"], epilogue="gate_res", res=h, gate=m(5))
    return h.view(Bn, L, C)


class _EncoderFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mods, rot, trans, mask, dims, *flat_ws):
        ctx.save_for_backward(x, mods, rot, trans, mask, *flat_ws)
        ctx.dims = dims
        return _stack(x, mods, flat_ws, rot, trans, mask, KERNELS, dims)

    @staticmethod
    def backward(ctx, gout):
        ipa_encoder.bwd_recomputes += 1
        x, mods, rot, trans, mask, *flat_ws = ctx.saved_tensors
        need = ctx.needs_input_grad
        ins = [x, mods] + flat_ws
        flags = [need[0], need[1]] + list(need[6:])
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_(f) for t, f in zip(ins, flags)]
            out = _stack(leaves[0], leaves[1], leaves[2:], rot, trans, mask, PLAIN_MATH,
                         ctx.dims)
            wanted = [t for t, f in zip(leaves, flags) if f]
            got = iter(torch.autograd.grad(out, wanted, gout.float(), allow_unused=True))
        grads = [next(got) if f else None for f in flags]
        grads = [g if g is None else g.to(t.dtype) for g, t in zip(grads, ins)]
        return (grads[0], grads[1], None, None, None, None, *grads[2:])


def ipa_encoder(x, mods, ws, frames: Rigid, mask, *, num_heads_mha: int, Hi: int,
                Ch: int, Pq: int, Pv: int, use_rope: bool = True, dropout=None):
    """x (Bn, L, C) tokens; mods (nb, NL*6*C) AdaLN rows, nb dividing Bn
    (consecutive elements share a row); ``ws`` a list of per-layer dicts
    (``ENC_KEYS``); frames Rigid (Bn, L); mask (Bn, L); ``use_rope``: the
    residue attention's RoPE (off under the model's ``no_rope``);
    ``dropout``: ``models.layers.Dropout`` (the plain path, module
    docstring). Returns (Bn, L, C), differentiable in x, mods and the
    weights."""
    flat = [w[k] for w in ws for k in ENC_KEYS]
    if dropout is not None:
        out = _stack(x.float(), mods.float(), [t.float() for t in flat],
                     frames.rot.float(), frames.trans.float(), mask.float(), PLAIN_MATH,
                     (num_heads_mha, Hi, Ch, Pq, Pv, use_rope), dropout)
        return out.to(x.dtype)
    return _EncoderFn.apply(x, mods, frames.rot.to(torch.float32).contiguous(),
                            frames.trans.to(torch.float32).contiguous(),
                            mask.to(torch.float32).contiguous(),
                            (num_heads_mha, Hi, Ch, Pq, Pv, use_rope), *flat)


ipa_encoder.bwd_recomputes = 0

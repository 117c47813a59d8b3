"""Invariant Point Attention (c_z = 0 variant).

Counterpart of the JAX package's ``models/ipa.py`` (AF2 IPA as used by the
reference, src/mdgen/model/ipa.py:34-255, pair representation removed). The
fused kv / kv-points projections of the reference are held split by
columns (``linear_k`` / ``linear_v``, ``linear_k_points`` /
``linear_v_points``), as the JAX package's ``fold_encoder_ws`` splits them;
``utils.weights.from_flax`` does the split when loading.

Training: ``ipa_forward`` and ``ipa_block`` (the modular layer's
``interleave_ipa`` block, h + IPA(affine LN(h))) are differentiable. Their
forward on the card is the ``ipa_attention`` kernel (row c) between the
products; their backward recomputes the block in f32 through the plain math
and differentiates that with autograd, as ``ops/ipa_encoder._EncoderFn``
does for the encoder: JAX's layer IPA is XLA, with no Pallas backward.
With a dropout (``dropout_mask`` / ``dropout``: training with
``model.dropout > 0``) the weights are masked between the softmax and the
values (JAX :124-125), which the kernel cannot do: the block then runs the
plain math under autograd, in f32, as JAX runs that path in XLA.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..geometry.rigid import Rigid
from ..ops.adaln_linear import adaln_linear, adaln_linear_math
from ..ops.ipa_attention import feat_width, ipa_attention, ipa_attention_math

# the block's weights (models/denoiser._ipa_weights)
IPA_KEYS = ("ln_w", "ln_b", "wproj", "bproj", "head_weights", "wo_i", "bo_i")


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


class _IPACoreFn(torch.autograd.Function):
    """The IPA core differentiable: the forward ``ipa_attention`` (the kernel
    on the card), the backward autograd through ``ipa_attention_math`` in
    f32 from the saved inputs."""

    @staticmethod
    def forward(ctx, proj, rot, trans, mask, head_weights, dims, out_dtype):
        ctx.save_for_backward(proj, rot, trans, mask, head_weights)
        ctx.dims = dims
        H, Ch, Pq, Pv = dims
        return ipa_attention(proj, rot, trans, mask, head_weights, H=H, Ch=Ch, Pq=Pq, Pv=Pv,
                             out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, gout):
        proj, rot, trans, mask, hw = ctx.saved_tensors
        H, Ch, Pq, Pv = ctx.dims
        with torch.enable_grad():
            p, h = proj.detach().float().requires_grad_(), hw.detach().float().requires_grad_()
            out = ipa_attention_math(p, rot, trans, mask, h, H=H, Ch=Ch, Pq=Pq, Pv=Pv,
                                     out_dtype=torch.float32)
            dp, dh = torch.autograd.grad(out, [p, h], gout.float())
        return dp.to(proj.dtype), None, None, None, dh.to(hw.dtype), None, None


def ipa_forward(s: torch.Tensor, r: Rigid, frame_mask: torch.Tensor, ipa: IPAParams,
                dtype=torch.float32, dropout_mask=None) -> torch.Tensor:
    """IPA on s (B, L, C) with frames r (B, L) and mask (B, L) (JAX
    ``ipa_forward`` :70-136), differentiable when grad mode is on.
    ``dropout_mask``: a function of the attention weights (B, H, L, L)
    (the module docstring)."""
    B, L, C = s.shape
    w, b = ipa.projections()
    proj = (s.to(dtype).reshape(B * L, C) @ w.to(dtype) + b.to(dtype)).view(B, L, -1)
    rot, trans = r.rot.float().contiguous(), r.trans.float().contiguous()
    mask = frame_mask.float().contiguous()
    dims = (ipa.H, ipa.Ch, ipa.Pq, ipa.Pv)
    if dropout_mask is not None:
        feats = ipa_attention_math(proj.float(), rot, trans, mask, ipa.head_weights.float(),
                                   H=ipa.H, Ch=ipa.Ch, Pq=ipa.Pq, Pv=ipa.Pv,
                                   out_dtype=torch.float32, dropout=dropout_mask)
    elif proj.is_cuda:
        feats = _IPACoreFn.apply(proj.float().contiguous(), rot, trans, mask,
                                 ipa.head_weights.float(), dims, torch.bfloat16)
    else:
        feats = ipa_attention(proj, rot, trans, mask, ipa.head_weights.float(),
                              H=ipa.H, Ch=ipa.Ch, Pq=ipa.Pq, Pv=ipa.Pv, out_dtype=dtype)
    return feats.to(dtype) @ ipa.linear_out.weight.t().to(dtype) + ipa.linear_out.bias.to(dtype)


def _block(h, w, rot, trans, mask, dims, lin, core, **kw):
    """h + linear_out(IPA(affine LN(h))) for h (Bn*L, C) rows of Bn
    sequences of L tokens (``mask`` (Bn, L)) through the ops ``lin``
    (``adaln_linear`` or its math) and ``core`` (``ipa_attention`` or its
    math): the layer's form (``models/denoiser.LatentMDGenLayer``)."""
    H, Ch, Pq, Pv = dims
    Bn, L = mask.shape
    proj = lin(h, w["wproj"], w["bproj"], ln="affine", ln_weight=w["ln_w"], ln_bias=w["ln_b"],
               out_dtype=torch.float32)
    feats = core(proj.view(Bn, L, -1), rot, trans, mask, w["head_weights"], H=H, Ch=Ch, Pq=Pq,
                 Pv=Pv, out_dtype=h.dtype, **kw)
    return lin(feats.reshape(Bn * L, -1), w["wo_i"], w["bo_i"], epilogue="gate_res", res=h)


def _f32_block(h, flat, rot, trans, mask, dims, dropout=None):
    """``_block`` through the plain math in f32 (the recompute, the dropout
    path), cast back to h's dtype."""
    w = {k: t.float() for k, t in zip(IPA_KEYS, flat)}
    kw = {} if dropout is None else {"dropout": dropout}
    return _block(h.float(), w, rot, trans, mask, dims, adaln_linear_math, ipa_attention_math,
                  **kw).to(h.dtype)


class IPABlockFn(torch.autograd.Function):
    """``ipa_block`` differentiable (module docstring): the forward on the
    kernels, the backward autograd through the f32 plain math."""

    @staticmethod
    def forward(ctx, h, rot, trans, mask, dims, *flat):
        ctx.save_for_backward(h, rot, trans, mask, *flat)
        ctx.dims = dims
        return _block(h, dict(zip(IPA_KEYS, flat)), rot, trans, mask, dims, adaln_linear,
                      ipa_attention)

    @staticmethod
    def backward(ctx, gout):
        ipa_block.bwd_recomputes += 1
        h, rot, trans, mask, *flat = ctx.saved_tensors
        need = ctx.needs_input_grad
        flags = [need[0]] + list(need[5:])
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_(f) for t, f in zip([h] + flat, flags)]
            out = _f32_block(leaves[0], leaves[1:], rot, trans, mask, ctx.dims)
            wanted = [t for t, f in zip(leaves, flags) if f]
            got = iter(torch.autograd.grad(out.float(), wanted, gout.float(), allow_unused=True))
        grads = [next(got) if f else None for f in flags]
        grads = [g if g is None else g.to(t.dtype) for g, t in zip(grads, [h] + flat)]
        return (grads[0], None, None, None, None, *grads[1:])


def ipa_block(h, w: dict, rot, trans, mask, *, H: int, Ch: int, Pq: int, Pv: int,
              dropout=None):
    """h + IPA(affine LN(h)) (module docstring): h (Bn*L, C) rows in the
    compute dtype, ``w`` the block's weights (``IPA_KEYS``), rot (Bn, L, 3,
    3) / trans (Bn, L, 3) / mask (Bn, L) f32; ``dropout``: a function of the
    weights (Bn, H, L, L). Differentiable when grad mode is on. Returns the
    new h (Bn*L, C)."""
    dims = (H, Ch, Pq, Pv)
    if dropout is not None:
        return _f32_block(h, [w[k] for k in IPA_KEYS], rot, trans, mask, dims, dropout)
    if not torch.is_grad_enabled():
        return _block(h, w, rot, trans, mask, dims, adaln_linear, ipa_attention)
    return IPABlockFn.apply(h, rot, trans, mask, dims, *[w[k] for k in IPA_KEYS])


ipa_block.bwd_recomputes = 0

"""adaln_stage: one AdaLN stage of the modular layer, differentiable.

A stage of the JAX package's modular ``LatentMDGenLayer`` (:288-325) is

    out = x + g * (core(modulate(LN(x), sh, sc) @ w_in + b_in) @ w_out + b_out)

with ``core`` the residue or frame attention (``MultiheadAttention``'s
routes) or Hyena's long convolution, between the stage's two products. JAX
differentiates it through XLA. Here the forward runs the two products on
``adaln_linear`` (the LayerNorm + modulate in the first one's prologue, the
gate and residual in the second one's ``gate_res`` epilogue) and the core
between them; ``StageFn``'s backward composes the products' adjoints as
``ops/fused_layer_bwd.attention_stage_bwd`` does for the trunk's stages:

    y            = adaln_linear(a @ w_out + b_out, f32)       (for dg)
    dw_out, db_out = linear_bwd wgrad (a, dout * g)
    da           = linear_bwd dgrad (dout * g, w_out)
    du, d(core args) = the core's own backward (autograd over the graph
                   its forward kept: ``ResidueAttentionFn``,
                   ``FusedAttentionFn``, Hyena's FFT, the dropout path)
    dw_in, db_in = linear_bwd wgrad (LN + modulate(x), du)
    dh           = linear_bwd dgrad (du, w_in)
    dx, (dsh, dsc, dg) = modln_bwd(x, dh, dout, y)

On CPU tensors every op runs its plain version. ``adaln_stage`` without
grad mode runs the same forward and builds no graph (the samplers).

Layouts: x (M, C) rows in the compute dtype; sh / sc / g (nb, C) AdaLN rows,
nb dividing M; w_in (C, K), w_out (C', C) with a = core(u) (M, C'); the
core's extra tensor arguments ``args`` (bias key / value, Hyena's
parameters, keep masks) get gradients where they require them.
"""
from __future__ import annotations

import torch

from .adaln_linear import adaln_linear
from .linear_bwd import linear_bwd
from .modln_bwd import modln_bwd


def _forward(core, x, sh, sc, g, w_in, b_in, w_out, b_out, args):
    u = adaln_linear(x, w_in, b_in, ln="plain", shift=sh, scale=sc)
    a = core(u, *args).contiguous()
    return adaln_linear(a, w_out, b_out, epilogue="gate_res", res=x, gate=g)


class StageFn(torch.autograd.Function):
    """The stage (module docstring). Forward: the products on
    ``adaln_linear``, the core under autograd on a leaf copy of u so that
    its graph stays for the backward; saves x, the AdaLN rows and the
    weights (the core's graph holds what the core saved). Backward: the
    products' adjoints on ``linear_bwd`` / ``modln_bwd``, the core's by
    ``torch.autograd.grad`` over its graph."""

    @staticmethod
    def forward(ctx, core, x, sh, sc, g, w_in, b_in, w_out, b_out, *args):
        u = adaln_linear(x, w_in, b_in, ln="plain", shift=sh, scale=sc)
        with torch.enable_grad():
            ul = u.requires_grad_()
            a = core(ul, *args).contiguous()
        out = adaln_linear(a.detach(), w_out, b_out, epilogue="gate_res", res=x, gate=g)
        ctx.graph = (a, ul)
        ctx.arg_grads = [torch.is_tensor(t) and t.requires_grad for t in args]
        ctx.save_for_backward(x, sh, sc, g, w_in, w_out, b_out, *args)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, sh, sc, g, w_in, w_out, b_out, *args = ctx.saved_tensors
        a, ul = ctx.graph
        del ctx.graph
        need = ctx.needs_input_grad
        C = x.shape[1]
        dout = gout.float().contiguous()
        ad = a.detach()
        y = adaln_linear(ad, w_out, b_out, out_dtype=torch.float32)
        dw_out = db_out = None
        if need[7] or need[8]:
            dw_out, db_out = linear_bwd("wgrad", dout, ad, gate=g)
        da = linear_bwd("dgrad", dout, w_out, gate=g, out_dtype=x.dtype)
        wanted = [t for t, f in zip(args, ctx.arg_grads) if f]
        got = torch.autograd.grad(a, [ul] + wanted, da.to(a.dtype), allow_unused=True)
        du = got[0].contiguous()
        it = iter(got[1:])
        dargs = [next(it) if f else None for f in ctx.arg_grads]
        dargs = [d if d is None else d.to(t.dtype) for d, t in zip(dargs, args)]
        dw_in = db_in = None
        if need[5] or need[6]:
            dw_in, db_in = linear_bwd("wgrad", du, x, ln=True, shift=sh, scale=sc)
        dh = linear_bwd("dgrad", du, w_in)
        dx, dmod = modln_bwd(x, dh, dout, y, sc)

        def cast(d, t):
            return None if d is None else d.to(t.dtype)

        return (None, dx.to(x.dtype), cast(dmod[:, :C], sh), cast(dmod[:, C:2 * C], sc),
                cast(dmod[:, 2 * C:], g), cast(dw_in, w_in), cast(db_in, w_in),
                cast(dw_out, w_out), cast(db_out, b_out), *dargs)


def adaln_stage(x, sh, sc, g, w_in, b_in, w_out, b_out, core, *args):
    """``x + g * (core(modulate(LN(x)) @ w_in + b_in) @ w_out + b_out)``
    (module docstring): x (M, C); ``core(u, *args)`` -> (M, C'), a function
    of tensors that autograd can differentiate. Differentiable in x, the
    rows, the weights and ``args`` when grad mode is on; else the plain
    forward. Returns (M, C) in x's dtype."""
    if not torch.is_grad_enabled():
        return _forward(core, x, sh, sc, g, w_in, b_in, w_out, b_out, args)
    return StageFn.apply(core, x, sh, sc, g, w_in, b_in, w_out, b_out, *args)

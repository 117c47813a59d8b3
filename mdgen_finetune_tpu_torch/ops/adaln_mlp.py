"""adaln_mlp: the AdaLN MLP stage of a trunk layer, forward and backward.

Counterpart of the JAX package's ``ops/adaln_mlp.py::adaln_mlp`` (:311),
whose TPU kernels are ``_pallas_fwd`` (:112), which computes
x + g * MLP(modulate(LN(x))) with ``_gelu_fast`` in one pass, and its VJP
``_pallas_bwd`` (:218, body ``_bwd_kernel`` :148), which recomputes that
forward from the saved inputs and chains the gradients. Here each is a short
sequence of hand-written kernels. Forward:

    hid  = adaln_linear(LN + modulate, GELU)        (M, 4C)
    out  = x + g * (hid @ w2 + b2)                  (adaln_linear, gate_res)

Backward (``adaln_mlp_bwd``), with dout the gradient of ``out``:

    ge, a    = adaln_linear(LN + modulate, GELU, pre=a)   one fc1 product:
               the bf16 hidden and its f32 pre-activation a (for gelu'(a))
    y        = adaln_linear(ge @ w2 + b2, f32)            the pre-gate output (for dg)
    dw2, db2 = linear_bwd wgrad (ge, dout * g)
    da       = linear_bwd dgrad (dout * g, w2) * gelu'(a)
    dw1, db1 = linear_bwd wgrad (LN + modulate(x), da)
    dh       = linear_bwd dgrad (da, w1)
    dx, (dsh, dsc, dg) = modln_bwd(x, dh, dout, y)

``adaln_mlp_plain`` / ``adaln_mlp_bwd_plain`` are the same compositions
through the plain twins: the counterpart of the JAX package's
``adaln_mlp._xla_impl`` (:274) and of ``_pallas_bwd``.

Layouts: x (M, C) rows; sh / sc / g (nb, C) AdaLN rows with nb dividing M;
w1 (C, F), b1 (F,), w2 (F, C), b2 (C,); ``out``: the destination of the
residual update (``out=x``: in place).
"""
from __future__ import annotations

import torch

from .adaln_linear import adaln_linear, adaln_linear_plain
from .linear_bwd import linear_bwd, linear_bwd_plain
from .modln_bwd import modln_bwd, modln_bwd_plain


def _mlp(lin, x, sh, sc, g, w1, b1, w2, b2, out=None):
    hid = lin(x, w1, b1, ln="plain", shift=sh, scale=sc, epilogue="gelu")
    return lin(hid, w2, b2, epilogue="gate_res", res=x, gate=g, out=out)


def adaln_mlp(x, sh, sc, g, w1, b1, w2, b2, *, out=None):
    """x + g * MLP(modulate(LN(x))) (module docstring)."""
    return _mlp(adaln_linear, x, sh, sc, g, w1, b1, w2, b2, out=out)


def adaln_mlp_plain(x, sh, sc, g, w1, b1, w2, b2, *, out=None):
    """``adaln_mlp`` through the plain twin (same arguments)."""
    return _mlp(adaln_linear_plain, x, sh, sc, g, w1, b1, w2, b2, out=out)


def _mlp_bwd(lin, lbwd, mbwd, x, sh, sc, g, w1, b1, w2, b2, dout, dmod):
    a = torch.empty(x.shape[0], w1.shape[1], dtype=torch.float32, device=x.device)
    ge = lin(x, w1, b1, ln="plain", shift=sh, scale=sc, epilogue="gelu", pre=a)
    y = lin(ge, w2, b2, out_dtype=torch.float32)
    dw2, db2 = lbwd("wgrad", dout, ge, gate=g)
    da = lbwd("dgrad", dout, w2, gate=g, act=a, out_dtype=x.dtype)
    del a, ge
    dw1, db1 = lbwd("wgrad", da, x, ln=True, shift=sh, scale=sc)
    dh = lbwd("dgrad", da, w1)
    dx, dmod = mbwd(x, dh, dout, y, sc, dmod)
    C = x.shape[1]
    return dx, dmod[:, :C], dmod[:, C:2 * C], dmod[:, 2 * C:], dw1, db1, dw2, db2


def adaln_mlp_bwd(x, sh, sc, g, w1, b1, w2, b2, dout, *, dmod=None):
    """The backward of ``adaln_mlp`` (module docstring): from the saved
    input x, the AdaLN rows, the weights and ``dout`` (M, C) f32 it returns
    (dx, dsh, dsc, dg, dw1, db1, dw2, db2). dx (M, C) f32; dsh / dsc / dg
    (nb, C) f32 per batch element, views of ``dmod`` (nb, 3C), which is
    written in place when given; the weight grads f32 sums over all rows."""
    return _mlp_bwd(adaln_linear, linear_bwd, modln_bwd, x, sh, sc, g, w1, b1, w2, b2, dout,
                    dmod)


def adaln_mlp_bwd_plain(x, sh, sc, g, w1, b1, w2, b2, dout, *, dmod=None):
    """``adaln_mlp_bwd`` through the plain twins (same arguments)."""
    return _mlp_bwd(adaln_linear_plain, linear_bwd_plain, modln_bwd_plain, x, sh, sc, g, w1, b1,
                    w2, b2, dout, dmod)


class AdaLNMLPFn(torch.autograd.Function):
    """``adaln_mlp`` as a differentiable op (the JAX package's custom VJP,
    ``_pallas_fwd`` / ``_pallas_bwd``): the forward writes a new tensor and
    saves its inputs; the backward is ``adaln_mlp_bwd``, which recomputes
    the hidden layer from them."""

    @staticmethod
    def forward(ctx, x, sh, sc, g, w1, b1, w2, b2):
        ctx.save_for_backward(x, sh, sc, g, w1, b1, w2, b2)
        return adaln_mlp(x, sh, sc, g, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, gout):
        x, sh, sc, g, w1, b1, w2, b2 = ctx.saved_tensors
        grads = adaln_mlp_bwd(x, sh, sc, g, w1, b1, w2, b2, gout.float().contiguous())
        return tuple(d.to(t.dtype) for d, t in zip(grads, (x, sh, sc, g, w1, b1, w2, b2)))


def adaln_mlp_train(x, sh, sc, g, w1, b1, w2, b2):
    """``adaln_mlp`` into a new tensor, differentiable in every argument
    when grad mode is on (``AdaLNMLPFn``)."""
    if not torch.is_grad_enabled():
        return adaln_mlp(x, sh, sc, g, w1, b1, w2, b2)
    return AdaLNMLPFn.apply(x, sh, sc, g, w1, b1, w2, b2)

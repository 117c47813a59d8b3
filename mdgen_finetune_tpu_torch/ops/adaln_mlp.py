"""adaln_mlp: the AdaLN MLP stage of a trunk layer, forward.

Counterpart of the JAX package's ``ops/adaln_mlp.py::adaln_mlp`` (:311),
whose TPU kernel ``_pallas_fwd`` (:112) computes
x + g * MLP(modulate(LN(x))) with ``_gelu_fast`` in one pass. Here it is two
hand-written kernels:

    hid  = adaln_linear(LN + modulate, GELU)        (M, 4C)
    out  = x + g * (hid @ w2 + b2)                  (adaln_linear, gate_res)

``adaln_mlp_plain`` is the same composition through the plain twin: the
counterpart of the JAX package's ``adaln_mlp._xla_impl`` (:274). The
backward (``_pallas_bwd``) is not ported here: the trunk's training
backward runs ``ops/fused_layer_bwd.py``.

Layouts: x (M, C) rows; sh / sc / g (nb, C) AdaLN rows with nb dividing M;
w1 (C, F), b1 (F,), w2 (F, C), b2 (C,); ``out``: the destination of the
residual update (``out=x``: in place).
"""
from __future__ import annotations

from .adaln_linear import adaln_linear, adaln_linear_plain


def _mlp(lin, x, sh, sc, g, w1, b1, w2, b2, out=None):
    hid = lin(x, w1, b1, ln="plain", shift=sh, scale=sc, epilogue="gelu")
    return lin(hid, w2, b2, epilogue="gate_res", res=x, gate=g, out=out)


def adaln_mlp(x, sh, sc, g, w1, b1, w2, b2, *, out=None):
    """x + g * MLP(modulate(LN(x))) (module docstring)."""
    return _mlp(adaln_linear, x, sh, sc, g, w1, b1, w2, b2, out=out)


def adaln_mlp_plain(x, sh, sc, g, w1, b1, w2, b2, *, out=None):
    """``adaln_mlp`` through the plain twin (same arguments)."""
    return _mlp(adaln_linear_plain, x, sh, sc, g, w1, b1, w2, b2, out=out)

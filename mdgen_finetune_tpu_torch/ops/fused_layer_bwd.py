"""The backward of one trunk layer, stage by stage.

Counterpart of the JAX package's ``ops/fused_layer_bwd.py::fused_layer_bwd``
(:563), which runs three Pallas kernels in the order MLP -> frame attention
-> residue attention (``_k3_core`` :122, ``_k2_core`` :175, ``_k1_core``
:342). Here each stage is a short sequence of hand-written kernels; like
the TPU kernels, a stage RECOMPUTES its forward from its saved input (x_in,
X1 or X2) and nothing else of the forward is kept:

    MLP stage (input X2, upstream dOUT): ``ops/adaln_mlp.py::adaln_mlp_bwd``
      ge, a = adaln_linear(LN+mod, GELU, pre=a)  one fc1 product: the hidden
                                                 and its f32 pre-activation
      y   = adaln_linear(ge @ w2 + b2, f32)    the pre-gate output (for dg)
      dW2, db2 = linear_bwd wgrad (ge, dOUT * g8)
      da       = linear_bwd dgrad (dOUT * g8, w2) * gelu'(a)
      dW1, db1 = linear_bwd wgrad (LN+mod(X2), da)
      dh       = linear_bwd dgrad (da, w1)
      dX2, (dsh, dsc, dg) = modln_bwd(X2, dh, dOUT, y)
    attention stage (frame: input X1, view (B, T, L), N = T; residue:
    input x_in, view (B*T, L, 1), N = L):
      qkv, att = adaln_linear + the forward's core (recompute: rope_attention,
                 or tiled_attention where the forward took it, so the y
                 behind dg is the forward's own)
      y        = adaln_linear(att @ wout + bout, f32)
      dWout, dbout = linear_bwd wgrad (att, dX * g)
      datt         = linear_bwd dgrad (dX * g, wout)
      dqkv, dbk, dbv = the attention backward core (qkv, datt)
      dWqkv, dbqkv = linear_bwd wgrad (LN+mod(X), dqkv)
      dh           = linear_bwd dgrad (dqkv, wqkv)
      dX_in, (dsh, dsc, dg) = modln_bwd(X, dh, dX, y)

The attention backward core is routed per stage by N, as the JAX package
routes its stage backwards (``_k1`` / ``_k2`` of ``_layer_kernels``'
training form, row 8's ``rows_block_bwd`` / ``time_block_bwd`` where
``_blocked_bwd_fits``, the XLA-twin VJP with ``fused_attention`` above):
``rope_attention_bwd`` at N <= 128; ``blocked_attention_bwd`` up to its
``max_keys`` (N <= 319 at D = 24: ATLAS, L = 256 and T = 250); above that
``ops/time_attention.py::time_attention_block_bwd``, the same steps with the
``fused_attention`` kernels as its core (the 4AA preset's frame stage at
T = 1000; the residue stage with its view swapped, B*T sequences of L).

Weight and bias gradients are f32 sums over the whole batch; the AdaLN-row
gradients are per batch element. On CPU tensors every op runs its plain
version, so the same code is the plain twin.

``MDGEN_FUSED_BWD`` picks the route at each call, as the JAX package reads
it at trace time (``ops/fused_layer_bwd.py:644``, ``ops/fused_layer.py:992``):

- unset or ``""``: the split route above (``layer_bwd_split``);
- ``merged``: on the short route (L <= ``MAX_L`` and T <= ``MAX_T``, the
  shapes on which the JAX package reaches its ``fused_layer_bwd`` at all),
  ``ops/fused_layer_bwd_merged.py``: the whole layer as one cooperative
  kernel launch; elsewhere (T = 1000, ATLAS) the split route, as in the JAX
  package, where the variable changes nothing there.

The JAX package's ``xla`` value (its escape hatch, ``_fl_bwd`` :1006-1018,
``jax.vjp`` of the plain composition) has no route here: the plain
composition is what CPU tensors take on the split route, and a CUDA tensor
runs the kernels. Any other value, ``xla`` included, raises ``ValueError``.
"""
from __future__ import annotations

import os

import torch

from .adaln_linear import adaln_linear, adaln_linear_plain
from .adaln_mlp import adaln_mlp_bwd, adaln_mlp_bwd_plain
from .blocked_attention_bwd import blocked_attention_bwd, blocked_attention_bwd_plain, max_keys
from .fused_layer_bwd_merged import fused_layer_bwd_merged
from .linear_bwd import linear_bwd, linear_bwd_plain
from .modln_bwd import modln_bwd, modln_bwd_plain
from .rope_attention import rope_attention, rope_attention_plain
from .rope_attention_bwd import MAX_N, rope_attention_bwd, rope_attention_bwd_plain
from .tiled_attention import tiled_attention, tiled_attention_plain
from .time_attention import MAX_L, MAX_T, time_attention_block_bwd

ROUTES = ("", "merged")


def bwd_core(N: int, D: int, plain: bool = False):
    """The attention backward core of a stage over N tokens of head dim D
    (module docstring), or None for the ``fused_attention`` route; ``plain``:
    its plain twin."""
    if N <= MAX_N:
        return rope_attention_bwd_plain if plain else rope_attention_bwd
    if N <= max_keys(D):
        return blocked_attention_bwd_plain if plain else blocked_attention_bwd
    return None


def attention_stage_bwd(X, dout, mod, j, ws, mask, view, num_heads: int, dmod, *,
                        short: bool, plain: bool = False):
    """The backward of one attention stage of ``trunk_layer``, routed by its
    length N (module docstring).

    - ``X`` (M, C) the stage's saved input, ``dout`` (M, C) f32 the gradient
      of its output; ``mod`` (nb, 9C) the layer's AdaLN rows, of which the
      stage's are j, j + 1, j + 2 (0 residue, 3 frame); ``ws`` its weights
      (wqkv, bqkv, wout, bout, bias_k, bias_v); ``mask`` (B, T, L) f32;
    - ``view`` (G, N, I): the attention layout, over N for every (g, i)
      (residue (B*T, L, 1), frame (B, T, L));
    - ``short``: the forward's core was ``rope_attention`` (else
      ``tiled_attention``); ``dmod`` (nb, 9C) f32, its rows j .. j + 2 get
      (dsh, dsc, dg); ``plain``: every op through its plain twin, also on
      CUDA tensors (the short route only).

    Returns dX_in (M, C) f32 and the weight grads (dwqkv, dbqkv, dwout,
    dbout, dbk, dbv), f32 sums over the batch."""
    C = X.shape[1]
    G, N, I = view
    wqkv, bqkv, wout, bout, bk, bv = ws

    def m(i):
        return mod[:, i * C:(i + 1) * C]

    core = bwd_core(N, C // num_heads, plain)
    if core is None:
        dx_in, _, _, _, *grads = time_attention_block_bwd(
            X, m(j), m(j + 1), m(j + 2), *ws, mask.reshape(view), dout, B=G, T=N, L=I,
            num_heads=num_heads, dmod=dmod[:, j * C:(j + 3) * C])
        return dx_in, tuple(grads)
    if plain:
        lin, lbwd, mbwd = adaln_linear_plain, linear_bwd_plain, modln_bwd_plain
        attn = rope_attention_plain if short else tiled_attention_plain
    else:
        lin, lbwd, mbwd = adaln_linear, linear_bwd, modln_bwd
        attn = rope_attention if short else tiled_attention
    qkv = lin(X, wqkv, bqkv, ln="plain", shift=m(j), scale=m(j + 1)).view(*view, 3 * C)
    mk = mask.reshape(view)
    att = attn(qkv, bk, bv, mk, num_heads=num_heads, base2=True).view(-1, C)
    y = lin(att, wout, bout, out_dtype=torch.float32)
    dwout, dbout = lbwd("wgrad", dout, att, gate=m(j + 2))
    datt = lbwd("dgrad", dout, wout, gate=m(j + 2), out_dtype=X.dtype)
    dqkv, dbk, dbv = core(qkv, datt.view(*view, C), bk, bv, mk, num_heads=num_heads)
    dqkv = dqkv.view(-1, 3 * C)
    dwqkv, dbqkv = lbwd("wgrad", dqkv, X, ln=True, shift=m(j), scale=m(j + 1))
    dh = lbwd("dgrad", dqkv, wqkv)
    dx, _ = mbwd(X, dh, dout, y, m(j + 1), dmod[:, j * C:(j + 3) * C])
    return dx, (dwqkv, dbqkv, dwout, dbout, dbk, dbv)


def fused_layer_bwd(x_in, X1, X2, dout, mod, w, mask, num_heads: int, dmod=None):
    """The backward of ``trunk_layer`` for one layer, by the route that
    ``MDGEN_FUSED_BWD`` names (module docstring).

    - ``x_in``, ``X1``, ``X2`` (B*T*L, C): the layer's input and the inputs of
      its frame and MLP stages, as the training forward saved them;
    - ``dout`` (B*T*L, C) f32: the gradient of the layer's output;
    - ``mod`` (nb, 9C) the layer's AdaLN rows; ``w`` its weight dict
      (``ops/fused_layer.LAYER_KEYS``); ``mask`` (B, T, L) f32.

    Returns ``(dx, dmod, dw)``: dx (B*T*L, C) f32; dmod (nb, 9C) f32 (written
    into ``dmod`` when a row view is given); dw a dict of f32 weight grads
    with ``LAYER_KEYS``' names."""
    route = os.environ.get("MDGEN_FUSED_BWD", "")
    if route not in ROUTES:
        raise ValueError(f"MDGEN_FUSED_BWD={route!r}: the routes are {ROUTES}")
    B, T, L = mask.shape
    if route == "merged" and L <= MAX_L and T <= MAX_T:
        return fused_layer_bwd_merged(x_in, X1, X2, dout, mod, w, mask, num_heads, dmod)
    return layer_bwd_split(x_in, X1, X2, dout, mod, w, mask, num_heads, dmod)


def layer_bwd_split(x_in, X1, X2, dout, mod, w, mask, num_heads: int, dmod=None, *,
                    plain: bool = False):
    """The split route: the three stage backwards (module docstring), same
    arguments and results as ``fused_layer_bwd``; ``plain``: every op
    through its plain twin, also on CUDA tensors (the short route only)."""
    B, T, L = mask.shape
    C = x_in.shape[1]
    nb = mod.shape[0]
    if dmod is None:
        dmod = torch.empty(nb, 9 * C, dtype=torch.float32, device=x_in.device)

    def m(i):
        return mod[:, i * C:(i + 1) * C]

    # ---- stage 3: the MLP ----
    mlp_bwd = adaln_mlp_bwd_plain if plain else adaln_mlp_bwd
    dx2, _, _, _, dw1, db1, dw2, db2 = mlp_bwd(
        X2, m(6), m(7), m(8), w["w1"], w["b1"], w["w2"], w["b2"], dout, dmod=dmod[:, 6 * C:])
    # ---- stage 2: attention over frames ----
    tw = [w[k] for k in ("wqkv_t", "bqkv_t", "wout_t", "bout_t", "bkt", "bvt")]
    dx1, (dwqkv_t, dbqkv_t, dwout_t, dbout_t, dbkt, dbvt) = attention_stage_bwd(
        X1, dx2, mod, 3, tw, mask, (B, T, L), num_heads, dmod, short=L <= MAX_L and T <= MAX_T,
        plain=plain)
    del dx2
    # ---- stage 1: attention over residues ----
    lw = [w[k] for k in ("wqkv_l", "bqkv_l", "wout_l", "bout_l", "bkl", "bvl")]
    dx, (dwqkv_l, dbqkv_l, dwout_l, dbout_l, dbkl, dbvl) = attention_stage_bwd(
        x_in, dx1, mod, 0, lw, mask, (B * T, L, 1), num_heads, dmod, short=L <= MAX_L,
        plain=plain)
    dw = dict(wqkv_l=dwqkv_l, bqkv_l=dbqkv_l, wout_l=dwout_l, bout_l=dbout_l,
              wqkv_t=dwqkv_t, bqkv_t=dbqkv_t, wout_t=dwout_t, bout_t=dbout_t,
              w1=dw1, b1=db1, w2=dw2, b2=db2, bkl=dbkl, bvl=dbvl, bkt=dbkt, bvt=dbvt)
    return dx, dmod, dw


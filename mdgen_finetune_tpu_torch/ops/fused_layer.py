"""The denoiser trunk: every LatentMDGenLayer, with the embed, the output
head and the Euler update optionally folded in.

Counterpart of the JAX package's ``ops/fused_layer.py::fused_trunk`` in its
inference form (``_trunk_call`` with ``embed``, ``final`` and ``step_dt``)
and, as ``fused_trunk_train`` (``FusedTrunkFn``), in its training form
(``_fused_trunk_pallas``, whose backward is ``ops/fused_layer_bwd.py``).
The TPU ran the whole trunk as one streaming kernel with the activation
resident across layers; here each layer is three stage ops, each a short
sequence of the hand-written kernels (the JAX package's long-T path,
``_layer_kernels``, has the same three stages):

    residue_block          stage 1: attention over residues
      qkv_l = adaln_linear(LN + modulate); att = rope_attention(B*T, L, 1)
      x    += g_l * (att @ out_l)          (adaln_linear, gate_res, in place)
      (residue_rows_block at L > MAX_L = 8: the same with tiled_attention)
    time_attention_block   stage 2: attention over frames
      qkv_t = adaln_linear(LN + modulate)
      att   = rope_attention(B, T, L) at T <= 256, tiled_attention above
      x    += g_t * (att @ out_t)
    adaln_mlp              stage 3: MLP
      hid   = adaln_linear(LN + modulate, GELU); x += g_m * (hid @ w2)

So the flagship (T = 100), the 4AA forward-simulation preset (T = 1000)
and ATLAS (L = 256, T = 250) run one code path. On CPU tensors every op
runs its plain PyTorch version, so the same code is the plain twin of the
JAX package's ``_layer_xla`` / ``_embed_xla`` / ``_trunk_final_xla`` chain.
Fusing the layer into fewer launches is later work (ROADMAP).

Layouts: the trunk activation is (B, T, L, C) contiguous (no frame padding);
``mods`` holds every layer's 9-way AdaLN rows, (nb, NL*9*C) with nb = B or 1
(one row shared by the batch); weights are (in, out) with the q columns
carrying head_dim**-0.5 * log2(e) (the base-2 fold).
"""
from __future__ import annotations

import functools

import torch

from .adaln_linear import adaln_linear, adaln_linear_math
from .adaln_mlp import adaln_mlp
from .fused_layer_bwd import fused_layer_bwd
from .residue_block import residue_block
from .sharded_trunk import sharded_trunk
from .time_attention import MAX_L, residue_rows_block, time_attention_block

# per-layer weight names (LatentMDGen.make_trunk_pack)
LAYER_KEYS = ("wqkv_l", "bqkv_l", "wout_l", "bout_l", "wqkv_t", "bqkv_t", "wout_t",
              "bout_t", "w1", "b1", "w2", "b2", "bkl", "bvl", "bkt", "bvt")


def trunk_layer(x, mod, w, mask, *, B: int, T: int, L: int, num_heads: int, out=None):
    """One layer on the (B*T*L, C) activation ``x``: ``residue_block``
    (``residue_rows_block`` at L > MAX_L) -> ``time_attention_block`` ->
    ``adaln_mlp``, as the JAX package's ``_layer_kernels`` (:906-952) routes
    them. ``mod`` (nb, 9C): shift/scale/gate rows
    for the three stages. Each stage's residual update writes into ``out``
    (``out=x``: in place) or, with ``out=None``, into a new tensor, so that
    the stage inputs survive. Returns the inputs of the frame and MLP stages
    and the layer's output, (X1, X2, out)."""
    C = x.shape[1]

    def m(j):
        return mod[:, j * C:(j + 1) * C]

    dims = dict(B=B, T=T, L=L, num_heads=num_heads, out=out)
    stage1 = residue_rows_block if L > MAX_L else residue_block
    x1 = stage1(x, m(0), m(1), m(2), w["wqkv_l"], w["bqkv_l"], w["wout_l"], w["bout_l"],
                w["bkl"], w["bvl"], mask, **dims)
    x2 = time_attention_block(x1, m(3), m(4), m(5), w["wqkv_t"], w["bqkv_t"], w["wout_t"],
                              w["bout_t"], w["bkt"], w["bvt"], mask, **dims)
    y = adaln_mlp(x2, m(6), m(7), m(8), w["w1"], w["b1"], w["w2"], w["b2"], out=out)
    return x1, x2, y


def fused_trunk(x, mods, ws, mask, *, num_heads: int, final=None, embed=None,
                step_dt=None, layer=None):
    """All layers of the trunk.

    - ``x`` (B, T, L, C) activation, or with ``embed`` the f32 latent carry
      (B, T, L, lat);
    - ``mods`` (nb, NL*9*C); ``ws`` a list of per-layer weight dicts
      (``LAYER_KEYS``); ``mask`` (B, T, L) f32, 1 = valid;
    - ``embed = (wlat (lat, C), cadd (B, T, L, C), enc (B, L, C) or None)``:
      the first op projects the carry and adds the per-step-constant terms
      and the encoder rows (the JAX kernel's folded embed);
    - ``final = (modf (nb, 2C), wfin (C, out), bfin (out,))``: the
      FinalLayer head (LN + modulate + linear) emits the latent in f32;
    - ``step_dt``: with ``final``, the head's output is applied as the Euler
      update ``carry + dt * v`` — written IN PLACE into the carry ``x``,
      which is returned;
    - ``layer``: another layer body, ``layer(i, h, mod, w) -> new h`` for
      layer i on the (M, C) activation with its (nb, 9C) AdaLN rows and its
      entry of ``ws`` (the modular branch, ``models/denoiser.LatentMDGenLayer``);
      by default ``trunk_layer``, in place.

    Without ``embed``, ``x`` itself is updated in place as the trunk runs.
    Returns the trunk activation, the velocity (B, T, L, out) f32, or the
    updated carry. Under a registered mesh whose axes split T and L, the
    fused layers run sequence-split (``ops/sharded_trunk.py``)."""
    if layer is None:
        out = sharded_trunk(x, mods, ws, mask, num_heads=num_heads, final=final, embed=embed,
                            keys=LAYER_KEYS, local=functools.partial(fused_trunk,
                                                                     num_heads=num_heads))
        if out is not None:
            return out if step_dt is None else x.add_(out, alpha=step_dt)
    B, T, L = mask.shape
    M = B * T * L
    if embed is not None:
        wlat, cadd, enc = embed
        C = wlat.shape[1]
        h = adaln_linear(x.reshape(M, x.shape[-1]), wlat, None, epilogue="add",
                         add1=cadd.reshape(M, C),
                         add2=None if enc is None else enc.reshape(B * L, C),
                         add2_map=(T * L, L, L), out_dtype=cadd.dtype)
    else:
        C = x.shape[-1]
        h = x.reshape(M, C)
    mask = mask.to(torch.float32).contiguous()
    for i, w in enumerate(ws):
        mod = mods[:, i * 9 * C:(i + 1) * 9 * C]
        if layer is None:
            trunk_layer(h, mod, w, mask, B=B, T=T, L=L, num_heads=num_heads, out=h)
        else:
            h = layer(i, h, mod, w)
    if final is None:
        return h.view(B, T, L, C)
    modf, wfin, bfin = final
    out_c = wfin.shape[1]
    if step_dt is None:
        carry = torch.zeros(M, out_c, dtype=torch.float32, device=h.device)
        dt = 1.0
    else:
        carry = x.reshape(M, out_c)
        dt = step_dt
    adaln_linear(h, wfin, bfin, ln="plain", shift=modf[:, :C], scale=modf[:, C:],
                 epilogue="euler", res=carry, dt=dt, out=carry)
    return carry.view(B, T, L, out_c) if step_dt is None else x


# ---------------------------------------------------------------------------
# training form
# ---------------------------------------------------------------------------

def _head(h, modf, wfin, bfin):
    """The FinalLayer head (LN + modulate + linear) in plain PyTorch, in the
    compute dtype: its backward is autograd through this, as the JAX
    package takes the head's VJP through ``_trunk_final_xla`` /
    ``_final_xla``."""
    C = h.shape[1]
    return adaln_linear_math(h, wfin, bfin, ln="plain", shift=modf[:, :C], scale=modf[:, C:])


def _head_vjp(g, *inputs):
    """Gradients of ``_head`` at ``inputs`` = (h, modf, wfin, bfin) for the
    output gradient ``g``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = _head(*leaves)
        return torch.autograd.grad(out, leaves, g.reshape(out.shape).to(out.dtype))


class FinalLayerFn(torch.autograd.Function):
    """The FinalLayer on the trunk's output as its own product, the JAX
    package's ``_final_xla`` (``models/denoiser.py:185-191``) under the
    design head: the forward on ``adaln_linear`` (LN + modulate in its
    prologue, out in the compute dtype, as ``LatentMDGen.denoise`` runs
    it), the backward by autograd through the plain head math (``_head``),
    as ``FusedTrunkFn`` takes its folded head's. h (M, C), modf (nb, 2C),
    wfin (C, out), bfin (out,) -> (M, out)."""

    @staticmethod
    def forward(ctx, h, modf, wfin, bfin):
        C = h.shape[1]
        ctx.save_for_backward(h, modf, wfin, bfin)
        return adaln_linear(h, wfin, bfin, ln="plain", shift=modf[:, :C], scale=modf[:, C:])

    @staticmethod
    def backward(ctx, g):
        return _head_vjp(g, *ctx.saved_tensors)


class FusedTrunkFn(torch.autograd.Function):
    """The trunk with or without its output head, differentiable: the
    counterpart of the JAX package's ``_fused_trunk_pallas`` custom VJP
    (``ops/fused_layer.py:1162-1229``).

    Forward: the same kernels as ``fused_trunk``, but every stage writes its
    residual update into a new tensor, and each layer's input and its stage
    inputs X1 and X2 are saved (3 x B*T*L*C elements per layer). With
    ``remat`` (the model's ``grad_checkpointing``, the JAX package's
    ``nn.remat(LatentMDGenLayer)``) only each layer's input is saved, and
    the backward recomputes X1 and X2 with the same kernels: the loss and
    every gradient are bit for bit those of the run without it. Backward:
    the head's VJP (autograd through ``_head``), then ``fused_layer_bwd``
    for each layer in reverse. Inputs: x (B, T, L, C), mods (nb, NL*9C),
    modf (nb, 2C), wfin (C, out), bfin (out,), mask (B, T, L) f32,
    num_heads, remat, then the layers' weights flattened in ``LAYER_KEYS``
    order. Returns the velocity (B, T, L, out) f32. Without a head (modf,
    wfin and bfin None: the design tasks, whose FinalLayer and design head
    read the trunk's output) it returns the trunk's output (B, T, L, C) in
    the compute dtype, and the backward hands its incoming gradient, in
    f32, straight to the layers' sweep (JAX :1196-1198)."""

    @staticmethod
    def forward(ctx, x, mods, modf, wfin, bfin, mask, num_heads, remat, *flat_ws):
        B, T, L, C = x.shape
        M = B * T * L
        ws = _unflatten(flat_ws)
        h = x.reshape(M, C)
        saved = []
        for i, w in enumerate(ws):
            x1, x2, y = trunk_layer(h, mods[:, i * 9 * C:(i + 1) * 9 * C], w, mask, B=B, T=T,
                                    L=L, num_heads=num_heads)
            saved += [h] if remat else [h, x1, x2]
            h = y
        ctx.num_heads = num_heads
        ctx.remat = remat
        ctx.dims = (B, T, L, C)
        ctx.dtype = x.dtype
        if wfin is None:
            ctx.save_for_backward(mods, None, None, None, mask, None, *saved, *flat_ws)
            return h.view(B, T, L, C)
        carry = torch.zeros(M, wfin.shape[1], dtype=torch.float32, device=h.device)
        adaln_linear(h, wfin, bfin, ln="plain", shift=modf[:, :C], scale=modf[:, C:],
                     epilogue="euler", res=carry, dt=1.0, out=carry)
        ctx.save_for_backward(mods, modf, wfin, bfin, mask, h, *saved, *flat_ws)
        return carry.view(B, T, L, -1)

    @staticmethod
    def backward(ctx, gout):
        B, T, L, C = ctx.dims
        mods, modf, wfin, bfin, mask, h_last, *rest = ctx.saved_tensors
        per = 1 if ctx.remat else 3
        NL = len(rest) // (per + len(LAYER_KEYS))
        saved, flat_ws = rest[:per * NL], rest[per * NL:]
        ws = _unflatten(flat_ws)
        if wfin is None:
            g, dmodf, dwfin, dbfin = gout.reshape(B * T * L, C), None, None, None
        else:
            g, dmodf, dwfin, dbfin = _head_vjp(gout.float(), h_last, modf, wfin, bfin)
        g = g.float()
        dmods = torch.empty(mods.shape[0], NL * 9 * C, dtype=torch.float32, device=g.device)
        dws = [None] * NL
        for i in reversed(range(NL)):
            mod = mods[:, i * 9 * C:(i + 1) * 9 * C]
            if ctx.remat:
                x_in = saved[i]
                x1, x2, _ = trunk_layer(x_in, mod, ws[i], mask, B=B, T=T, L=L,
                                        num_heads=ctx.num_heads)
            else:
                x_in, x1, x2 = saved[3 * i:3 * i + 3]
            g, _, dws[i] = fused_layer_bwd(x_in, x1, x2, g, mod, ws[i], mask, ctx.num_heads,
                                           dmod=dmods[:, i * 9 * C:(i + 1) * 9 * C])
            del x1, x2
        dflat = [dws[i][k].to(w.dtype) for i in range(NL) for k, w in
                 zip(LAYER_KEYS, flat_ws[i * len(LAYER_KEYS):(i + 1) * len(LAYER_KEYS)])]
        return (g.view(B, T, L, C).to(ctx.dtype), dmods.to(mods.dtype), dmodf, dwfin,
                dbfin, None, None, None, *dflat)


def _unflatten(flat_ws):
    n = len(LAYER_KEYS)
    return [dict(zip(LAYER_KEYS, flat_ws[i:i + n])) for i in range(0, len(flat_ws), n)]


def fused_trunk_train(x, mods, ws, mask, *, num_heads: int, final=None, remat: bool = False):
    """The trunk, and its head with ``final = (modf, wfin, bfin)``, as a
    differentiable op (``FusedTrunkFn``): x (B, T, L, C); mods (nb, NL*9C);
    ``ws`` the per-layer weight dicts; ``remat``: save only each layer's
    input and recompute the rest in the backward. Returns the velocity
    (B, T, L, out) f32, or without ``final`` the trunk's output
    (B, T, L, C) in the compute dtype. Under a registered mesh whose axes
    split T and L, the trunk runs sequence-split, stage by stage
    (``ops/sharded_trunk.py``; ``remat`` does not apply there)."""
    out = sharded_trunk(x, mods, ws, mask, num_heads=num_heads, final=final, keys=LAYER_KEYS,
                        local=functools.partial(fused_trunk_train, num_heads=num_heads,
                                                remat=remat))
    if out is not None:
        return out
    flat = [w[k] for w in ws for k in LAYER_KEYS]
    return FusedTrunkFn.apply(x.contiguous(), mods, *(final or (None, None, None)),
                              mask.to(torch.float32).contiguous(), num_heads, remat, *flat)


def fused_layer_train(h, mod, w, mask, *, num_heads: int, remat: bool = False):
    """One trunk layer as a differentiable op (``FusedLayerFn``): h (M, C)
    rows of the (B, T, L) trunk, mod (nb, 9C) its AdaLN rows, ``w`` its
    weight dict (``LAYER_KEYS``); ``remat`` the model's
    ``grad_checkpointing``. Returns the layer's output (M, C)."""
    B, T, L = mask.shape
    C = h.shape[1]
    return fused_trunk_train(h.view(B, T, L, C), mod, [w], mask, num_heads=num_heads,
                             remat=remat).reshape(B * T * L, C)


# The per-layer form of ``FusedTrunkFn`` (one layer, no head): the
# counterpart of the JAX package's per-layer ``fused_layer`` custom VJP
# (``fused_layer`` :1026, ``_fl_fwd`` / ``_fl_bwd`` :964-1018), which the
# ``interleave_ipa`` layer runs after its IPA. Forward ``trunk_layer``
# saving X1 and X2 (or, with ``remat``, only the layer's input), backward
# ``fused_layer_bwd``.
FusedLayerFn = FusedTrunkFn

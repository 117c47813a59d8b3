"""The trunk with its frame and residue axes split over a mesh's sequence
axes: the Ulysses-style factorization of the JAX package's sharded stage
kernels (``ops/residue_block.py::_s1_frame_sharded``,
``ops/time_attention.py::_rows_frame_sharded``, their
``shard_map_batch_seq`` calls; SURVEY §2.7), for the shapes whose batch
does not divide the mesh (ATLAS crop-256 and T = 1000 at B = 1).

With s ranks in the sequence group, rank j holds
- a **frame** shard (B, T/s, L, C) for stage 1, the attention over residues
  (``residue_block``, or ``residue_rows_block`` at L > 8): every frame sees
  all its residues;
- a **residue** shard (B, T, L/s, C) for stage 2, the attention over frames
  (``time_attention_block``), and the MLP (row-local, either layout).

An all-to-all (``parallel/kernel_sharding.Swap``) turns one into the other
between the stages. Each rank's stage ops are the hand-written kernels,
called with their local T or L: the bias-KV token stays at position L and
T, since each stage still sees its whole attended axis. The region starts
from the frame shard of x (``Scatter``), its weights and AdaLN rows enter
through ``CopyToRegion`` (their gradients summed over the group), the head
runs on the residue shard, and its output is all-gathered along L.

Training cannot go through ``FusedTrunkFn``'s one-piece backward: the
all-to-alls lie between its stages. Each stage is its own autograd node
(``AttentionStageFn``: forward the stage op, backward
``fused_layer_bwd.attention_stage_bwd``; the MLP ``AdaLNMLPFn``; the head
``HeadFn``), chained by autograd through the swaps, so the backward runs
the same kernels as ``layer_bwd_split``, on the shards. Without grad mode
the same chain is the sampler's trunk.
"""
from __future__ import annotations

import math

import torch

from ..parallel.kernel_sharding import (get_kernel_mesh, kernel_mesh, shard_map_batch0,
                                       shard_map_batch_seq, swap)
from .adaln_linear import adaln_linear
from .adaln_mlp import AdaLNMLPFn
from .fused_layer_bwd import attention_stage_bwd
from .residue_block import residue_block
from .time_attention import MAX_L, MAX_T, residue_rows_block, time_attention_block

STAGE_KEYS = {"residue": ("wqkv_l", "bqkv_l", "wout_l", "bout_l", "bkl", "bvl"),
              "frame": ("wqkv_t", "bqkv_t", "wout_t", "bout_t", "bkt", "bvt")}


class AttentionStageFn(torch.autograd.Function):
    """One attention stage of ``trunk_layer`` as a differentiable op: x
    (M, C) rows of the (B, T, L) view ``dims`` = (stage, B, T, L, heads),
    ``mod3`` (nb, 3C) its shift / scale / gate rows, mask (B, T, L) f32,
    then the stage's six weights. Forward ``residue_block`` /
    ``residue_rows_block`` (stage "residue") or ``time_attention_block``
    ("frame") into a new tensor; backward ``attention_stage_bwd``, which
    recomputes the stage from its saved input."""

    @staticmethod
    def forward(ctx, x, mod3, mask, dims, *ws):
        stage, B, T, L, H = dims
        C = x.shape[1]
        if stage == "residue":
            op = residue_rows_block if L > MAX_L else residue_block
        else:
            op = time_attention_block
        ctx.dims = dims
        ctx.save_for_backward(x, mod3, mask, *ws)
        return op(x, mod3[:, :C], mod3[:, C:2 * C], mod3[:, 2 * C:], *ws, mask, B=B, T=T, L=L,
                  num_heads=H)

    @staticmethod
    def backward(ctx, g):
        stage, B, T, L, H = ctx.dims
        x, mod3, mask, *ws = ctx.saved_tensors
        if stage == "residue":
            view, short = (B * T, L, 1), L <= MAX_L
        else:
            view, short = (B, T, L), L <= MAX_L and T <= MAX_T
        dmod = torch.empty(mod3.shape, dtype=torch.float32, device=x.device)
        dx, grads = attention_stage_bwd(x, g.float().contiguous(), mod3, 0, ws, mask, view, H,
                                        dmod, short=short)
        return (dx.to(x.dtype), dmod.to(mod3.dtype), None, None,
                *(d.to(w.dtype) for d, w in zip(grads, ws)))


class HeadFn(torch.autograd.Function):
    """The FinalLayer head folded as ``FusedTrunkFn`` folds it: h (M, C),
    modf (nb, 2C), wfin (C, out), bfin (out,) -> (M, out) f32 (the
    ``euler`` epilogue over a zero carry); backward the head's VJP."""

    @staticmethod
    def forward(ctx, h, modf, wfin, bfin):
        C = h.shape[1]
        ctx.save_for_backward(h, modf, wfin, bfin)
        carry = torch.zeros(h.shape[0], wfin.shape[1], dtype=torch.float32, device=h.device)
        return adaln_linear(h, wfin, bfin, ln="plain", shift=modf[:, :C], scale=modf[:, C:],
                            epilogue="euler", res=carry, dt=1.0, out=carry)

    @staticmethod
    def backward(ctx, g):
        from .fused_layer import _head_vjp
        return _head_vjp(g.float(), *ctx.saved_tensors)


def _region(x, mods, mask, modf, wfin, bfin, wlat, cadd, enc, *flat, seq_group, num_heads,
            n_keys):
    """The trunk on this rank's shards: x (B, T/s, L, ·) the frame shard of
    the activation (or, with ``wlat``, of the latent carry, whose embed is
    folded as ``fused_trunk`` folds it); mask (B, T, L) whole; returns the
    residue shard (B, T, L/s, ·) of the head's output or of the trunk's."""
    B, T, L = mask.shape
    s = torch.distributed.get_world_size(seq_group)
    j = torch.distributed.get_rank(seq_group)
    Tl, Ll = T // s, L // s
    mask_f = mask[:, j * Tl:(j + 1) * Tl].contiguous()
    mask_r = mask[:, :, j * Ll:(j + 1) * Ll].contiguous()
    if wlat is not None:
        C = wlat.shape[1]
        M = B * Tl * L
        h = adaln_linear(x.reshape(M, x.shape[-1]), wlat, None, epilogue="add",
                         add1=cadd.reshape(M, C),
                         add2=None if enc is None else enc.reshape(B * L, C),
                         add2_map=(Tl * L, L, L), out_dtype=cadd.dtype)
    else:
        C = x.shape[-1]
        h = x.reshape(B * Tl * L, C)
    ws = [dict(zip(n_keys, flat[i:i + len(n_keys)])) for i in range(0, len(flat), len(n_keys))]
    for i, w in enumerate(ws):
        mod = mods[:, i * 9 * C:(i + 1) * 9 * C]
        h = AttentionStageFn.apply(h, mod[:, :3 * C], mask_f, ("residue", B, Tl, L, num_heads),
                                   *(w[k] for k in STAGE_KEYS["residue"]))
        h = swap(h.view(B, Tl, L, C), seq_group, 2, 1).reshape(B * T * Ll, C)
        h = AttentionStageFn.apply(h, mod[:, 3 * C:6 * C], mask_r, ("frame", B, T, Ll, num_heads),
                                   *(w[k] for k in STAGE_KEYS["frame"]))
        h = AdaLNMLPFn.apply(h, mod[:, 6 * C:7 * C], mod[:, 7 * C:8 * C], mod[:, 8 * C:],
                             w["w1"], w["b1"], w["w2"], w["b2"])
        if i < len(ws) - 1:
            h = swap(h.view(B, T, Ll, C), seq_group, 1, 2).reshape(B * Tl * L, C)
    if wfin is None:
        return h.view(B, T, Ll, C)
    return HeadFn.apply(h, modf, wfin, bfin).view(B, T, Ll, -1)


def sharded_trunk(x, mods, ws, mask, *, num_heads: int, final=None, embed=None, keys=None,
                  local=None):
    """The trunk (``fused_trunk`` / ``fused_trunk_train``) over the
    registered mesh, in the JAX package's order: split over the batch where
    it divides the mesh (``shard_map_batch0``: ``local(x, mods, ws, mask,
    final=[, embed=])`` runs the caller's whole trunk on this rank's elements,
    the weights' gradients summed over the batch axes), else over the
    sequence axes (``seq_shard_axes`` over gcd(T, L): the frame and residue
    shards above). None when no mesh is registered or nothing divides; the
    caller then runs the whole trunk. Arguments as ``fused_trunk``:
    ``final = (modf, wfin, bfin)``, ``embed = (wlat, cadd, enc)``; ``keys``
    the per-layer weight names. Returns the head's output (B, T, L, out)
    f32, or the trunk's (B, T, L, C), whole on every rank; differentiable
    when grad mode is on."""
    mesh = get_kernel_mesh()
    if mesh is None:
        return None
    B, T, L = mask.shape
    modf, wfin, bfin = final or (None, None, None)
    wlat, cadd, enc = embed or (None, None, None)
    flat = [w[k] for w in ws for k in keys]
    nb = mods.shape[0]
    per_row = (nb == B and B > 1, modf is not None and modf.shape[0] == B and B > 1)
    mask = mask.to(torch.float32).contiguous()

    def whole(x, mods, mask, modf, wfin, bfin, wlat, cadd, enc, *flat):
        n = len(keys)
        ws_ = [dict(zip(keys, flat[i:i + n])) for i in range(0, len(flat), n)]
        kw = {} if wlat is None else {"embed": (wlat, cadd, enc)}
        with kernel_mesh(None):
            return local(x, mods, ws_, mask, final=None if wfin is None else (modf, wfin, bfin),
                         **kw)

    args = (x, mods, mask, modf, wfin, bfin, wlat, cadd, enc, *flat)
    batched = (True, per_row[0], True, per_row[1], False, False, False, cadd is not None,
               enc is not None) + (False,) * len(flat)
    out = shard_map_batch0(whole, batched, *args, mesh=mesh)
    if out is not None:
        return out
    row = "b" if per_row[0] else None
    specs = (1, row, "b", "b" if per_row[1] else None, None, None, None,
             None if cadd is None else 1, None if enc is None else "b") + (None,) * len(flat)
    return shard_map_batch_seq(
        lambda *a, seq_group: _region(*a, seq_group=seq_group, num_heads=num_heads, n_keys=keys),
        specs, *args, seq_dim_size=math.gcd(T, L), out_spec=2, mesh=mesh)

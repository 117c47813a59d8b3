"""fused_attention: masked softmax attention over long key sequences, with
its backward, for the trunk's training path at long T.

Kernels: ``csrc/fused_attention.cu`` (forward) and
``csrc/fused_attention_bwd.cu`` (backward). They replace the JAX package's
``ops/fused_attention.py::_fwd_tpu`` (body ``_fwd_kernel``) and
``_bwd_tpu`` (body ``_bwd_kernel``), the TPU kernels that keep a whole
row's K/V (up to 4,096 keys) in VMEM. On the card the forward has two forms
(``long_attention.fused_plan``): the long one stages a row's keys and
values once in shared memory for a block of 8 warps that walk them with
tensor-core tiles of 16 queries (row g's design), the short one (at most 16
queries and 32 keys a row: the ``no_rope`` residue view) gives each query a
thread that works in f32 on the CUDA cores; the backward is two passes,
dq (a row's keys and values resident in shared memory) then dK / dV (its
queries and dout resident), each in windows where a row does not fit (the
schedule is ``long_attention.dq_plan`` / ``dkdv_plan``), so M has no cap
from shared memory.

Interface (the JAX package's ``fused_attention``): q (B, H, N, D) already
scaled (and RoPE'd); k, v (B, H, M, D); ``key_valid`` (B, M) f32 with
1 = attendable (None: every key). Two softmaxes:

- ``base2=True``: q also carries log2(e); the weights are
  ``exp2(min(l, 100))`` with no max, over their sum + 1e-30
  (``fused_attention.py:51-56``);
- ``base2=False``: the max-subtracted natural softmax of the logits (the
  kernel keeps a running max per key tile and rescales).

A masked key's logit is replaced by -1e9. The forward also returns one f32
statistic per query row, the log2 of the softmax denominator in base-2
units, so that the backward recomputes p = exp2(t - stat) without a second
pass over the keys.

- ``fused_attention`` is the differentiable op (``FusedAttentionFn``);
  ``fused_attention_plain`` is the port's twin of the JAX package's
  ``_attention_xla`` (``models/attention_core.py::attention_core``);
- ``fused_attention_fwd`` / ``fused_attention_bwd`` launch the kernels on
  CUDA tensors (or raise) and run their plain versions
  (``*_plain``, the same arithmetic in f32) on CPU tensors;
- ``dense_attn`` is the dense attention of the JAX package's
  ``models/attention.py::dense_attn`` on (S, N, C) projections (bias key,
  optional RoPE, then ``fused_attention``: its TPU route without dropout,
  :153), and ``dense_qkv_attention`` the same over ``rope_attention``'s
  (G, N, I, 3C) interface (the encoder's residue attention under
  ``no_rope``); ``dense_attn_dropout`` is JAX's ``dense_attn`` with
  dropout, on dense probabilities (training with ``model.dropout > 0``).
"""
from __future__ import annotations

import torch

from ..models.attention_core import LN2, LOG2E, NEG_INF, attention_core
from ..models.rope import apply_rope
from . import _cuda
from .long_attention import dkdv_plan, dq_plan, fused_plan

HEAD_DIMS = (16, 24, 32, 64)

# pointers, (R, N, M, H, D, base2), the stream, then the plan: form, chunk,
# window, rows per block, shared-memory bytes
_FWD_ARGTYPES = [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
                 _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P,
                 _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I64]
# pointers, (R, N, M, H, D, base2), the stream, then the schedule: the dq
# pass's (chunk, window) and the dK / dV pass's
_BWD_ARGTYPES = [_cuda.P] * 11 + [_cuda.I32] * 6 + [_cuda.P] + [_cuda.I32] * 4


def fused_attention_plain(q, k, v, key_valid=None, *, base2: bool = False):
    """The attention in plain PyTorch (``attention_core``: f32 logits and
    softmax, weights rounded to q's dtype before the product with v)."""
    if key_valid is None:
        key_valid = torch.ones(q.shape[0], k.shape[2], device=q.device)
    return attention_core(q, k, v, key_valid, base2=base2)


def _logits2(q, k, key_valid, base2):
    """f32 logits in base-2 units, masked keys replaced by -1e9."""
    t = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if not base2:
        t = t * LOG2E
    return torch.where(key_valid[:, None, None, :] > 0, t, NEG_INF)


def _weights(t, stat, base2):
    return torch.exp2((t.clamp(max=100.0) if base2 else t) - stat[..., None])


def _check(name, t, shape, dtype):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"fused_attention: {name} must be a contiguous {dtype} {tuple(shape)} "
                         "tensor")


def _dims(q, k, v, key_valid):
    B, H, N, D = q.shape
    M = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"fused_attention: head dim {D} is not supported (one of {HEAD_DIMS})")
    _check("q", q, (B, H, N, D), torch.bfloat16)
    _check("k", k, (B, H, M, D), torch.bfloat16)
    _check("v", v, (B, H, M, D), torch.bfloat16)
    _check("key_valid", key_valid, (B, M), torch.float32)
    return B, H, N, M, D


def fused_attention_fwd_plain(q, k, v, key_valid, *, base2: bool = False):
    """Plain PyTorch version of ``fused_attention_fwd`` (same arguments):
    the output of ``fused_attention_plain`` and the row statistic; counts
    its calls on CUDA tensors in ``cuda_calls``."""
    if q.is_cuda:
        fused_attention_fwd_plain.cuda_calls += 1
    t = _logits2(q, k, key_valid, base2)
    if base2:
        stat = torch.log2(torch.exp2(t.clamp(max=100.0)).sum(-1) + 1e-30)
    else:
        m = t.amax(-1)
        stat = m + torch.log2(torch.exp2(t - m[..., None]).sum(-1))
    return fused_attention_plain(q, k, v, key_valid, base2=base2), stat


fused_attention_fwd_plain.cuda_calls = 0


def fused_attention_fwd(q, k, v, key_valid, *, base2: bool = False):
    """The forward: (o (B, H, N, D), stat (B, H, N) f32). The kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if not q.is_cuda:
        return fused_attention_fwd_plain(q, k, v, key_valid, base2=base2)
    B, H, N, M, D = _dims(q, k, v, key_valid)
    q, k, v = map(_cuda.aligned, (q, k, v))
    o = torch.empty_like(q)
    stat = torch.empty(B, H, N, dtype=torch.float32, device=q.device)
    p = fused_plan(B * H, N, M, D)
    lib = _cuda.library("fused_attention", _FWD_ARGTYPES)
    code = lib.fused_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
                               o.data_ptr(), stat.data_ptr(), B * H, N, M, H, D, int(base2),
                               _cuda.stream_ptr(q), p.form, p.chunk, p.win, p.rows, p.smem)
    _cuda.check(code, "fused_attention")
    fused_attention_fwd.launches += 1
    fused_attention_fwd.forms[p.form] += 1
    return o, stat


fused_attention_fwd.launches = 0
fused_attention_fwd.forms = [0, 0]  # launches by form (long, short)


def fused_attention_bwd_plain(q, k, v, key_valid, o, stat, dout, *, base2: bool = False):
    """Plain PyTorch version of ``fused_attention_bwd`` (same arguments), in
    f32: P from the saved statistic, delta = rowsum(dout * o),
    ds = p * (dp - delta) on attendable keys (0 on masked ones), times ln 2
    in base 2; counts its calls on CUDA tensors in ``cuda_calls``."""
    if q.is_cuda:
        fused_attention_bwd_plain.cuda_calls += 1
    t = _logits2(q, k, key_valid, base2)
    p = _weights(t, stat.float(), base2)
    g = dout.float()
    delta = (g * o.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v.float())
    ds = torch.where(key_valid[:, None, None, :] > 0, p * (dp - delta), 0.0)
    if base2:
        ds = ds * LN2
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


fused_attention_bwd_plain.cuda_calls = 0


def fused_attention_bwd(q, k, v, key_valid, o, stat, dout, *, base2: bool = False):
    """The backward: (dq, dk, dv) in q's dtype from the forward's inputs,
    its output ``o``, its ``stat`` and the upstream gradient ``dout``. The
    kernel on CUDA tensors (deterministic: a dq pass over each row's keys,
    then a dK / dV pass over its queries, no atomics), the plain version on
    CPU tensors."""
    if not q.is_cuda:
        return fused_attention_bwd_plain(q, k, v, key_valid, o, stat, dout, base2=base2)
    B, H, N, M, D = _dims(q, k, v, key_valid)
    _check("o", o, (B, H, N, D), torch.bfloat16)
    _check("dout", dout, (B, H, N, D), torch.bfloat16)
    _check("stat", stat, (B, H, N), torch.float32)
    q, k, v, o, dout = map(_cuda.aligned, (q, k, v, o, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B * H * N, dtype=torch.float32, device=q.device)
    pq, pk = dq_plan(B * H, N, M, D), dkdv_plan(B * H, N, M, D)
    lib = _cuda.library("fused_attention_bwd", _BWD_ARGTYPES)
    code = lib.fused_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
                                   o.data_ptr(), dout.data_ptr(), stat.data_ptr(), dq.data_ptr(),
                                   dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B * H, N, M, H,
                                   D, int(base2), _cuda.stream_ptr(q), pq.chunk, pq.win, pk.chunk,
                                   pk.win)
    _cuda.check(code, "fused_attention_bwd")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


def fwd_resources(R: int, N: int, M: int, D: int, base2: bool = True) -> dict:
    """The forward's launch resources at that shape (on the card): its
    plan, registers and local (spill) bytes per thread, dynamic shared
    memory per block, resident blocks per SM."""
    p = fused_plan(R, N, M, D)
    lib = _cuda.library("fused_attention", _FWD_ARGTYPES)
    fn = lib.fused_attention_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.I32, _cuda.I64, _cuda.P]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(p.form, D, int(base2), p.smem, info), "fused_attention_resources")
    return dict(form=("long", "short")[p.form], registers=info[0], local_bytes=info[1],
                smem_bytes=info[2], blocks_per_sm=info[3], blocks=p.blocks,
                query_tiles_per_block=p.chunk, rows_per_block=p.rows, windows=p.windows)


def bwd_resources(R: int, N: int, M: int, D: int, base2: bool = True) -> dict:
    """The backward's launch resources at that shape (on the card), per
    pass: its schedule, registers and local (spill) bytes per thread,
    dynamic shared memory per block, resident blocks per SM."""
    lib = _cuda.library("fused_attention_bwd", _BWD_ARGTYPES)
    fn = lib.fused_attention_bwd_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P]
    out = {}
    for i, (name, sched) in enumerate((("dq", dq_plan(R, N, M, D)),
                                       ("dkdv", dkdv_plan(R, N, M, D)))):
        info = (_cuda.I64 * 4)()
        _cuda.check(fn(i, sched.win, D, int(base2), info), "fused_attention_bwd_resources")
        out[name] = dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2],
                         blocks_per_sm=info[3], blocks=sched.blocks, tiles_per_block=sched.chunk,
                         windows=sched.windows)
    return out


class FusedAttentionFn(torch.autograd.Function):
    """The JAX package's ``_attention_pallas`` custom VJP: the forward saves
    its inputs, its output and the row statistic; the backward recomputes P
    from them. ``key_valid`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, base2):
        o, stat = fused_attention_fwd(q, k, v, key_valid, base2=base2)
        ctx.save_for_backward(q, k, v, key_valid, o, stat)
        ctx.base2 = base2
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, o, stat = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, key_valid, o, stat,
                                         dout.to(o.dtype).contiguous(), base2=ctx.base2)
        return dq, dk, dv, None, None


def fused_attention(q, k, v, key_valid=None, *, base2: bool = False):
    """Masked softmax attention (module docstring), differentiable in q, k
    and v. Returns (B, H, N, D) in q's dtype."""
    if key_valid is None:
        key_valid = torch.ones(q.shape[0], k.shape[2], device=q.device)
    return FusedAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                  key_valid.float().contiguous(), base2)


def dense_attn(q, k, v, mask, bias_k, bias_v, H: int, use_rope: bool = True,
               base2: bool = False, core=None):
    """Bias-KV + (RoPE) + masked softmax attention on (S, N, C) projections;
    ``mask`` (S, N) with 1 = valid (the bias key is always valid). The layout
    changes and RoPE are plain tensor ops (XLA's in JAX); the core is
    ``fused_attention`` (the kernel on the card), or ``core`` with its
    arguments (``fused_attention_plain``: the encoder's f32 recompute)."""
    S, N, C = q.shape
    D = C // H
    k = torch.cat([k, bias_k.reshape(1, 1, C).to(k.dtype).expand(S, 1, C)], dim=1)
    v = torch.cat([v, bias_v.reshape(1, 1, C).to(v.dtype).expand(S, 1, C)], dim=1)

    def split_heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, D).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if use_rope:
        q, k = apply_rope(q, k)
    key_valid = torch.cat([mask.float(), torch.ones(S, 1, device=q.device)], dim=1)
    out = (core or fused_attention)(q, k, v, key_valid, base2=base2)
    return out.transpose(1, 2).reshape(S, N, C)


def dense_qkv_attention(qkv, bias_k, bias_v, key_valid, *, num_heads: int, base2: bool = False,
                        use_rope: bool = True, core=None):
    """``dense_attn`` with ``rope_attention``'s arguments: qkv (G, N, I, 3C),
    attention over N for every (g, i), key_valid (G, N, I). Returns
    (G, N, I, C)."""
    G, N, I, C3 = qkv.shape
    C = C3 // 3
    x = qkv.permute(0, 2, 1, 3).reshape(G * I, N, C3)
    mask = key_valid.permute(0, 2, 1).reshape(G * I, N)
    o = dense_attn(x[..., :C], x[..., C:2 * C], x[..., 2 * C:], mask, bias_k, bias_v, num_heads,
                   use_rope=use_rope, base2=base2, core=core)
    return o.reshape(G, I, N, C).permute(0, 2, 1, 3)


def dense_attn_dropout(q, k, v, mask, bias_k, bias_v, H: int, use_rope: bool, dropout):
    """The JAX package's ``dense_attn`` with ``dropout`` (:137-172): q, k, v
    (S, N, C), mask (S, N) 1 = valid; the bias key and value appended
    (always attendable), heads split, RoPE (the bias key at position N),
    logits in the operands' dtype plus (1 - valid) * -1e9, the f32 softmax
    rounded to v's dtype, ``dropout(probs)`` (S, H, N, N + 1), the product
    with v. Returns (S, N, C)."""
    S, N, C = q.shape
    D = C // H
    k = torch.cat([k, bias_k.reshape(1, 1, C).to(k.dtype).expand(S, 1, C)], dim=1)
    v = torch.cat([v, bias_v.reshape(1, 1, C).to(v.dtype).expand(S, 1, C)], dim=1)

    def split_heads(t):
        return t.reshape(S, t.shape[1], H, D).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if use_rope:
        q, k = apply_rope(q, k)
    valid = torch.cat([mask.to(q.dtype), torch.ones(S, 1, dtype=q.dtype, device=q.device)], 1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) + (1.0 - valid)[:, None, None, :] * NEG_INF
    probs = dropout(torch.softmax(logits.float(), dim=-1).to(v.dtype))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.transpose(1, 2).reshape(S, N, C)

"""rope_attention_bwd: the backward of ``rope_attention``, in base-2 mode
(the trunk's attention cores) and, for short sequences, in natural mode
(the modular layer's residue attention).

Kernel: ``csrc/rope_attention_bwd.cu`` (it replaces the attention adjoints
inside the JAX package's ``ops/fused_layer_bwd.py`` stage kernels ``_k2``
(frame attention, :258-309) and ``_k1`` (residue attention, :420-458)).
Short sequences (N <= 16) stream units of whole sequences (``short_plan``:
SPB sequences x HG heads) through a persistent grid, the next unit's q|k|v
and dO in flight while a thread per (sequence, head, query) forms each
exponent once for dq and a thread per (sequence, head, key) takes dk and dv
from the row's p and dl, in f32; longer ones
(up to ``MAX_N``, base 2 only) give a block of 4 warps one (sequence, head)
and run all six products on the tensor cores (``mma.sync``): RoPE'd q and
k in fp16 (scaled by powers of two into its range), p, v and dO in bf16,
ds in fp16 scaled by 1 / max|dO|. ``rope_attention_bwd_plain`` is the same
function in plain PyTorch; it runs for CPU tensors. For CUDA tensors the
wrapper launches the kernel or raises.

Same layout as the forward: ``qkv`` (G, N, I, 3C), attention over N for
every (g, i); ``dout`` (G, N, I, C) the gradient of the attention output;
``key_valid`` (G, N, I) f32. Two softmaxes:

- ``base2=True``: q carries scale * log2(e), the weights are
  exp2(min(l, 100)) with no max, and the adjoint carries a factor ln 2
  (``fused_layer_bwd.py:280-281, 437-438``);
- ``base2=False``: q carries the scale alone, the weights are the
  max-subtracted exp(l - max) / sum of ``rope_attention(base2=False)``
  (the JAX package's ``residue_attention._xla_impl(base2=False)``, whose
  ``jax.vjp`` is ``_ra_bwd`` :233-238), and the adjoint has no ln 2. The
  kernel takes N <= 16 (the short body with the row's maximum taken in
  registers before the exponent); above, the call runs
  ``fused_attention_fwd`` / ``fused_attention_bwd(base2=False)`` (row i)
  with RoPE and its transpose outside, as ``time_attention_block_bwd``
  treats long T and JAX's ``_ta_bwd`` (:1015-1030) its long rows.

    dl = c * p * (dp - rowsum(p * dp)),   dp = dO V^T,   dV = p^T dO,
    dq = dl K,   dk = dl^T q,             c = ln 2 (base 2) or 1 (natural)

then the RoPE transpose of dq and dk (``_rot_t`` :112) at their positions,
the bias key's at position N. Returns ``dqkv`` (G, N, I, 3C) in qkv's dtype
and the bias key's and value's gradients summed over every sequence, (C,)
f32 each.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.attention_core import LN2, NEG_INF
from ..models.rope import rope_tables, rotate_half
from . import _cuda
from ._cuda import SMS
from .fused_attention import fused_attention_bwd, fused_attention_fwd
from .rope_attention import SHORT_N, ShortPlan

MAX_N = 128  # a head's q, dO, k and v stay in shared memory, a row of p in registers
_ARGTYPES = [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
             _cuda.P, _cuda.P, _cuda.P, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32,
             _cuda.I32, _cuda.P, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32]
SHORT_THREADS = 128    # csrc/rope_attention_bwd.cuh: a thread per (sequence, head, query)
SHORT_BUDGET = 115_712  # bytes of a short block: two resident per SM (233,472 / 2 less 1 KB)


def short_bytes(spb: int, hg: int, N: int, D: int, nbuf: int, H: int) -> int:
    """Shared memory of a short backward unit (csrc/rope_attention_bwd.cuh
    ``ShortLayout``): ``nbuf`` raw buffers, each the bf16 q|k|v and dO of SPB
    sequences x HG heads and their tokens' key_valid (N rounded up to 4
    floats per sequence); q and k RoPE'd in f32 at a head stride of N * D + 4
    floats; the key biases; p and dl of every (query, key), f32, each
    rounded up to 16 bytes; the bias key and value of all H heads in f32."""
    kbs = (N + 3) // 4 * 4
    raw = spb * N * 4 * hg * D * 2 + spb * kbs * 4
    tile = -(-spb * hg * N * (N + 1) * 4 // 16) * 16
    return (nbuf * raw + 2 * spb * hg * (N * D + 4) * 4 + spb * kbs * 4 + 2 * tile
            + 2 * H * D * 4)


@functools.lru_cache(maxsize=256)
def short_plan(G: int, N: int, I: int, H: int, D: int, merged: bool = False) -> ShortPlan:
    """The short backward's unit (N <= 16) for a call over (G, N, I) with H
    heads of D: all H heads of a sequence unless its unit would pass
    ``SHORT_BUDGET`` (then the fewest even head groups that fit); about
    ``SHORT_THREADS`` keys per unit (SPB = 128 // (HG (N + 1)): the key
    side, a thread per key with the bias key, in one pass), no more
    sequences than leave 3 units per SM (of ``SMS``), and within the
    budget. ``merged``: one raw buffer (the merged layer backward's virtual
    blocks). The bits do not depend on the plan: each output's sums run in
    the same order whatever the unit."""
    if not 1 <= N <= SHORT_N:
        raise ValueError(f"short_plan: N = {N} is not a short sequence (1 <= N <= {SHORT_N})")
    nbuf = 1 if merged else 2
    S = G * I
    groups = 1
    while groups < H and short_bytes(1, -(-H // groups), N, D, nbuf, H) > SHORT_BUDGET:
        groups += 1
    hg = -(-H // groups)
    groups = -(-H // hg)
    spb = max(1, SHORT_THREADS // (hg * (N + 1)))
    spb = min(spb, max(1, S * groups // (3 * SMS)))
    while spb > 1 and short_bytes(spb, hg, N, D, nbuf, H) > SHORT_BUDGET:
        spb -= 1
    return ShortPlan(spb, hg, nbuf, short_bytes(spb, hg, N, D, nbuf, H), -(-S // spb) * groups)


def _rotate_half_t(g: torch.Tensor) -> torch.Tensor:
    """Adjoint of rotate_half: (g1, g2) -> (g2, -g1)."""
    g1, g2 = g.chunk(2, dim=-1)
    return torch.cat([g2, -g1], dim=-1)


def rope_attention_bwd_math(qkv, dout, bias_k, bias_v, key_valid, *, num_heads: int,
                            base2: bool = True, stage=None):
    """The plain PyTorch math of ``rope_attention_bwd`` (same arguments),
    computed in f32 and counted nowhere; ``blocked_attention_bwd_plain``
    runs it too. ``stage``: a dtype to round the RoPE'd q and k to (as
    ``rope_attention_math`` does): what that rounding alone costs. With
    ``base2=False`` the steps of ``jax.vjp`` of the JAX package's
    ``residue_attention._xla_impl(base2=False)``: natural logits, the
    max-subtracted softmax, no ln 2."""
    G, N, I, C3 = qkv.shape
    C, H = C3 // 3, num_heads
    D = C // H
    S = G * I
    x = qkv.float().permute(0, 2, 1, 3).reshape(S, N, C3)

    def heads(t):
        return t.reshape(S, t.shape[1], H, D).transpose(1, 2)

    q = heads(x[..., :C])
    k = heads(torch.cat([x[..., C:2 * C], bias_k.float().reshape(1, 1, C).expand(S, 1, C)], 1))
    v = heads(torch.cat([x[..., 2 * C:], bias_v.float().reshape(1, 1, C).expand(S, 1, C)], 1))
    cos, sin = rope_tables(N + 1, D, device=qkv.device)
    qr = q * cos[:N] + rotate_half(q) * sin[:N]
    kr = k * cos + rotate_half(k) * sin
    if stage is not None:
        qr, kr = qr.to(stage).float(), kr.to(stage).float()
    valid = torch.cat([key_valid.permute(0, 2, 1).reshape(S, N).float(),
                       torch.ones(S, 1, device=qkv.device)], dim=1)
    c = LN2 if base2 else 1.0
    logits = torch.einsum("shqd,shkd->shqk", qr, kr)
    if base2:
        logits = logits * LN2
    logits = torch.where(valid[:, None, None, :] > 0, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)  # (S, H, N, N+1)
    do = heads(dout.float().permute(0, 2, 1, 3).reshape(S, N, C))
    dv = torch.einsum("shqk,shqd->shkd", p, do)
    dp = torch.einsum("shqd,shkd->shqk", do, v)
    dl = c * p * (dp - (p * dp).sum(-1, keepdim=True))
    dqr = torch.einsum("shqk,shkd->shqd", dl, kr)
    dkr = torch.einsum("shqk,shqd->shkd", dl, qr)
    dq = dqr * cos[:N] + _rotate_half_t(dqr * sin[:N])
    dk = dkr * cos + _rotate_half_t(dkr * sin)

    def merge(t):  # (S, H, N, D) -> (G, N, I, C)
        return t.transpose(1, 2).reshape(G, I, N, C).permute(0, 2, 1, 3)

    dqkv = torch.cat([merge(dq), merge(dk[:, :, :N]), merge(dv[:, :, :N])], dim=-1)
    dbk = dk[:, :, N].sum(0).reshape(C)
    dbv = dv[:, :, N].sum(0).reshape(C)
    return dqkv.to(qkv.dtype).contiguous(), dbk, dbv


def rope_attention_bwd_plain(qkv, dout, bias_k, bias_v, key_valid, *, num_heads: int,
                             base2: bool = True):
    """Plain PyTorch version of ``rope_attention_bwd`` (same arguments),
    computed in f32; counts its calls on CUDA tensors in ``cuda_calls``."""
    if qkv.is_cuda:
        rope_attention_bwd_plain.cuda_calls += 1
    return rope_attention_bwd_math(qkv, dout, bias_k, bias_v, key_valid, num_heads=num_heads,
                                   base2=base2)


rope_attention_bwd_plain.cuda_calls = 0


def natural_long_bwd(qkv, dout, bias_k, bias_v, key_valid, *, num_heads: int):
    """The natural-softmax backward at N > 16 (module docstring): per
    sequence the RoPE'd q (S, H, N, D) and k, v with the bias key and value
    appended (the bias key RoPE'd at N), ``fused_attention_fwd(base2=False)``
    for the output and its row statistic, ``fused_attention_bwd``, then the
    RoPE transpose and the bias sums. Same arguments and results as
    ``rope_attention_bwd``; the layout changes and RoPE are plain tensor ops
    (XLA's in JAX), the two attention passes the row h / i kernels."""
    G, N, I, C3 = qkv.shape
    C, H = C3 // 3, num_heads
    D, S = C // H, G * I
    x = qkv.permute(0, 2, 1, 3).reshape(S, N, 3, H, D)

    def with_bias(t, b):  # (S, N, H, D) + the bias token -> (S, H, N + 1, D)
        return torch.cat([t, b.view(1, 1, H, D).to(t.dtype).expand(S, 1, H, D)], 1).transpose(1, 2)

    cos, sin = rope_tables(N + 1, D, device=qkv.device)

    def rope(t, n):
        f = t.float()
        return (f * cos[:n] + rotate_half(f) * sin[:n]).to(t.dtype).contiguous()

    q = rope(x[:, :, 0].transpose(1, 2), N)
    k = rope(with_bias(x[:, :, 1], bias_k), N + 1)
    v = with_bias(x[:, :, 2], bias_v).contiguous()
    valid = torch.cat([key_valid.permute(0, 2, 1).reshape(S, N).float(),
                       torch.ones(S, 1, device=qkv.device)], 1)
    o, stat = fused_attention_fwd(q, k, v, valid, base2=False)
    do = dout.permute(0, 2, 1, 3).reshape(S, N, H, D).transpose(1, 2).to(q.dtype).contiguous()
    dq, dk, dv = fused_attention_bwd(q, k, v, valid, o, stat, do, base2=False)
    dq, dk, dv = dq.float(), dk.float(), dv.float()
    dq = dq * cos[:N] + _rotate_half_t(dq * sin[:N])
    dk = dk * cos + _rotate_half_t(dk * sin)
    dbk = dk[:, :, N].sum(0).reshape(C)
    dbv = dv[:, :, N].sum(0).reshape(C)
    # (3, S, H, N, D) -> (G, I, N, 3, H, D) -> (G, N, I, 3C)
    d = torch.stack([dq, dk[:, :, :N], dv[:, :, :N]]).view(3, G, I, H, N, D)
    dqkv = d.permute(1, 4, 2, 0, 3, 5).reshape(G, N, I, C3).to(qkv.dtype).contiguous()
    return dqkv, dbk, dbv


def rope_attention_bwd(qkv, dout, bias_k, bias_v, key_valid, *, num_heads: int,
                       base2: bool = True):
    """The attention backward: the kernel on CUDA tensors, the plain
    version on CPU tensors (see the module docstring); with ``base2=False``
    at N > 16 the ``fused_attention`` route (``natural_long_bwd``)."""
    if not qkv.is_cuda:
        return rope_attention_bwd_plain(qkv, dout, bias_k, bias_v, key_valid,
                                        num_heads=num_heads, base2=base2)
    G, N, I, C3 = qkv.shape
    if not base2 and N > SHORT_N:
        return natural_long_bwd(qkv, dout, bias_k, bias_v, key_valid, num_heads=num_heads)
    C = C3 // 3
    D = C // num_heads
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("rope_attention_bwd: qkv must be a contiguous bf16 (G, N, I, 3C) tensor")
    if dout.dtype != torch.bfloat16 or dout.shape != (G, N, I, C) or not dout.is_contiguous():
        raise ValueError("rope_attention_bwd: dout must be a contiguous bf16 (G, N, I, C) tensor")
    if D not in (16, 24, 32, 64) or C % num_heads:
        raise ValueError(f"rope_attention_bwd: head dim {C}/{num_heads} is not supported")
    if N > MAX_N:
        raise ValueError(f"rope_attention_bwd: at most {MAX_N} keys per sequence, got {N}; "
                         "longer sequences take ops/blocked_attention_bwd.py (up to its "
                         "max_keys) or ops/time_attention.py::time_attention_block_bwd")
    if (bias_k.dtype != torch.bfloat16 or bias_v.dtype != torch.bfloat16
            or not bias_k.is_contiguous() or not bias_v.is_contiguous()):
        raise ValueError("rope_attention_bwd: bias_k / bias_v must be contiguous bf16 (C,)")
    if key_valid.dtype != torch.float32 or key_valid.shape != (G, N, I) \
            or not key_valid.is_contiguous():
        raise ValueError("rope_attention_bwd: key_valid must be a contiguous f32 (G, N, I) tensor")
    if qkv.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("rope_attention_bwd: qkv and dout must start on a 16-byte boundary "
                         "(the kernels read head rows as 16-byte vectors)")
    cos, sin = rope_tables(N + 1, D, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty(2, C, dtype=torch.float32, device=qkv.device)
    scratch = torch.empty(G * I * 2 * C, dtype=torch.float32, device=qkv.device)
    lib = _cuda.library("rope_attention_bwd", _ARGTYPES)
    p = short_plan(G, N, I, num_heads, D) if N <= SHORT_N else None
    # the short kernel's persistent grid: its resident blocks, at most a unit each
    grid = min(p.units, _slots(qkv.device.index, N, num_heads, C, p.spb, p.hg, base2)) \
        if p else 0
    code = lib.rope_attention_bwd(qkv.data_ptr(), dout.data_ptr(), bias_k.data_ptr(),
                                  bias_v.data_ptr(), key_valid.data_ptr(), cos.data_ptr(),
                                  sin.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
                                  scratch.data_ptr(), G, N, I, num_heads, C,
                                  _cuda.stream_ptr(qkv), p.spb if p else 0, p.hg if p else 0, grid,
                                  int(base2))
    _cuda.check(code, "rope_attention_bwd")
    rope_attention_bwd.launches += 1
    rope_attention_bwd.bodies[2 if not base2 else int(N > SHORT_N)] += 1
    return dqkv, dbias[0], dbias[1]


rope_attention_bwd.launches = 0
# launches by body: short base 2 (N <= 16), long (base 2), short natural
rope_attention_bwd.bodies = [0, 0, 0]


def _info(N: int, H: int, C: int, spb: int, hg: int, base2: bool = True):
    """The C query behind ``resources`` (the short kernel at plan (spb, hg),
    of the softmax ``base2``)."""
    fn = _cuda.built("rope_attention_bwd").rope_attention_bwd_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.I32, _cuda.P, _cuda.I32, _cuda.I32, _cuda.I32]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(N, H, C, info, spb, hg, int(base2)), "rope_attention_bwd_resources")
    return list(info)


@functools.lru_cache(maxsize=64)
def _slots(device: int, N: int, H: int, C: int, spb: int, hg: int, base2: bool = True) -> int:
    """Resident short blocks at plan (spb, hg) on card ``device``: its SMs x
    blocks per SM of this checkout's build (queried once per plan)."""
    with torch.cuda.device(device):
        per_sm = _info(N, H, C, spb, hg, base2)[3]
        if per_sm <= 0:
            raise RuntimeError(f"rope_attention_bwd: the short plan {(spb, hg)} fits no block "
                               "on an SM")
        return torch.cuda.get_device_properties(device).multi_processor_count * per_sm


def resources(N: int, num_heads: int, C: int, G: int = 1, I: int = 1,
              base2: bool = True) -> dict:
    """The launch resources of the kernel that a call over (G, N, I) runs
    (on the card): registers and local (spill) bytes per thread, dynamic
    shared memory per block, resident blocks per SM; at N <= 16 also the
    short body's plan (G and I matter only there)."""
    p = short_plan(G, N, I, num_heads, C // num_heads) if N <= SHORT_N else None
    info = _info(N, num_heads, C, p.spb if p else 0, p.hg if p else 0, base2)
    out = dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3])
    if p is not None:
        out["plan"] = dataclasses.asdict(p)
    return out

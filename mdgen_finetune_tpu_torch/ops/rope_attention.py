"""rope_attention: RoPE + bias-KV + masked softmax attention over one axis
of a (G, N, I, 3C) qkv tensor — the attention core of trunk stage 1, trunk
stage 2 and the encoder's residue MHA, and (``base2=False``) of the modular
layer's residue and frame attention.

Kernel: ``csrc/rope_attention.cu`` (it replaces the attention cores inside
the JAX package's ``ops/fused_layer.py::_trunk_call``,
``ops/ipa_encoder.py::_encoder_call``, ``ops/time_attention.py::_pallas_fwd``
and ``ops/residue_attention.py::_pallas_fwd``). Short sequences (N <= 16)
stream units of whole sequences (``short_plan``: SPB sequences x HG heads)
through a persistent grid, the next unit's q|k|v span in flight while a
thread per (sequence, head, query) attends in f32. Long ones give a block
of 4 warps one (sequence, head): the head's
N + 1 keys are staged once in shared memory (RoPE'd k in fp16, v in bf16)
and the warps take 16-query tiles through ``mma.sync`` tensor-core
products. ``rope_attention_plain`` is the same function in plain PyTorch
(the op order of the JAX package's ``time_attention._xla_impl`` /
``dense_attn``); it runs for CPU tensors. For CUDA tensors the wrapper
launches the kernel or raises.

Attention runs over N for every (g, i): stage 1 views the trunk as
(B*T, L, 1, 3C), stage 2 as (B, T, L, 3C), the encoder as (B, L, 1, 3C).
``key_valid`` (G, N, I), 1 = attendable; the bias key (RoPE'd at position N)
is always attendable. ``base2``: q carries scale*log2(e) and the softmax is
exp2 with no max subtraction (the trunk); otherwise natural exp (encoder,
modular layer). Returns (G, N, I, C). The long kernel stages the N+1 keys and
N queries of a head in shared memory, so N is capped (``max_keys``: 943 at
D = 24, 527 at D = 64); the wrapper raises ``ValueError`` beyond it, and
``tiled_attention`` takes any N.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.attention_core import attention_core
from ..models.rope import apply_rope, rope_tables
from . import _cuda
from ._cuda import SMS

_ARGTYPES = [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
             _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P,
             _cuda.I32, _cuda.I32, _cuda.I32]
SMEM_BYTES = 232_448  # the shared memory one block may use on an H100
SHORT_N = 16          # the short body takes N <= 16
SHORT_THREADS = 128   # csrc/rope_attention.cuh: a thread per (sequence, head, query)
SHORT_BUDGET = 57_344  # bytes of a short block: four resident per SM (233,472 less 1 KB each)


def short_bytes(spb: int, hg: int, N: int, D: int, nbuf: int, H: int) -> int:
    """Shared memory of a short unit (csrc/rope_attention.cuh ``ShortLayout``):
    ``nbuf`` raw buffers, each the bf16 q|k|v of SPB sequences x HG heads (V
    is read there, the output written over q) and their tokens' key_valid
    (N rounded up to 4 floats per sequence); K RoPE'd in f32 at a head
    stride of N * D + 4 floats; the key biases (as key_valid); the bias key
    and value of all H heads in f32."""
    kbs = (N + 3) // 4 * 4
    raw = spb * N * 3 * hg * D * 2 + spb * kbs * 4
    return nbuf * raw + spb * hg * (N * D + 4) * 4 + spb * kbs * 4 + 2 * H * D * 4


@dataclasses.dataclass(frozen=True)
class ShortPlan:
    spb: int     # sequences per unit
    hg: int      # heads per unit (H unless a sequence's heads do not fit the budget)
    nbuf: int    # raw buffers: 2 streaming (the next unit in flight), 1 merged
    smem: int    # bytes of shared memory per block
    units: int   # units of the call


@functools.lru_cache(maxsize=256)
def short_plan(G: int, N: int, I: int, H: int, D: int, merged: bool = False) -> ShortPlan:
    """The short body's unit (N <= 16) for a call over (G, N, I) with H heads
    of D: all H heads of a sequence unless its unit would pass
    ``SHORT_BUDGET`` (then the fewest even head groups that fit); about
    ``SHORT_THREADS`` queries per unit (SPB = 128 // (HG N)), no more
    sequences than leave 3 units per SM (of ``SMS``), and within the budget. ``merged``:
    one raw buffer (the merged layer backward's virtual blocks)."""
    if not 1 <= N <= SHORT_N:
        raise ValueError(f"short_plan: N = {N} is not a short sequence (1 <= N <= {SHORT_N})")
    nbuf = 1 if merged else 2
    S = G * I
    groups = 1
    while groups < H and short_bytes(1, -(-H // groups), N, D, nbuf, H) > SHORT_BUDGET:
        groups += 1
    hg = -(-H // groups)
    groups = -(-H // hg)
    spb = max(1, SHORT_THREADS // (hg * N))
    spb = min(spb, max(1, S * groups // (3 * SMS)))
    while spb > 1 and short_bytes(spb, hg, N, D, nbuf, H) > SHORT_BUDGET:
        spb -= 1
    return ShortPlan(spb, hg, nbuf, short_bytes(spb, hg, N, D, nbuf, H), -(-S // spb) * groups)


def _head_bytes(N: int, D: int) -> int:
    """Shared memory of the long-sequence kernel's block
    (csrc/rope_attention.cuh ``LongLayout``): K (fp16) and V (bf16) of the
    N + 1 keys and Q (fp16) of the N queries, each rounded up to 16 rows of
    D lanes padded to DP = 16 * ceil(D / 16), at a stride of DP + 8 lanes;
    a f32 bias per key; 16 f32 of warp maxima."""
    rs = (D + 15) // 16 * 16 + 8
    nkp, nqp = (N + 1 + 15) // 16 * 16, (N + 15) // 16 * 16
    return nkp * (2 * rs * 2 + 4) + nqp * rs * 2 + 16 * 4


@functools.lru_cache(maxsize=None)
def max_keys(D: int) -> int:
    """The largest N whose N+1 keys and N queries of head dim D fit one
    block's shared memory in the long-sequence kernel (N > 16): 943 at
    D = 24, 527 at 64."""
    N = SMEM_BYTES // (6 * ((D + 15) // 16 * 16 + 8) + 4)  # a token's bytes: no token more
    while _head_bytes(N, D) > SMEM_BYTES:
        N -= 1
    return N


def rope_attention_math(qkv, bias_k, bias_v, key_valid, *, num_heads: int,
                        base2: bool, out=None, stage=None):
    """The plain PyTorch math of ``rope_attention`` (same arguments), counted
    nowhere and differentiable with ``out=None``. ``stage``: a dtype to
    round the RoPE'd q and k to, as the kernels stage them (bf16 in the JAX
    kernel and ``tiled_attention``, fp16 in the long-sequence body here): a
    reference for logits so large that that rounding, not the kernel, sets
    the error."""
    G, N, I, C3 = qkv.shape
    C, H = C3 // 3, num_heads
    D = C // H
    S = G * I
    x = qkv.permute(0, 2, 1, 3).reshape(S, N, C3)
    q, k, v = x[..., :C], x[..., C:2 * C], x[..., 2 * C:]
    k = torch.cat([k, bias_k.reshape(1, 1, C).to(k.dtype).expand(S, 1, C)], dim=1)
    v = torch.cat([v, bias_v.reshape(1, 1, C).to(v.dtype).expand(S, 1, C)], dim=1)

    def heads(t):
        return t.reshape(S, t.shape[1], H, D).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    q, k = apply_rope(q, k)
    if stage is not None:
        q, k = q.to(stage).to(q.dtype), k.to(stage).to(k.dtype)
    valid = torch.cat([key_valid.permute(0, 2, 1).reshape(S, N).to(q.dtype),
                       torch.ones(S, 1, dtype=q.dtype, device=q.device)], dim=1)
    o = attention_core(q, k, v, valid, base2=base2)  # (S, H, N, D)
    o = o.transpose(1, 2).reshape(G, I, N, C).permute(0, 2, 1, 3)
    if out is not None:
        out.copy_(o)
        return out
    return o.contiguous()


def rope_attention_plain(qkv, bias_k, bias_v, key_valid, **kw):
    """Plain PyTorch version of ``rope_attention`` (same arguments); counts
    its calls on CUDA tensors in ``cuda_calls``."""
    if qkv.is_cuda:
        rope_attention_plain.cuda_calls += 1
    return rope_attention_math(qkv, bias_k, bias_v, key_valid, **kw)


rope_attention_plain.cuda_calls = 0


def rope_attention(qkv, bias_k, bias_v, key_valid, *, num_heads: int, base2: bool,
                   out=None):
    """The attention core: the kernel on CUDA tensors, the plain version on
    CPU tensors (see the module docstring)."""
    if not qkv.is_cuda:
        return rope_attention_plain(qkv, bias_k, bias_v, key_valid,
                                    num_heads=num_heads, base2=base2, out=out)
    G, N, I, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("rope_attention: qkv must be a contiguous bf16 (G, N, I, 3C) tensor")
    if D not in (16, 24, 32, 64) or C % num_heads:
        raise ValueError(f"rope_attention: head dim {C}/{num_heads} is not supported")
    if N > 16 and N > max_keys(D):
        raise ValueError(
            f"rope_attention: {N + 1} keys of head dim {D} need {_head_bytes(N, D):,} bytes of "
            f"shared memory, more than the {SMEM_BYTES:,} a block may use (N <= {max_keys(D)} "
            f"at D = {D}); ops.tiled_attention takes any N")
    if (bias_k.dtype != torch.bfloat16 or bias_v.dtype != torch.bfloat16
            or not bias_k.is_contiguous() or not bias_v.is_contiguous()):
        raise ValueError("rope_attention: bias_k / bias_v must be contiguous bf16 (C,)")
    if key_valid.dtype != torch.float32 or tuple(key_valid.shape) != (G, N, I) \
            or not key_valid.is_contiguous():
        raise ValueError("rope_attention: key_valid must be a contiguous f32 (G, N, I) tensor")
    if out is None:
        out = torch.empty(G, N, I, C, dtype=torch.bfloat16, device=qkv.device)
    elif out.dtype != torch.bfloat16 or not out.is_contiguous() or tuple(out.shape) != (G, N, I, C):
        raise ValueError("rope_attention: out must be a contiguous bf16 (G, N, I, C) tensor")
    if qkv.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("rope_attention: qkv and out must start on a 16-byte boundary "
                         "(the kernels read and write head rows as 16-byte vectors)")
    lib = _cuda.library("rope_attention", _ARGTYPES)
    p = short_plan(G, N, I, num_heads, D) if N <= SHORT_N else None
    # the short kernel's persistent grid: its resident blocks, at most a unit each
    grid = min(p.units, _slots(lib._name, qkv.device.index, N, num_heads, C, p.spb, p.hg)) \
        if p else 0
    cos, sin = rope_tables(N + 1, D, device=qkv.device)
    code = lib.rope_attention(qkv.data_ptr(), bias_k.data_ptr(), bias_v.data_ptr(),
                              key_valid.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                              out.data_ptr(), G, N, I, num_heads, C, int(base2),
                              _cuda.stream_ptr(qkv), p.spb if p else 0, p.hg if p else 0, grid)
    _cuda.check(code, "rope_attention")
    rope_attention.launches += 1
    rope_attention.bodies[2 if p is None else 1 - int(base2)] += 1
    if p is None and not base2:
        rope_attention.long_natural += 1
    return out


rope_attention.launches = 0
rope_attention.bodies = [0, 0, 0]  # launches by body: short base 2, short natural, long
rope_attention.long_natural = 0  # launches of the long body with the natural softmax


def _info(N: int, H: int, C: int, spb: int, hg: int):
    """The C query behind ``resources`` (the short kernel at plan (spb, hg))."""
    fn = _cuda.library("rope_attention", _ARGTYPES).rope_attention_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.I32, _cuda.P, _cuda.I32, _cuda.I32]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(N, H, C, info, spb, hg), "rope_attention_resources")
    return list(info)


@functools.lru_cache(maxsize=64)
def _slots(lib: str, device: int, N: int, H: int, C: int, spb: int, hg: int) -> int:
    """Resident short blocks of library ``lib`` at plan (spb, hg) on card
    ``device``: its SMs x blocks per SM (queried once per plan)."""
    with torch.cuda.device(device):
        per_sm = _info(N, H, C, spb, hg)[3]
        if per_sm <= 0:
            raise RuntimeError(f"rope_attention: the short plan {(spb, hg)} fits no block on an SM")
        return torch.cuda.get_device_properties(device).multi_processor_count * per_sm


def resources(N: int, num_heads: int, C: int, G: int = 1, I: int = 1) -> dict:
    """The launch resources of the kernel that a call over (G, N, I) runs
    (on the card): registers and local (spill) bytes per thread, dynamic
    shared memory per block, resident blocks per SM; at N <= 16 also the
    short body's plan (G and I matter only there)."""
    p = short_plan(G, N, I, num_heads, C // num_heads) if N <= SHORT_N else None
    info = _info(N, num_heads, C, p.spb if p else 0, p.hg if p else 0)
    out = dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3])
    if p is not None:
        out["plan"] = dataclasses.asdict(p)
    return out

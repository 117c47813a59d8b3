"""blocked_attention_bwd: the backward of the trunk's base-2 attention core
for sequences longer than ``rope_attention_bwd.MAX_N`` (128) that a head's
whole surfaces still fit one block's shared memory.

Kernel: ``csrc/blocked_attention_bwd.cu`` (one block per (sequence, head):
the head's RoPE'd q and k (fp16), dO and v (bf16) stay in shared memory; a
first pass makes each query's softmax statistics, a second walks the query
tiles with each warp's 16 keys' dK and dV in registers and adds each dq
partial into shared memory in a fixed order). It replaces the attention
adjoint inside the JAX package's ``ops/blocked_block_bwd.py::_bwd_kernel`` (:53), the body of
``time_block_bwd`` (:298) and ``rows_block_bwd`` (:380) that train the
ATLAS crop-256 preset (residue stage N = L = 256, frame stage N = T = 250).
``blocked_attention_bwd_plain`` is the same function in plain PyTorch
(``rope_attention_bwd``'s math); it runs for CPU tensors. For CUDA tensors
the wrapper launches the kernel or raises. The kernel takes any finite bf16
q and k: a query tile or head whose RoPE'd maximum lies outside fp16's
comfortable range is scaled into it by a power of two, and the logits and
gradients scaled back in f32.

Arguments and results as ``rope_attention_bwd``: ``qkv`` (G, N, I, 3C) bf16,
attention over N for every (g, i); ``dout`` (G, N, I, C) bf16; ``bias_k`` /
``bias_v`` (C,) bf16; ``key_valid`` (G, N, I) f32. Returns ``dqkv``
(G, N, I, 3C) in qkv's dtype and the bias key's and value's gradients summed
over every sequence, (C,) f32 each. The shared memory grows with N
(``smem_bytes``); N is capped at ``max_keys(D)``, 319 at D = 24 (511 at 16,
255 at 32, 127 at 64): the limits that the first design's shared memory set,
kept so that the attention backward's routing by N does not move. The
wrapper raises ``ValueError`` naming the limit beyond it.
"""
from __future__ import annotations

import torch

from ..models.rope import rope_tables
from . import _cuda
from .rope_attention import SMEM_BYTES
from .rope_attention_bwd import rope_attention_bwd_math

_ARGTYPES = [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
             _cuda.P, _cuda.P, _cuda.P, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32,
             _cuda.I32, _cuda.I32, _cuda.P]


def _rs(D: int) -> int:
    """The row stride (2-byte elements) of a staged q, dO, k or v row: D
    lanes, an odd number of 16-byte units (24 at D = 16 and 24, 40 at 32,
    72 at 64)."""
    return D if (D // 8) % 2 else D + 8


def smem_bytes(N: int, D: int) -> int:
    """Shared memory of one block at N tokens and head dim D (the kernel's
    ``Layout``): q and dO of NQP = 16 * ceil(N / 16) queries and k and v of
    NKP = 16 * ceil((N + 1) / 16) keys in rows of ``_rs(D)`` 2-byte
    elements, the NKP key biases, 1 / sum p and delta per query, max|dO| of
    each 16-query tile (16-byte aligned), the 4 warps' maxima (16 floats)
    and each warp's area: 16 keys and values, or a 16 x (D + 1) f32 tile."""
    rs = _rs(D)
    nqp, nkp = -(-N // 16) * 16, -(-(N + 1) // 16) * 16
    wa = max(16 * rs * 4, 16 * (D + 1) * 4)
    return (2 * nqp * rs * 2 + 2 * nkp * rs * 2 + nkp * 4 + 2 * nqp * 4
            + -(-(nqp // 16 * 4) // 16) * 16 + 64 + 4 * wa)


# The longest sequence per head dim: the limits that the first design's
# shared memory (213,824 bytes at N = 256, D = 24) set, kept so that the
# routing of the attention backward by N does not move.
MAX_KEYS = {16: 511, 24: 319, 32: 255, 64: 127}


def max_keys(D: int) -> int:
    """The largest N that the kernel takes at head dim D."""
    return MAX_KEYS[D]


def resources(N: int, D: int) -> dict:
    """The launch resources of the kernel at N tokens and head dim D (on the
    card): registers and local (spill) bytes per thread, dynamic shared
    memory per block, resident blocks per SM."""
    lib = _cuda.library("blocked_attention_bwd", _ARGTYPES)
    fn = lib.blocked_attention_bwd_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.P]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(N, D, info), "blocked_attention_bwd_resources")
    return dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3])


def blocked_attention_bwd_plain(qkv, dout, bias_k, bias_v, key_valid, *, num_heads: int):
    """Plain PyTorch version of ``blocked_attention_bwd`` (same arguments),
    computed in f32; counts its calls on CUDA tensors in ``cuda_calls``."""
    if qkv.is_cuda:
        blocked_attention_bwd_plain.cuda_calls += 1
    return rope_attention_bwd_math(qkv, dout, bias_k, bias_v, key_valid, num_heads=num_heads)


blocked_attention_bwd_plain.cuda_calls = 0


def blocked_attention_bwd(qkv, dout, bias_k, bias_v, key_valid, *, num_heads: int):
    """The attention backward: the kernel on CUDA tensors, the plain version
    on CPU tensors (see the module docstring)."""
    if not qkv.is_cuda:
        return blocked_attention_bwd_plain(qkv, dout, bias_k, bias_v, key_valid,
                                           num_heads=num_heads)
    G, N, I, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("blocked_attention_bwd: qkv must be a contiguous bf16 (G, N, I, 3C) tensor")
    if dout.dtype != torch.bfloat16 or tuple(dout.shape) != (G, N, I, C) or not dout.is_contiguous():
        raise ValueError("blocked_attention_bwd: dout must be a contiguous bf16 (G, N, I, C) tensor")
    if D not in (16, 24, 32, 64) or C % num_heads:
        raise ValueError(f"blocked_attention_bwd: head dim {C}/{num_heads} is not supported")
    if N > max_keys(D):
        raise ValueError(
            f"blocked_attention_bwd: {N} tokens of head dim {D} are beyond the kernel's limit "
            f"(N <= {max_keys(D)} at D = {D}, the limit its first design's shared memory set); "
            "longer sequences take ops/time_attention.py::time_attention_block_bwd")
    if (bias_k.dtype != torch.bfloat16 or bias_v.dtype != torch.bfloat16
            or not bias_k.is_contiguous() or not bias_v.is_contiguous()):
        raise ValueError("blocked_attention_bwd: bias_k / bias_v must be contiguous bf16 (C,)")
    if key_valid.dtype != torch.float32 or tuple(key_valid.shape) != (G, N, I) \
            or not key_valid.is_contiguous():
        raise ValueError("blocked_attention_bwd: key_valid must be a contiguous f32 (G, N, I) tensor")
    cos, sin = rope_tables(N + 1, D, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty(2, C, dtype=torch.float32, device=qkv.device)
    scratch = torch.empty(G * I * 2 * C, dtype=torch.float32, device=qkv.device)
    lib = _cuda.library("blocked_attention_bwd", _ARGTYPES)
    code = lib.blocked_attention_bwd(qkv.data_ptr(), dout.data_ptr(), bias_k.data_ptr(),
                                     bias_v.data_ptr(), key_valid.data_ptr(), cos.data_ptr(),
                                     sin.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
                                     scratch.data_ptr(), G, N, I, num_heads, C, SMEM_BYTES,
                                     _cuda.stream_ptr(qkv))
    _cuda.check(code, "blocked_attention_bwd")
    blocked_attention_bwd.launches += 1
    return dqkv, dbias[0], dbias[1]


blocked_attention_bwd.launches = 0

"""blocked_attention_bwd: the backward of the trunk's base-2 attention core
for sequences longer than ``rope_attention_bwd.MAX_N`` (128) that a head's
whole surfaces still fit one block's shared memory.

Kernel: ``csrc/blocked_attention_bwd.cu`` (one block per (sequence, head):
the RoPE'd keys and values stay in shared memory, P is formed once per
(query, key) pair, dK and dV accumulate in f32 in shared memory across the
64-query tiles). It replaces the attention adjoint inside the JAX package's
``ops/blocked_block_bwd.py::_bwd_kernel`` (:53), the body of
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
(``smem_bytes``), so N is capped: ``max_keys(D)``, 319 at D = 24 (511 at 16,
255 at 32); the wrapper raises ``ValueError`` naming the limit beyond it.
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
ROWS = 64  # the kernel's query and key tiles


def smem_bytes(N: int, D: int) -> int:
    """Shared memory of one block at N tokens and head dim D (the kernel's
    ``Layout``): keys and values row-major and the keys transposed (2-byte
    elements, padded to NKP = 64 * ceil((N+1)/64) rows and DP = D rounded up
    to 16 lanes), the query and dO tiles both ways, the pn^T / ds^T tiles,
    the tile's p (bf16, 128 bytes per key), dK and dV in f32, the key
    classes and the 4 warps' max|dO|, max|q| and max|k| (16 floats)."""
    DP = -(-D // 16) * 16
    RS, QTS = DP + 8, ROWS + 8
    NKP = -(-(N + 1) // ROWS) * ROWS
    return (2 * NKP * RS * 2 + DP * (NKP + 8) * 2 + 2 * ROWS * RS * 2 + 2 * DP * QTS * 2
            + 2 * ROWS * QTS * 2 + NKP * 128 + 2 * NKP * D * 4 + NKP * 4 + 64)


def max_keys(D: int) -> int:
    """The largest N whose block fits the shared memory one block may use."""
    N = 1
    while smem_bytes(N + 1, D) <= SMEM_BYTES:
        N += 1
    return N


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
            f"blocked_attention_bwd: {N} tokens of head dim {D} need {smem_bytes(N, D):,} bytes "
            f"of shared memory, more than the {SMEM_BYTES:,} a block may use (N <= "
            f"{max_keys(D)} at D = {D}); longer sequences take "
            "ops/time_attention.py::time_attention_block_bwd")
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

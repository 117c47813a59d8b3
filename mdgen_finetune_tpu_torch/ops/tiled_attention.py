"""tiled_attention: the frame-attention core at long T, with the same
interface as ``rope_attention`` but no limit on N from shared memory.

Kernel: ``csrc/tiled_attention.cu`` (a block of 8 warps per (sequence,
head, chunk of 16-query tiles) stages the head's RoPE'd keys and values
once in shared memory; every warp walks them for each of its query tiles
with mma.sync products and f32 accumulators; keys that do not fit come in
windows; the schedule is ``long_attention.forward_plan``). It replaces the
attention core of the JAX package's
``ops/time_attention.py::_block_pallas_fwd_blocked`` (body
``_block_kernel_blocked``), the TPU kernel of the frame stage at
T > MAX_T, and in its natural mode ``time_attention.py::_pallas_fwd_blocked``
(:343), the modular layer's attention core above L = 8 or T = 256.
``tiled_attention_plain`` is the same function in plain PyTorch (the op
order of the JAX package's ``time_attention._xla_impl``); it runs for CPU
tensors. For CUDA tensors the wrapper launches the kernel or raises.

Arguments as ``rope_attention``: qkv (G, N, I, 3C) bf16, attention over N for
every (g, i); bias_k / bias_v (C,), the bias key RoPE'd at position N and
always attendable; key_valid (G, N, I) f32, 1 = attendable. ``base2``: q
carries head_dim**-0.5 * log2(e) and the softmax is exp2 without a max (the
fused trunk); otherwise q carries head_dim**-0.5 and the softmax is the
natural one with its max subtracted, kept as a running max across the key
steps (the modular layer). Returns (G, N, I, C).
"""
from __future__ import annotations

import torch

from ..models.rope import rope_tables
from . import _cuda
from .long_attention import forward_plan
from .rope_attention import rope_attention_math

# pointers, (G, N, I, H, C, base2), the stream, then the schedule (chunk, win)
_ARGTYPES = [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
             _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P,
             _cuda.I32, _cuda.I32]


def tiled_attention_plain(qkv, bias_k, bias_v, key_valid, *, num_heads: int,
                          base2: bool = True, out=None):
    """Plain PyTorch version of ``tiled_attention`` (same arguments); counts
    its calls on CUDA tensors in ``cuda_calls``."""
    if qkv.is_cuda:
        tiled_attention_plain.cuda_calls += 1
    return rope_attention_math(qkv, bias_k, bias_v, key_valid, num_heads=num_heads,
                               base2=base2, out=out)


tiled_attention_plain.cuda_calls = 0


def tiled_attention(qkv, bias_k, bias_v, key_valid, *, num_heads: int, base2: bool = True,
                    out=None):
    """The attention core: the kernel on CUDA tensors, the plain version on
    CPU tensors (see the module docstring)."""
    if not qkv.is_cuda:
        return tiled_attention_plain(qkv, bias_k, bias_v, key_valid, num_heads=num_heads,
                                     base2=base2, out=out)
    G, N, I, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("tiled_attention: qkv must be a contiguous bf16 (G, N, I, 3C) tensor")
    if D not in (16, 24, 32, 64) or C % num_heads:
        raise ValueError(f"tiled_attention: head dim {C}/{num_heads} is not supported")
    if (bias_k.dtype != torch.bfloat16 or bias_v.dtype != torch.bfloat16
            or not bias_k.is_contiguous() or not bias_v.is_contiguous()):
        raise ValueError("tiled_attention: bias_k / bias_v must be contiguous bf16 (C,)")
    if key_valid.dtype != torch.float32 or tuple(key_valid.shape) != (G, N, I) \
            or not key_valid.is_contiguous():
        raise ValueError("tiled_attention: key_valid must be a contiguous f32 (G, N, I) tensor")
    if out is None:
        out = torch.empty(G, N, I, C, dtype=torch.bfloat16, device=qkv.device)
    elif (out.dtype != torch.bfloat16 or not out.is_contiguous() or tuple(out.shape) != (G, N, I, C)
          or out.data_ptr() % 16):
        raise ValueError("tiled_attention: out must be a contiguous, 16-byte aligned bf16 "
                         "(G, N, I, C) tensor")
    cos, sin = rope_tables(N + 1, D, device=qkv.device)
    sched = forward_plan(G * I * num_heads, N, D)
    qkv = _cuda.aligned(qkv)
    lib = _cuda.library("tiled_attention", _ARGTYPES)
    code = lib.tiled_attention(qkv.data_ptr(), bias_k.data_ptr(), bias_v.data_ptr(),
                               key_valid.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                               out.data_ptr(), G, N, I, num_heads, C, int(base2),
                               _cuda.stream_ptr(qkv), sched.chunk, sched.win)
    _cuda.check(code, "tiled_attention")
    tiled_attention.launches += 1
    if not base2:
        tiled_attention.natural += 1
    return out


tiled_attention.launches = 0
tiled_attention.natural = 0  # launches with the natural softmax


def resources(G: int, N: int, I: int, num_heads: int, D: int, base2: bool = True) -> dict:
    """The kernel's launch resources at that shape (on the card): its
    schedule, registers and local (spill) bytes per thread, dynamic shared
    memory per block, resident blocks per SM."""
    sched = forward_plan(G * I * num_heads, N, D)
    lib = _cuda.library("tiled_attention", _ARGTYPES)
    fn = lib.tiled_attention_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.I32, _cuda.P]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(sched.win, D, int(base2), info), "tiled_attention_resources")
    return dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3],
                blocks=sched.blocks, query_tiles_per_block=sched.chunk, windows=sched.windows)

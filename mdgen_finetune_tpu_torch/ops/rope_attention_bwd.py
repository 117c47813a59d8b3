"""rope_attention_bwd: the backward of ``rope_attention`` in base-2 mode
(the trunk's attention cores).

Kernel: ``csrc/rope_attention_bwd.cu`` (it replaces the attention adjoints
inside the JAX package's ``ops/fused_layer_bwd.py`` stage kernels ``_k2``
(frame attention, :258-309) and ``_k1`` (residue attention, :420-458)).
Short sequences (N <= 16) give a thread one (head, row) in f32; longer ones
(up to ``MAX_N``) give a block of 4 warps one (sequence, head) and run all
six products on the tensor cores (``mma.sync``): RoPE'd q and k in fp16
(scaled by powers of two into its range), p, v and dO in bf16, ds in fp16
scaled by 1 / max|dO|. ``rope_attention_bwd_plain`` is the same function
in plain PyTorch; it runs for CPU tensors. For CUDA tensors the wrapper
launches the kernel or raises.

Same layout as the forward: ``qkv`` (G, N, I, 3C), attention over N for
every (g, i); ``dout`` (G, N, I, C) the gradient of the attention output;
``key_valid`` (G, N, I) f32. q carries scale * log2(e), so the logits are
base 2 and the softmax adjoint carries a factor ln 2
(``fused_layer_bwd.py:280-281, 437-438``):

    dl = ln2 * p * (dp - rowsum(p * dp)),   dp = dO V^T,   dV = p^T dO,
    dq = dl K,   dk = dl^T q,

then the RoPE transpose of dq and dk (``_rot_t`` :112) at their positions,
the bias key's at position N. Returns ``dqkv`` (G, N, I, 3C) in qkv's dtype
and the bias key's and value's gradients summed over every sequence, (C,)
f32 each.
"""
from __future__ import annotations

import torch

from ..models.attention_core import LN2, NEG_INF
from ..models.rope import rope_tables, rotate_half
from . import _cuda

MAX_N = 128  # a head's q, dO, k and v stay in shared memory, a row of p in registers
_ARGTYPES = [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
             _cuda.P, _cuda.P, _cuda.P, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32,
             _cuda.I32, _cuda.P]


def _rotate_half_t(g: torch.Tensor) -> torch.Tensor:
    """Adjoint of rotate_half: (g1, g2) -> (g2, -g1)."""
    g1, g2 = g.chunk(2, dim=-1)
    return torch.cat([g2, -g1], dim=-1)


def rope_attention_bwd_math(qkv, dout, bias_k, bias_v, key_valid, *, num_heads: int,
                            stage=None):
    """The plain PyTorch math of ``rope_attention_bwd`` (same arguments),
    computed in f32 and counted nowhere; ``blocked_attention_bwd_plain``
    runs it too. ``stage``: a dtype to round the RoPE'd q and k to (as
    ``rope_attention_math`` does): what that rounding alone costs."""
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
    logits = torch.einsum("shqd,shkd->shqk", qr, kr) * LN2
    logits = torch.where(valid[:, None, None, :] > 0, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)  # (S, H, N, N+1)
    do = heads(dout.float().permute(0, 2, 1, 3).reshape(S, N, C))
    dv = torch.einsum("shqk,shqd->shkd", p, do)
    dp = torch.einsum("shqd,shkd->shqk", do, v)
    dl = LN2 * p * (dp - (p * dp).sum(-1, keepdim=True))
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


def rope_attention_bwd_plain(qkv, dout, bias_k, bias_v, key_valid, *, num_heads: int):
    """Plain PyTorch version of ``rope_attention_bwd`` (same arguments),
    computed in f32; counts its calls on CUDA tensors in ``cuda_calls``."""
    if qkv.is_cuda:
        rope_attention_bwd_plain.cuda_calls += 1
    return rope_attention_bwd_math(qkv, dout, bias_k, bias_v, key_valid, num_heads=num_heads)


rope_attention_bwd_plain.cuda_calls = 0


def rope_attention_bwd(qkv, dout, bias_k, bias_v, key_valid, *, num_heads: int):
    """The attention backward: the kernel on CUDA tensors, the plain
    version on CPU tensors (see the module docstring)."""
    if not qkv.is_cuda:
        return rope_attention_bwd_plain(qkv, dout, bias_k, bias_v, key_valid,
                                        num_heads=num_heads)
    G, N, I, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("rope_attention_bwd: qkv must be a contiguous bf16 (G, N, I, 3C) tensor")
    if dout.dtype != torch.bfloat16 or tuple(dout.shape) != (G, N, I, C) or not dout.is_contiguous():
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
    if key_valid.dtype != torch.float32 or tuple(key_valid.shape) != (G, N, I) \
            or not key_valid.is_contiguous():
        raise ValueError("rope_attention_bwd: key_valid must be a contiguous f32 (G, N, I) tensor")
    if N > 16 and (qkv.data_ptr() % 16 or dout.data_ptr() % 16):
        raise ValueError("rope_attention_bwd: qkv and dout must start on a 16-byte boundary "
                         "(the long kernel reads head rows as 16-byte vectors)")
    cos, sin = rope_tables(N + 1, D, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty(2, C, dtype=torch.float32, device=qkv.device)
    scratch = torch.empty(G * I * 2 * C, dtype=torch.float32, device=qkv.device)
    lib = _cuda.library("rope_attention_bwd", _ARGTYPES)
    code = lib.rope_attention_bwd(qkv.data_ptr(), dout.data_ptr(), bias_k.data_ptr(),
                                  bias_v.data_ptr(), key_valid.data_ptr(), cos.data_ptr(),
                                  sin.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
                                  scratch.data_ptr(), G, N, I, num_heads, C,
                                  _cuda.stream_ptr(qkv))
    _cuda.check(code, "rope_attention_bwd")
    rope_attention_bwd.launches += 1
    rope_attention_bwd.bodies[int(N > 16)] += 1
    return dqkv, dbias[0], dbias[1]


rope_attention_bwd.launches = 0
rope_attention_bwd.bodies = [0, 0]  # launches by body: short (N <= 16), long


def resources(N: int, num_heads: int, C: int) -> dict:
    """The launch resources of the kernel that a call at sequence length N
    runs (on the card): registers and local (spill) bytes per thread,
    dynamic shared memory per block, resident blocks per SM."""
    lib = _cuda.library("rope_attention_bwd", _ARGTYPES)
    fn = lib.rope_attention_bwd_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.I32, _cuda.P]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(N, num_heads, C, info), "rope_attention_bwd_resources")
    return dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3])

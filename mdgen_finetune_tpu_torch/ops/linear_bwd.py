"""linear_bwd: the two products of a projection's backward, bf16 operands
with f32 accumulation.

Kernel: ``csrc/linear_bwd.cu`` (hand-written bf16 tensor-core GEMMs:
128 x 128 output tiles, a 4-stage ring of asynchronous copies; a gate or
LN prologue runs first as a bf16 pass of its own; they replace the weight-
and data-gradient products inside the JAX package's
``ops/fused_layer_bwd.py`` stage kernels ``_k3`` / ``_k2`` / ``_k1``, its
``_mm`` at :92 and the f32 sums of ``_acc`` at :97). ``linear_bwd_plain`` is
the same function in plain PyTorch; it runs for CPU tensors. For CUDA
tensors the wrapper launches the kernel or raises.

Both modes take the upstream gradient ``dy`` (M, N), bf16 or f32, with an
optional prologue ``dy * gate[r // (M // nb)]`` (gate (nb, N) rows, one per
batch element, :140, :260, :423), rounded to the compute dtype:

- ``mode="dgrad"``, ``x`` = W (K, N): ``dX = P(dy) @ W.T`` (M, K); with
  ``act`` (M, K) f32, the recomputed MLP pre-activation, the result is
  multiplied by ``gelu_fast'(act)`` (:145). Output f32 or ``out_dtype``.
- ``mode="wgrad"``, ``x`` = A (M, K): ``dW = P(A).T @ P(dy)`` (K, N) and
  ``db = colsum(P(dy))`` (N,), both f32 sums over all M rows. With
  ``ln=True`` the prologue recomputes ``A = modulate(LN(x), shift, scale)``
  (non-affine, eps 1e-6; shift/scale (nb, K) rows) from the saved stage
  input, rounded to the compute dtype, as ``adaln_linear``'s prologue does.
"""
from __future__ import annotations

import torch

from ..models.layers import gelu_fast_with_grad, layer_norm
from . import _cuda
from .adaln_linear import _rows

_ARGTYPES = [_cuda.I32,
             _cuda.P, _cuda.I32, _cuda.I64, _cuda.P, _cuda.I64, _cuda.I32,
             _cuda.P, _cuda.I64, _cuda.P, _cuda.I64,
             _cuda.I32, _cuda.P, _cuda.P, _cuda.I64, _cuda.I32,
             _cuda.P, _cuda.I32, _cuda.I64, _cuda.P, _cuda.P, _cuda.I32,
             _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P]


def linear_bwd_plain(mode, dy, x, *, gate=None, act=None, ln=False, shift=None, scale=None,
                     out_dtype=None):
    """Plain PyTorch version of ``linear_bwd`` (same arguments); counts its
    calls on CUDA tensors in ``cuda_calls``."""
    if dy.is_cuda:
        linear_bwd_plain.cuda_calls += 1
    cd = x.dtype
    M = dy.shape[0]
    g = (dy * _rows(gate, M) if gate is not None else dy).to(cd)
    if mode == "dgrad":
        dx = g.float() @ x.float().t()
        if act is not None:
            dx = dx * gelu_fast_with_grad(act.float())[1]
        return dx.to(out_dtype or torch.float32)
    a = layer_norm(x) * (1 + _rows(scale, M).to(cd)) + _rows(shift, M).to(cd) if ln else x
    return a.float().t() @ g.float(), g.float().sum(0)


linear_bwd_plain.cuda_calls = 0


def _check_rows(t, name, width, M):
    if t is None:
        return
    if t.dim() != 2 or t.stride(1) != 1 or t.shape[1] != width or t.dtype != torch.bfloat16 \
            or M % t.shape[0]:
        raise ValueError(f"linear_bwd: {name} must be bf16 (nb, {width}) rows with unit column "
                         f"stride, nb dividing {M}")


TILE = 128  # the kernel's output tile (csrc/linear_bwd.cuh)
SLOTS = 264  # resident wgrad blocks on an H100: 2 per SM x 132 SMs


def _splits(M: int, K: int, N: int) -> int:
    """Row splits of the wgrad sum: as many blocks as an H100 holds at once
    and no more (a block past them would take a second wave), each split
    at least 256 rows (8 chunks of the ring)."""
    tiles = -(-K // TILE) * -(-N // TILE)
    return max(1, min(M // 256, SLOTS // tiles))


def scratch_floats(M: int, K: int, N: int, mode: str = "wgrad", pre_dy: bool = False,
                   pre_a: bool = False) -> int:
    """The f32 scratch of a call: for wgrad the splits' partial dW and db
    and the mean and rstd of each row (rounded up to 4 floats); then the
    bf16 P(dY) (M, N) where its prologue is not the identity (pre_dy) and
    the bf16 P(A) (M, K) with the LN prologue (pre_a), which the kernel
    makes in a pass of its own."""
    n = _splits(M, K, N) * (K * N + N) + -(-2 * M // 4) * 4 if mode == "wgrad" else 0
    return n + (M * N // 2 if pre_dy else 0) + (M * K // 2 if pre_a else 0)


def resources(mode: str) -> dict:
    """The launch resources of the dgrad or wgrad kernel (on the card):
    registers and local (spill) bytes per thread, dynamic shared memory per
    block, resident blocks per SM."""
    lib = _cuda.library("linear_bwd", _ARGTYPES)
    fn = lib.linear_bwd_resources
    fn.argtypes = [_cuda.I32, _cuda.P]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(int(mode == "wgrad"), info), "linear_bwd_resources")
    return dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3])


def linear_bwd(mode, dy, x, *, gate=None, act=None, ln=False, shift=None, scale=None,
               out_dtype=None):
    """The backward products: the kernel on CUDA tensors, the plain version
    on CPU tensors (see the module docstring)."""
    if mode not in ("dgrad", "wgrad"):
        raise ValueError(f"linear_bwd: unknown mode {mode!r}")
    if not dy.is_cuda:
        return linear_bwd_plain(mode, dy, x, gate=gate, act=act, ln=ln, shift=shift,
                                scale=scale, out_dtype=out_dtype)
    M, N = dy.shape
    if dy.dtype not in (torch.bfloat16, torch.float32) or not dy.is_contiguous():
        raise ValueError("linear_bwd: dy must be a contiguous bf16 or f32 (M, N) tensor")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.dim() != 2:
        raise ValueError("linear_bwd: the second operand must be a contiguous bf16 matrix")
    _check_rows(gate, "gate", N, M)
    if mode == "dgrad":
        K = x.shape[0]
        if x.shape[1] != N:
            raise ValueError(f"linear_bwd: W is {tuple(x.shape)}, dy has {N} columns")
        if act is not None and (act.dtype != torch.float32 or tuple(act.shape) != (M, K)
                                or not act.is_contiguous()):
            raise ValueError(f"linear_bwd: act must be a contiguous f32 ({M}, {K}) tensor")
        odt = out_dtype or torch.float32
        if odt not in (torch.float32, torch.bfloat16):
            raise ValueError("linear_bwd: dgrad writes f32 or bf16")
        out = torch.empty(M, K, dtype=odt, device=dy.device)
        db = None
        splits = 1
    else:
        K = x.shape[1]
        if x.shape[0] != M:
            raise ValueError(f"linear_bwd: A has {x.shape[0]} rows, dy has {M}")
        if ln:
            _check_rows(shift, "shift", K, M)
            _check_rows(scale, "scale", K, M)
            if shift is None or scale is None or shift.shape[0] != scale.shape[0]:
                raise ValueError("linear_bwd: the LN prologue takes shift and scale rows")
        out = torch.empty(K, N, dtype=torch.float32, device=dy.device)
        db = torch.empty(N, dtype=torch.float32, device=dy.device)
        splits = _splits(M, K, N)
    pre_dy = dy.dtype == torch.float32 or gate is not None
    n = scratch_floats(M, K, N, mode, pre_dy, mode == "wgrad" and bool(ln))
    scratch = torch.empty(n, dtype=torch.float32, device=dy.device) if n else None
    if K % 8 or N % 8:
        raise ValueError(f"linear_bwd: K = {K} and N = {N} must be multiples of 8")
    lib = _cuda.library("linear_bwd", _ARGTYPES)
    code = lib.linear_bwd(
        int(mode == "wgrad"),
        dy.data_ptr(), int(dy.dtype == torch.float32), dy.stride(0),
        _cuda.ptr(gate), gate.stride(0) if gate is not None else 0,
        M // gate.shape[0] if gate is not None else 1,
        x.data_ptr(), x.stride(0), _cuda.ptr(act), act.stride(0) if act is not None else 0,
        int(bool(ln)), _cuda.ptr(shift) if ln else None, _cuda.ptr(scale) if ln else None,
        shift.stride(0) if ln else 0, M // shift.shape[0] if ln else 1,
        out.data_ptr(), int(out.dtype == torch.float32), out.stride(0), _cuda.ptr(db),
        _cuda.ptr(scratch), splits, M, N, K, _cuda.stream_ptr(dy))
    _cuda.check(code, "linear_bwd")
    linear_bwd.launches += 1
    return out if mode == "dgrad" else (out, db)


linear_bwd.launches = 0

"""modln_bwd: the adjoint of LayerNorm + AdaLN modulate, fused with the
residual add of a trunk stage and the stage's AdaLN-row gradients.

Kernel: ``csrc/modln_bwd.cu`` (it replaces ``_modln_bwd`` (:79-89), the
``dg`` sums and the residual adds ``dOUT + dx_ln`` (:154, :320, :471) inside
the JAX package's ``ops/fused_layer_bwd.py`` stage kernels).
``modln_bwd_plain`` is the same function in plain PyTorch; it runs for CPU
tensors. For CUDA tensors the wrapper launches the kernel or raises.

A stage computes ``out = x + g * y`` with ``y = f(modulate(LN(x), sh, sc))``.
Given the stage input ``x`` (M, C), ``dh`` (M, C) f32 the gradient of the
modulated LN output, ``dout`` (M, C) f32 the gradient of ``out``, ``y``
(M, C) f32 the recomputed pre-gate output and the ``scale`` rows (nb, C),
it returns ``dx = dout + LN-modulate adjoint of dh`` (M, C) f32, and writes
per batch element (the rows r of element b = r // (M // nb)), in f32:

    dsh = sum_r dh,   dsc = sum_r dh * h_hat,   dg = sum_r dout * y

into ``dmod`` (nb, 3C) as [dsh | dsc | dg] (a row view may be given). The
LayerNorm is non-affine with eps 1e-6; mean, rstd and h_hat are recomputed
per row in f32.

The kernel's sums follow a fixed tree (``csrc/modln_bwd.cu``): ``plan``
cuts each element's rows into runs, one block each, whose eight warps sum
every eighth row; a second launch adds the runs' partials. Two launches a
call. Rows of up to ``MAX_C`` columns.
"""
from __future__ import annotations

import torch

from . import _cuda

_ARGTYPES = [_cuda.P, _cuda.I64, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I64,
             _cuda.P, _cuda.P, _cuda.I64, _cuda.P, _cuda.I32, _cuda.I32, _cuda.I32,
             _cuda.I32, _cuda.I32, _cuda.P]
MAX_C = 512  # the widest row the kernel takes (csrc/modln_bwd.cu)


def modln_bwd_plain(x, dh, dout, y, scale, dmod=None):
    """Plain PyTorch version of ``modln_bwd`` (same arguments); counts its
    calls on CUDA tensors in ``cuda_calls``. Returns (dx, dmod)."""
    if x.is_cuda:
        modln_bwd_plain.cuda_calls += 1
    M, C = x.shape
    nb = scale.shape[0]
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + 1e-6)
    hh = (x32 - mean) * rstd
    dh = dh.float()
    sc = scale.float().repeat_interleave(M // nb, dim=0)
    dhh = dh * (1.0 + sc)
    m1 = dhh.mean(-1, keepdim=True)
    m2 = (dhh * hh).mean(-1, keepdim=True)
    dx = dout.float() + rstd * (dhh - m1 - hh * m2)

    def per_b(v):
        return v.reshape(nb, M // nb, C).sum(1)

    sums = torch.cat([per_b(dh), per_b(dh * hh), per_b(dout.float() * y.float())], dim=1)
    if dmod is None:
        return dx, sums
    dmod.copy_(sums)
    return dx, dmod


modln_bwd_plain.cuda_calls = 0


def _splits(rows: int, nb: int) -> int:
    """Row splits of each element's sums: about two blocks per SM of an
    H100, each split at least 8 rows."""
    return max(1, min(rows // 8, -(-264 // nb)))


def plan(M: int, nb: int) -> tuple:
    """(splits, rows_per_split) of a call over M rows of nb elements: the
    grid is (nb, splits) blocks."""
    rows = M // nb
    splits = _splits(rows, nb)
    return splits, -(-rows // splits)


def resources(C: int, x_f32: bool = False) -> dict:
    """The launch resources of the kernel at width ``C`` (on the card):
    registers and local (spill) bytes per thread, dynamic shared memory per
    block, resident blocks per SM."""
    fn = _cuda.built("modln_bwd").modln_bwd_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.P]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(int(x_f32), C, info), "modln_bwd_resources")
    return dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3])


def modln_bwd(x, dh, dout, y, scale, dmod=None):
    """The LN-modulate adjoint: the kernel on CUDA tensors, the plain
    version on CPU tensors (see the module docstring). Returns (dx, dmod)."""
    if not x.is_cuda:
        return modln_bwd_plain(x, dh, dout, y, scale, dmod)
    M, C = x.shape
    nb = scale.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32) or x.stride(1) != 1:
        raise ValueError("modln_bwd: x must be a bf16 or f32 (M, C) row view")
    for name, t in (("dh", dh), ("dout", dout), ("y", y)):
        if t.dtype != torch.float32 or tuple(t.shape) != (M, C) or not t.is_contiguous():
            raise ValueError(f"modln_bwd: {name} must be a contiguous f32 ({M}, {C}) tensor")
    if C > MAX_C:
        raise ValueError(f"modln_bwd: rows of {C} > {MAX_C} columns are not taken")
    if scale.dtype != torch.bfloat16 or scale.stride(1) != 1 or scale.shape[1] != C or M % nb:
        raise ValueError("modln_bwd: scale must be bf16 (nb, C) rows, nb dividing M")
    if dmod is None:
        dmod = torch.empty(nb, 3 * C, dtype=torch.float32, device=x.device)
    elif dmod.dtype != torch.float32 or tuple(dmod.shape) != (nb, 3 * C) or dmod.stride(1) != 1:
        raise ValueError(f"modln_bwd: dmod must be an f32 ({nb}, {3 * C}) row view")
    splits, _ = plan(M, nb)
    dx = torch.empty(M, C, dtype=torch.float32, device=x.device)
    part = torch.empty(splits * nb * 3 * C, dtype=torch.float32, device=x.device)
    lib = _cuda.library("modln_bwd", _ARGTYPES)
    code = lib.modln_bwd(x.data_ptr(), x.stride(0), dh.data_ptr(), dout.data_ptr(), y.data_ptr(),
                         scale.data_ptr(), scale.stride(0), dx.data_ptr(), dmod.data_ptr(),
                         dmod.stride(0), part.data_ptr(), int(x.dtype == torch.float32),
                         M, C, nb, splits, _cuda.stream_ptr(x))
    _cuda.check(code, "modln_bwd")
    modln_bwd.launches += 1
    return dx, dmod


modln_bwd.launches = 0

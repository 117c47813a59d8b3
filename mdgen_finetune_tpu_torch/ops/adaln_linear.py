"""adaln_linear: ``Y = epilogue(prologue(X) @ W + b)`` — every projection of
the trunk and of the IPA encoder.

Kernel: ``csrc/adaln_linear.cu`` (hand-written bf16 tensor-core GEMM with
the LayerNorm/AdaLN prologue and the gate/GELU/Euler/embed epilogues fused;
it replaces the products inside the JAX package's
``ops/fused_layer.py::_trunk_call`` and ``ops/ipa_encoder.py::_encoder_call``
kernels). ``adaln_linear_plain`` is the same function in plain PyTorch, in
the op order of the JAX package's XLA twins (its math, uncounted, is ``adaln_linear_math``);
it runs for CPU tensors. For
CUDA tensors the wrapper launches the kernel or raises.

Arguments (all 2D row views, unit column stride):
- ``x`` (M, K); ``w`` (K, N) contiguous; ``b`` (N,) or None;
- ``ln``: None, "plain" (non-affine, eps 1e-6) or "affine" (eps 1e-5 with
  ``ln_weight`` / ``ln_bias`` (K,) f32);
- ``shift`` / ``scale`` (nb, K): AdaLN rows, row ``r`` of x uses
  ``r // (M // nb)``;
- ``epilogue``: "none", "gelu" (with ``pre``, an f32 (M, N) row view, the
  pre-activation ``y`` is written there too), "gate_res" (``res + gate * y``; ``gate``
  (ng, N) rows like shift, None = 1), "euler" (``res`` is the f32 carry,
  ``carry + dt * bf16(y)``), "add" (``y + add1[r] + add2[map(r)]`` with
  ``add2_map = (div, mul, mod)``: ``map(r) = (r // div) * mul + r % mod``);
- ``out``: optional destination (may be ``res``: the update is in place).
"""
from __future__ import annotations

import torch

from ..models.layers import gelu_fast
from . import _cuda

_EPI = {"none": 0, "gelu": 1, "gate_res": 2, "euler": 3, "add": 4}
_LN = {None: 0, "plain": 1, "affine": 2}
_ARGTYPES = [_cuda.P, _cuda.I32, _cuda.I64, _cuda.P, _cuda.P,
             _cuda.P, _cuda.I32, _cuda.I64, _cuda.I32, _cuda.I32, _cuda.I32,
             _cuda.I32, _cuda.P, _cuda.P,
             _cuda.P, _cuda.P, _cuda.I64, _cuda.I32,
             _cuda.I32, _cuda.P, _cuda.I64,
             _cuda.P, _cuda.I64, _cuda.I32, _cuda.F32,
             _cuda.P, _cuda.I64,
             _cuda.P, _cuda.I64, _cuda.I32, _cuda.I32, _cuda.I32,
             _cuda.P, _cuda.I64, _cuda.P]


def _rows(v: torch.Tensor, M: int) -> torch.Tensor:
    """Per-batch rows (nb, X) -> per-row (M, X)."""
    return v.repeat_interleave(M // v.shape[0], dim=0)


def adaln_linear_math(x, w, b=None, *, ln=None, ln_weight=None, ln_bias=None,
                      shift=None, scale=None, epilogue="none", res=None, gate=None,
                      dt=None, add1=None, add2=None, add2_map=None, out=None,
                      out_dtype=None, pre=None):
    """The plain PyTorch math of ``adaln_linear`` (same arguments), counted
    nowhere: differentiable with ``out=None``, so the encoder's backward
    recomputes through it."""
    cd = w.dtype
    M = x.shape[0]
    if ln == "plain":
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        h = ((x32 - mean) * torch.rsqrt(var + 1e-6)).to(cd)
    elif ln == "affine":
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        h = ((x32 - mean) * (torch.rsqrt(var + 1e-5) * ln_weight.float())
             + ln_bias.float()).to(cd)
    else:
        h = x.to(cd)
    if shift is not None:
        h = h * (1 + _rows(scale, M).to(cd)) + _rows(shift, M).to(cd)
    y = h @ w
    if b is not None:
        y = y + b.to(cd)
    if epilogue == "gelu":
        if pre is not None:
            pre.copy_(y)
        y = gelu_fast(y)
    elif epilogue == "gate_res":
        y = res + (y if gate is None else _rows(gate, M).to(cd) * y)
    elif epilogue == "euler":
        y = res + dt * y.float()
    elif epilogue == "add":
        if add1 is not None:
            y = y + add1.to(cd)
        if add2 is not None:
            div, mul, mod = add2_map
            r = torch.arange(M, device=x.device)
            y = y + add2[(r // div) * mul + r % mod].to(cd)
    elif epilogue != "none":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if out_dtype is not None:
        y = y.to(out_dtype)
    if out is not None:
        out.copy_(y)
        return out
    return y


def adaln_linear_plain(x, w, b=None, **kw):
    """Plain PyTorch version of ``adaln_linear`` (same arguments); counts its
    calls on CUDA tensors in ``cuda_calls``."""
    if x.is_cuda:
        adaln_linear_plain.cuda_calls += 1
    return adaln_linear_math(x, w, b, **kw)


adaln_linear_plain.cuda_calls = 0


def _rowview(t, name, K=None):
    if t is None:
        return
    if t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"adaln_linear: {name} must be a 2D row view with unit column stride")
    if K is not None and t.shape[1] != K:
        raise ValueError(f"adaln_linear: {name} has {t.shape[1]} columns, expected {K}")


def adaln_linear(x, w, b=None, *, ln=None, ln_weight=None, ln_bias=None,
                 shift=None, scale=None, epilogue="none", res=None, gate=None,
                 dt=None, add1=None, add2=None, add2_map=None, out=None,
                 out_dtype=None, pre=None):
    """``epilogue(prologue(x) @ w + b)``: the kernel on CUDA tensors, the
    plain version on CPU tensors (see the module docstring)."""
    kw = dict(ln=ln, ln_weight=ln_weight, ln_bias=ln_bias, shift=shift, scale=scale,
              epilogue=epilogue, res=res, gate=gate, dt=dt, add1=add1, add2=add2,
              add2_map=add2_map, out=out, out_dtype=out_dtype, pre=pre)
    if not x.is_cuda:
        return adaln_linear_plain(x, w, b, **kw)
    M, K = x.shape
    N = w.shape[1]
    if w.dtype != torch.bfloat16 or not w.is_contiguous() or w.shape[0] != K:
        raise ValueError("adaln_linear: w must be a contiguous (K, N) bf16 tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("adaln_linear: x must be bf16 or f32")
    _rowview(x, "x")
    for name, t in (("b", b), ("shift", shift), ("scale", scale), ("gate", gate),
                    ("add1", add1), ("add2", add2)):
        if t is not None and t.dtype != torch.bfloat16:
            raise ValueError(f"adaln_linear: {name} must be bf16")
    if b is not None and not b.is_contiguous():
        raise ValueError("adaln_linear: b must be contiguous")
    _rowview(shift, "shift", K)
    _rowview(scale, "scale", K)
    _rowview(gate, "gate", N)
    _rowview(add1, "add1", N)
    _rowview(add2, "add2", N)
    if shift is not None and (scale is None or M % shift.shape[0]):
        raise ValueError("adaln_linear: shift/scale rows must divide the rows of x")
    if gate is not None and M % gate.shape[0]:
        raise ValueError("adaln_linear: gate rows must divide the rows of x")
    if ln == "affine" and (ln_weight is None or ln_weight.dtype != torch.float32):
        raise ValueError("adaln_linear: the affine LayerNorm takes f32 weight and bias")
    if epilogue == "euler":
        if res is None or res.dtype != torch.float32:
            raise ValueError("adaln_linear: the euler epilogue updates an f32 carry")
        out_dtype = torch.float32
    elif epilogue == "gate_res" and (res is None or res.dtype != torch.bfloat16):
        raise ValueError("adaln_linear: gate_res takes a bf16 residual")
    _rowview(res, "res", N)
    if pre is not None:
        _rowview(pre, "pre", N)
        if epilogue != "gelu" or pre.dtype != torch.float32 or pre.shape[0] != M:
            raise ValueError("adaln_linear: pre is the f32 (M, N) pre-activation of the gelu "
                             "epilogue")
    if out is None:
        odt = out_dtype or (torch.float32 if epilogue == "euler" else torch.bfloat16)
        out = torch.empty(M, N, dtype=odt, device=x.device)
    _rowview(out, "out", N)
    if out.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("adaln_linear: out must be bf16 or f32")
    div, mul, mod = add2_map if add2 is not None else (1, 0, 1)
    lib = _cuda.library("adaln_linear", _ARGTYPES)
    code = lib.adaln_linear(
        x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), w.data_ptr(), _cuda.ptr(b),
        out.data_ptr(), int(out.dtype == torch.float32), out.stride(0), M, N, K,
        _LN[ln], _cuda.ptr(ln_weight), _cuda.ptr(ln_bias),
        _cuda.ptr(shift), _cuda.ptr(scale), shift.stride(0) if shift is not None else 0,
        M // shift.shape[0] if shift is not None else 1,
        _EPI[epilogue], _cuda.ptr(res), res.stride(0) if res is not None else 0,
        _cuda.ptr(gate), gate.stride(0) if gate is not None else 0,
        M // gate.shape[0] if gate is not None else 1, float(dt or 0.0),
        _cuda.ptr(add1), add1.stride(0) if add1 is not None else 0,
        _cuda.ptr(add2), add2.stride(0) if add2 is not None else 0, div, mul, mod,
        _cuda.ptr(pre), pre.stride(0) if pre is not None else 0, _cuda.stream_ptr(x))
    _cuda.check(code, "adaln_linear")
    adaln_linear.launches += 1
    return out


adaln_linear.launches = 0

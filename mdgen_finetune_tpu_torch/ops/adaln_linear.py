"""adaln_linear: ``Y = epilogue(prologue(X) @ W + b)`` — every projection of
the trunk and of the IPA encoder.

Kernel: ``csrc/adaln_linear.cu`` (hand-written bf16 tensor-core GEMM with
the LayerNorm/AdaLN prologue and the gate/GELU/Euler/embed epilogues fused;
it replaces the products inside the JAX package's
``ops/fused_layer.py::_trunk_call`` and ``ops/ipa_encoder.py::_encoder_call``
kernels). ``plan`` chooses its route on the host: the wgmma + TMA core
(resident: the block's rows normalised once in shared memory; pipelined:
X and W both streamed) where the operands pass TMA's 16-byte rule, else
the scalar 64 x 64 tiling (``tiled64``), and sizes the grid, the ring and
the shared memory; the launcher takes the plan as trailing arguments.
``adaln_linear_plain`` is the same function in plain PyTorch, in
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

import dataclasses

import torch

from ..models.layers import gelu_fast
from . import _cuda
from ._cuda import SMS

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
             _cuda.P, _cuda.I64, _cuda.P,
             _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I64]

ROUTES = ("resident", "pipelined", "tiled64")
SMEM_PER_SM = 233_472              # 228 KB, of which each resident block reserves 1 KB
SMEM_PER_BLOCK = 232_448           # 227 KB
MERGED_STAGES = 3                  # the merged layer backward's ring: two blocks per SM
MIN_STAGES, MAX_STAGES = 3, 8
WAVES = 4                          # resident: column chunks split until ~4 waves of blocks exist
# csrc/adaln_linear.cuh, namespace wg: the columns of a chunk (wgmma N),
# a warpgroup's staging tiles, the alignment slack of the dynamic shared
# memory, the W rows of a ring stage (KB); a block is one or two
# warpgroups of 64 rows each
TILE_N, STAGING, ALIGN, SLAB = 128, 4 * 16 * 40 * 4, 1024, 64
KMAX = 512                         # resident: the block's rows at K <= 512


def stage_bytes(route: int, wgs: int) -> int:
    """A ring stage: the W slab of ``SLAB`` rows (two 64-column boxes), after
    the (64 wgs) x 64 X tile on the pipelined route."""
    return SLAB * 256 + (64 * wgs * 128 if route == 1 else 0)


def smem_bytes(route: int, K: int, stages: int, wgs: int) -> int:
    """Dynamic shared memory of a wgmma block (``wg::smem``): alignment
    slack, the resident rows (K in blocks of 64), the ring, the staging
    tiles, the barriers."""
    rows = -(-K // 64) * 64 * wgs * 128 if route == 0 else 0
    return ALIGN + rows + stages * stage_bytes(route, wgs) + STAGING * wgs + 8 * (stages + 1)


def blocks_per_sm(smem: int) -> int:
    return min(2, SMEM_PER_SM // (smem + 1024))


@dataclasses.dataclass(frozen=True)
class Plan:
    route: int        # 0 resident, 1 pipelined (wgmma + TMA), 2 tiled64
    tile_m: int       # a block's rows (64 a warpgroup)
    tile_n: int       # a block's columns per chunk (the wgmma N)
    per: int          # column chunks per block
    splits: int       # blocks across the columns
    row_blocks: int
    stages: int       # TMA ring stages
    smem: int         # dynamic shared memory per block, bytes
    tma: bool         # the operands pass TMA's base and stride rule

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.splits

    @property
    def name(self) -> str:
        return ROUTES[self.route]

    @property
    def warpgroups(self) -> int:
        return self.tile_m // 64 if self.route < 2 else 0


def _rows16(t) -> bool:
    """A row view whose rows start on 16-byte boundaries (bf16 or f32)."""
    return t is None or (t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size()) % 16 == 0)


def plan(x, w, b=None, *, ln=None, shift=None, epilogue="none", res=None, gate=None,
         out=None, pre=None, merged=False, **_) -> Plan:
    """The route, grid, ring depth and shared memory of ``adaln_linear`` on
    these operands (the wrapper's arguments; ``out`` None is a new, aligned
    tensor): a wgmma route where the operands pass TMA's 16-byte rule and
    the epilogue is none, GELU or gate_res, else tiled64. ``merged``: inside
    the merged layer backward, whose blocks are one warpgroup, two to an SM
    (a ring of ``MERGED_STAGES``)."""
    M, K = x.shape
    N = w.shape[1]
    tma = (x.dtype == torch.bfloat16 and N % 8 == 0 and K % 8 == 0 and N >= 64
           and _rows16(x) and w.data_ptr() % 16 == 0
           and (b is None or b.data_ptr() % 16 == 0)
           and all(_rows16(t) for t in (out, res, gate, pre)))
    prologue = ln is not None or shift is not None
    wgmma = tma and epilogue not in ("euler", "add")  # the head's and the embed's: tiled64
    if wgmma and K % 32 == 0 and K <= KMAX:
        route = 0
    elif wgmma and not prologue and K >= 64:
        route = 1
    else:
        return Plan(2, 64, 64, 1, -(-N // 64), -(-M // 64), 1, 0, tma)
    wgs = 1 if merged or M <= 64 else 2
    rb = -(-M // (64 * wgs))
    if merged:
        stages = MERGED_STAGES
    else:
        stages = MIN_STAGES
        cap = SMEM_PER_BLOCK if wgs == 2 else SMEM_PER_SM // 2 - 1024
        while stages < MAX_STAGES and smem_bytes(route, K, stages + 1, wgs) <= cap:
            stages += 1
    smem = smem_bytes(route, K, stages, wgs)
    chunks = -(-N // TILE_N)
    if route == 0:
        split = min(chunks, max(1, -(-WAVES * SMS * blocks_per_sm(smem) // rb)))
        per = -(-chunks // split)
        split = -(-chunks // per)
    else:
        per, split = 1, chunks
    return Plan(route, 64 * wgs, TILE_N, per, split, rb, stages, smem, tma)


def resources(p: Plan, out_f32: bool = False, epilogue: str = "none") -> dict:
    """The wgmma kernel's launch resources under plan ``p`` for an output
    type and an epilogue (on the card): registers and local (spill) bytes
    per thread, dynamic shared memory, resident blocks per SM."""
    lib = _cuda.library("adaln_linear", _ARGTYPES)
    fn = lib.adaln_linear_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.I32, _cuda.I64, _cuda.P]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(int(out_f32), p.warpgroups, _EPI[epilogue], p.smem, info),
                "adaln_linear_resources")
    return dict(registers=info[0], local_bytes=info[1], smem_bytes=info[2], blocks_per_sm=info[3])


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
    p = plan(x, w, b, **{**kw, "out": out})
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
        _cuda.ptr(pre), pre.stride(0) if pre is not None else 0, _cuda.stream_ptr(x),
        p.route, p.tile_m, p.tile_n, p.per, p.splits, p.stages, p.smem)
    _cuda.check(code, "adaln_linear")
    adaln_linear.launches += 1
    adaln_linear.routes[p.route] += 1
    return out


adaln_linear.launches = 0
adaln_linear.routes = [0, 0, 0]  # launches by route (resident, pipelined, tiled64)

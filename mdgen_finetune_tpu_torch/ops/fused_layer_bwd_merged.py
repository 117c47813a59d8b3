"""fused_layer_bwd_merged: the backward of one trunk layer as one
cooperative kernel launch (``MDGEN_FUSED_BWD=merged``).

Kernel: ``csrc/fused_layer_bwd.cu``; it replaces the JAX package's merged
whole-layer backward ``ops/fused_layer_bwd.py::_kmerged`` (:501, launched at
:644-699 when ``MDGEN_FUSED_BWD=merged``). The kernel runs the split route of
``ops/fused_layer_bwd.py`` (MLP -> frame attention -> residue attention) in
15 phases separated by grid-wide barriers, each step the block body of the
split kernel it replaces over the same blocks, so its outputs are the split
route's (the kernel's note says where the order of a sum could differ).

``fused_layer_bwd_merged_plain`` is the plain version: the split route with
every op through its plain twin (``layer_bwd_split(plain=True)``); on CPU
tensors that is the split route itself, so on the CPU the merged route is
the split route by construction. For CUDA tensors the wrapper launches the
kernel or raises: a shape the kernel does not take is a ``ValueError``, a
refused cooperative launch a ``RuntimeError``; it never hands a shape to the
split kernels.

Shapes it takes (the short route of the JAX package's ``fused_layer_bwd``):
L <= ``MAX_L`` = 8 and T <= ``MAX_T`` = 256; the frame stage's attention core
is ``rope_attention_bwd``'s body at T <= 128 and ``blocked_attention_bwd``'s
above, up to its ``max_keys``; C a multiple of 32 from 64 to 512 (the
resident route of ``adaln_linear``) and head dim 16, 24, 32 or 64. Arguments and
results as ``ops/fused_layer_bwd.fused_layer_bwd``.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.rope import rope_tables
from . import _cuda
from .adaln_linear import plan as adaln_plan
from .blocked_attention_bwd import max_keys
from .linear_bwd import _splits as wgrad_splits
from .linear_bwd import scratch_floats as wgrad_scratch
from .modln_bwd import _splits as modln_splits
from .rope_attention import SHORT_N, SMEM_BYTES, short_plan
from .rope_attention_bwd import MAX_N
from .rope_attention_bwd import short_plan as short_bwd_plan
from .time_attention import MAX_L, MAX_T

_ARGTYPES = [_cuda.P, _cuda.P, _cuda.P, _cuda.P]
N_PTR, N_INT = 75, 48  # csrc/fused_layer_bwd.cu: enum Ptr, enum Int
_KEYS = ("wqkv_l", "bqkv_l", "wout_l", "bout_l", "wqkv_t", "bqkv_t", "wout_t", "bout_t",
         "w1", "b1", "w2", "b2", "bkl", "bvl", "bkt", "bvt")


def fused_layer_bwd_merged_plain(x_in, X1, X2, dout, mod, w, mask, num_heads: int, dmod=None):
    """Plain PyTorch version of ``fused_layer_bwd_merged`` (same arguments):
    the split route through the plain twins; counts its calls on CUDA
    tensors in ``cuda_calls``."""
    from .fused_layer_bwd import layer_bwd_split

    if x_in.is_cuda:
        fused_layer_bwd_merged_plain.cuda_calls += 1
    return layer_bwd_split(x_in, X1, X2, dout, mod, w, mask, num_heads, dmod, plain=True)


fused_layer_bwd_merged_plain.cuda_calls = 0


def _check(x_in, X1, X2, dout, mod, w, mask, num_heads, dmod):
    """The shapes and layouts the kernel takes; returns (B, T, L, C, D)."""
    if mask.dim() != 3:
        raise ValueError("fused_layer_bwd_merged: mask must be (B, T, L)")
    B, T, L = mask.shape
    M, C = x_in.shape
    D = C // num_heads if num_heads else 0
    if L > MAX_L or T > MAX_T:
        raise ValueError(f"fused_layer_bwd_merged: the merged route takes L <= {MAX_L} and "
                         f"T <= {MAX_T} (the short route), got L = {L}, T = {T}")
    if C % 32 or not 64 <= C <= 512 or C != num_heads * D or D not in (16, 24, 32, 64):
        raise ValueError(f"fused_layer_bwd_merged: C = {C} with {num_heads} heads is not taken "
                         "(C a multiple of 32 from 64 to 512, head dim 16, 24, 32 or 64)")
    if T > MAX_N and T > max_keys(D):
        raise ValueError(f"fused_layer_bwd_merged: T = {T} is beyond blocked_attention_bwd's "
                         f"{max_keys(D)} keys at head dim {D}")
    if M != B * T * L:
        raise ValueError(f"fused_layer_bwd_merged: x has {M} rows, mask says {B * T * L}")
    for name, t in (("x_in", x_in), ("X1", X1), ("X2", X2)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (M, C) or not t.is_contiguous():
            raise ValueError(f"fused_layer_bwd_merged: {name} must be a contiguous bf16 "
                             f"({M}, {C}) tensor")
    if dout.dtype != torch.float32 or tuple(dout.shape) != (M, C) or not dout.is_contiguous():
        raise ValueError(f"fused_layer_bwd_merged: dout must be a contiguous f32 ({M}, {C}) tensor")
    nb = mod.shape[0]
    if mod.dtype != torch.bfloat16 or mod.dim() != 2 or mod.shape[1] != 9 * C \
            or mod.stride(1) != 1 or M % nb:
        raise ValueError("fused_layer_bwd_merged: mod must be bf16 (nb, 9C) rows with unit "
                         "column stride, nb dividing M")
    if mask.dtype != torch.float32 or not mask.is_contiguous():
        raise ValueError("fused_layer_bwd_merged: mask must be a contiguous f32 (B, T, L) tensor")
    shapes = dict(wqkv_l=(C, 3 * C), bqkv_l=(3 * C,), wout_l=(C, C), bout_l=(C,),
                  wqkv_t=(C, 3 * C), bqkv_t=(3 * C,), wout_t=(C, C), bout_t=(C,), w1=(C, 4 * C),
                  b1=(4 * C,), w2=(4 * C, C), b2=(C,), bkl=(C,), bvl=(C,), bkt=(C,), bvt=(C,))
    for k, shape in shapes.items():
        t = w[k]
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused_layer_bwd_merged: {k} must be a contiguous bf16 {shape} "
                             "tensor")
    if dmod is not None and (dmod.dtype != torch.float32 or tuple(dmod.shape) != (nb, 9 * C)
                             or dmod.stride(1) != 1):
        raise ValueError(f"fused_layer_bwd_merged: dmod must be an f32 ({nb}, {9 * C}) row view")
    return B, T, L, C, D


class _Carve:
    """Sub-tensors of one allocation, each 256-byte aligned."""

    def __init__(self, device):
        self.device = device
        self.parts = []
        self.nbytes = 0

    def add(self, shape, dtype):
        off = self.nbytes
        n = 1
        for s in shape:
            n *= s
        self.parts.append((off, shape, dtype, n))
        self.nbytes += -(-n * dtype.itemsize // 256) * 256
        return len(self.parts) - 1

    def build(self):
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=self.device)
        return [buf[off:off + n * dt.itemsize].view(dt).view(shape)
                for off, shape, dt, n in self.parts]


_PLANS: dict = {}  # plan integers by shapes and operand alignment


def _plans(x_in, X1, X2, mod, w, scratch, B, T, L, C, num_heads):
    """The integer slots after ``SMEM_LIMIT``: the six recomputed products'
    plans (ops/adaln_linear.py::plan with ``merged``: the split route's
    tiling on one warpgroup), four each: fc1, fc2, qkv_t, out_t, qkv_l,
    out_l; then the short rope_attention plans (sequences and heads per
    unit) of the frame (B, T, L) and the residue (B * T, L, 1) stage, where
    the stage is short; then rope_attention_bwd's the same way."""
    ints = []
    ge, act, y3, yt, yl = scratch[:5]
    qkv_t, qkv_l, att_t, att_l = scratch[9:13]
    sh = dict(ln="plain", shift=mod[:, :C], scale=mod[:, C:2 * C])
    for x, wk, bk, kw in ((X2, "w1", "b1", dict(sh, epilogue="gelu", out=ge, pre=act)),
                          (ge, "w2", "b2", dict(out=y3)), (X1, "wqkv_t", "bqkv_t", dict(sh, out=qkv_t)),
                          (att_t, "wout_t", "bout_t", dict(out=yt)),
                          (x_in, "wqkv_l", "bqkv_l", dict(sh, out=qkv_l)),
                          (att_l, "wout_l", "bout_l", dict(out=yl))):
        p = adaln_plan(x, w[wk], w[bk], merged=True, **kw)
        ints += [p.route, p.per, p.splits, p.stages]
    for plan in (short_plan, short_bwd_plan):
        for G, N, I in ((B, T, L), (B * T, L, 1)):
            sp = plan(G, N, I, num_heads, C // num_heads, merged=True) if N <= SHORT_N else None
            ints += [sp.spb, sp.hg] if sp else [0, 0]
    return ints


def launch_slots(x_in, X1, X2, dout, mod, w, mask, num_heads: int, dmod=None, clock=None):
    """The launch's arguments on CUDA tensors: the ``N_PTR`` tensors whose
    pointers fill ``enum Ptr`` (``clock``, the last, may be None: a u64
    buffer that only the phase-clock build writes), the ``N_INT`` integers
    of ``enum Int`` (the outputs and the scratch carved from one
    allocation), and the results ``(dx, dmod, dw)`` that the launch
    fills."""
    B, T, L, C, D = _check(x_in, X1, X2, dout, mod, w, mask, num_heads, dmod)
    M, F, nb = B * T * L, 4 * C, mod.shape[0]
    f32, bf = torch.float32, torch.bfloat16
    spl = [wgrad_splits(M, K, N) for K, N in ((F, C), (C, F), (C, C), (C, 3 * C), (C, C),
                                               (C, 3 * C))]
    splm = modln_splits(M // nb, nb)

    cv = _Carve(x_in.device)
    outs = [cv.add((M, C), f32)]                      # dx
    if dmod is None:
        outs.append(cv.add((nb, 9 * C), f32))
    grads = {k: cv.add(tuple(w[k].shape), f32) for k in _KEYS if k not in ("bkl", "bvl", "bkt",
                                                                              "bvt")}
    dbias = [cv.add((2, C), f32), cv.add((2, C), f32)]  # (dbk, dbv) residue, frame
    scratch = [cv.add((M, F), bf), cv.add((M, F), f32)]               # ge, a
    scratch += [cv.add((M, C), f32) for _ in range(3)]                # y3, y_t, y_l
    scratch += [cv.add((M, F), bf)] + [cv.add((M, C), f32) for _ in range(3)]  # da, dh, dx2, dx1
    scratch += [cv.add((M, 3 * C), bf) for _ in range(2)]             # qkv_t, qkv_l
    scratch += [cv.add((M, C), bf) for _ in range(3)]                 # att_t, att_l, datt
    scratch += [cv.add((M, 3 * C), bf)]                               # dqkv
    for K, N in ((F, C), (C, F), (C, C), (C, 3 * C), (C, C), (C, 3 * C)):
        scratch.append(cv.add((wgrad_scratch(M, K, N),), f32))         # wgrad partials, stats
    scratch += [cv.add((splm * nb * 3 * C,), f32) for _ in range(3)]  # modln partials
    scratch += [cv.add((B * L * 2 * C,), f32), cv.add((B * T * 2 * C,), f32)]  # bias partials
    # linear_bwd's prologues in bf16: dOUT g8, LN + modulate of X2, X1, x_in, dx2 g5, dx1 g2
    scratch += [cv.add((M, C), bf) for _ in range(6)]
    t = cv.build()
    dx = t[outs[0]]
    if dmod is None:
        dmod = t[outs[1]]
    scratch = [t[i] for i in scratch]
    cos_t, sin_t = rope_tables(T + 1, D, device=x_in.device)
    cos_l, sin_l = rope_tables(L + 1, D, device=x_in.device)
    ptrs = [x_in, X1, X2, dout, mod, mask] + [w[k] for k in _KEYS] + [cos_t, sin_t, cos_l, sin_l]
    ptrs += [dx, dmod] + [t[grads[k]] for k in _KEYS[:12]] + [t[dbias[0]], t[dbias[1]]]
    ptrs += scratch + [clock]
    ints = [B, T, L, C, num_heads, nb, mod.stride(0), dmod.stride(0), *spl, splm, SMEM_BYTES]
    # the six recomputed products' plans and the short rope_attention and
    # rope_attention_bwd plans: they follow from the shapes and from which
    # operands start on 16 bytes, so they are kept by those
    key = (str(x_in.device), B, T, L, C, num_heads, nb, mod.stride(0),
           tuple(v.data_ptr() % 16 == 0 for v in (x_in, X1, X2, mod, *w.values())))
    if key not in _PLANS:
        if len(_PLANS) >= 64:
            _PLANS.clear()
        _PLANS[key] = _plans(x_in, X1, X2, mod, w, scratch, B, T, L, C, num_heads)
    ints += _PLANS[key]
    dw = {k: t[grads[k]] for k in _KEYS[:12]}
    dl, dtt = t[dbias[0]], t[dbias[1]]
    dw.update(bkl=dl[0], bvl=dl[1], bkt=dtt[0], bvt=dtt[1])
    return ptrs, ints, (dx, dmod, dw)


def fused_layer_bwd_merged(x_in, X1, X2, dout, mod, w, mask, num_heads: int, dmod=None):
    """The layer backward in one launch: the kernel on CUDA tensors, the
    plain version on CPU tensors (see the module docstring). Returns
    ``(dx, dmod, dw)`` as ``fused_layer_bwd``."""
    if not x_in.is_cuda:
        return fused_layer_bwd_merged_plain(x_in, X1, X2, dout, mod, w, mask, num_heads, dmod)
    ptrs, ints, out = launch_slots(x_in, X1, X2, dout, mod, w, mask, num_heads, dmod)
    lib = _cuda.library("fused_layer_bwd", _ARGTYPES)
    lib.fused_layer_bwd_slots.argtypes = [_cuda.I32]
    lib.fused_layer_bwd_slots.restype = _cuda.I32
    if (lib.fused_layer_bwd_slots(0), lib.fused_layer_bwd_slots(1)) != (N_PTR, N_INT) \
            or len(ptrs) != N_PTR or len(ints) != N_INT:
        raise RuntimeError("fused_layer_bwd_merged: the argument slots disagree with the kernel's")
    p_arr = (ctypes.c_void_p * N_PTR)(*[_cuda.ptr(p) for p in ptrs])
    i_arr = (ctypes.c_longlong * N_INT)(*ints)
    info = (ctypes.c_longlong * 3)()
    code = lib.fused_layer_bwd(ctypes.addressof(p_arr), ctypes.addressof(i_arr),
                               ctypes.addressof(info), _cuda.stream_ptr(x_in))
    _cuda.check(code, "fused_layer_bwd_merged (cooperative launch)")
    fused_layer_bwd_merged.launches += 1
    fused_layer_bwd_merged.last_launch = dict(grid=info[0], blocks_per_sm=info[1],
                                              smem_bytes=info[2])
    return out


fused_layer_bwd_merged.launches = 0
fused_layer_bwd_merged.last_launch = None

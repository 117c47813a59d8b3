"""Micro-op cost probe on the card: the Hopper counterpart of the JAX
package's ``tools/micro_ops.py``.

    python -m mdgen_finetune_tpu_torch.tools.micro_ops [--ops mul_416x384,...] [--reps 5]

Each named op runs K times inside one kernel (``csrc/micro_ops.cu``, one
block per program, grid (32,)) on x (32, 416, 384) and y (32, 416, 1536)
bf16; the kernel is timed with CUDA events (median of ``--reps``) at K = 2
and K = 10, and the marginal cost of one op in one program is
(t10 - t2) / 8 / 32 microseconds, the JAX probe's protocol. Each program
returns two sums over every element of its K evaluations: the plain sum and
the sum weighted by a fixed pseudo-random weight in [-1, 1) per place in the
op's output (``_weights``), which an element computed or moved to the wrong
place changes even where the plain sum cannot (a roll, a concat). Every
op's two sums are first held against ``micro_ops_plain`` (the same sums in
torch) on the card (``check``). The card's name and power limit are printed
with the table.

The ops keep the JAX probe's names and shapes (``OPS``, in its order; x is
one program's (416, 384), y its (416, 1536), rot(t, k) rolls t's rows by
8 (k + 1)). What each is on this card:

- ``mul``, ``fma_f32``, ``exp*``, ``add``, ``maxlane``, ``sumlane``,
  ``ln_f32``, ``softmax_tail``: f32 arithmetic in registers, a warp per
  row for the row reductions (shuffles for max and sum);
- ``dot_*``, ``pair_dot_*``, ``stack_dot_*``: bf16 products on the tensor
  cores in the kernel's own body: the block is one warpgroup issuing
  wgmma.mma_async with f32 accumulators on 64-row tiles (64 columns for
  N = 16, whose other columns are zeros; else 128): B's K x 128 panel
  brought once per column tile (N-major, through wgmma's transpose bit),
  A's 64 x 64 slabs streamed through a ring of six by 16-byte cp.async
  (its rows rolled row by row);
  ``pair`` is two 416-row products, ``stack`` one 832-row product of the
  same rows; ``dot_bf16out`` rounds each output to bf16;
  ``dot_416x16x384`` and ``dot_416x80x1920`` take f32 operands in the JAX
  probe: f32 FMA chains here. The JAX probe's weight of
  ``dot_416x384x1536``, ``dot_832x384x1536`` and ``dot_bf16out_416x384x1536``
  (``y.reshape(4R, 384)[:384].T.reshape(384, 1536)``) does not reshape
  (147,456 elements into 589,824), so the JAX tool reports those three as
  failed; here their weight is ``y[:384]``, (384, 1536);
- the TPU layout ops become the data movement they stand for:
  ``lane_concat5`` (a 1,920-lane row concat) writes each output row to
  shared memory and reads it back; ``row_tile4`` (a sublane tiling) stages
  104 rows in shared memory and reads them 4 times; ``mask_stack`` (16
  lane-masked copies of a (104, 512) block) writes each masked row to shared
  memory and reads it back; ``collapse`` (the masked sum of 4 row blocks)
  is a strided gather from device memory; ``roll_pair`` (two lane
  rotations) stages each row in shared memory and reads it at both
  rotations; ``slice_lane`` (a lane-offset slice) reads the 384 lanes from
  device memory.

``micro_ops`` is the kernel's wrapper (a launch counter on it);
``micro_ops_plain`` the plain version, for CPU tensors too. The tool needs
an NVIDIA GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..ops import _cuda

R, C, TP, PROGRAMS = 416, 384, 104, 32
_ARGTYPES = [_cuda.P, _cuda.P, _cuda.P, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P]


def _rot(t, k):
    s = 8 * (k + 1) % t.shape[0]
    return torch.cat([t[s:], t[:s]], dim=0)


def _r4(t):
    return t.reshape(4 * R, C)


def _dot(a, b):
    return a.float() @ b.float()


def _group_masks(head_dim: int, group_heads: int, dtype, device):
    """(gh, 1, gh * D): mask j keeps lanes j D .. (j + 1) D - 1."""
    lane = torch.arange(group_heads * head_dim, device=device)
    j = torch.arange(group_heads, device=device)[:, None, None]
    return ((lane >= j * head_dim) & (lane < (j + 1) * head_dim)).to(dtype)


def _pair(nk):
    def op(x, y, k):
        w = x[:384, :nk] if nk <= 384 else y[:384, :nk]
        return _dot(_rot(x, k), w) + _dot(_rot(x, k + 11), w)
    return op


def _stack(nk):
    def op(x, y, k):
        w = x[:384, :nk] if nk <= 384 else y[:384, :nk]
        d = _dot(torch.cat([_rot(x, k), _rot(x, k + 11)], dim=0), w)
        return d[:R] + d[R:]
    return op


def _ln(x, y, k):
    x32 = _rot(x, k).float()
    mean = x32.mean(1, keepdim=True)
    var = (x32 * x32).mean(1, keepdim=True) - mean * mean
    return (x32 - mean) * torch.rsqrt(var + 1e-6)


def _softmax_tail(x, y, k):
    p = _rot(x, k)[:, :112].float()
    e = p - p.amax(1, keepdim=True)
    return e / e.sum(1, keepdim=True)


def _dot_1664x512x112(x, y, k):
    a = _r4(_rot(y, k))[:, :256]
    return _dot(torch.cat([a, a], dim=1), _r4(y)[:512, :112])


def _dot_416x80x1920(x, y, k):
    w = _r4(_rot(y, k))[:80].float()
    return _rot(x, k)[:, :80].float() @ torch.cat([w] * 5, dim=1)


def _collapse(x, y, k):
    pv = _r4(_rot(y, k))[:4 * TP, :128].float()
    return (pv.reshape(4, TP, 128) * _group_masks(32, 4, torch.float32, x.device)).sum(0)


# the plain ops, in the JAX probe's order (csrc/micro_ops.cu enum Op)
OPS = {
    "mul_416x384": lambda x, y, k: _rot(x, k) * x,
    "fma_f32_416x384": lambda x, y, k: _rot(x, k).float() * x.float() + x.float(),
    "exp_f32_416x112": lambda x, y, k: torch.exp(_rot(x, k)[:, :112].float()),
    "exp_f32_1664x112": lambda x, y, k: torch.exp(_r4(_rot(y, k))[:, :112].float()),
    "exp2_f32_416x112": lambda x, y, k: torch.exp2(_rot(x, k)[:, :112].float()),
    "exp2_f32_1664x112": lambda x, y, k: torch.exp2(_r4(_rot(y, k))[:, :112].float()),
    "add_f32_416x112": lambda x, y, k: _rot(x, k)[:, :112].float() + x[:1, :112].float(),
    "maxlane_f32_416x112": lambda x, y, k: _rot(x, k)[:, :112].float().amax(1, keepdim=True),
    "sumlane_f32_416x112": lambda x, y, k: _rot(x, k)[:, :112].float().sum(1, keepdim=True),
    "lane_concat5_416x384": lambda x, y, k: torch.cat([_rot(x, k), x] * 2 + [_rot(x, k)], dim=1),
    "row_tile4_104x384": lambda x, y, k: torch.cat([_rot(x, k)[:TP]] * 4, dim=0),
    "dot_104x384x16": lambda x, y, k: _dot(_rot(x, k)[:TP], x[:384, :16]),
    "dot_416x384x16": lambda x, y, k: _dot(_rot(x, k), x[:384, :16]),
    "pair_dot_416x384x16": _pair(16),
    "stack_dot_832x384x16": _stack(16),
    "pair_dot_416x384x384": _pair(384),
    "stack_dot_832x384x384": _stack(384),
    "pair_dot_416x384x1536": _pair(1536),
    "stack_dot_832x384x1536": _stack(1536),
    "dot_416x384x384": lambda x, y, k: _dot(_rot(x, k), x[:384, :384]),
    "dot_832x384x384": lambda x, y, k: _dot(_r4(_rot(y, k))[:832], x[:384, :384]),
    "dot_1664x384x384": lambda x, y, k: _dot(_r4(_rot(y, k)), x[:384, :384]),
    "dot_416x384x1536": lambda x, y, k: _dot(_rot(x, k), y[:384]),
    "dot_832x384x1536": lambda x, y, k: _dot(_r4(_rot(y, k))[:832], y[:384]),
    "dot_bf16out_416x384x1536": lambda x, y, k: _dot(_rot(x, k), y[:384]).to(torch.bfloat16),
    "dot_416x128x112": lambda x, y, k: _dot(_rot(x, k)[:, :128], x[:128, :112]),
    "dot_1664x512x112": _dot_1664x512x112,
    "dot_416x16x384": lambda x, y, k: _rot(x, k)[:, :16].float() @ x[:16].float(),
    "dot_416x80x1920": _dot_416x80x1920,
    "mask_stack_16x104x512": lambda x, y, k: (
        _rot(y, k)[:TP, :512][None] * _group_masks(32, 16, y.dtype, y.device)).reshape(16 * TP, 512),
    "collapse_4x416x128": _collapse,
    "ln_f32_416x384": _ln,
    "softmax_tail_416x112": _softmax_tail,
    "roll_pair_416x384": lambda x, y, k: (torch.roll(_rot(x, k).float(), 12, 1)
                                          + torch.roll(_rot(x, k).float(), 372, 1)),
    "slice_lane_416x384of1536": lambda x, y, k: _rot(y, k)[:, 384:768],
}
NAMES = tuple(OPS)


def _weights(rows: int, cols: int, device):
    """(rows, cols) f64: the weight of each output place, the kernel's
    ``wt``: the top byte h >> 24 of h = (r * 65536 + c) * 2654435761 mod 2^32,
    as h / 128 - 1."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h = ((r * 65536 + c) * 2654435761) & 0xFFFFFFFF
    return (h >> 24).double() / 128 - 1


def micro_ops_plain(x, y, name: str, K: int, ops=None):
    """Plain version of ``micro_ops`` (same arguments; ``ops`` in place of
    ``OPS``, to hold a changed op): per program b the sums of every element v
    of op(x[b], y[b], k), k < K, as (programs, 2) f64: the plain sum and the
    sum weighted by ``_weights`` of v's place; and their scales, the sums of
    |v| and |w v|, (programs, 2) f64."""
    op = (ops or OPS)[name]
    sums, mags = [], []
    for b in range(x.shape[0]):
        s = torch.zeros(2, dtype=torch.float64, device=x.device)
        m = torch.zeros_like(s)
        for k in range(K):
            v = op(x[b], y[b], k).double()
            wv = _weights(*v.shape, v.device) * v
            s += torch.stack([v.sum(), wv.sum()])
            m += torch.stack([v.abs().sum(), wv.abs().sum()])
        sums.append(s)
        mags.append(m)
    return torch.stack(sums), torch.stack(mags)


def micro_ops(x, y, name: str, K: int, out=None):
    """The probe kernel: op ``name`` K times in each of x.shape[0] blocks;
    returns the (programs, 2) f32 sums (plain, position-weighted). CUDA
    tensors only."""
    if not x.is_cuda:
        raise ValueError("micro_ops: the probe kernel runs on an NVIDIA GPU; "
                         "micro_ops_plain is its plain version")
    P = x.shape[0]
    if (x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16 or tuple(x.shape) != (P, R, C)
            or tuple(y.shape) != (P, R, 4 * C) or not x.is_contiguous() or not y.is_contiguous()):
        raise ValueError(f"micro_ops: x (P, {R}, {C}) and y (P, {R}, {4 * C}) contiguous bf16")
    if out is None:
        out = torch.empty(P, 2, dtype=torch.float32, device=x.device)
    lib = _cuda.library("micro_ops", _ARGTYPES)
    lib.micro_ops_count.argtypes = []
    lib.micro_ops_count.restype = _cuda.I32
    if lib.micro_ops_count() != len(NAMES):
        raise RuntimeError("micro_ops: the kernel's ops disagree with OPS")
    code = lib.micro_ops(x.data_ptr(), y.data_ptr(), out.data_ptr(), NAMES.index(name), P, K,
                         _cuda.stream_ptr(x))
    _cuda.check(code, f"micro_ops[{name}]")
    micro_ops.launches += 1
    return out


micro_ops.launches = 0


def inputs(device, seed: int = 0, programs: int = PROGRAMS):
    """x (programs, 416, 384) and y (programs, 416, 1536) bf16, 0.1 N(0, 1)
    (the JAX probe's inputs)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (0.1 * torch.randn(programs, R, C, generator=g, device=device)).to(torch.bfloat16)
    y = (0.1 * torch.randn(programs, R, 4 * C, generator=g, device=device)).to(torch.bfloat16)
    return x, y


# The limit of a sum, relative to the sum of the magnitudes of its terms.
# The kernel adds its terms in f32, ~K N / 128 of them in a row per thread
# (at most ~12,500, lane_concat5): terms of random sign leave a rounding of
# ~2^-24 of that scale, terms of one sign ~2^-24 sqrt(n / 3) = 4e-6 of it
# at most; a term's own rounding (f32 products, expf, bf16 outputs) is as
# small or cancels. A layout fault moves weight-sums by ~1 / sqrt(N) of
# their scale (6e-4 at lane_concat5's 1.6M terms), 30x this limit.
REL = 2e-5


def compare(name: str, got, ref, mag, rel: float = REL):
    """Hold the kernel's (programs, 2) sums ``got`` against the plain
    version's ``ref``: |got - ref| <= rel x ``mag`` for each program and both
    sums; raises AssertionError. Returns (max |got - ref|, max |got - ref| /
    mag)."""
    got = got.double()
    err = (got - ref).abs()
    lim = rel * mag
    if not bool(torch.isfinite(got).all()) or bool((err > lim).any()):
        i, j = divmod(int((err - lim).argmax()), 2)
        raise AssertionError(f"micro_ops[{name}]: program {i}, {('plain', 'weighted')[j]} sum: "
                             f"kernel {got[i, j].item()} vs plain {ref[i, j].item()} "
                             f"(limit {lim[i, j].item()})")
    return err.max().item(), (err / mag).max().item()


def check(x, y, name: str, K: int = 2):
    """The kernel's sums against the plain version's on the same inputs
    (``compare``). Returns (max abs error, max relative error)."""
    ref, mag = micro_ops_plain(x, y, name, K)
    return compare(name, micro_ops(x, y, name, K), ref, mag)


def measure(x, y, name: str, reps: int = 5):
    """t2, t10 (ms, median of ``reps`` CUDA-event-timed launches) and the
    marginal cost in microseconds per op per program."""
    out = torch.empty(x.shape[0], 2, dtype=torch.float32, device=x.device)
    times = {}
    for K in (2, 10):
        micro_ops(x, y, name, K, out)  # warm-up
        ts = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            micro_ops(x, y, name, K, out)
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        times[K] = sorted(ts)[len(ts) // 2]
    return times[2], times[10], (times[10] - times[2]) / 8 / x.shape[0] * 1e3


def run(names=NAMES, reps: int = 5, seed: int = 0):
    """Build, check and time every op in ``names``; returns {name: {...}}."""
    x, y = inputs("cuda", seed)
    res = {}
    for name in names:
        err, rel = check(x, y, name)
        t2, t10, us = measure(x, y, name, reps)
        res[name] = dict(t2_ms=t2, t10_ms=t10, marginal_us=us, max_abs_err=err,
                         max_rel_err=rel, tol=REL)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", default="", help="comma-separated op names (default: all)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro_ops: CUDA is not available; the probe measures an NVIDIA GPU", file=sys.stderr)
        return 2
    names = args.ops.split(",") if args.ops else list(NAMES)
    unknown = [n for n in names if n not in OPS]
    if unknown:
        print(f"micro_ops: unknown ops {unknown}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    res = run(names, args.reps)
    for n, r in res.items():
        print(f"{n:28s} t2={r['t2_ms']:8.3f}ms t10={r['t10_ms']:8.3f}ms "
              f"marginal {r['marginal_us']:9.3f} us/op/program")
    print("\n== sorted ==")
    for n, r in sorted(res.items(), key=lambda kv: -kv[1]["marginal_us"]):
        print(f"{r['marginal_us']:9.3f} us  {n}")
    print(json.dumps({"card": smi, "micro_ops": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

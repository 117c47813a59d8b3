"""Where the merged layer backward's time goes, on the card: its phase clock.

    python -m mdgen_finetune_tpu_torch.tools.merged_phase_clock [--reps 5] [--out FILE]

Builds ``csrc/fused_layer_bwd.cu`` a second time with ``-DMDGEN_PHASE_CLOCK``
into a library of its own (``_cuda.variant_library``): in
that build thread 0 of every block stamps ``%globaltimer`` where its work in
each of the 15 phases starts and ends. Then, at the merged route's two
shapes (B = 32, T = 100 and B = 4, T = 200; L = 4, C = 384, 16 heads, seeded
random inputs), it runs that build ``--reps`` times on the same launch slots
as ``ops/fused_layer_bwd_merged.py`` and reports per phase (medians over the
runs, ms):

- ``phase_ms``: from the first block's start of the phase to the first
  block's start of the next (the last phase: to its last block's end);
- ``busy_mean_ms`` / ``busy_max_ms``: a block's work in the phase, the mean
  and the largest over the blocks;
- ``wait_mean_ms``: a block's time from its end of the phase to its start
  of the next (at the grid barrier), the mean over the blocks;
- ``split_ms``: the device time of the split route's launches that do the
  phase's main work (``SPLIT_CALLS``; a torch.profiler trace of
  ``layer_bwd_split`` on the same inputs after a warm-up step of the
  profiler, its launches told apart by a marker kernel before each wrapper
  call; a trace without 25 markers is taken again, ``split_traces`` says
  how many were taken; after ``TRACES`` such traces the split side is
  reported as not measured, with the markers each trace held). A split call's
  prologues and column sums, which the merged kernel runs in neighbouring
  phases, stay with its main product.

Also: the merged launch by CUDA events in the normal build and in the clock
build (the clock's cost), the split route's, and the launch's grid. Prints
the card's name and power limit, then one JSON line per shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from ..ops import _cuda
from ..ops import fused_layer_bwd as FB
from ..ops import fused_layer_bwd_merged as FM

TRACES = 5  # profiler traces taken for the split side before it goes unmeasured

PHASES = (
    "P0 recompute fc1 + GELU, qkv_t, qkv_l; LN statistics; dOUT g8",
    "P1 fc2; dW2 wgrad; da dgrad; attention fwd (frame, residue); LN + modulate prologues",
    "P2 dW1 wgrad; dh dgrad; out_t, out_l; dW2 sums",
    "P3 modln (MLP); dW1 sums",
    "P4 dmod sums (MLP); dx2 g5",
    "P5 dWout_t wgrad; datt dgrad",
    "P6 frame attention bwd; dWout_t sums",
    "P7 dWqkv_t wgrad; dh dgrad; frame bias sums",
    "P8 modln (frame); dWqkv_t sums",
    "P9 dmod sums (frame); dx1 g2",
    "P10 dWout_l wgrad; datt dgrad",
    "P11 residue attention bwd; dWout_l sums",
    "P12 dWqkv_l wgrad; dh dgrad; residue bias sums",
    "P13 modln (residue); dWqkv_l sums",
    "P14 dmod sums (residue)",
)
# the split route's wrapper calls in their order (layer_bwd_split), each with
# the merged phase that runs its main work
SPLIT_CALLS = (
    ("adaln_linear fc1", 0), ("adaln_linear fc2", 1), ("linear_bwd dW2", 1),
    ("linear_bwd da", 1), ("linear_bwd dW1", 2), ("linear_bwd dh", 2), ("modln_bwd mlp", 3),
    ("adaln_linear qkv_t", 0), ("attention fwd frame", 1), ("adaln_linear out_t", 2),
    ("linear_bwd dWout_t", 5), ("linear_bwd datt_t", 5), ("attention bwd frame", 6),
    ("linear_bwd dWqkv_t", 7), ("linear_bwd dh_t", 7), ("modln_bwd frame", 8),
    ("adaln_linear qkv_l", 0), ("attention fwd residue", 1), ("adaln_linear out_l", 2),
    ("linear_bwd dWout_l", 10), ("linear_bwd datt_l", 10), ("attention bwd residue", 11),
    ("linear_bwd dWqkv_l", 12), ("linear_bwd dh_l", 12), ("modln_bwd residue", 13),
)
SHAPES = (("T100", 32, 100), ("T200", 4, 200))
L, C, H = 4, 384, 16
MAX_GRID = 132 * 8  # blocks of a cooperative launch, at most (the clock buffer's rows)


CLOCK = "MDGEN_PHASE_CLOCK"


def start_clock_build() -> None:
    """Start the phase-clock build of fused_layer_bwd.cu in the background."""
    _cuda.start_variant("fused_layer_bwd", CLOCK)


def clock_library() -> ctypes.CDLL:
    """The phase-clock build of fused_layer_bwd.cu (built once per source)."""
    lib = _cuda.variant_library("fused_layer_bwd", CLOCK)
    lib.fused_layer_bwd.argtypes = [ctypes.c_void_p] * 4
    lib.fused_layer_bwd.restype = ctypes.c_int
    return lib


def layer_case(Bc, Tc, seed):
    """Seeded bf16 inputs of one trunk layer (a padded residue, a frame whose
    only valid residue key is the bias token) and its forward's X1, X2."""
    from ..ops.fused_layer import trunk_layer

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=g, device="cuda") * sc

    shapes = dict(wqkv_l=(C, 3 * C), bqkv_l=(3 * C,), wout_l=(C, C), bout_l=(C,),
                  wqkv_t=(C, 3 * C), bqkv_t=(3 * C,), wout_t=(C, C), bout_t=(C,),
                  w1=(C, 4 * C), b1=(4 * C,), w2=(4 * C, C), b2=(C,), bkl=(C,), bvl=(C,),
                  bkt=(C,), bvt=(C,))
    w = {k: r(*s, sc=(s[0] ** -0.5 if k[0] == "w" else 0.4)).bfloat16() for k, s in shapes.items()}
    mask = torch.ones(Bc, Tc, L, device="cuda")
    mask[0, :, -1] = 0
    mask[-1, 2, :] = 0
    x, mod = r(Bc * Tc * L, C).bfloat16(), r(Bc, 9 * C, sc=0.3).bfloat16()
    x1, x2, _ = trunk_layer(x, mod, w, mask, B=Bc, T=Tc, L=L, num_heads=H)
    return x, x1, x2, r(Bc * Tc * L, C), mod, w, mask, H


def events_ms(fn, reps):
    """Median of CUDA-event-timed calls, after a warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def split_by_phase(args):
    """Device ms of the split route's wrapper calls (SPLIT_CALLS), summed by
    the merged phase that runs each call's main work: (by phase, by call,
    traces taken); (None, why, traces taken) where no trace held every call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from ..ops import adaln_mlp as AM

    mark = torch.zeros(1, dtype=torch.int32, device="cuda")
    names = {AM: ("adaln_linear", "linear_bwd", "modln_bwd"),
             FB: ("adaln_linear", "linear_bwd", "modln_bwd", "rope_attention", "tiled_attention",
                  "rope_attention_bwd", "blocked_attention_bwd")}
    kept = {(m, n): getattr(m, n) for m, ns in names.items() for n in ns}

    def marked(fn):
        def call(*a, **k):
            torch.bitwise_not(mark, out=mark)
            return fn(*a, **k)
        return call

    def trace():
        """The marked calls' device ms from one trace (a list with one
        entry per marker seen)."""
        # the first step only warms the profiler up (a trace's first kernels
        # can go unrecorded); the second is read
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traces.append(p.events())) as prof:
            for _ in range(2):
                FB.layer_bwd_split(*args)
                torch.cuda.synchronize()
                prof.step()
        if len(traces) != 1:
            return []
        dev = sorted((e for e in traces[0] if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        calls = []
        for e in dev:
            if "bitwise_not" in e.name:
                calls.append(0.0)
            elif calls:
                calls[-1] += e.time_range.elapsed_us() / 1e3
        return calls

    for (m, n), fn in kept.items():
        setattr(m, n, marked(fn))
    seen = []
    try:
        # a trace can come back without the card's kernels (a CUPTI
        # hiccup on the card's machine): up to TRACES traces are taken
        for taken in range(1, TRACES + 1):
            calls = trace()
            if len(calls) == len(SPLIT_CALLS):
                break
            seen.append(len(calls))
    finally:
        for (m, n), fn in kept.items():
            setattr(m, n, fn)
    if len(seen) == TRACES:
        return None, (f"not measured: {TRACES} profiler traces held {seen} of the "
                      f"{len(SPLIT_CALLS)} marked wrapper calls"), TRACES
    per = [0.0] * len(PHASES)
    for (_, p), ms in zip(SPLIT_CALLS, calls):
        per[p] += ms
    return per, {name: ms for (name, _), ms in zip(SPLIT_CALLS, calls)}, taken


def phase_table(stamps, grid):
    """Per phase (ms): span, busy mean and max, wait mean, from the u64
    stamps [PHASES][grid][2] of one run."""
    st = stamps[:len(PHASES) * grid * 2].view(len(PHASES), grid, 2).double()
    start, end = st[..., 0], st[..., 1]
    out = []
    for p in range(len(PHASES)):
        busy = (end[p] - start[p]) / 1e6
        if p + 1 < len(PHASES):
            span = (start[p + 1].min() - start[p].min()) / 1e6
            wait = ((start[p + 1] - end[p]) / 1e6).mean()
        else:
            span, wait = (end[p].max() - start[p].min()) / 1e6, torch.tensor(0.0)
        out.append((float(span), float(busy.mean()), float(busy.max()), float(wait)))
    return out


def measure(name, Bc, Tc, reps, lib):
    args = layer_case(Bc, Tc, seed=41 + Tc)
    clock = torch.zeros(len(PHASES) * MAX_GRID * 2, dtype=torch.int64, device="cuda")
    ptrs, ints, _ = FM.launch_slots(*args, clock=clock)
    p_arr = (ctypes.c_void_p * len(ptrs))(*[_cuda.ptr(t) for t in ptrs])
    i_arr = (ctypes.c_longlong * len(ints))(*ints)
    info = (ctypes.c_longlong * 3)()
    stream = torch.cuda.current_stream().cuda_stream

    def run_clock():
        code = lib.fused_layer_bwd(ctypes.addressof(p_arr), ctypes.addressof(i_arr),
                                   ctypes.addressof(info), stream)
        if code:
            raise RuntimeError(f"the phase-clock build failed to launch: cudaError {code}")

    run_clock()
    torch.cuda.synchronize()
    grid = int(info[0])
    if grid > MAX_GRID:
        raise RuntimeError(f"grid {grid} > {MAX_GRID}")
    runs = []
    for _ in range(reps):
        run_clock()
        torch.cuda.synchronize()
        runs.append(phase_table(clock, grid))
    med = [[statistics.median(r[p][k] for r in runs) for k in range(4)] for p in range(len(PHASES))]
    split, calls, taken = split_by_phase(args)
    rows = [dict(phase=PHASES[p], phase_ms=m[0], busy_mean_ms=m[1], busy_max_ms=m[2],
                 wait_mean_ms=m[3], split_ms=None if split is None else split[p])
            for p, m in enumerate(med)]
    return dict(
        shape=name, B=Bc, T=Tc, L=L, C=C, heads=H, grid=grid, blocks_per_sm=int(info[1]),
        smem_bytes=int(info[2]), phases=rows,
        merged_ms=events_ms(lambda: FM.fused_layer_bwd_merged(*args), reps),
        clock_build_ms=events_ms(run_clock, reps),
        split_ms=events_ms(lambda: FB.layer_bwd_split(*args), reps),
        phase_sum_ms=sum(r["phase_ms"] for r in rows),
        wait_sum_ms=sum(r["wait_mean_ms"] for r in rows),
        split_device_ms=None if split is None else sum(split), split_calls=calls,
        split_traces=taken)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("merged_phase_clock: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    start_clock_build()
    _cuda.build_all()
    lib = clock_library()
    lines = []
    for name, Bc, Tc in SHAPES:
        res = measure(name, Bc, Tc, args.reps, lib)
        res["card"] = smi
        lines.append(json.dumps(res))
        print(lines[-1], flush=True)
        print(f"{name}: merged {res['merged_ms']:.3f} ms (clock build {res['clock_build_ms']:.3f}), "
              f"split {res['split_ms']:.3f} ms; grid {res['grid']}", flush=True)
        for r in res["phases"]:
            print(f"  {r['phase'][:4]:5s} span {r['phase_ms']:.3f}  busy {r['busy_mean_ms']:.3f}"
                  f" / {r['busy_max_ms']:.3f}  wait {r['wait_mean_ms']:.3f}  split "
                  f"{r['split_ms']}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()

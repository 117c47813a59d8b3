"""Where the time of the long-key attention kernels goes, on the card.

    python -m mdgen_finetune_tpu_torch.tools.long_attention_ablation [--reps 50]

Times ``tiled_attention`` (both softmaxes) at the 4AA preset's frame
attention (B = 8, T = 1000, L = 4, 16 heads of D = 24) and at the ATLAS
residue view (250 frames of L = 256), and ``fused_attention_bwd`` at
T = 1000 (both softmaxes), back to back (``--reps`` calls between two CUDA
events), against builds of the same sources with one part taken out, and
against other block schedules:

- ``no_walk``: no warp walks the resident rows (what is left: staging, the
  per-tile loads and the stores);
- ``no_q_stage`` (forward): no walk and no query loads;
- ``no_exp2``: every exp2 replaced by an FMA (the SFU's share);
- ``chunks_<n>``: each attention row split over n blocks (the schedule
  picks one block per row at these shapes).

An ablated build computes wrong values and is only timed; each full kernel
is first held to its plain twin (1e-2 x max(1, max |twin|)). The device
time of each of ``fused_attention_bwd``'s two passes comes from
torch.profiler. Prints the card's name and power limit, then one JSON line
per case.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import _cuda
from ..ops import fused_attention as FA
from ..ops import long_attention as LA
from ..ops import tiled_attention as TA


def _no_walk(n, np_):
    """The edit that stops every warp's walk over the window's rows."""
    tail = f"\n        const int {n} = min(win, {np_} - w * win);"
    return ("      if (active) {" + tail, "      if (active && N < 0) {" + tail)


# source edits (old, new) per ablation, per kernel source ((file, old, new)
# for an edit of another file of csrc/)
ABLATIONS = {
    "tiled_attention": {
        "no_walk": [_no_walk("nk", "NKP")],
        "no_q_stage": [_no_walk("nk", "NKP"),
                       ("if (lane < TQ * 16 && n < N) {", "if (lane < TQ * 16 && n < 0) {")],
        # the key walk's step lives in the shared header
        "no_exp2": [("long_attention.cuh",
                     "const float p0 = ex2(s[t][nb][0]), p1 = ex2(s[t][nb][1]);\n"
                     "      const float p2 = ex2(s[t][nb][2]), p3 = ex2(s[t][nb][3]);",
                     "const float p0 = fmaf(s[t][nb][0], 1e-3f, 1.f), p1 = fmaf(s[t][nb][1], 1e-3f, 1.f);\n"
                     "      const float p2 = fmaf(s[t][nb][2], 1e-3f, 1.f), p3 = fmaf(s[t][nb][3], 1e-3f, 1.f);")],
    },
    "fused_attention_bwd": {
        "no_walk_dq": [_no_walk("nk", "MKP")],
        "no_walk_dkdv": [_no_walk("nq", "NQP")],
        "no_exp2": [("ds[e] = ex2(t - lse[e >> 1]) * (dp[e] - dl[e >> 1]);",
                     "ds[e] = fmaf(t, 1e-3f, -lse[e >> 1]) * (dp[e] - dl[e >> 1]);"),
                    ("p[e] = ex2(t - (e & 1 ? ls.y : ls.x));",
                     "p[e] = fmaf(t, 1e-3f, -(e & 1 ? ls.y : ls.x));")],
    },
}


def build_ablations(out: Path) -> dict:
    """Every ablated library, built in parallel from edited copies of csrc/."""
    procs = {}
    for kern, cases in ABLATIONS.items():
        for case, edits in cases.items():
            d = out / f"{kern}-{case}"
            shutil.copytree(_cuda.CSRC, d)
            src = d / f"{kern}.cu"
            for edit in edits:
                path = d / edit[0] if len(edit) == 3 else src
                old, new = edit[-2:]
                text = path.read_text()
                if old not in text:
                    raise RuntimeError(f"ablation {kern}/{case}: {path.name} no longer holds {old!r}")
                path.write_text(text.replace(old, new))
            procs[(kern, case)] = (d / f"{kern}.so", subprocess.Popen(
                [_cuda.nvcc(), *_cuda.FLAGS, "-o", str(d / f"{kern}.so"), str(src)],
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
    libs = {}
    for key, (so, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"ablation {key} did not build")
        libs[key] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def swapped(kern: str, lib):
    """The wrapper of ``kern`` running ``lib``."""
    cur = _cuda._LIBS[kern]
    fn, ref = getattr(lib, kern), getattr(cur, kern)
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    _cuda._LIBS[kern] = lib
    try:
        yield
    finally:
        _cuda._LIBS[kern] = cur


@contextlib.contextmanager
def chunked(module, names, n):
    """``module``'s plans ``names`` with each row split over n blocks."""
    old = {name: getattr(module, name) for name in names}

    def split(plan):
        def f(*a):
            p = plan(*a)
            tiles = p.chunk * p.chunks
            return dataclasses.replace(p, chunk=-(-tiles // n), chunks=n)
        return f

    for name, plan in old.items():
        setattr(module, name, split(plan))
    try:
        yield
    finally:
        for name, plan in old.items():
            setattr(module, name, plan)


def back_to_back_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def hold(name, got, ref):
    got, ref = (got if isinstance(got, tuple) else (got,)), (ref if isinstance(ref, tuple) else (ref,))
    for a, b in zip(got, ref):
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        if not err <= 1e-2 * scale:
            raise AssertionError(f"{name}: max abs err {err} > 1e-2 x {scale}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("long_attention_ablation: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _cuda.build_all(("tiled_attention", "fused_attention", "fused_attention_bwd"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    H, D = 16, 24
    C = H * D

    def r(*s, sc=1.0):
        return (torch.randn(*s, generator=g, device=dev) * sc).to(torch.bfloat16)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_ablations(Path(tmp))
        for name, (G, N, I) in (("frames_T1000", (8, 1000, 4)), ("atlas_residue", (250, 256, 1))):
            for base2 in (True, False):
                qkv = r(G, N, I, 3 * C)
                qkv[..., :C] *= 0.5 * D ** -0.5 * (math.log2(math.e) if base2 else 1.0)
                bk, bv = r(C), r(C)
                mask = torch.ones(G, N, I, device=dev)
                mask[0, N // 2:, -1] = 0

                def run():
                    return TA.tiled_attention(qkv, bk, bv, mask, num_heads=H, base2=base2)

                hold(name, run(), TA.tiled_attention_plain(qkv.float(), bk.float(), bv.float(),
                                                           mask, num_heads=H, base2=base2))
                res = dict(kernel="tiled_attention", shape=name, base2=base2,
                           plan=dataclasses.asdict(LA.forward_plan(G * I * H, N, D)),
                           ms=back_to_back_ms(run, args.reps))
                for case in ABLATIONS["tiled_attention"]:
                    with swapped("tiled_attention", libs[("tiled_attention", case)]):
                        res[case] = back_to_back_ms(run, args.reps)
                for n in (2, 4):
                    with chunked(TA, ("forward_plan",), n):
                        res[f"chunks_{n}"] = back_to_back_ms(run, args.reps)
                print(json.dumps(res), flush=True)
        S, N, M = 32, 1000, 1001
        for base2 in (True, False):
            q = r(S, H, N, D, sc=0.5 * D ** -0.5 * (math.log2(math.e) if base2 else 1.0))
            k, v, do = r(S, H, M, D), r(S, H, M, D), r(S, H, N, D)
            kv = torch.ones(S, M, device=dev)
            kv[0, N // 2:N] = 0
            o, stat = FA.fused_attention_fwd(q, k, v, kv, base2=base2)

            def run():
                return FA.fused_attention_bwd(q, k, v, kv, o, stat, do, base2=base2)

            hold("fused_attention_bwd", run(), FA.fused_attention_bwd_plain(
                q.float(), k.float(), v.float(), kv, o.float(), stat, do.float(), base2=base2))
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    run()
                torch.cuda.synchronize()
            passes = {e.key.split("::")[-1].split("<")[0]: e.device_time_total / e.count / 1e3
                      for e in prof.key_averages() if e.device_time_total > 0}
            res = dict(kernel="fused_attention_bwd", shape=f"{S * H} rows, {N} x {M}, D = {D}",
                       base2=base2, ms=back_to_back_ms(run, args.reps), passes_ms=passes)
            for case in ABLATIONS["fused_attention_bwd"]:
                with swapped("fused_attention_bwd", libs[("fused_attention_bwd", case)]):
                    res[case] = back_to_back_ms(run, args.reps)
            for n in (2,):
                with chunked(FA, ("dq_plan", "dkdv_plan"), n):
                    res[f"chunks_{n}"] = back_to_back_ms(run, args.reps)
            print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

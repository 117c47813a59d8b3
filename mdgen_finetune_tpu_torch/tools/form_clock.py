"""The choices that the short kernels and the column sum make by size, timed on the card.

    python -m mdgen_finetune_tpu_torch.tools.form_clock [--parent CSRC] [--rounds 7]
        [--only colsum,ipa_forms,ipa_long_forms,ipa_tc_parts,special_builds,modln] [--out FILE]

Six measurements, in one process on seeded inputs. In every round each
variant of a shape runs once (the order rotated from round to round): its
device time per call (``device_ms``: calls queued behind a sleep kernel, so
that no call waits on the host, between two CUDA events); reported are the
median and the range of the rounds (the range is the noise a difference is
read against), and the median by events of single calls (``ms``: with the
host's time):

- ``colsum``: the second pass of the split backwards' sums
  (``csrc/colsum.cuh``) at each caller's (rows, columns) on the training
  paths (rows d, e, f, j and f' of PERF.md's kernel table): this checkout's
  ``colsum::launch``, its ``colsum_kernel`` and ``colsum_tall_kernel`` (where
  the header has one) each forced, and with ``--parent`` (the csrc
  directory of another checkout) that checkout's ``colsum::launch``. Each is built from a small
  source that includes the header. Every variant's sums are asserted to be
  the same bits.
- ``ipa_forms``: ``ipa_attention`` at L = 4, 4 heads, the model's widths,
  over B elements from 100 to 6,400: the resident form and the streaming
  form (each forced), their features asserted equal: where the streaming
  form takes over.
- ``ipa_long_forms``: ``ipa_attention`` at L = 17, 32, 48, 64 and 65, 4
  heads, the model's widths, over 100 elements (the t grid) and 1: the
  resident form and the tensor-core form (each forced, each held to the
  plain version within 1e-2 of its scale: the tensor-core form's products
  change the bits): where the tensor-core form takes over
  (``TC_MIN_L``).
- ``ipa_tc_parts``: the tensor-core form at (100, 256), (1, 256) and
  (100, 300), the model's widths, translations across +-40 A: this build; a
  ``-DMDGEN_TC_STAGING_ONLY`` build (the key ring, the lift and the splits,
  no products: what the staging costs); a ``-DMDGEN_TC_WARPS16`` build
  with an (element, head)'s queries in one block of up to 16 warps (its
  keys staged and lifted once, not once per block of 8); and at B = 1
  blocks of one warp (the plan patched): what sharing the staging across a
  block's warps saves.
- ``special_builds``: the L = H = 4 instance of ``ipa_attention``'s
  streaming kernel and the N = 4 instance of ``rope_attention_bwd``'s short
  body against the generic instance (a ``-DMDGEN_GENERIC_SHORT`` build of each source), at the
  paths' shapes, bits asserted equal.
- ``modln``: ``modln_bwd`` (row e) at the three training shapes (12,800,
  32,000 and 64,000 rows of 384 over 32, 8 and 1 elements): this build
  (the staged kernel, then ``colsum::launch``) and, with ``--parent``, that
  checkout's ``modln_bwd`` through this wrapper, its dx and dmod checked
  against this build's bits (``bits_equal``; a difference fails the run
  after the line is printed). Also the device time and the launches per
  call of each kernel of both (``kernel_ms``, ``launches``: torch.profiler,
  the main kernel and the split sum apart), the host's time per call of
  this wrapper and of the parent's through it (``host_ms``), the bound and
  this build's resources.

Prints the card's name and power limit, then one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..ops import _cuda

GENERIC = "MDGEN_GENERIC_SHORT"
TC_STAGING = "MDGEN_TC_STAGING_ONLY"  # ipa_attention's tensor-core form without its products
TC_WARPS16 = "MDGEN_TC_WARPS16"  # ... with blocks of up to 16 warps
C, H, L = 384, 16, 4
# row e's shapes on the training paths: (name, rows, elements) at C = 384
MODLN_SHAPES = (("flagship (train_path)", 32 * 100 * L, 32),
                ("T = 1000 (train_1000)", 8 * 1000 * L, 8),
                ("ATLAS (train_atlas)", 250 * 256, 1))
COLSUM_SRC = r"""
#include "colsum.cuh"
extern "C" int cs_launch(const float* in, float* out, long long R, long long W, void* s) {
  return colsum::launch(in, out, R, W, W, 0, (cudaStream_t)s);
}
extern "C" int cs_cols(const float* in, float* out, long long R, long long W, void* s) {
  colsum::colsum_kernel<<<(unsigned)((W + colsum::COLS - 1) / colsum::COLS),
                          colsum::COLS * colsum::LANES, 0, (cudaStream_t)s>>>(in, out, R, W, W, 0);
  return (int)cudaGetLastError();
}
#ifdef CS_TALL
extern "C" int cs_tall(const float* in, float* out, long long R, long long W, void* s) {
  cudaError_t e = cudaFuncSetAttribute(colsum::colsum_tall_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)colsum::TALL_SMEM);
  if (e != cudaSuccess) return (int)e;
  colsum::colsum_tall_kernel<<<(unsigned)((W + colsum::TALL_NC - 1) / colsum::TALL_NC),
                               colsum::TALL_WARPS * 32, colsum::TALL_SMEM, (cudaStream_t)s>>>(
      in, out, R, W, W, 0);
  return (int)cudaGetLastError();
}
#endif
"""


def events_ms(fn, reps=20):
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


def device_ms(fn, n):
    """The device's time per call of ``n`` calls of ``fn`` queued behind a
    sleep kernel (longer than the host takes to queue them), between two
    CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(n * 400_000)  # ~0.2 ms of the card's clock a call
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def rounds(variants: dict, n_rounds: int, calls: int, ctx=None) -> dict:
    """{variant: {device_ms (median of the rounds), min, max, ms}}: every
    round times each variant once (``device_ms``), in a rotated order, each
    inside its context ``ctx[variant]()`` where given."""
    names = list(variants)
    ctx = ctx or {}

    def within(n):
        return ctx[n]() if n in ctx else contextlib.nullcontext()

    got = {n: [] for n in names}
    for n in names:
        with within(n):
            variants[n]()
    torch.cuda.synchronize()
    for r in range(n_rounds):
        for n in names[r % len(names):] + names[:r % len(names)]:
            with within(n):
                got[n].append(device_ms(variants[n], calls))
    out = {}
    for n, v in got.items():
        with within(n):
            out[n] = dict(device_ms=statistics.median(v), min=min(v), max=max(v),
                          ms=events_ms(variants[n]))
    return out


@contextlib.contextmanager
def swapped(name: str, lib):
    """The wrappers of kernel ``name`` running library ``lib``."""
    cur = _cuda._LIBS[name]
    fn, ref = getattr(lib, name), getattr(cur, name)
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    _cuda._LIBS[name] = lib
    try:
        yield
    finally:
        _cuda._LIBS[name] = cur


def build_colsum(csrc: Path, tag: str) -> tuple:
    """The small library over ``csrc/colsum.cuh`` and the entry points it has."""
    text = (csrc / "colsum.cuh").read_text()
    defs = ["CS_TALL"] if "colsum_tall_kernel" in text else []
    out = _cuda.BUILD / "form_clock"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / f"colsum_{tag}.cu", out / f"colsum_{tag}.so"
    src.write_text(COLSUM_SRC)
    subprocess.run([_cuda.nvcc(), *_cuda.FLAGS, f"-I{csrc}", *(f"-D{d}" for d in defs),
                    "-o", str(so), str(src)], check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    names = ["cs_launch", "cs_cols"] + (["cs_tall"] if defs else [])
    for n in names:
        getattr(lib, n).argtypes = [_cuda.P, _cuda.P, _cuda.I64, _cuda.I64, _cuda.P]
        getattr(lib, n).restype = ctypes.c_int
    return lib, names


def colsum_shapes() -> list:
    """(use, rows, columns) of every colsum::launch on the training paths
    (B = 32, T = 100: 12,800 rows; ATLAS; T = 1000; the residue stage at
    B = 4, T = 200)."""
    from ..ops import linear_bwd as LB
    from ..ops import modln_bwd as MB

    M = 32 * 100 * L
    out = []
    for name, K, N in (("fc1", C, 4 * C), ("fc2", 4 * C, C), ("qkv", C, 3 * C), ("out", C, C)):
        s = LB._splits(M, K, N)
        out.append((f"d {name} wgrad dW", s, K * N))
    out.append(("d fc1 wgrad db", LB._splits(M, C, 4 * C), 4 * C))
    out.append(("e modln_bwd (12800, 384), 32 elements", MB._splits(M // 32, 32), 32 * 3 * C))
    out.append(("f long body, stage 2: 128 sequences", 128, 2 * C))
    out.append(("j blocked_attention_bwd, ATLAS: 250 sequences", 250, 2 * C))
    for G in (800, 3200, 8000):
        out.append((f"f' short body: {G} sequences", G, 2 * C))
    return out


def measure_colsum(parent, n_rounds) -> list:
    mine, names = build_colsum(_cuda.CSRC, "this")
    libs = [(f"this {n[3:]}", mine, n) for n in names]
    if parent:
        plib, _ = build_colsum(Path(parent), "parent")
        libs.append(("parent launch", plib, "cs_launch"))
    g = torch.Generator(device="cuda").manual_seed(7)
    stream = torch.cuda.current_stream().cuda_stream
    res = []
    for use, R, W in colsum_shapes():
        x = torch.randn(R, W, generator=g, device="cuda")
        outs = {k: torch.empty(W, device="cuda") for k, _, _ in libs}

        def call(k, lib, n):
            def run():
                code = getattr(lib, n)(x.data_ptr(), outs[k].data_ptr(), R, W, stream)
                if code:
                    raise RuntimeError(f"colsum {k} failed to launch: cudaError {code}")
            return run

        variants = {k: call(k, lib, n) for k, lib, n in libs}
        times = rounds(variants, n_rounds, 200)
        ref = outs["this launch"]
        differ = [k for k in outs if not torch.equal(outs[k], ref)]
        if differ:
            raise AssertionError(f"colsum[{use}]: {differ} differ from this launch's sums")
        res.append(dict(use=use, rows=R, columns=W, bound_ms=(R + 1) * W * 4 / 3.35e9,
                        times=times))
        del x, outs
    return res


def ipa_inputs(Bn, seed=3, length=L):
    from ..geometry.rigid import Rigid
    from ..ops import ipa_attention as IA

    g = torch.Generator(device="cuda").manual_seed(seed)
    proj = torch.randn(Bn, length, IA.proj_width(4, 32, 8, 8), generator=g, device="cuda")
    t7 = torch.randn(Bn, length, 7, generator=g, device="cuda")
    t7[..., 4:] *= 5
    fr = Rigid.from_tensor_7(t7)
    mask = torch.ones(Bn, length, device="cuda")
    mask[::7, -1] = 0
    hw = torch.randn(4, generator=g, device="cuda")
    return (proj, fr.rot.contiguous(), fr.trans.contiguous(), mask, hw), dict(H=4, Ch=32, Pq=8, Pv=8)


@contextlib.contextmanager
def ipa_form(form):
    """ipa_attention with every call in ``form`` (an index of its FORMS)."""
    from ..ops import ipa_attention as IA

    kept = IA._form
    IA._form = lambda *shape: form
    try:
        yield
    finally:
        IA._form = kept


def measure_ipa_forms(n_rounds) -> list:
    from ..ops import ipa_attention as IA

    res = []
    for Bn in (100, 132, 200, 264, 396, 528, 800, 1600, 6400):
        args, kw = ipa_inputs(Bn)
        feats = {}
        forms = {"resident": lambda: ipa_form(1), "streaming": lambda: ipa_form(0)}
        for form, slot in (("resident", 1), ("streaming", 0)):
            with forms[form]():
                n0 = IA.ipa_attention.forms[slot]
                feats[form] = IA.ipa_attention(*args, **kw)
                if IA.ipa_attention.forms[slot] != n0 + 1:
                    raise AssertionError(f"ipa_forms[{Bn}]: the {form} form did not run")
        if not torch.equal(feats["resident"], feats["streaming"]):
            raise AssertionError(f"ipa_forms[{Bn}]: the forms' features differ")
        run = lambda: IA.ipa_attention(*args, **kw)  # noqa: E731
        times = rounds({"resident": run, "streaming": run}, n_rounds, 50, ctx=forms)
        res.append(dict(elements=Bn, L=L, heads=4, plan=IA.ipa_plan(Bn, L, 4, 32, 8, 8).__dict__,
                        times=times))
    return res


def measure_ipa_long_forms(n_rounds) -> list:
    from ..ops import ipa_attention as IA

    res = []
    for Bn in (100, 1):
        for Lc in (17, 32, 48, 64, 65):
            args, kw = ipa_inputs(Bn, seed=Lc, length=Lc)
            ref = IA.ipa_attention_plain(*args, **kw)
            scale = max(1.0, ref.abs().max().item())
            forms = {"resident": lambda: ipa_form(1), "tensor-core": lambda: ipa_form(3)}
            errs = {}
            for form, slot in (("resident", 1), ("tensor-core", 3)):
                with forms[form]():
                    n0 = IA.ipa_attention.forms[slot]
                    got = IA.ipa_attention(*args, **kw)
                    if IA.ipa_attention.forms[slot] != n0 + 1:
                        raise AssertionError(f"ipa_long_forms[{Bn}, {Lc}]: the {form} form did not run")
                errs[form] = (got.float() - ref).abs().max().item()
                if not errs[form] <= 1e-2 * scale:
                    raise AssertionError(f"ipa_long_forms[{Bn}, {Lc}]: the {form} form's error "
                                         f"{errs[form]} > 1e-2 x {scale}")
            run = lambda: IA.ipa_attention(*args, **kw)  # noqa: E731
            times = rounds({"resident": run, "tensor-core": run}, n_rounds, 50, ctx=forms)
            res.append(dict(elements=Bn, L=Lc, heads=4, max_abs_err=errs, scale=scale,
                            plan=IA.tc_plan(Bn, Lc, 4, 32, 8, 8).__dict__, times=times))
    return res


@contextlib.contextmanager
def tc_warps(warps):
    """ipa_attention's tensor-core form in blocks of ``warps`` warps."""
    from ..ops import ipa_attention as IA

    kept = IA.tc_plan

    def plan(B, L_, H_, Ch, Pq, Pv):
        tiles = -(-L_ // 16)
        qgroups = -(-tiles // warps)
        return IA.TcPlan(warps, qgroups, B * H_ * qgroups, IA.tc_bytes(Ch, Pq, Pv))

    IA.tc_plan = plan
    try:
        yield
    finally:
        IA.tc_plan = kept


def measure_ipa_tc_parts(n_rounds) -> list:
    from ..geometry.rigid import Rigid
    from ..ops import ipa_attention as IA

    staging = _cuda.variant_library("ipa_attention", TC_STAGING)
    whole = _cuda.variant_library("ipa_attention", TC_WARPS16)

    @contextlib.contextmanager
    def one_block():
        with swapped("ipa_attention", whole), tc_warps(16):
            yield

    res = []
    for Bn, Lc in ((100, 256), (1, 256), (100, 300)):
        g = torch.Generator(device="cuda").manual_seed(Bn + Lc)
        proj = torch.randn(Bn, Lc, IA.proj_width(4, 32, 8, 8), generator=g, device="cuda")
        fr = Rigid.from_tensor_7(torch.randn(Bn, Lc, 7, generator=g, device="cuda"))
        trans = (torch.rand(Bn, Lc, 3, generator=g, device="cuda") * 2 - 1) * 40
        mask = torch.ones(Bn, Lc, device="cuda")
        mask[:, Lc - 56:] = 0
        hw = torch.randn(4, generator=g, device="cuda")
        args, kw = (proj, fr.rot.contiguous(), trans, mask, hw), dict(H=4, Ch=32, Pq=8, Pv=8)
        ref = IA.ipa_attention_plain(*args, **kw)
        run = lambda: IA.ipa_attention(*args, **kw)  # noqa: E731
        variants = {"this build": run, "staging only": run, "one block per (element, head)": run}
        ctx = {"staging only": lambda: swapped("ipa_attention", staging),
               "one block per (element, head)": one_block}
        if Bn == 1:
            variants["one warp a block"] = run
            ctx["one warp a block"] = lambda: tc_warps(1)
        errs = {}
        for n in variants:
            if n == "staging only":
                continue
            with ctx[n]() if n in ctx else contextlib.nullcontext():
                errs[n] = (run().float() - ref).abs().max().item()
        times = rounds(variants, n_rounds, 50, ctx=ctx)
        res.append(dict(elements=Bn, L=Lc, heads=4, plan=IA.tc_plan(Bn, Lc, 4, 32, 8, 8).__dict__,
                        max_abs_err=errs, tol=1e-2 * max(1.0, ref.abs().max().item()), times=times))
    return res


def measure_special(n_rounds) -> list:
    from ..ops import ipa_attention as IA
    from ..ops import rope_attention_bwd as RB

    res = []
    # ipa_attention at the encoder's (6400, 4): the L = H = 4 instance
    args, kw = ipa_inputs(6400)
    IA.ipa_attention(*args, **kw)
    generic = _cuda.variant_library("ipa_attention", GENERIC)

    def tensors(x):
        return [x] if torch.is_tensor(x) else list(x)

    def pair(name, lib, run, calls=50):
        out = {}
        special = tensors(run())
        with swapped(name, lib):
            gen = tensors(run())
        if len(special) != len(gen) or not all(torch.equal(a, b) for a, b in zip(special, gen)):
            raise AssertionError(f"special_builds[{name}]: the generic instance's bits differ")

        out.update(rounds({"special": run, "generic": run}, n_rounds, calls,
                          ctx={"generic": lambda: swapped(name, lib)}))
        return out

    res.append(dict(kernel="ipa_attention", shape="(6400, 4), 4 heads",
                    times=pair("ipa_attention", generic, lambda: IA.ipa_attention(*args, **kw))))
    # rope_attention_bwd's short body at its three uses: the N = 4 instance
    generic = _cuda.variant_library("rope_attention_bwd", GENERIC)
    g = torch.Generator(device="cuda").manual_seed(5)
    for Gb in (800, 3200, 8000):
        qkv = (torch.randn(Gb, L, 1, 3 * C, generator=g, device="cuda") * 0.5).bfloat16()
        do = (torch.randn(Gb, L, 1, C, generator=g, device="cuda") * 0.1).bfloat16()
        bk = (torch.randn(C, generator=g, device="cuda") * 0.4).bfloat16()
        bv = (torch.randn(C, generator=g, device="cuda") * 0.4).bfloat16()
        mask = torch.ones(Gb, L, 1, device="cuda")
        mask[:Gb // 32, -1] = 0
        res.append(dict(kernel="rope_attention_bwd", shape=f"({Gb}, 4, 1), 16 heads of D = 24",
                        times=pair("rope_attention_bwd", generic, lambda: RB.rope_attention_bwd(
                            qkv, do, bk, bv, mask, num_heads=H))))
    return res


def host_ms(fn, n=100):
    """The host's time per call of ``fn`` while the card sleeps through a
    kernel queued first (no call waits on the card)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return dt


class TraceGap(RuntimeError):
    """No profiler trace held whole launches a call (the card's profiler can
    drop a trace's device events); ``seen`` holds each trace's counts."""

    def __init__(self, seen):
        super().__init__(f"{len(seen)} profiler traces, none holds whole launches a call; "
                         f"launches seen by kernel: {seen}")
        self.seen = seen


def _kernel_key(name: str) -> str:
    return next((m for m in ("modln_bwd", "colsum") if m in name), name[:48])


def kernel_ms(run, calls=20, traces=5) -> tuple:
    """Device ms and launches per call of ``run()`` by kernel (``modln_bwd``,
    ``colsum``, or the name): a torch.profiler trace of ``calls`` calls,
    after a step that warms the profiler up. A trace that holds no device
    event, or a count of some kernel's launches that is not a whole number
    a call, is taken again; after ``traces`` such traces it raises
    ``TraceGap``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = []
    for _ in range(traces):
        got = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.append(p.events())) as prof:
            for _ in range(2):
                for _ in range(calls):
                    run()
                torch.cuda.synchronize()
                prof.step()
        ms, n = {}, {}
        for e in got[0] if got else ():
            if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
                k = _kernel_key(e.name)
                ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
                n[k] = n.get(k, 0) + 1
        if n and all(v % calls == 0 for v in n.values()):
            return ms, {k: v // calls for k, v in n.items()}
        seen.append(n)
    raise TraceGap(seen)


def _cu(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"{what}: CUresult {code}")


def kernel_nodes(run) -> dict:
    """Launches of one ``run()`` by kernel (named as in ``kernel_ms``),
    counted without the profiler: the call is captured into a CUDA graph,
    which is never replayed, and the graph's nodes are read through the
    driver API. A node that is not a kernel counts under its type."""
    cu = ctypes.CDLL("libcuda.so.1")
    P, byref = ctypes.c_void_p, ctypes.byref
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        run()
    g = P(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(g, None, byref(n)), "cuGraphGetNodes")
    nodes = (P * n.value)()
    _cu(cu.cuGraphGetNodes(g, nodes, byref(n)), "cuGraphGetNodes")
    out = {}
    for node in nodes:
        kind = ctypes.c_int()
        _cu(cu.cuGraphNodeGetType(P(node), byref(kind)), "cuGraphNodeGetType")
        key = f"node type {kind.value}"
        if kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            # CUDA_KERNEL_NODE_PARAMS_v2: func first, kern at byte 64
            params = (P * 16)()
            _cu(cu.cuGraphKernelNodeGetParams_v2(P(node), params), "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            if params[0]:
                _cu(cu.cuFuncGetName(byref(name), P(params[0])), "cuFuncGetName")
            else:
                _cu(cu.cuKernelGetName(byref(name), P(params[8])), "cuKernelGetName")
            key = _kernel_key(name.value.decode())
        out[key] = out.get(key, 0) + 1
    del graph
    return out


def modln_inputs(M, nb, seed=9):
    """Seeded inputs of ``modln_bwd`` at (M, C) over nb elements: x in bf16,
    dh, dout, y in f32, the scale rows in bf16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, C, generator=g, device="cuda").bfloat16()
    dh, dout, y = (torch.randn(M, C, generator=g, device="cuda") for _ in range(3))
    scale = (0.3 * torch.randn(nb, C, generator=g, device="cuda")).bfloat16()
    return x, dh, dout, y, scale


def modln_bound_ms(M, nb):
    """Bytes over 3.35 TB/s: x (bf16), dh, dout, y read and dx written (f32),
    the scale rows read and dmod written."""
    return (M * C * (2 + 3 * 4 + 4) + nb * C * 2 + nb * 3 * C * 4) / 3.35e9


def parent_modln(parent):
    """``modln_bwd`` built from another checkout's csrc directory."""
    out = _cuda.BUILD / "form_clock"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "modln_bwd_parent.so"
    subprocess.run([_cuda.nvcc(), *_cuda.FLAGS, "-o", str(so), str(Path(parent) / "modln_bwd.cu")],
                   check=True, stdout=subprocess.DEVNULL)
    return ctypes.CDLL(str(so))


def measure_modln(parent, n_rounds) -> list:
    from ..ops import modln_bwd as MB

    builds = {}
    plib = parent_modln(parent) if parent else None
    if plib is not None:
        builds["parent"] = plib
    res = []
    for name, M, nb in MODLN_SHAPES:
        args = modln_inputs(M, nb)

        def run():
            return MB.modln_bwd(*args)

        splits, per = MB.plan(M, nb)
        ctx = {k: (lambda lib=lib: swapped("modln_bwd", lib)) for k, lib in builds.items()}
        ref = run()
        bits = {}
        for k, c in ctx.items():
            with c():
                got = run()
            torch.cuda.synchronize()
            bits[k] = all(torch.equal(a, b) for a, b in zip(got, ref))
        times = rounds({"this": run, **{k: run for k in ctx}}, n_rounds, 50, ctx=ctx)
        by_kernel, launches = {}, {}
        for k in ("this", *ctx):
            with ctx[k]() if k in ctx else contextlib.nullcontext():
                by_kernel[k], launches[k] = kernel_ms(run)
        host = {"this": host_ms(run)}
        if plib is not None:
            with ctx["parent"]():
                host["parent"] = host_ms(run)
        res.append(dict(shape=name, rows=M, elements=nb, C=C, splits=splits,
                        rows_per_split=per, blocks=nb * splits,
                        bound_ms=modln_bound_ms(M, nb), bits_equal=bits, times=times,
                        kernel_ms=by_kernel, launches=launches, host_ms=host,
                        resources=MB.resources(C)))
        del args, ref
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="the csrc directory of another checkout")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--only",
                    default="colsum,ipa_forms,ipa_long_forms,ipa_tc_parts,special_builds,modln",
                    help="the measurements to make, comma-separated")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("form_clock: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    only = args.only.split(",")
    if "special_builds" in only:
        for n in ("ipa_attention", "rope_attention_bwd"):
            _cuda.start_variant(n, GENERIC)
    if "ipa_tc_parts" in only:
        for macro in (TC_STAGING, TC_WARPS16):
            _cuda.start_variant("ipa_attention", macro)
    _cuda.build_all()
    lines = []
    for name, fn in (("colsum", lambda: measure_colsum(args.parent, args.rounds)),
                     ("ipa_forms", lambda: measure_ipa_forms(args.rounds)),
                     ("ipa_long_forms", lambda: measure_ipa_long_forms(args.rounds)),
                     ("ipa_tc_parts", lambda: measure_ipa_tc_parts(args.rounds)),
                     ("special_builds", lambda: measure_special(args.rounds)),
                     ("modln", lambda: measure_modln(args.parent, args.rounds))):
        if name not in only:
            continue
        lines.append(json.dumps(dict(measurement=name, card=smi, rows=fn())))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    differ = [(r["shape"], k) for ln in lines for r in json.loads(ln)["rows"]
              for k, same in r.get("bits_equal", {}).items() if not same]
    if differ:
        sys.exit(f"form_clock: modln_bwd's bits differ from this build's: {differ}")


if __name__ == "__main__":
    main()

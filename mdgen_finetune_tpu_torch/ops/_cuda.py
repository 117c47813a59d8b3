"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is a shared library with a plain C interface,
compiled with ``nvcc`` for ``sm_90a`` at first use into ``_build/`` (listed
in .gitignore) and loaded with ctypes. The library file name carries a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt. ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch; ``check``
raises on a non-zero code. ``variant_library`` loads a second build of a
source with one macro defined (a measuring build: the merged layer
backward's phase clock, the short attention body without its contiguous
path).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
KERNELS = ("adaln_linear", "rope_attention", "ipa_attention", "linear_bwd", "modln_bwd",
           "rope_attention_bwd", "tiled_attention", "fused_attention", "fused_attention_bwd",
           "blocked_attention_bwd", "fused_layer_bwd", "micro_ops")
SMS = 132  # an H100 SXM's SMs: the plans that size a grid in Python (the same on the CPU)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_VARIANTS: dict = {}  # (name, macro): (library path, temporary path, log, nvcc process)


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{tag}.so"


def build_all(names=KERNELS) -> float:
    """Compile every missing library, one nvcc per source, all at once.
    Returns the seconds spent; the compiler's report goes to _build/<name>.log."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for n in todo:
        tmp = _target(n).with_suffix(f".tmp{os.getpid()}")
        log = open(BUILD / f"{n}.log", "w")
        p = subprocess.Popen([exe, *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                             stdout=log, stderr=subprocess.STDOUT)
        procs.append((n, tmp, p, log))
    failed = []
    for n, tmp, p, log in procs:
        p.wait()
        log.close()
        if p.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, _target(n))
    if failed:
        msgs = "\n".join(f"--- {n}\n" + (BUILD / f"{n}.log").read_text()[-4000:] for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return time.perf_counter() - t0


def library(name: str, argtypes) -> ctypes.CDLL:
    """The loaded library of kernel ``name``; its entry point gets
    ``argtypes`` and an int return."""
    if name not in _LIBS:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def built(name: str) -> ctypes.CDLL:
    """The library built from this checkout's ``csrc/<name>.cu``, whatever
    library a caller has put in its place in ``library``'s cache (a
    measurement that runs an earlier build through the same wrapper): the
    wrappers query their kernels' resources here."""
    build_all((name,))
    return ctypes.CDLL(str(_target(name)))


def _variant_target(name: str, macro: str) -> Path:
    return _target(name).with_name(_target(name).name.replace(f"lib{name}-",
                                                              f"lib{name}_{macro.lower()}-"))


def start_variant(name: str, macro: str) -> None:
    """Start building ``csrc/<name>.cu`` with ``-D<macro>`` (one nvcc in the
    background; a no-op when that library exists or is being built)."""
    so = _variant_target(name, macro)
    if (name, macro) in _VARIANTS or so.exists():
        return
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    log = open(BUILD / f"{name}_{macro.lower()}.log", "w")
    _VARIANTS[name, macro] = (so, tmp, log, subprocess.Popen(
        [nvcc(), *FLAGS, f"-D{macro}", "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT))


def variant_library(name: str, macro: str) -> ctypes.CDLL:
    """The build of ``csrc/<name>.cu`` with ``-D<macro>`` (built once per
    source; its entry points get their argument types from the caller)."""
    so = _variant_target(name, macro)
    if not so.exists():
        start_variant(name, macro)
        _, tmp, log, proc = _VARIANTS[name, macro]
        proc.wait()
        log.close()
        if proc.returncode != 0:
            raise RuntimeError(f"the -D{macro} build of {name}.cu failed:\n"
                               + (BUILD / f"{name}_{macro.lower()}.log").read_text()[-4000:])
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s card, as the pointer the entry
    points take (read without making a Stream object: a few microseconds
    less of every launch's host time)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary (the kernels read rows with 16-byte loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float

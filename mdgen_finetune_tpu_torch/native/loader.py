"""ctypes bindings and on-demand build of the C++ batch loader.

Counterpart of the JAX package's ``native/loader.py``: ``loader.cpp`` (the
port's own copy of the JAX package's source) is compiled once per checkout
(``g++ -O3 -std=c++17 -shared -fPIC -pthread``) into
``mdgen_finetune_tpu_torch/_build/_loader.so``, which ``.gitignore`` lists.
``NativeLoader`` yields the arrays of the port's ``make_batch_iterator``
batches, {atom14 (B, T, crop, 14, 3) f32, seqres (B, crop) int32, mask
(B, crop) f32}, from C++ worker threads over memory-mapped ``.npy`` files
(without the entry ``name``, which the C++ side does not report). Where
g++ is missing it raises ``ImportError``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cpp")
_SO = os.path.join(os.path.dirname(_DIR), "_build", "_loader.so")


def build_native_library(force: bool = False) -> str:
    """The loader's shared library, built from ``loader.cpp`` when it is
    missing or older than the source. Returns its path."""
    if os.path.exists(_SO) and not force and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    if shutil.which("g++") is None:
        raise ImportError("the native loader needs g++ to build loader.cpp")
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)  # atomic: a concurrent build never sees a partial file
    return _SO


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native_library())
        lib.ld_create.restype = ctypes.c_void_p
        lib.ld_create.argtypes = [ctypes.c_int64] * 4 + [ctypes.c_uint64, ctypes.c_int64,
                                                         ctypes.c_int64]
        lib.ld_add_traj.restype = ctypes.c_int
        lib.ld_add_traj.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.ld_start.restype = ctypes.c_int
        lib.ld_start.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ld_next.restype = ctypes.c_int
        lib.ld_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
        lib.ld_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeLoader:
    """Iterator of {atom14, seqres, mask} batches from the C++ loader.

    ``files``: (npy path, aatype int32 (L,)) per trajectory; windows of
    ``num_frames`` frames every ``frame_interval`` frames, residues cropped
    or padded to ``crop``; ``n_threads`` workers fill a ring of
    ``max_queue`` batches (with one worker the batches are a function of
    ``seed``)."""

    def __init__(self, files: list, batch_size: int, num_frames: int, crop: int,
                 frame_interval: Optional[int] = None, seed: int = 0, n_threads: int = 2,
                 max_queue: int = 4):
        lib = _load()
        self._lib = lib
        self._handle = lib.ld_create(batch_size, num_frames, crop, frame_interval or 1, seed,
                                     n_threads, max_queue)
        n_added = 0
        for path, aatype in files:
            aat = np.ascontiguousarray(np.asarray(aatype, dtype=np.int32))
            rc = lib.ld_add_traj(self._handle, os.fsencode(path),
                                 aat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(aat))
            n_added += rc == 0
        if not n_added:
            self.close()
            raise FileNotFoundError("native loader: no usable trajectories")
        if lib.ld_start(self._handle, n_threads) != 0:
            self.close()
            raise RuntimeError("native loader failed to start")
        self.B, self.T, self.C = batch_size, num_frames, crop

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        atom14 = np.empty((self.B, self.T, self.C, 14, 3), np.float32)
        seqres = np.empty((self.B, self.C), np.int32)
        mask = np.empty((self.B, self.C), np.float32)
        rc = self._lib.ld_next(self._handle,
                               atom14.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               seqres.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                               mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise StopIteration
        return {"atom14": atom14, "seqres": seqres, "mask": mask}

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.ld_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

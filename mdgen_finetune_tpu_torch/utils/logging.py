"""Run logging and profiling helpers: the JAX package's ``utils/logging.py``.

``get_logger`` is the reference's logger (src/mdgen/logger.py:20-33: a
stream handler, and a file handler into ``$MODEL_DIR/log.out``, with host
and pid); ``MetricLogger`` its accumulate -> mean -> emit metric log
(src/mdgen/wrapper.py:52-62, 132-165), always to ``metrics.jsonl`` and to
wandb when asked and configured; ``timer`` its wall-clock counters
(wrapper.py:370-401); ``profile_trace`` a ``torch.profiler`` trace of a
region (the JAX package's uses ``jax.profiler``).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import time
from collections import defaultdict
from typing import Optional

import numpy as np


def get_logger(name: str, model_dir: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        f"%(asctime)s [{socket.gethostname()}:{os.getpid()}] [%(levelname)s] %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    model_dir = model_dir or os.environ.get("MODEL_DIR")
    if model_dir:
        os.makedirs(model_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(model_dir, "log.out"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricLogger:
    """``add(key, value)`` accumulates; ``flush(step)`` emits each key's
    nan-mean with ``step`` (and ``extra``) as one JSON line into
    ``out_dir/metrics.jsonl`` and to wandb, then clears. wandb is imported
    only with ``use_wandb`` and a ``WANDB_API_KEY`` set, and skipped when
    it is not installed."""

    def __init__(self, out_dir: Optional[str] = None, use_wandb: bool = False,
                 run_name: str = "run"):
        self._log = defaultdict(list)
        self.out_dir = out_dir
        self.jsonl = os.path.join(out_dir, "metrics.jsonl") if out_dir else None
        self.wandb = None
        if use_wandb and os.environ.get("WANDB_API_KEY"):
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.init(project="mdgen_finetune_tpu", name=run_name)
                self.wandb = wandb

    def add(self, key: str, value):
        self._log[key].append(float(value))

    def flush(self, step: int, extra: Optional[dict] = None) -> dict:
        out = {k: float(np.nanmean(v)) for k, v in self._log.items()}
        out["step"] = step
        if extra:
            out.update(extra)
        self._log.clear()
        if self.jsonl:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(self.jsonl, "a") as f:
                f.write(json.dumps(out) + "\n")
        if self.wandb:
            self.wandb.log(out)
        return out


@contextlib.contextmanager
def timer(store: dict, key: str):
    """Adds the region's wall-clock seconds to ``store[key]``."""
    t0 = time.time()
    try:
        yield
    finally:
        store[key] = store.get(key, 0.0) + time.time() - t0


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the region (the CPU's, and the card's
    when there is one) into ``log_dir/trace.json`` when ``log_dir`` is
    set."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""Run a function on n ranks of a fresh ``torch.distributed`` world.

``run(fn, n, *args)`` starts n processes with the ``spawn`` method (a
parent that has initialised CUDA cannot ``fork``), gives each the
torchrun environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` on a free localhost
port), initialises the default group with ``backend`` unless ``init`` is
false (a CLI that initialises it itself), calls ``fn(*args)`` and returns
the ranks' results in rank order. ``fn`` must be importable by its module
path, from a module that imports neither JAX nor a test module. A rank that
raises fails the run, and the others are stopped.
"""
from __future__ import annotations

import os
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, n, port, backend, init, out, args):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))  # n ranks share the host's cores
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if init:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=n,
                                rank=rank)
    try:
        result = fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def run(fn, n: int, *args, backend: str = "gloo", init: bool = True) -> list:
    with tempfile.TemporaryDirectory() as out:
        mp.start_processes(_entry, args=(fn, n, free_port(), backend, init, out, args),
                           nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def init_from_env(device: str = "cuda") -> torch.device:
    """This rank's device, with the default group initialised from the
    torchrun environment when ``WORLD_SIZE`` > 1 (one process: ``device``
    as given). A rank's card is ``cuda:(LOCAL_RANK % device_count)``. The
    backend is fixed before the group starts: ``nccl`` when every rank on
    the host has a card of its own (``LOCAL_WORLD_SIZE`` <= the cards),
    ``gloo`` on the CPU and when ranks share a card (NCCL refuses two
    ranks on one device); neither stands in for the other on an error."""
    dev = torch.device(device)
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1 or dist.is_initialized():
        return dev
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % cards)
        torch.cuda.set_device(dev)
        if int(os.environ.get("LOCAL_WORLD_SIZE", str(n))) <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method="env://")
    return dev

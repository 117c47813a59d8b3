"""The port's collectives: four ``torch.distributed`` ops, counted by kind.

Every collective of ``parallel/`` goes through these functions, so that a
run can say how often each kind ran: the counts stand where the JAX
package's ``dryrun_multichip`` counts ``all-reduce`` / ``all-to-all`` in the
compiled step's HLO (``__graft_entry__.py:115-121``). ``COUNTS`` holds the
calls by kind and ``BYTES`` the bytes each call sent from this rank; reset
them with ``reset()``.

Only the four ops that both backends take on CUDA tensors are used:
``all_reduce``, ``all_gather``, ``broadcast`` and ``all_to_all_single``
(gloo has no ``reduce_scatter``). Each runs on the tensor's own device, so
under gloo a CUDA tensor is staged through the host by gloo itself.
The callers skip one-rank groups; a group given here always communicates.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "broadcast", "all_to_all")
COUNTS = dict.fromkeys(KINDS, 0)
BYTES = dict.fromkeys(KINDS, 0)


def reset() -> None:
    for k in KINDS:
        COUNTS[k] = 0
        BYTES[k] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    COUNTS[kind] += 1
    BYTES[kind] += t.numel() * t.element_size()


def flat(tensors: list, op) -> list:
    """``op`` on one f32 buffer holding every tensor (one collective for
    many); the results in the tensors' shapes and dtypes."""
    buf = op(torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]))
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group``, in place; returns ``t``."""
    _count("all_reduce", t)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    t = t.contiguous()
    _count("all_gather", t)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` overwritten in place with global rank ``src``'s; returns ``t``."""
    _count("broadcast", t)
    dist.broadcast(t, src=src, group=group)
    return t


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (n, ...) with n the group's size: chunk k goes to group rank k,
    and chunk k of the result came from group rank k."""
    t = t.contiguous()
    _count("all_to_all", t)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out

"""The mesh registry, the sharding rules and the collectives of a sharded
region, with their backwards written by hand.

Counterpart of the JAX package's ``parallel/kernel_sharding.py``. There,
``shard_map`` runs each Pallas kernel on its device's local shard and XLA
inserts the collectives at the region's edges; its transpose sums the
cotangents of replicated operands over the mesh. Here the same regions are
built from explicit collectives (``parallel/comm.py``), each a
``torch.autograd.Function`` (Megatron's f / g operators are the model):

- ``Scatter``: forward, this rank's slice of a dimension; backward,
  all-gather of the gradient;
- ``Gather``: forward, all-gather; backward, this rank's slice;
- ``Swap``: the Ulysses all-to-all, from a shard of one dimension to a
  shard of another (frames to residues and back); backward, the inverse
  all-to-all;
- ``CopyToRegion``: replicated operands entering a region (weights, AdaLN
  rows); forward, identity; backward, one all-reduce (SUM) of all their
  gradients over the region's group.

Every hand-written kernel runs unchanged on each rank's local shard.

The registry (``set_kernel_mesh`` / ``get_kernel_mesh`` / ``kernel_mesh``)
holds the mesh the model's sharded regions run over. ``Trainer`` and
``InferenceEngine`` register none for the whole process: while they run a
step or a sample whose batch they have already split, ``kernel_mesh``
holds the mesh of the axes that are left (``Mesh.sub``), and nothing
outside that is split. ``get_kernel_mesh`` gives None for a one-rank mesh.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.distributed as dist

from . import comm

_ACTIVE_MESH: list = [None]


def set_kernel_mesh(mesh) -> None:
    """Register the mesh the model's sharded regions run over (None clears)."""
    _ACTIVE_MESH[0] = mesh


def get_kernel_mesh():
    mesh = _ACTIVE_MESH[0]
    if mesh is not None and mesh.size <= 1:
        return None
    return mesh


@contextlib.contextmanager
def kernel_mesh(mesh):
    prev = _ACTIVE_MESH[0]
    _ACTIVE_MESH[0] = mesh
    try:
        yield
    finally:
        _ACTIVE_MESH[0] = prev


# ---------------------------------------------------------------------------
# the rules (JAX :57-100, pure functions of the mesh's names and sizes)
# ---------------------------------------------------------------------------

def batch_shard_axes(axis_names: Sequence[str], shape: dict, batch: int):
    """Mesh axes to shard dim 0 over: the full mesh when the batch divides
    it, else the leading (dp) axis alone, else None (caller falls back)."""
    names = tuple(axis_names)
    size = 1
    for n in names:
        size *= shape[n]
    if batch % size == 0:
        return names
    lead = shape[names[0]]
    if lead > 1 and batch % lead == 0:
        return (names[0],)
    return None


def seq_shard_axes(axis_names: Sequence[str], shape: dict, batch: int, seq: int):
    """(batch_axes, seq_axes) for batch + sequence sharding when the batch
    alone does not divide the mesh: the leading axes whose product divides
    ``batch`` shard dim 0, the axes after them (their product dividing
    ``seq``) the sequence axis. None when no sequence axis can be sharded."""
    names = tuple(axis_names)
    b_axes = []
    prod = 1
    for n in names:
        if batch % (prod * shape[n]) == 0:
            b_axes.append(n)
            prod *= shape[n]
        else:
            break
    rest = names[len(b_axes):]
    s_axes = []
    prod = 1
    for n in rest:
        if seq % (prod * shape[n]) == 0:
            s_axes.append(n)
            prod *= shape[n]
        else:
            break
    if not s_axes:
        return None
    return tuple(b_axes), tuple(s_axes)


def split_axes(mesh, batch: int, T: int, L: int) -> tuple:
    """How a step of ``batch`` elements of (T, L) runs on ``mesh``:
    (batch axes, sequence axes). The batch fold when the batch divides the
    mesh (all axes, none left); else the sequence split
    (``seq_shard_axes`` over gcd(T, L), the trunk's frame and residue axes
    both); else the batch over dp alone (``batch_shard_axes``); else
    replication ((), ())."""
    names, shape = mesh.axis_names, mesh.shape
    if mesh.size <= 1:
        return (), ()
    if batch % mesh.size == 0:
        return names, ()
    seq = seq_shard_axes(names, shape, batch, math.gcd(T, L))
    if seq is not None:
        return seq
    return batch_shard_axes(names, shape, batch) or (), ()


# ---------------------------------------------------------------------------
# the region's collectives
# ---------------------------------------------------------------------------

def _part(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size).contiguous()


class Scatter(torch.autograd.Function):
    """This rank's slice of ``dim`` (forward); the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _part(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.group, ctx.dim), None, None


class Gather(torch.autograd.Function):
    """Every rank's shard concatenated along ``dim`` (forward); the
    gradient's slice of this rank."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return comm.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.group, ctx.dim), None, None


def _swap(x: torch.Tensor, group, split: int, concat: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = comm.all_to_all(torch.stack(x.chunk(n, dim=split)), group)
    return torch.cat(out.unbind(0), dim=concat)


class Swap(torch.autograd.Function):
    """The Ulysses all-to-all: ``x`` whole along ``split`` and sharded along
    ``concat`` becomes sharded along ``split`` and whole along ``concat``
    (chunk k of ``split`` goes to group rank k). Backward: the inverse."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _swap(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _swap(g, ctx.group, ctx.concat, ctx.split), None, None, None


class CopyToRegion(torch.autograd.Function):
    """Replicated operands of a region: identity forward; backward, their
    gradients (each rank's partial sums over its shard) summed over
    ``group`` in one f32 all-reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [g if g is not None else torch.zeros(s, dtype=d, device=dev)
              for g, (s, d, dev) in zip(gs, ctx.like)]
        return (None, *comm.flat(gs, lambda f: comm.all_reduce(f, ctx.group)))


def scatter(x, group, dim: int):
    return x if group is None else Scatter.apply(x, group, dim)


def gather(x, group, dim: int):
    return x if group is None else Gather.apply(x, group, dim)


def swap(x, group, split: int, concat: int):
    return x if group is None else Swap.apply(x, group, split, concat)


def copy_to_region(group, *xs):
    """``xs`` as the region uses them: through ``CopyToRegion`` those that
    need a gradient (one all-reduce for all of them in the backward)."""
    idx = [i for i, x in enumerate(xs) if torch.is_tensor(x) and x.requires_grad]
    if group is None or not idx or not torch.is_grad_enabled():
        return list(xs)
    out = list(xs)
    for i, y in zip(idx, CopyToRegion.apply(group, *(xs[i] for i in idx))):
        out[i] = y
    return out


# ---------------------------------------------------------------------------
# regions (JAX shard_map_batch0 :141, shard_map_batch_seq :103)
# ---------------------------------------------------------------------------

def _map_tensors(fn, a):
    if isinstance(a, dict):
        return {k: _map_tensors(fn, v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_map_tensors(fn, v) for v in a)
    return fn(a) if torch.is_tensor(a) else a


def _first_dim0(args, flags):
    for a, f in zip(args, flags):
        if f is None or f is False:
            continue
        found = []
        _map_tensors(lambda t: found.append(t.shape[0]), a)
        if found:
            return found[0]
    raise ValueError("no sharded argument")


def _copy_replicated(group, args, flags):
    """The replicated arguments' tensors that need a gradient, through one
    ``CopyToRegion`` over ``group``."""
    leaves = []
    for a, f in zip(args, flags):
        if not f:
            _map_tensors(leaves.append, a)
    copied = iter(copy_to_region(group, *leaves))
    return [a if f else _map_tensors(lambda t: next(copied), a) for a, f in zip(args, flags)]


def shard_map_batch0(fn, batched: Sequence[bool], *args, mesh=None):
    """``fn(*args)`` with dim 0 of every tensor of each ``batched`` argument
    (a tensor, or a dict / tuple of tensors) split over the mesh's batch
    axes (``batch_shard_axes``); the other arguments replicated. ``fn``
    gets this rank's shards; its output (a tensor or a tuple of them) is
    gathered along dim 0, so every rank returns the whole. Returns None
    when no mesh is active or the batch does not divide (the caller then
    runs ``fn`` on everything)."""
    mesh = mesh if mesh is not None else get_kernel_mesh()
    if mesh is None:
        return None
    axes = batch_shard_axes(mesh.axis_names, mesh.shape, _first_dim0(args, batched))
    if axes is None:
        return None
    group = mesh.group(axes)
    args = _copy_replicated(group, args, batched)
    local = [_map_tensors(lambda t: scatter(t, group, 0), a) if b else a
             for a, b in zip(args, batched)]
    return _map_tensors(lambda t: gather(t, group, 0), fn(*local))


def shard_map_batch_seq(fn, specs: Sequence, *args, seq_dim_size: int, out_spec=None,
                        mesh=None):
    """``fn`` over batch and sequence shards (``seq_shard_axes``). Per
    argument, ``specs``: ``"b"`` = dim 0 over the batch axes; an int d =
    dim 0 over the batch axes and dim d over the sequence axes; None =
    replicated. ``fn(*local, seq_group=g)`` gets this rank's shards and the
    sequence axes' group, which it may communicate over (the Ulysses swap);
    it must be element-independent along dim 0 and return its output
    sharded as ``out_spec`` (default: the first sharded argument's spec),
    which is gathered. Returns None when no mesh is active or no sequence
    axis divides."""
    mesh = mesh if mesh is not None else get_kernel_mesh()
    if mesh is None:
        return None
    batch = _first_dim0(args, specs)
    axes = seq_shard_axes(mesh.axis_names, mesh.shape, batch, seq_dim_size)
    if axes is None:
        return None
    b_axes, s_axes = axes
    bg, sg = mesh.group(b_axes), mesh.group(s_axes)
    # replicated over the whole region; batch-split ones are replicated over
    # the sequence axes, so their gradients sum there
    args = _copy_replicated(mesh.group(b_axes + s_axes), args, specs)
    args = _copy_replicated(sg, args, [s != "b" for s in specs])

    def place(t, s):
        t = scatter(t, bg, 0)
        return t if s == "b" else scatter(t, sg, s)

    local = [a if s is None else _map_tensors(lambda t, s=s: place(t, s), a)
             for a, s in zip(args, specs)]
    out = fn(*local, seq_group=sg)
    if out_spec is None:
        out_spec = next(s for s in specs if s is not None)

    def unplace(t):
        t = t if out_spec == "b" else gather(t, sg, out_spec)
        return gather(t, bg, 0)

    return _map_tensors(unplace, out)

"""The process mesh.

Counterpart of the JAX package's ``parallel/mesh.py``. The mesh has two
axes, as there (SURVEY.md §2.7):

- ``dp``: data parallel, the batch split, gradients all-reduced (the
  reference's DDP, src/train.py:46-68);
- ``sp``: sequence parallel, the trunk's frame and residue axes split
  (``parallel/kernel_sharding.py``).

The ranks of ``torch.distributed``'s world take the places JAX gives its
devices, ``np.array(devices).reshape(dp, sp)`` (JAX ``make_mesh``): rank r
sits at (r // sp, r % sp). Without an initialised default group the world
is this one process. Every rank is handed the whole global batch and keeps
its rows (``local_slice`` over the axes ``kernel_sharding.split_axes``
picks): JAX's ``shard_batch`` placement, which splits the frames over sp
as well, has no counterpart here, since the featurization and
``prep_batch`` (frame 0) run on all of a row's frames.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import torch.distributed as dist

AXES = ("dp", "sp")


def world() -> tuple[int, int]:
    """This process's rank and the number of ranks of the default group;
    (0, 1) without an initialised one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Named axes over ranks, row-major: ``shape`` {name: size}, this
    rank's ``coords`` {name: index}, and the process group of every set of
    axes whose ranks number more than one (the ranks that share this rank's
    index on the other axes; ``group(axes)``). ``sub(axes)`` is the mesh of
    those axes alone, with the same groups."""

    def __init__(self, shape: dict, coords: dict, groups: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.coords = dict(coords)
        self._groups = groups

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        """This rank's place in the mesh (row-major), 0 for the one that
        writes the log and the checkpoints."""
        return self.index(self.axis_names)

    def sub(self, axes) -> "Mesh":
        axes = tuple(a for a in self.axis_names if a in axes)
        return Mesh({a: self.shape[a] for a in axes}, {a: self.coords[a] for a in axes},
                    self._groups)

    def index(self, axes) -> int:
        """This rank's position along ``axes`` (row-major), its group rank."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def count(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes):
        """The group of ``axes`` (None when they span one rank)."""
        axes = tuple(sorted(axes, key=AXES.index))
        return None if self.count(axes) <= 1 else self._groups[axes]

    def __repr__(self):
        return f"Mesh({self.shape}, at {self.coords})"


def make_mesh(dp_size: Optional[int] = None, sp_size: int = 1) -> Mesh:
    """The (dp, sp) mesh over the ranks of the default group; ``dp_size``
    None takes their number // sp_size (the CLI's ``--dp_size 0``). Raises
    JAX's ``ValueError`` when the mesh needs more ranks than there are, and
    when it leaves ranks out (the port runs one rank per place). Every rank
    calls it, with the same sizes: it makes the axes' groups."""
    rank, n = world()
    if dp_size is None:
        dp_size = max(n // sp_size, 1)
    use = dp_size * sp_size
    if use > n:
        raise ValueError(f"mesh {dp_size}x{sp_size} needs {use} devices, have {n}")
    if use < n:
        raise ValueError(f"mesh {dp_size}x{sp_size} places {use} of the {n} ranks: "
                         "every rank needs a place")
    shape = {"dp": dp_size, "sp": sp_size}
    coords = {"dp": rank // sp_size, "sp": rank % sp_size}
    groups = {}
    for k in (1, 2):
        for axes in itertools.combinations(AXES, k):
            if math.prod(shape[a] for a in axes) <= 1:
                continue
            # the ranks that share this rank's index on the other axes; each
            # rank makes its own groups, in this order (local synchronisation:
            # only a group's members take part)
            ranks = [r for r in range(use)
                     if all((r // sp_size, r % sp_size)[AXES.index(a)] == coords[a]
                            for a in AXES if a not in axes)]
            groups[axes] = (dist.group.WORLD if len(ranks) == n
                            else dist.new_group(ranks, use_local_synchronization=True))
    return Mesh(shape, coords, groups)


def local_slice(mesh: Mesh, axes, size: int) -> slice:
    """The part of a dimension of ``size`` that this rank holds when the
    dimension is split over ``axes``."""
    n = mesh.count(axes)
    if size % n:
        raise ValueError(f"a dimension of {size} does not split over {axes} ({n} ranks)")
    i = mesh.index(axes)
    return slice(i * size // n, (i + 1) * size // n)

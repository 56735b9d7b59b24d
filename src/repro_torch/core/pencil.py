"""Pencil (distributed-array alignment) on a ``DeviceMesh`` — the port of
``repro/core/pencil.py``.

A ``Pencil`` says, for each axis of a d-dimensional global array, whether
the axis is aligned (``None``: fully local) or block-distributed over a mesh
dimension (named as in the reference's JAX mesh).  Axes are stored padded to
a multiple of every subgroup they are ever distributed over (``lcm``
policy), so every rank holds an equal shard: the reference's equal-shard
layout, which makes the port's rank blocks equal the JAX shards.

torch runs one process per rank, so where the reference pads and slices one
global array, the port works on this rank's block: :func:`scatter_global`
pads the logical global array and cuts out one rank's block, and
:func:`assemble_blocks` / :func:`gather_blocks` put every rank's block back
into the logical global array.  Each of these takes ``nbatch`` leading field
axes (stacked multi-field execution), replicated on every rank as the
reference's ``batched_spec()`` has them: padded, cut and gathered along the
array axes only.

A group is one mesh dimension name or a tuple of names, a composed
subgroup of the product of their sizes (a slab over ``("p0", "p1")``, or
``("p1", "p0")``); a rank's block along it is cut at its composed index,
row-major over the tuple's own order, as the JAX shard of its device is
(:func:`repro_torch.core.meshutil.composed_coordinate`).  Building a
Pencil over a composed group makes that group's process groups
(:func:`~repro_torch.core.meshutil.build_subgroup`), which is collective:
every rank builds its pencils alike.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from functools import cached_property

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.decomp import pad_to_multiple
from repro_torch.core.meshutil import (build_subgroup, composed_coordinate, composed_size,
                                       rank_coordinate)

#: one mesh dimension name or a tuple of names (composed subgroup)
Group = str | tuple[str, ...]


def group_names(group: Group) -> tuple[str, ...]:
    return (group,) if isinstance(group, str) else tuple(group)


def group_size(mesh: DeviceMesh, group: Group) -> int:
    return composed_size(mesh, group_names(group))


@dataclass(frozen=True)
class Pencil:
    """Alignment state of a distributed d-dim array.

    ``logical``   — true global extents.
    ``physical``  — stored global extents (padded; equal-shard policy).
    ``placement`` — per array axis: mesh dimension name(s) or None (aligned).
    """

    mesh: DeviceMesh = field(repr=False, compare=False)
    logical: tuple[int, ...]
    physical: tuple[int, ...]
    placement: tuple[Group | None, ...]

    def __post_init__(self):
        if not len(self.logical) == len(self.physical) == len(self.placement):
            raise ValueError("logical, physical and placement differ in length")
        for ext, grp in zip(self.physical, self.placement):
            if grp is not None:
                build_subgroup(self.mesh, group_names(grp))
                m = group_size(self.mesh, grp)
                if ext % m != 0:
                    raise ValueError(
                        f"physical extent {ext} not divisible by group {grp} (size {m})")

    @property
    def ndim(self) -> int:
        return len(self.logical)

    @cached_property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(ext if grp is None else ext // group_size(self.mesh, grp)
                     for ext, grp in zip(self.physical, self.placement))

    def aligned(self, axis: int) -> bool:
        return self.placement[axis] is None

    def exchanged(self, v: int, w: int) -> "Pencil":
        """Alignment after the v->w exchange: axis ``v`` takes over the
        subgroup of axis ``w``, which becomes aligned.  Physical extents are
        unchanged."""
        if not self.aligned(v):
            raise ValueError(f"axis v={v} must be aligned, placement={self.placement}")
        grp = self.placement[w]
        if grp is None:
            raise ValueError(f"axis w={w} must be distributed, placement={self.placement}")
        m = group_size(self.mesh, grp)
        if self.physical[v] % m != 0:
            raise ValueError(
                f"axis v={v} physical extent {self.physical[v]} not divisible by |{grp}|={m}")
        new_placement = list(self.placement)
        new_placement[v] = grp
        new_placement[w] = None
        return replace(self, placement=tuple(new_placement))

    def with_axis_extent(self, axis: int, logical: int) -> "Pencil":
        """New pencil with axis ``axis`` resized (r2c/pruning extent change),
        re-padded to its current group's size."""
        m = 1 if self.placement[axis] is None else group_size(self.mesh, self.placement[axis])
        new_logical = list(self.logical)
        new_physical = list(self.physical)
        new_logical[axis] = logical
        new_physical[axis] = pad_to_multiple(logical, m)
        return replace(self, logical=tuple(new_logical), physical=tuple(new_physical))

    def block_slices(self, rank: int) -> tuple[slice, ...]:
        """Slices of the physical global array that global ``rank`` holds."""
        coord = rank_coordinate(self.mesh, rank)
        out = []
        for ext, grp in zip(self.local_shape, self.placement):
            if grp is None:
                out.append(slice(0, ext))
            else:
                c = composed_coordinate(self.mesh, group_names(grp), coord)
                out.append(slice(c * ext, (c + 1) * ext))
        return tuple(out)


def make_pencil(mesh: DeviceMesh, logical: tuple[int, ...],
                placement: tuple[Group | None, ...], *,
                divisors: tuple[int, ...] | None = None) -> Pencil:
    """Build a Pencil, padding each axis to ``divisors`` (per-axis required
    divisibility) and its current placement."""
    physical = []
    for i, (ext, grp) in enumerate(zip(logical, placement)):
        need = divisors[i] if divisors is not None else 1
        if grp is not None:
            need = math.lcm(need, group_size(mesh, grp))
        physical.append(pad_to_multiple(ext, need))
    return Pencil(mesh=mesh, logical=tuple(logical), physical=tuple(physical),
                  placement=tuple(placement))


def _lead(nbatch: int) -> tuple[slice, ...]:
    return (slice(None),) * nbatch


def pad_global(x: torch.Tensor, pencil: Pencil, *, nbatch: int = 0) -> torch.Tensor:
    """Zero-pad a logical global tensor to the pencil's physical extents
    (``nbatch`` leading field axes left as they are)."""
    lead = tuple(x.shape[:nbatch])
    if tuple(x.shape[nbatch:]) == pencil.physical:
        return x
    out = torch.zeros(lead + pencil.physical, dtype=x.dtype, device=x.device)
    out[_lead(nbatch) + tuple(slice(0, l) for l in pencil.logical)] = x
    return out


def unpad_global(x: torch.Tensor, pencil: Pencil, *, nbatch: int = 0) -> torch.Tensor:
    """Slice a physical global tensor back to its logical extents."""
    if pencil.logical == pencil.physical:
        return x
    return x[_lead(nbatch) + tuple(slice(0, l) for l in pencil.logical)]


def scatter_global(x, pencil: Pencil, rank: int, *, nbatch: int = 0) -> torch.Tensor:
    """Global ``rank``'s padded block of the logical global array ``x``
    (numpy array or tensor, ``nbatch`` leading field axes kept whole),
    contiguous, on ``x``'s device."""
    xt = torch.as_tensor(x)
    if tuple(xt.shape[nbatch:]) != pencil.logical or xt.dim() != nbatch + pencil.ndim:
        raise ValueError(f"global shape {tuple(xt.shape)} != {nbatch} field axes + pencil "
                         f"logical {pencil.logical}")
    padded = pad_global(xt, pencil, nbatch=nbatch)
    return padded[_lead(nbatch) + pencil.block_slices(rank)].contiguous()


def assemble_blocks(blocks, pencil: Pencil, *, nbatch: int = 0) -> torch.Tensor:
    """The logical global tensor from every rank's block (``blocks[r]`` is
    global rank ``r``'s, with ``nbatch`` leading field axes)."""
    b0 = blocks[0]
    out = torch.empty(tuple(b0.shape[:nbatch]) + pencil.physical, dtype=b0.dtype,
                      device=b0.device)
    for rank, blk in enumerate(blocks):
        out[_lead(nbatch) + pencil.block_slices(rank)] = blk
    return unpad_global(out, pencil, nbatch=nbatch)


def gather_blocks(blocks, pencil: Pencil, *, nbatch: int = 0) -> np.ndarray:
    """:func:`assemble_blocks` as a numpy array."""
    return assemble_blocks([torch.as_tensor(b).cpu() for b in blocks], pencil,
                           nbatch=nbatch).numpy()


def allgather_global(block: torch.Tensor, pencil: Pencil, *, nbatch: int = 0) -> torch.Tensor:
    """The logical global tensor on every rank, from each rank's ``block``
    (``nbatch`` leading field axes; one all-gather over the default group,
    which the mesh must cover)."""
    world = dist.get_world_size()
    if pencil.mesh.size() != world:
        raise ValueError(f"mesh of {pencil.mesh.size()} ranks does not cover the world of {world}")
    flat = torch.view_as_real(block) if block.is_complex() else block
    flat = flat.contiguous()
    gathered = torch.empty((world * flat.shape[0], *flat.shape[1:]), dtype=flat.dtype,
                           device=flat.device)
    dist.all_gather_into_tensor(gathered, flat)
    gathered = gathered.reshape(world, *flat.shape)
    if block.is_complex():
        gathered = torch.view_as_complex(gathered)
    return assemble_blocks(list(gathered.unbind(0)), pencil, nbatch=nbatch)

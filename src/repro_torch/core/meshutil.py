"""Meshes of the PyTorch port: a ``torch.distributed`` ``DeviceMesh`` whose
``mesh_dim_names`` are the reference's JAX mesh axis names.

torch runs one process per rank, so a mesh needs an initialized default
process group (``torch.distributed.init_process_group`` with this rank's
address, world size and rank); :func:`make_mesh` lays the world's ranks out
row-major over ``shape``, as ``jax.make_mesh`` does with host devices.

A group named by a tuple of mesh dimensions (a composed subgroup, the
paper's ``MPI_CART_SUB`` keeping several dimensions) is one group of the
product of their sizes.  A rank's index in it is row-major over the tuple's
own order, as JAX linearises ``PartitionSpec(("p1", "p0"))`` and
``lax.all_to_all(axis_name=("p1", "p0"))``: ``c_p1 * n_p0 + c_p0``.
:func:`build_subgroup` makes its process groups (collective over the
world, once per mesh and set of dimensions); :func:`subgroup` gives the
group, its size and the order of ``all_to_all_single``'s dim-0 chunks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def balanced_dims(ndev: int) -> tuple[int, int]:
    """Factor ``ndev`` into the most-square (a, b) with a*b == ndev, a <= b."""
    a = int(ndev**0.5)
    while ndev % a:
        a -= 1
    return a, ndev // a


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], *,
              device: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the default process
    group.  ``device="cuda"`` (the default) needs a CUDA card and raises
    without one; the CPU (gloo) mesh is only built when asked for."""
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in length")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda'): no CUDA device is available; "
                           "pass device='cpu' for a gloo mesh")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown mesh device {device!r}; expected 'cuda' or 'cpu'")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} does not cover the world of {dist.get_world_size()} ranks")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(names))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """Size of the mesh dimension called ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def rank_coordinate(mesh: DeviceMesh, rank: int) -> tuple[int, ...]:
    """Coordinate of global ``rank`` in ``mesh`` (row-major over its dims)."""
    hit = (mesh.mesh == rank).nonzero()
    if hit.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in mesh {mesh.mesh.tolist()}")
    return tuple(int(c) for c in hit[0])


def composed_size(mesh, names: tuple[str, ...]) -> int:
    """Size of the group the mesh dimensions ``names`` make together."""
    return math.prod(axis_size(mesh, n) for n in names)


def composed_coordinate(mesh, names: tuple[str, ...], coord: tuple[int, ...]) -> int:
    """Index, in the group of the dimensions ``names``, of the rank at mesh
    coordinate ``coord``: row-major over ``names`` in their given order."""
    dims = mesh.mesh_dim_names
    idx = 0
    for n in names:
        idx = idx * axis_size(mesh, n) + coord[dims.index(n)]
    return idx


def in_mesh_order(mesh, names: tuple[str, ...]) -> bool:
    """Whether the composed index of ``names`` is the order of the global
    ranks (the group's own rank order) on a row-major mesh: the dimensions
    of size > 1 come in the mesh's order."""
    dims = mesh.mesh_dim_names
    pos = [dims.index(n) for n in names if axis_size(mesh, n) > 1]
    return pos == sorted(pos)


class Subgroup(NamedTuple):
    """A (possibly composed) group of this rank: its process group, its
    size, and, where the composed index is not the group's rank order, the
    dim-0 chunk orders of an ``all_to_all_single``: ``send[g]`` is the
    composed index of group rank ``g`` (the chunk it must receive), and
    ``recv[j]`` the group rank that holds composed index ``j``.  Both are
    None for a group in mesh order."""

    pg: object
    size: int
    send: torch.Tensor | None
    recv: torch.Tensor | None


def _check_names(mesh, names: tuple[str, ...]):
    for n in names:
        if n not in mesh.mesh_dim_names:
            raise ValueError(f"{n!r} is not a dimension of the mesh {mesh.mesh_dim_names}")
    if len(set(names)) != len(names):
        raise ValueError(f"group {names} names a mesh dimension twice")


def _dim_set(mesh, names: tuple[str, ...]) -> tuple[int, ...]:
    return tuple(sorted(mesh.mesh_dim_names.index(n) for n in names))


def build_subgroup(mesh, names: tuple[str, ...]) -> None:
    """Make the process groups of the composed group ``names``: every rank
    calls ``new_group`` for every coset (the ranks that share each mesh
    coordinate outside ``names``) in one fixed order, so this is collective
    over the world and must run on every rank alike.  Once per mesh and set
    of dimensions (any order of them shares the groups); a single dimension,
    or a mesh that is not a ``DeviceMesh`` (a stand-in for arithmetic), has
    nothing to build."""
    names = tuple(names)
    _check_names(mesh, names)
    if len(names) < 2 or not isinstance(mesh, DeviceMesh):
        return
    built = mesh.__dict__.setdefault("_composed_groups", {})
    key = _dim_set(mesh, names)
    if key in built:
        return
    others = [d for d in range(mesh.ndim) if d not in key]
    ranks = mesh.mesh.permute(*others, *key).reshape(-1, math.prod(mesh.shape[d] for d in key))
    backend = dist.get_backend(mesh.get_group(mesh.mesh_dim_names[0]))
    me = dist.get_rank()
    for coset in ranks.tolist():
        pg = dist.new_group(ranks=coset, backend=backend)
        if me in coset:
            built[key] = (pg, sorted(coset))


def subgroup(mesh, names: tuple[str, ...]) -> Subgroup:
    """This rank's group of the mesh dimensions ``names`` (one name: the
    mesh's own group of that dimension; several: the groups
    :func:`build_subgroup` made, else ``RuntimeError``)."""
    names = tuple(names)
    _check_names(mesh, names)
    cache = mesh.__dict__.setdefault("_subgroups", {})
    if names in cache:
        return cache[names]
    if len(names) == 1:
        pg = mesh.get_group(names[0])
        members = sorted(dist.get_process_group_ranks(pg))
    else:
        built = mesh.__dict__.get("_composed_groups", {})
        if _dim_set(mesh, names) not in built:
            raise RuntimeError(
                f"the process groups of the composed group {names} were not built: "
                "build_subgroup (a Pencil over the group calls it) must run on every "
                "rank before an exchange")
        pg, members = built[_dim_set(mesh, names)]
    inv = [composed_coordinate(mesh, names, rank_coordinate(mesh, r)) for r in members]
    send = recv = None
    if inv != list(range(len(inv))):
        device = mesh_device(mesh)
        send = torch.tensor(inv, dtype=torch.long, device=device)
        recv = torch.argsort(send)
    cache[names] = Subgroup(pg, len(members), send, recv)
    return cache[names]

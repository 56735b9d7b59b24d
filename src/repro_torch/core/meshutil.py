"""Meshes of the PyTorch port: a ``torch.distributed`` ``DeviceMesh`` whose
``mesh_dim_names`` are the reference's JAX mesh axis names.

torch runs one process per rank, so a mesh needs an initialized default
process group (``torch.distributed.init_process_group`` with this rank's
address, world size and rank); :func:`make_mesh` lays the world's ranks out
row-major over ``shape``, as ``jax.make_mesh`` does with host devices.
"""

from __future__ import annotations

import math

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

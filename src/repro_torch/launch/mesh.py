"""The LM's mesh (the port of ``repro/launch/mesh.py``'s ``make_host_mesh``).

``make_host_mesh(model)`` lays the world's ranks out as ``(world // model,
model)`` named ``("data", "model")``: tensor and expert parallelism over
``"model"``, the batch over ``"data"``.  It needs an initialized default
process group (``torchrun`` sets the address, world size and rank; a test
passes them to ``init_process_group`` itself).  The reference's production
meshes are TPU pods and have no twin here.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.meshutil import make_mesh


def make_host_mesh(model: int = 1, device: str = "cuda") -> DeviceMesh:
    """A ``(world // model, model)`` mesh named ``("data", "model")`` over the
    default process group.  ``device="cuda"`` (the default) raises without a
    card; ``"cpu"`` gives a gloo mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"--model-parallel {model} does not divide the world of {n} ranks")
    return make_mesh((n // model, model), ("data", "model"), device=device)

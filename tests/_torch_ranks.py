"""Four CPU (gloo) ranks running the port's exchanges and plans, for
tests/test_torch_pfft.py.

The cases and their numpy-seeded inputs are plain data here, so the JAX side
of the comparison (a subprocess with 4 virtual devices) builds the very same
ones.  This module imports no torch at top level and no jax at all.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np

WORLD = 4

#: the quickstart's padded extents (examples/quickstart.py)
QS_SHAPE = (42, 63, 64)

#: reference PlanConfig fields of the two configurations of the slice
PLAN_CONFIGS = {
    "default": {"method": "fused"},
    "slice": {"method": "fused", "impl": "matmul", "exchange_impl": "pallas",
              "comm_dtype": "bf16"},
}

#: (mesh shape, mesh names, global field shape, input placement, v, w)
EXCHANGE_LAYOUTS = {
    "pencil_w_before_v": ((2, 2), ("p0", "p1"), (4, 6, 10), ("p0", "p1", None), 2, 1),
    "pencil_w_after_v": ((2, 2), ("p0", "p1"), (4, 10, 6), ("p0", None, "p1"), 1, 2),
    "slab_w_before_v": ((4,), ("s",), (8, 12, 6), ("s", None, None), 1, 0),
    "slab_w_after_v": ((4,), ("s",), (12, 8, 6), (None, "s", None), 0, 1),
}

COMM_DTYPES = ("complex64", "bf16", "int8")


def exchange_cases() -> list[tuple[str, str, str, int]]:
    """``(key, layout, comm_dtype, nbatch)`` of every exchange compared."""
    return [(f"{lay}-{comm}-nb{nb}", lay, comm, nb)
            for lay in EXCHANGE_LAYOUTS for comm in COMM_DTYPES for nb in (0, 1)]


def out_placement(placement, v, w):
    out = list(placement)
    out[v], out[w] = placement[w], None
    return tuple(out)


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def inputs() -> dict[str, np.ndarray]:
    """The global input of every case (two stacked fields when nbatch=1)."""
    out = {}
    for i, (key, lay, _, nb) in enumerate(exchange_cases()):
        shape = EXCHANGE_LAYOUTS[lay][2]
        out[key] = _complex(np.random.default_rng(100 + i), ((2,) if nb else ()) + shape)
    out["quickstart"] = _complex(np.random.default_rng(0), QS_SHAPE)
    return out


def run_rank(rank: int, init_file: str, out_dir: str):
    """One rank: every exchange case and both quickstart plans; rank 0
    saves the gathered global results to ``out_dir/results.npz``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.meshutil import make_mesh
    from repro_torch.core.pencil import allgather_global, gather_blocks, make_pencil, scatter_global
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import config_from_reference
    from repro_torch.core.redistribute import exchange_shard

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        meshes = {}
        data = inputs()
        res = {}
        for key, lay, comm, nb in exchange_cases():
            mshape, names, fshape, placement, v, w = EXCHANGE_LAYOUTS[lay]
            if mshape not in meshes:
                meshes[mshape] = make_mesh(mshape, names, device="cpu")
            mesh = meshes[mshape]
            pin = make_pencil(mesh, fshape, placement)
            pout = pin.exchanged(v, w)
            fields = torch.from_numpy(data[key]).reshape(-1, *fshape)
            block = torch.stack([scatter_global(f, pin, rank) for f in fields])
            y = exchange_shard(block if nb else block[0], v, w, placement[w], mesh=mesh,
                               comm_dtype=comm, nbatch=nb, impl="cuda")
            ys = y if nb else y[None]
            glob = torch.stack([allgather_global(f, pout) for f in ys])
            res[key] = (glob if nb else glob[0]).numpy()

        u = data["quickstart"]
        for name, cfg in PLAN_CONFIGS.items():
            plan = ParallelFFT(meshes[(2, 2)], QS_SHAPE, ("p0", "p1"),
                               config=config_from_reference(cfg))
            uh = plan.forward(u)
            res[f"plan-{name}-fwd"] = uh.numpy()
            res[f"plan-{name}-back"] = plan.backward(uh).numpy()
        pen = plan.input_pencil
        res["gather-roundtrip"] = gather_blocks(
            [scatter_global(u, pen, r) for r in range(WORLD)], pen)
        if rank == 0:
            np.savez(Path(out_dir) / "results.npz", **res)
    finally:
        dist.destroy_process_group()

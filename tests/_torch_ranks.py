"""Four CPU (gloo) ranks running the port's exchanges and plans, for
tests/test_torch_pfft.py, tests/test_torch_engines.py and
tests/test_torch_guard.py.

The cases and their numpy-seeded inputs are plain data here, so the JAX side
of the comparison (a subprocess with 4 virtual devices) builds the very same
ones.  This module imports no torch at top level and no jax at all.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
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


#: (method, options) of the traditional and pipelined engines compared
ENGINES = {
    "trad": ("traditional", {"transposed_out": False}),
    "trad_tout": ("traditional", {"transposed_out": True}),
    "pipe1": ("pipelined", {"chunks": 1}),
    "pipe3": ("pipelined", {"chunks": 3}),
}

#: reference PlanConfig fields of the quickstart plan under the other engines
ENGINE_PLANS = {
    "traditional": {"method": "traditional"},
    "pipelined": {"method": "pipelined", "chunks": 3},
}

#: the fault matrix's plan (tests/test_robustness.py, on a (2, 2) mesh)
GUARD_SHAPE = (16, 8, 8)

#: case -> (guard, comm_dtype, [(injector, kwargs)], direction): the matrix of
#: tests/test_robustness.py without its tuner and batched cases, plus an
#: injected compile failure
GUARD_CASES = {
    "clean_strict": ("strict", "complex64", [], "forward"),
    "clean_bf16": ("strict", "bf16", [], "forward"),
    "wire_c64_strict": ("strict", "complex64",
                        [("corrupt_wire", {"engine": "fused", "codec": "complex64"})], "forward"),
    "wire_c64_degrade": ("degrade", "complex64",
                         [("corrupt_wire", {"engine": "fused", "codec": "complex64"})], "forward"),
    "nan_input_strict": ("strict", "complex64", [("nan_input", {"stage": 0, "engine": "fused"})],
                         "forward"),
    "nan_input_degrade": ("degrade", "complex64",
                          [("nan_input", {"stage": 0, "engine": "fused"})], "forward"),
    "wire_bf16_strict": ("strict", "bf16", [("corrupt_wire", {"engine": "fused", "codec": "bf16"})],
                         "forward"),
    "wire_bf16_degrade": ("degrade", "bf16",
                          [("corrupt_wire", {"engine": "fused", "codec": "bf16"})], "forward"),
    "int8_scale_degrade": ("degrade", "int8", [("corrupt_wire", {"engine": "fused", "codec": "int8",
                                                                 "label": "scale"})], "forward"),
    "saturate_strict": ("strict", "int8", [("saturate", {"engine": "fused"})], "forward"),
    "saturate_degrade": ("degrade", "int8", [("saturate", {"engine": "fused"})], "forward"),
    "saturate_backward": ("degrade", "int8", [("saturate", {"engine": "fused"})], "backward"),
    "exhausted": ("degrade", "complex64", [("nan_input", {})], "forward"),
    "fail_compile_degrade": ("degrade", "complex64", [("fail_compile", {"engine": "fused"})],
                             "forward"),
}

#: (reference exchange_impl, cases) the matrix runs: every case with the plain
#: codec, the lossy ones again through the exchange kernels
GUARD_RUNS = (("jnp", tuple(GUARD_CASES)),
              ("pallas", ("wire_bf16_degrade", "int8_scale_degrade", "saturate_strict",
                          "saturate_degrade")))


def guard_keys() -> list[tuple[str, str, str]]:
    """``(key, reference exchange_impl, case)`` of every matrix run."""
    return [(f"{impl}:{case}", impl, case) for impl, cases in GUARD_RUNS for case in cases]


def engine_cases() -> list[tuple[str, str, str, str]]:
    """``(key, layout, engine, comm_dtype)`` of every engine exchange compared."""
    return [(f"{lay}-{eng}-{comm}", lay, eng, comm)
            for lay in EXCHANGE_LAYOUTS for eng in ENGINES for comm in COMM_DTYPES]


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
    for i, (key, lay, _, _) in enumerate(engine_cases()):
        out[key] = _complex(np.random.default_rng(300 + i), EXCHANGE_LAYOUTS[lay][2])
    out["quickstart"] = _complex(np.random.default_rng(0), QS_SHAPE)
    out["guard"] = _complex(np.random.default_rng(0), GUARD_SHAPE)
    return out


def start(target, out_dir: Path):
    """Start ``target(rank, init_file, out_dir)`` on ``WORLD`` spawned ranks;
    returns a function that waits for them and checks their exit codes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, str(out_dir / "pg"), str(out_dir)))
             for r in range(WORLD)]
    for p in procs:
        p.start()

    def join(timeout: int = 300):
        for p in procs:
            p.join(timeout=timeout)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * WORLD, f"rank exit codes {codes}"

    return join


def _init(rank: int, init_file: str):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))


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

    _init(rank, init_file)
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


def _count_calls(module, names, calls):
    """Wrap ``module.<name>`` for each name so that every call adds one to
    ``calls[name]``."""
    for name in names:
        def counted(*args, _fn=getattr(module, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        setattr(module, name, counted)


def run_engine_rank(rank: int, init_file: str, out_dir: str):
    """One rank: every engine case with ``guard=True`` (this rank's output
    block and stats, and its calls of the exchange-kernel wrappers, saved
    per rank), the lossy transposed-out cases again with the plain codec,
    and the quickstart plan under the traditional and pipelined engines
    (rank 0 saves the global results)."""
    from collections import Counter

    import torch.distributed as dist

    from repro_torch.core.meshutil import make_mesh
    from repro_torch.core.pencil import make_pencil, scatter_global
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import config_from_reference
    from repro_torch.core.redistribute import exchange_shard
    from repro_torch.kernels.exchange import ops as xops

    calls = Counter()
    _count_calls(xops, ("pack_chunks", "unpack_chunks"), calls)
    _init(rank, init_file)
    try:
        meshes, data, res = {}, inputs(), {}
        for key, lay, eng, comm in engine_cases():
            mshape, names, fshape, placement, v, w = EXCHANGE_LAYOUTS[lay]
            if mshape not in meshes:
                meshes[mshape] = make_mesh(mshape, names, device="cpu")
            method, opts = ENGINES[eng]
            block = scatter_global(data[key], make_pencil(meshes[mshape], fshape, placement), rank)
            calls.clear()
            y, st = exchange_shard(block, v, w, placement[w], mesh=meshes[mshape], method=method,
                                   comm_dtype=comm, impl="cuda", guard=True, **opts)
            res[key] = y.numpy()
            res[key + ":stats"] = np.array([float(st["nonfinite"]), float(st["saturated"])])
            res[key + ":calls"] = np.array([calls["pack_chunks"], calls["unpack_chunks"]])
            if eng == "trad_tout" and comm != "complex64":
                y, st = exchange_shard(block, v, w, placement[w], mesh=meshes[mshape],
                                       method=method, comm_dtype=comm, impl="torch", guard=True,
                                       **opts)
                res[key + ":torch"] = y.numpy()
                res[key + ":torch:stats"] = np.array([float(st["nonfinite"]),
                                                      float(st["saturated"])])
        for name, cfg in ENGINE_PLANS.items():
            plan = ParallelFFT(meshes[(2, 2)], QS_SHAPE, ("p0", "p1"),
                               config=config_from_reference(cfg))
            uh = plan.forward(data["quickstart"])
            res[f"plan-{name}-fwd"] = uh.numpy()
            res[f"plan-{name}-back"] = plan.backward(uh).numpy()
        guarded = ParallelFFT(meshes[(2, 2)], QS_SHAPE, ("p0", "p1"),
                              config=config_from_reference({"method": "pipelined",
                                                            "guard": "strict"}))
        res["warm"] = np.array([plan.warm(), guarded.warm(("forward",))])
        np.savez(Path(out_dir) / f"engines{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def run_guard_rank(rank: int, init_file: str, out_dir: str):
    """One rank: the fault matrix (outcomes as JSON and outputs, saved per
    rank), and a kernel wrapper made to raise under ``guard="degrade"``."""
    import torch.distributed as dist

    from repro_torch.core.meshutil import make_mesh
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig, config_from_reference
    from repro_torch.kernels.exchange import ops as xops
    from repro_torch.robustness import FaultPlan, GuardError

    _init(rank, init_file)
    try:
        mesh = make_mesh((2, 2), ("p0", "p1"), device="cpu")
        x = inputs()["guard"]
        base = ParallelFFT(mesh, GUARD_SHAPE, ("p0", "p1"))
        y_ref = base.forward(x)
        outcomes, arrays = {}, {}
        for key, impl, case in guard_keys():
            guard, comm, injectors, direction = GUARD_CASES[case]
            cfg = config_from_reference({"method": "fused", "guard": guard, "comm_dtype": comm,
                                         "exchange_impl": impl})
            fp = FaultPlan()
            for name, kw in injectors:
                getattr(fp, name)(**kw)
            with fp:
                plan = ParallelFFT(mesh, GUARD_SHAPE, ("p0", "p1"), config=cfg)
                try:
                    y, rep = getattr(plan, direction)(x if direction == "forward" else y_ref)
                except GuardError as e:
                    outcomes[key] = {"raised": True,
                                     "tripped": list(e.report.tripped) if e.report else []}
                    continue
            outcomes[key] = report_outcome(rep)
            arrays[key] = y.numpy()

        # a kernel that fails is not a fault to degrade past: it propagates
        def broken(*args, **kwargs):
            raise RuntimeError("exchange kernel failed")

        plan = ParallelFFT(mesh, GUARD_SHAPE, ("p0", "p1"),
                           config=PlanConfig(guard="degrade", comm_dtype="int8",
                                             exchange_impl="cuda"))
        real, xops.pack_chunks = xops.pack_chunks, broken
        try:
            plan.forward(x)
            outcomes["kernel_error"] = "no error"
        except GuardError as e:
            outcomes["kernel_error"] = f"GuardError: {e}"
        except RuntimeError as e:
            outcomes["kernel_error"] = f"RuntimeError: {e}"
        finally:
            xops.pack_chunks = real
        (Path(out_dir) / f"guard{rank}.json").write_text(json.dumps(outcomes))
        np.savez(Path(out_dir) / f"guard{rank}.npz", **arrays)
    finally:
        dist.destroy_process_group()


def report_outcome(rep) -> dict:
    """The parts of a HealthReport both packages' matrices compare (the
    schedule with the reference's implementation names)."""
    names = {"torch": "jnp", "cuda": "pallas"}
    return {"raised": False, "ok": rep.ok, "tripped": list(rep.tripped),
            "kinds": [t["kind"] for t in rep.transitions], "attempts": rep.attempts,
            "schedule": [[e[0], e[1], e[2], names.get(e[3], e[3]), e[4]] for e in rep.schedule],
            "has_energy": rep.energy_in is not None, "rel_err": rep.parseval_rel_err,
            "tol": rep.parseval_tol, "direction": rep.direction}

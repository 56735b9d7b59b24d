"""CPU (gloo) ranks running the port's exchanges, plans and server, for
tests/test_torch_pfft.py, tests/test_torch_engines.py,
tests/test_torch_guard.py, tests/test_torch_many.py,
tests/test_torch_tuner.py, tests/test_torch_bitwise.py (four ranks each),
tests/test_torch_serve.py (two), tests/test_torch_tp.py and
tests/test_torch_tp_attention.py (the LM on meshes of one, two and four
ranks).

The cases and their numpy-seeded inputs are plain data here, so the JAX side
of the comparison (a subprocess with 4 virtual devices) builds the very same
ones.  This module imports no torch at top level and no jax at all.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import zlib
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
#: tests/test_robustness.py without its tuner case, plus an injected compile
#: failure; direction "forward_many" runs the three fields of guard_fields()
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
    "batched_clean": ("strict", "complex64", [], "forward_many"),
}


def guard_fields(x: np.ndarray) -> np.ndarray:
    """The batched_clean case's three fields (tests/test_robustness.py)."""
    return np.stack([x, 2 * x, x - 1])

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


def start(target, out_dir: Path, world: int = WORLD):
    """Start ``target(rank, init_file, out_dir)`` on ``world`` spawned ranks;
    returns a function that waits for them and checks their exit codes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, str(out_dir / "pg"), str(out_dir)))
             for r in range(world)]
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
        assert codes == [0] * world, f"rank exit codes {codes}"

    return join


def _init(rank: int, init_file: str, world: int = WORLD):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))


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
                arg = {"forward": x, "backward": y_ref, "forward_many": guard_fields(x)}
                try:
                    y, rep = getattr(plan, direction)(arg[direction])
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
    return {"raised": False, "ok": rep.ok, "nfields": rep.nfields, "tripped": list(rep.tripped),
            "kinds": [t["kind"] for t in rep.transitions], "attempts": rep.attempts,
            "schedule": [[e[0], e[1], e[2], names.get(e[3], e[3]), e[4]] for e in rep.schedule],
            "has_energy": rep.energy_in is not None, "rel_err": rep.parseval_rel_err,
            "tol": rep.parseval_tol, "direction": rep.direction}


# ---------------------------------------------------------------------------
# batched multi-field execution (tests/test_torch_many.py)
# ---------------------------------------------------------------------------

#: tests/test_batched.py's field shape and field count, on a (2, 2) mesh
MANY_SHAPE = (16, 12, 20)
NFIELDS = 3

#: plan -> (grid, reference PlanConfig fields, transforms): the four plans of
#: tests/test_batched.py (slab c2c, pencil c2c, pencil r2c, pipelined)
MANY_PLANS = {
    "slab": (("p0",), {}, None),
    "pencil": (("p0", "p1"), {}, None),
    "pencil_r2c": (("p0", "p1"), {}, ("c2c", "c2c", "r2c")),
    "pipelined": (("p0", "p1"), {"method": "pipelined", "chunks": 2}, None),
}

BATCH_FUSIONS = ("stacked", "pipelined-across-fields", "per-field")

#: (fusion, comm_dtype) of the pencil plan's forward_many held against the
#: JAX package (lossy wires through the exchange kernels on both sides)
MANY_REFERENCE_CASES = tuple((f, c) for f in ("stacked", "per-field") for c in COMM_DTYPES)

#: (key, layout, transposed_out) of the traditional int8 exchanges of a
#: stacked block held against the JAX package (its plain codec)
TRAD_INT8_CASES = tuple((f"{lay}-tout{int(t)}", lay, t)
                        for lay in ("slab_w_before_v", "pencil_w_after_v") for t in (False, True))

#: (engine, method, options) of the stacked exchange_shard cases
MANY_ENGINES = (("fused", "fused", {}), ("trad", "traditional", {}),
                ("trad_tout", "traditional", {"transposed_out": True}),
                ("pipe2", "pipelined", {"chunks": 2}))


def many_fields(plan_name: str, real: bool) -> np.ndarray:
    """The ``NFIELDS`` global fields a plan's forward_many transforms."""
    rng = np.random.default_rng(500 + list(MANY_PLANS).index(plan_name))
    x = rng.standard_normal((NFIELDS, *MANY_SHAPE)).astype(np.float32)
    if real:
        return x
    return (x + 1j * rng.standard_normal((NFIELDS, *MANY_SHAPE))).astype(np.complex64)


def many_reference_input() -> np.ndarray:
    """The pencil plan's fields held against the JAX package, field 1 a
    thousand times the others (int8 scales must be per field)."""
    x = many_fields("pencil", real=False)
    x[1] *= 1e3
    return x


def stacked_exchange_input(lay: str) -> np.ndarray:
    """``NFIELDS`` stacked fields of a layout, field 1 a thousand times the
    others (int8 scales must be per field)."""
    x = _complex(np.random.default_rng(700 + list(EXCHANGE_LAYOUTS).index(lay)),
                 (NFIELDS, *EXCHANGE_LAYOUTS[lay][2]))
    x[1] *= 1e3
    return x


def many_counts(plan, exchange_stage, fusions=BATCH_FUSIONS) -> dict:
    """The plan's batch-aware counts, keyed the same for both packages:
    ``model_flops``, ``model_collective_launches`` (each field count,
    fusion and direction), and per exchange stage ``exchange_cost_bytes``,
    ``exchange_wire_bytes`` (each payload, field count and slice count) and
    ``pipeline_slices``.  ``exchange_stage`` is the package's class."""
    from importlib import import_module

    red = import_module(type(plan).__module__.replace("pfft", "redistribute"))
    out = {}
    for nf in (1, NFIELDS):
        out[f"flops:{nf}"] = plan.model_flops(nf)
        for fusion in fusions:
            for direction in ("forward", "backward"):
                out[f"launches:{nf}:{fusion}:{direction}"] = plan.model_collective_launches(
                    nfields=nf, batch_fusion=fusion, direction=direction)
    for i, st in enumerate(plan.stages):
        if not isinstance(st, exchange_stage):
            continue
        src = plan.pencil_trace[i]
        out[f"cost:{i}"] = red.exchange_cost_bytes(src, st.v, st.w)
        for chunks in (1, 2, 3, 8):
            out[f"slices:{i}:{chunks}"] = red.pipeline_slices(src, st.v, st.w, chunks=chunks)
        for comm in COMM_DTYPES:
            for nf in (1, NFIELDS):
                for slices in (1, 2):
                    out[f"wire:{i}:{comm}:{nf}:{slices}"] = red.exchange_wire_bytes(
                        src, st.v, st.w, itemsize=8, comm_dtype=comm, nfields=nf,
                        slices=slices)
        for method, chunks in (("fused", 1), ("pipelined", 2)):
            for fusion in fusions:
                out[f"ex_launches:{i}:{method}:{fusion}"] = red.exchange_collective_launches(
                    src, st.v, st.w, method=method, chunks=chunks, nfields=NFIELDS,
                    batch_fusion=fusion)
    return {k: float(v) for k, v in out.items()}


def many_issue_order(mesh, fusion: str) -> str:
    """The host's order of work in one 3-field forward of the pencil plan:
    ``A`` a collective issued, ``W`` a wait on an asynchronous one, ``F``
    a 1-D transform stage called."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import fftcore
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import config_from_reference

    seq = []
    a2a, transform = dist.all_to_all_single, fftcore.local_transform

    class Work:
        def __init__(self, work):
            self.work = work

        def wait(self):
            seq.append("W")
            return self.work.wait()

    def traced_a2a(*args, **kwargs):
        seq.append("A")
        work = a2a(*args, **kwargs)
        return None if work is None else Work(work)

    def traced_transform(*args, **kwargs):
        seq.append("F")
        return transform(*args, **kwargs)

    plan = ParallelFFT(mesh, MANY_SHAPE, ("p0", "p1"),
                       config=config_from_reference({"batch_fusion": fusion}))
    block = torch.zeros((NFIELDS, *plan.input_pencil.local_shape), dtype=torch.complex64)
    dist.all_to_all_single, fftcore.local_transform = traced_a2a, traced_transform
    try:
        plan.forward_many_padded(NFIELDS)(block)
    finally:
        dist.all_to_all_single, fftcore.local_transform = a2a, transform
    return "".join(seq)


def run_many_rank(rank: int, init_file: str, out_dir: str):
    """One rank: the four plans' forward_many/backward_many under every
    batch_fusion against the per-field loop, with every
    ``all_to_all_single`` call counted; the structures forward_many takes;
    stacked exchanges of every engine against the per-field loop; guarded
    batches; the batch-aware counts.  Rank 0 saves the global arrays
    (``many.npz``) and the counts and flags (``many.json``)."""
    from collections import Counter

    import torch
    import torch.distributed as dist

    from repro_torch.core.meshutil import make_mesh
    from repro_torch.core.pencil import (allgather_global, gather_blocks, make_pencil,
                                         scatter_global)
    from repro_torch.core.pfft import ExchangeStage, ParallelFFT
    from repro_torch.core.planconfig import config_from_reference
    from repro_torch.core.redistribute import exchange_shard
    from repro_torch.robustness import FaultPlan, runner

    calls = Counter()
    _count_calls(dist, ("all_to_all_single",), calls)
    _init(rank, init_file)
    try:
        mesh = make_mesh((2, 2), ("p0", "p1"), device="cpu")
        arrays, info = {}, {"counts": {}, "model": {}, "plan_counts": {}}

        def collectives(fn, *args):
            calls.clear()
            out = fn(*args)
            return out, calls["all_to_all_single"]

        for name, (grid, cfg, transforms) in MANY_PLANS.items():
            plans = {f: ParallelFFT(mesh, MANY_SHAPE, grid, transforms=transforms,
                                    config=config_from_reference({**cfg, "batch_fusion": f}))
                     for f in BATCH_FUSIONS}
            base = plans["stacked"]
            x = many_fields(name, real=base.input_dtype == torch.float32)
            loop = torch.stack([base.forward(f) for f in x])
            arrays[f"{name}:loop:fwd"] = loop.numpy()
            arrays[f"{name}:loop:back"] = torch.stack([base.backward(y) for y in loop]).numpy()
            info["plan_counts"][name] = many_counts(base, ExchangeStage)
            for fusion, plan in plans.items():
                y = plan.forward_many(torch.from_numpy(x))
                arrays[f"{name}:{fusion}:fwd"] = y.numpy()
                arrays[f"{name}:{fusion}:back"] = plan.backward_many(loop).numpy()
                for direction, pen, dt in (("forward", plan.input_pencil, plan.input_dtype),
                                           ("backward", plan.output_pencil,
                                            plan.spectral_dtype)):
                    block = torch.zeros((NFIELDS, *pen.local_shape), dtype=dt)
                    fn = getattr(plan, f"{direction}_many_padded")(NFIELDS)
                    _, n = collectives(fn, block)
                    key = f"{name}:{fusion}:{direction}"
                    info["counts"][key] = n
                    info["model"][key] = plan.model_collective_launches(
                        nfields=NFIELDS, direction=direction)
            # one field of the per-field loop issues the stacked count
            _, n = collectives(base.forward_padded,
                               torch.zeros(base.input_pencil.local_shape, dtype=base.input_dtype))
            info["counts"][f"{name}:single:forward"] = n

        info["issue_order"] = {f: many_issue_order(mesh, f) for f in BATCH_FUSIONS}

        # the structures forward_many takes and returns
        plan = ParallelFFT(mesh, MANY_SHAPE, ("p0", "p1"))
        x = many_fields("pencil", real=False)
        stacked = plan.forward_many(x)
        as_dict = plan.forward_many({"u": x[0], "v": x[1], "w": x[2]})
        as_list = plan.forward_many([x[0], x[1], x[2]])
        as_tuple = plan.backward_many(tuple(stacked.unbind(0)))
        info["structures"] = {
            "dict_keys": list(as_dict),
            "dict_equal": all(torch.equal(as_dict[k], stacked[i]) for i, k in
                              enumerate(("u", "v", "w"))),
            "list": type(as_list).__name__,
            "list_equal": all(torch.equal(a, b) for a, b in zip(as_list, stacked)),
            "tuple": type(as_tuple).__name__,
            "tuple_equal": all(torch.equal(a, b) for a, b in
                               zip(as_tuple, plan.backward_many(stacked))),
            "forward_routes": torch.equal(plan.forward(x), stacked),
            "backward_routes": torch.equal(plan.backward(stacked), plan.backward_many(stacked)),
            "one_field": torch.equal(plan.forward_many(x[:1])[0], plan.forward(x[0])),
        }
        arrays["structures:stacked"] = stacked.numpy()
        pen = plan.input_pencil
        qs = make_pencil(mesh, QS_SHAPE, ("p0", "p1", None))
        xq = np.stack([inputs()["quickstart"]] * 2)
        info["structures"]["gather_nbatch"] = bool(np.array_equal(
            gather_blocks([scatter_global(xq, qs, r, nbatch=1) for r in range(WORLD)], qs,
                          nbatch=1), xq))
        info["structures"]["allgather_nbatch"] = bool(np.array_equal(
            allgather_global(scatter_global(xq, qs, rank, nbatch=1), qs, nbatch=1).numpy(), xq))

        # the pencil plan against the reference: forward_many, lossy wires
        # through the exchange kernels (their plain versions here)
        xr = many_reference_input()
        for fusion, comm in MANY_REFERENCE_CASES:
            p = ParallelFFT(mesh, MANY_SHAPE, ("p0", "p1"), config=config_from_reference(
                {"batch_fusion": fusion, "comm_dtype": comm, "exchange_impl": "pallas"}))
            arrays[f"ref:{fusion}:{comm}"] = p.forward_many(xr).numpy()
            if comm == "int8":  # scale collectives ride beside the payload's
                _, n = collectives(p.forward_many_padded(NFIELDS),
                                   torch.zeros((NFIELDS, *pen.local_shape), dtype=torch.complex64))
                info["counts"][f"int8:{fusion}"] = n
                info["model"][f"int8:{fusion}"] = p.model_collective_launches(nfields=NFIELDS)

        # stacked exchanges of every engine against the per-field loop
        for lay in EXCHANGE_LAYOUTS:
            mshape, names, fshape, placement, v, w = EXCHANGE_LAYOUTS[lay]
            m = mesh if mshape == (2, 2) else make_mesh(mshape, names, device="cpu")
            pin = make_pencil(m, fshape, placement)
            xs = stacked_exchange_input(lay)
            block = scatter_global(xs, pin, rank, nbatch=1)
            arrays[f"ex:{lay}:input"] = xs
            for eng, method, opts in MANY_ENGINES:
                for impl in ("torch", "cuda"):
                    for comm in COMM_DTYPES:
                        kw = dict(mesh=m, method=method, comm_dtype=comm, impl=impl, **opts)
                        got = exchange_shard(block, v, w, placement[w], nbatch=1, **kw)
                        field_axis = 1 if opts.get("transposed_out") else 0
                        want = torch.stack([exchange_shard(f, v, w, placement[w], **kw)
                                            for f in block.unbind(0)], dim=field_axis)
                        lossless = torch.stack(
                            [exchange_shard(f, v, w, placement[w],
                                            **{**kw, "comm_dtype": "complex64"})
                             for f in block.unbind(0)], dim=field_axis)
                        key = f"ex:{lay}:{eng}:{impl}:{comm}"
                        info.setdefault("exchange", {})[key] = {
                            "shape": list(got.shape), "want_shape": list(want.shape),
                            "equal_loop": torch.equal(got, want),
                            "rel_vs_lossless": [
                                float(torch.linalg.vector_norm(g - e) / torch.linalg.vector_norm(e))
                                for g, e in zip(got.unbind(field_axis),
                                                lossless.unbind(field_axis))]}
            for key, tlay, tout in TRAD_INT8_CASES:
                if tlay == lay:  # the global result (per rank: its block)
                    y = exchange_shard(block, v, w, placement[w], mesh=m, method="traditional",
                                       comm_dtype="int8", nbatch=1, impl="torch",
                                       transposed_out=tout)
                    gathered = [torch.empty_like(y) for _ in range(WORLD)]
                    dist.all_gather(gathered, y.contiguous())
                    arrays[f"trad_int8:{key}"] = torch.stack(gathered).numpy()

        # guarded batches: strict clean equals the unguarded run; a bf16 wire
        # corrupted under degrade ends ok after degrading
        gx = many_fields("pencil", real=False)
        strict = ParallelFFT(mesh, MANY_SHAPE, ("p0", "p1"),
                             config=config_from_reference({"guard": "strict"}))
        ys, rep = strict.forward_many(gx)
        info["guard_strict"] = {"ok": rep.ok, "nfields": rep.nfields,
                                "equal_unguarded": torch.equal(ys, plan.forward_many(gx))}
        for fusion in BATCH_FUSIONS:
            deg = ParallelFFT(mesh, MANY_SHAPE, ("p0", "p1"), config=config_from_reference(
                {"guard": "degrade", "comm_dtype": "bf16", "batch_fusion": fusion}))
            with FaultPlan().corrupt_wire(engine="fused", codec="bf16"):
                yd, rep = deg.forward_many(gx)
            info[f"guard_degrade:{fusion}"] = {
                "ok": rep.ok, "nfields": rep.nfields,
                "kinds": [t["kind"] for t in rep.transitions],
                "schedule": [list(e) for e in rep.schedule],
                "rel": float(torch.linalg.vector_norm(yd - ys) / torch.linalg.vector_norm(ys))}
        forced = (("traditional", 1, "complex64", "torch", "per-field"),) * strict.n_exchanges
        block = scatter_global(torch.from_numpy(gx), strict.input_pencil, rank, nbatch=1)
        yf, rep = runner.run_guarded(strict, block, "forward", NFIELDS, schedule=forced)
        info["guard_forced"] = {
            "ok": rep.ok, "nfields": rep.nfields, "schedule": [list(e) for e in rep.schedule],
            "equal": torch.equal(allgather_global(yf, strict.output_pencil, nbatch=1), ys)}
        info["warm"] = [strict.warm(nfields=NFIELDS), plan.warm(("forward",), nfields=NFIELDS)]
        if rank == 0:
            np.savez(Path(out_dir) / "many.npz", **arrays)
            (Path(out_dir) / "many.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the schedule tuner (tests/test_torch_tuner.py)
# ---------------------------------------------------------------------------

#: the port's exchange implementation names -> the reference's
REFERENCE_IMPLS = {"torch": "jnp", "cuda": "pallas"}


class StandInMesh:
    """The attributes of a ``DeviceMesh`` a plan's arithmetic reads, for a
    mesh of any shape in one process (no process group)."""

    device_type = "cpu"

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]

#: the plans of tests/test_pfft.py:17-42 by name: (mesh shape, mesh names,
#: shape, grid, transforms), with the composed slab also out of mesh order
MODEL_PLANS = {
    "slab": ((2, 4), ("p0", "p1"), (16, 12, 20), ("p0",), None),
    "slab_composed": ((2, 4), ("p0", "p1"), (16, 12, 20), (("p0", "p1"),), None),
    "slab_composed_reversed": ((2, 4), ("p0", "p1"), (16, 12, 20), (("p1", "p0"),), None),
    "pencil": ((2, 4), ("p0", "p1"), (16, 12, 20), ("p0", "p1"), None),
    "pencil_r2c": ((2, 4), ("p0", "p1"), (16, 12, 20), ("p0", "p1"), ("c2c", "c2c", "r2c")),
    "nondiv": ((2, 4), ("p0", "p1"), (13, 9, 11), ("p0", "p1"), None),
    "nondiv_r2c": ((2, 4), ("p0", "p1"), (13, 9, 11), ("p0", "p1"), ("c2c", "c2c", "r2c")),
    "4d_on_2d": ((2, 4), ("p0", "p1"), (8, 6, 10, 12), ("p0", "p1"), None),
    "4d_on_3d": ((2, 2, 2), ("a", "b", "c"), (8, 8, 8, 8), ("a", "b", "c"), None),
}

#: coefficients both packages' models are priced at (passed explicitly)
MODEL_COEFFS = {"peak_flops": 1.1e13, "ici_bw": 3.3e11, "hbm_bw": 2.2e12, "ici_latency_s": 7e-6}

#: the overlap seconds passed to exchange_time_model
MODEL_OVERLAP_S = 1e-4

#: (budget, reference exchange_impl) of the candidate sets compared
CANDIDATE_BUDGETS = tuple((b, i) for b in ("complex64", "bf16", "int8") for i in ("jnp", "pallas"))


def as_reference_rows(schedule) -> list[list]:
    """Schedule rows with the reference's implementation names."""
    return [[e[0], int(e[1]), e[2], REFERENCE_IMPLS.get(e[3], e[3]), e[4]] for e in schedule]


def fake_stage_seconds(si, method, chunks, comm_dtype, impl="jnp", batch_fusion="stacked", *,
                       repeats=None, inner=None, nfields=1) -> float:
    """A deterministic stand-in for the tuner's ``_time_stage(plan, si,
    ...)`` (the plan dropped): the same seconds in both packages, the
    implementation read by its reference name."""
    tag = "@".join(map(str, (si, method, chunks, comm_dtype, REFERENCE_IMPLS.get(impl, impl),
                             batch_fusion, nfields)))
    return 1e-3 * (1.0 + (zlib.crc32(tag.encode()) % 1000) / 1000.0)


def model_numbers(plan, exchange_stage, candidates) -> dict:
    """The plan's priced models, keyed the same for both packages:
    ``model_time_s`` of each candidate as the uniform schedule (both
    directions, 1 and 3 fields, and exchanges only), ``exchange_time_model``
    of each exchange stage under each candidate, and ``comm_bytes_per_device``
    for each payload, engine, itemsize and field count.  ``candidates`` are
    the package's ``batched_candidates_for("int8", <kernels>)``, in order."""
    from importlib import import_module

    red = import_module(type(plan).__module__.replace("pfft", "redistribute"))
    out = {}
    n = plan.n_exchanges
    for c, e in enumerate(candidates):
        for nf in (1, 3):
            for direction in ("forward", "backward"):
                out[f"time:{c}:{nf}:{direction}"] = plan.model_time_s(
                    schedule=(e,) * n, direction=direction, nfields=nf, **MODEL_COEFFS)
            out[f"time_ex:{c}:{nf}"] = plan.model_time_s(schedule=(e,) * n, nfields=nf,
                                                         exchange_only=True, **MODEL_COEFFS)
            for i, st in enumerate(plan.stages):
                if isinstance(st, exchange_stage):
                    out[f"ex:{c}:{i}:{nf}"] = red.exchange_time_model(
                        plan.pencil_trace[i], st.v, st.w, itemsize=plan._stage_itemsize(i),
                        method=e.method, chunks=e.chunks, comm_dtype=e.comm_dtype,
                        impl=e.impl, nfields=nf, batch_fusion=e.batch_fusion,
                        overlap_compute_s=MODEL_OVERLAP_S, **{k: v for k, v in MODEL_COEFFS.items()
                                                              if k != "peak_flops"})
    for nf in (1, 3):
        for comm in (None, "complex64", "bf16", "int8"):
            for method in (None, "fused", "traditional", "pipelined"):
                for isz in (None, 8):
                    out[f"bytes:{nf}:{comm}:{method}:{isz}"] = plan.comm_bytes_per_device(
                        isz, method=method, comm_dtype=comm, nfields=nf)
    return {k: float(v) for k, v in out.items()}


#: the tuned plan of the ranks: tests/test_robustness.py's guard plan
TUNE_SHAPE = GUARD_SHAPE


def rank_skewed_seconds(rank: int):
    """A stand-in ``_time_stage`` under which each rank alone would pick a
    different lossless engine: candidate i of 5 takes 1 + ((i + rank) % 5)
    / 10 seconds, so rank r's own fastest is (5 - r) % 5; the slowest
    rank's times make candidate 0 (fused) the winner on every rank."""
    order = [("fused", 1), ("traditional", 1), ("pipelined", 2), ("pipelined", 4),
             ("pipelined", 8)]

    def fake(plan, si, method, chunks, *args, **kwargs):
        i = order.index((method, chunks))
        return 1.0 + ((i + rank) % 5) / 10.0

    return fake


def run_tune_rank(rank: int, init_file: str, out_dir: str):
    """One rank: the tuned lossless plan (the cache it leaves, its forward
    and ``forward_many`` against the explicit plan under its schedule), a
    replay from the cache, the int8 budget, stale and corrupt caches, a
    rank-skewed stand-in timer, and the poisoned entry under a compile
    fault; with the ``_time_stage`` calls and cache writes of each.  Each
    rank saves its outcomes (``tune<rank>.json``), rank 0 the global
    arrays (``tune.npz``)."""
    from collections import Counter

    import torch
    import torch.distributed as dist

    from repro_torch.core import tuner
    from repro_torch.core.meshutil import make_mesh
    from repro_torch.core.pencil import allgather_global, scatter_global
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.robustness import FaultPlan

    calls = Counter()
    _count_calls(tuner, ("_time_stage", "save_cache"), calls)
    _init(rank, init_file)
    try:
        mesh = make_mesh((2, 2), ("p0", "p1"), device="cpu")
        out, arrays = {}, {}
        x = inputs()["guard"]
        d = Path(out_dir)
        cache = d / "tune.json"

        def auto(path=cache, **kw):
            return ParallelFFT(mesh, TUNE_SHAPE, ("p0", "p1"),
                               config=PlanConfig(method="auto", tuner_cache=str(path), **kw))

        def resolved(plan, nfields=1):
            calls.clear()
            sched = plan.batched_schedule(nfields)
            return {"schedule": [list(e) for e in sched], "time_stage": calls["_time_stage"],
                    "saves": calls["save_cache"]}

        def entry(path, plan, nfields=1):
            """Rank 0's disk entry of the plan (None elsewhere)."""
            return tuner.load_cache(path).get(tuner.plan_key(plan, nfields=nfields)) \
                if rank == 0 else None

        # the lossless budget: tune, then run against the explicit plan
        plan = auto()
        out["tuned"] = resolved(plan)
        out["tuned"]["entry"] = entry(cache, plan)
        out["tuned"]["key"] = tuner.plan_key(plan)
        explicit = ParallelFFT(mesh, TUNE_SHAPE, ("p0", "p1"))
        sched = plan.schedule
        block = scatter_global(torch.from_numpy(x), explicit.input_pencil, rank)
        want = allgather_global(explicit._execute(block, "forward", sched, guard=False),
                                explicit.output_pencil)
        y = plan.forward(x)
        out["tuned"]["forward_equal"] = torch.equal(y, want)
        arrays["auto_forward"] = y.numpy()
        xs = guard_fields(x)
        out["batched"] = resolved(plan, NFIELDS)
        bsched = plan.batched_schedule(NFIELDS)
        stacked = scatter_global(torch.from_numpy(xs), explicit.input_pencil, rank, nbatch=1)
        want = allgather_global(explicit._execute(stacked, "forward", bsched, guard=False,
                                                  nbatch=1), explicit.output_pencil, nbatch=1)
        ym = plan.forward_many(xs)
        out["batched"]["forward_many_equal"] = torch.equal(ym, want)
        arrays["auto_forward_many"] = ym.numpy()
        out["warm"] = plan.warm(nfields=NFIELDS)

        # a second plan with the same key replays from the cache: no timing
        tuner._MEMO.clear()
        again = auto()
        out["replay"] = resolved(again)
        out["replay"]["forward_equal"] = torch.equal(again.forward(x), y)

        # the int8 budget, and its replay
        p8 = auto(comm_dtype="int8")
        out["int8"] = resolved(p8)
        out["int8"]["entry"] = entry(cache, p8)
        tuner._MEMO.clear()
        out["int8_replay"] = resolved(auto(comm_dtype="int8"))

        # stale or corrupt caches are ignored and rewritten, never raised on
        stale = d / "stale.json"
        key = tuner.plan_key(plan)
        payloads = ["{ not json", "[1, 2, 3]",
                    json.dumps({'{"schema": 3, "mesh": []}': {
                        "schedule": [["fused", 1, "complex64"]], "timings": {}}})]
        bad_entries = ["garbage", {"schedule": "garbage"}, {"schedule": [["x"]]},
                       {"schedule": [["fused", 1, "complex64"]]},
                       {"schedule": [["bogus", 1, "complex64"], ["fused", 1, "complex64"]]},
                       {"schedule": [["fused", 1, "float8"], ["fused", 1, "complex64"]]},
                       {"schedule": [["pipelined", 16, "complex64"], ["fused", 1, "complex64"]]},
                       {"schedule": [["fused", 1, "int8"], ["fused", 1, "complex64"]]}]
        out["stale"] = []
        for text in payloads + [json.dumps({key: e}) for e in bad_entries]:
            if rank == 0:
                stale.write_text(text)
            tuner._MEMO.clear()
            got = resolved(auto(stale))
            got["entry"] = entry(stale, plan)
            out["stale"].append(got)

        # a rank-skewed timer: the ranks still agree on one winner
        tuner._STAGE_MEMO.clear()
        real, tuner._time_stage = tuner._time_stage, rank_skewed_seconds(rank)
        try:
            skewed = d / "skewed.json"
            out["skewed"] = resolved(auto(skewed))
            out["skewed"]["entry"] = entry(skewed, plan)
        finally:
            tuner._time_stage = real

        # the reference's poison_auto case (tests/test_robustness.py)
        poisoned_cache = d / "poisoned.json"
        p = auto(poisoned_cache, guard="degrade")
        poisoned = (("pipelined", 2, "complex64", "torch", "stacked"),) * p.n_exchanges
        if rank == 0:
            FaultPlan.poison_cache(poisoned_cache, p, poisoned)
        y_ref = explicit.forward(x)
        with FaultPlan().fail_compile(engine="pipelined"):
            yp, rep = p.forward(x)
        disk = tuner.load_cache(poisoned_cache)
        out["poison_auto"] = {
            "ok": rep.ok, "kinds": [t["kind"] for t in rep.transitions],
            "rel": float(torch.linalg.vector_norm(yp - y_ref) / torch.linalg.vector_norm(y_ref)),
            "quarantines": [e.get("quarantines") for e in disk.values()
                            if isinstance(e, dict) and e.get("quarantines")],
            "fired": sorted({f["kind"] for f in rep.fired_faults}),
            "schedule": [list(e) for e in rep.schedule]}
        dist.barrier()
        (d / f"tune{rank}.json").write_text(json.dumps(out))
        if rank == 0:
            np.savez(d / "tune.npz", **arrays)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the bitwise contracts (tests/test_torch_bitwise.py)
# ---------------------------------------------------------------------------

#: plan -> (global shape, grid, transform tags or specs): the pruned plans,
#: the r2c plans with odd trailing extents, the 4-D plan and the DCT/DST
#: plans of tests/test_pfft.py and tests/test_transforms.py
BITWISE_PLANS = {
    "pruned": ((12, 12, 12), ("p0", "p1"), (("pruned", 8),) * 3),
    "pruned_r2c": ((12, 12, 12), ("p0", "p1"), (("pruned", 8), ("pruned", 8), ("r2c", 5))),
    "r2c_12_10_9": ((12, 10, 9), ("p0", "p1"), ("c2c", "c2c", "r2c")),
    "r2c_8_6_11": ((8, 6, 11), ("p0", "p1"), ("c2c", "c2c", "r2c")),
    "r2c_8_6_11_slab": ((8, 6, 11), ("p0",), ("c2c", "c2c", "r2c")),
    "c2c_4d": ((8, 6, 10, 12), ("p0", "p1"), None),
    "dct2": ((16, 12, 20), ("p0", "p1"), ("dct2", "dct2", "dct2")),
    "dst2": ((16, 12, 20), ("p0", "p1"), ("dst2", "dst2", "dst2")),
    "dct3_dst3_dct2": ((16, 12, 20), ("p0", "p1"), ("dct3", "dst3", "dct2")),
    "dct2_c2c_r2c": ((16, 12, 20), ("p0", "p1"), ("dct2", "c2c", "r2c")),
    "c2c_r2c_dst2": ((16, 12, 20), ("p0", "p1"), ("c2c", "r2c", "dst2")),
}

BITWISE_IMPLS = ("torch", "matmul")

#: pipelined chunk counts held bitwise against the fused engine
BITWISE_CHUNKS = (2, 3, 4)


def bitwise_transforms(tags):
    """The TransformSpecs of a BITWISE_PLANS entry (None: all c2c)."""
    from repro_torch.core.fftcore import TransformSpec, as_spec

    if tags is None:
        return None
    out = []
    for t in tags:
        if isinstance(t, tuple):
            kind, keep = t
            out.append(TransformSpec.pruned(keep) if kind == "pruned"
                       else TransformSpec.r2c(n_keep=keep))
        else:
            out.append(as_spec(t))
    return tuple(out)


def bitwise_fields(name: str, real: bool) -> np.ndarray:
    """Two global fields of a BITWISE_PLANS plan."""
    shape = BITWISE_PLANS[name][0]
    rng = np.random.default_rng(900 + list(BITWISE_PLANS).index(name))
    if real:
        return rng.standard_normal((2, *shape)).astype(np.float32)
    return _complex(rng, (2, *shape))


def run_bitwise_rank(rank: int, init_file: str, out_dir: str):
    """One rank: each plan under each FFT impl, forward and backward, the
    lossless traditional and pipelined engines against the fused one, and
    two-field forward_many/backward_many under every batch_fusion (lossless
    and int8) against the per-field loop; rank 0 saves, per comparison,
    whether it is bitwise equal (``bitwise.json``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.meshutil import make_mesh
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig

    torch.set_num_threads(1)  # four ranks share the host's cores
    _init(rank, init_file)
    try:
        mesh = make_mesh((2, 2), ("p0", "p1"), device="cpu")
        out = {}
        for name, (shape, grid, tags) in BITWISE_PLANS.items():
            transforms = bitwise_transforms(tags)
            for impl in BITWISE_IMPLS:
                def plan(**kw):
                    return ParallelFFT(mesh, shape, grid, transforms=transforms,
                                       config=PlanConfig(impl=impl, **kw))

                fused = plan(method="fused")
                x = bitwise_fields(name, real=fused.input_dtype == torch.float32)
                y = fused.forward(x[0])
                b = fused.backward(y)
                eng = {"traditional": plan(method="traditional")}
                eng.update({f"pipelined{c}": plan(method="pipelined", chunks=c)
                            for c in BITWISE_CHUNKS})
                for ename, p in eng.items():
                    out[f"{name}:{impl}:engine:{ename}"] = (torch.equal(p.forward(x[0]), y)
                                                            and torch.equal(p.backward(y), b))
                for comm in ("complex64", "int8"):
                    base = plan(comm_dtype=comm)
                    loop_f = torch.stack([base.forward(f) for f in x])
                    loop_b = torch.stack([base.backward(f) for f in loop_f])
                    for fusion in BATCH_FUSIONS:
                        p = plan(comm_dtype=comm, batch_fusion=fusion)
                        out[f"{name}:{impl}:many:{comm}:{fusion}"] = (
                            torch.equal(p.forward_many(x), loop_f)
                            and torch.equal(p.backward_many(loop_f), loop_b))
        if rank == 0:
            (Path(out_dir) / "bitwise.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the spectral server (tests/test_torch_serve.py)
# ---------------------------------------------------------------------------

SERVE_WORLD = 2
SERVE_SHAPE = (16, 16, 16)

#: the LRU case's request shapes, one at a time through a capacity-1 registry
SERVE_LRU_SHAPES = ((16, 16, 16), (8, 16, 16), (16, 16, 16))

#: the soak's deadline and grace (tests/test_serve.py)
SOAK_DEADLINE, SOAK_GRACE = 120.0, 5.0


def serve_inputs() -> dict[str, np.ndarray]:
    """The clean case's five fields and the LRU case's three, float32."""
    rng = np.random.default_rng(0)
    out = {f"clean{i}": rng.standard_normal(SERVE_SHAPE).astype(np.float32) for i in range(5)}
    for i, shape in enumerate(SERVE_LRU_SHAPES):
        out[f"lru{i}"] = rng.standard_normal(shape).astype(np.float32)
    return out


def _serve(rank, mesh, grid, pc, sc, fault, make_fields):
    """One server over ``mesh`` with ``fault`` armed on this rank.  Rank 0
    asks the load harness's burst factor, submits each wave of fields that
    ``make_fields(burst)`` lists (a wave's results are awaited before the
    next is submitted) and returns the outcomes, the stats and the fired
    faults; the other ranks follow and return None."""
    from repro_torch.robustness import FaultPlan, faults
    from repro_torch.serve import SpectralServer

    fp = fault if fault is not None else FaultPlan()
    with fp:
        burst = 1 if rank else faults.serve_burst()
        with SpectralServer(mesh, grid, plan_config=pc, config=sc) as srv:
            if rank:
                srv.follow()
                return None
            waves = make_fields(burst)
            outs = []
            for wave in waves:
                futs = [srv.submit(x) for x in wave]
                outs += [f.result(grace=sc.grace_s) for f in futs]
            stats = srv.stats()
    return outs, stats, list(fp.fired)


class _StageFault:
    """While active on an ``armed`` rank, the next staging of a group's
    fields there (rank 0's cast to the device, another rank's receiving
    block) raises once, as running out of device memory would."""

    def __init__(self, armed: bool):
        self.armed = armed

    def __enter__(self):
        from repro_torch.serve.engine import SpectralServer

        real, left = SpectralServer._stage, [int(self.armed)]

        def stage(*args):
            if left[0]:
                left[0] -= 1
                raise RuntimeError("out of device memory (injected while staging)")
            return real(*args)

        self._real = real
        SpectralServer._stage = staticmethod(stage)
        return self

    def __exit__(self, *exc):
        from repro_torch.serve.engine import SpectralServer

        SpectralServer._stage = staticmethod(self._real)


def _summary(outs, stats) -> dict:
    return {"statuses": [o.status for o in outs], "trips": [o.trip for o in outs],
            "retries": [o.retries for o in outs], "batched": [o.batched for o in outs],
            "latency": [o.latency_s for o in outs], "stats": stats}


def run_serve_rank(rank: int, init_file: str, out_dir: str):
    """One of two ranks: the engine cases of tests/test_serve.py (clean
    coalescing, LRU eviction, overload shed, breaker, crash retry) and the
    soak's waves, each a fresh server over a slab of both ranks; rank 0
    saves the outcomes (``serve.json``) and the served spectra beside the
    plain plan's forward of each field (``serve.npz``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import tuner
    from repro_torch.core.meshutil import make_mesh
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.robustness import FaultPlan
    from repro_torch.serve import OUTCOME_STATUSES, ServeConfig

    torch.set_num_threads(1)
    _init(rank, init_file, world=SERVE_WORLD)
    try:
        mesh, grid = make_mesh((SERVE_WORLD,), ("p0",), device="cpu"), ("p0",)
        data = serve_inputs()
        info, arrays = {}, {}
        degrade = PlanConfig(method="fused", guard="degrade")

        # clean coalescing: five same-shape requests
        xs = [data[f"clean{i}"] for i in range(5)]
        res = _serve(rank, mesh, grid, degrade, ServeConfig(deadline_s=120.0, max_batch=8),
                     None, lambda _: [xs])
        plain = ParallelFFT(mesh, SERVE_SHAPE, grid, config=PlanConfig(method="fused"))
        want = [plain.forward(x) for x in xs]
        if res is not None:
            outs, stats, _ = res
            info["clean"] = _summary(outs, stats)
            info["clean"]["bitwise_plan_forward"] = [torch.equal(o.value, w)
                                                     for o, w in zip(outs, want)]
            for i, o in enumerate(outs):
                arrays[f"clean{i}"] = o.value.numpy()

        # LRU eviction: capacity 1, three shapes in turn
        lru = [[data[f"lru{i}"]] for i in range(len(SERVE_LRU_SHAPES))]
        res = _serve(rank, mesh, grid, degrade, ServeConfig(deadline_s=120.0, capacity=1),
                     None, lambda _: lru)
        want = [ParallelFFT(mesh, s, grid, config=PlanConfig(method="fused")).forward(x[0])
                for s, x in zip(SERVE_LRU_SHAPES, lru)]
        if res is not None:
            outs, stats, _ = res
            info["lru"] = _summary(outs, stats)
            info["lru"]["shapes"] = [list(o.value.shape) for o in outs]
            info["lru"]["bitwise_plan_forward"] = [torch.equal(o.value, w)
                                                   for o, w in zip(outs, want)]
            for i, o in enumerate(outs):
                arrays[f"lru{i}"] = o.value.numpy()

        x = data["clean0"]
        # overload: a 4x burst against a queue of 2 while each dispatch stalls
        res = _serve(rank, mesh, grid, degrade,
                     ServeConfig(deadline_s=120.0, max_queue=2, max_batch=1),
                     FaultPlan().slow_collective(seconds=0.4, times=100)
                     .request_burst(factor=4, times=1), lambda burst: [[x] * (2 * burst)])
        if res is not None:
            outs, stats, fired = res
            info["shed"] = _summary(outs, stats)
            info["shed"]["burst"] = sum(f["kind"] == "request_burst" for f in fired) * 4

        # breaker: persistent bf16 wire corruption on a strict plan
        strict = PlanConfig(method="fused", comm_dtype="bf16", guard="strict")
        sc = ServeConfig(deadline_s=120.0, breaker_threshold=2, breaker_cooldown_s=60.0,
                         max_retries=0, grace_s=5.0)
        res = _serve(rank, mesh, grid, strict, sc, FaultPlan().corrupt_wire(codec="bf16"),
                     lambda _: [[x]] * 4)
        clean = plain.forward(x)
        if res is not None:
            outs, stats, _ = res
            info["breaker"] = _summary(outs, stats)
            info["breaker"]["rel_vs_lossless"] = [
                float(torch.linalg.vector_norm(o.value - clean) / torch.linalg.vector_norm(clean))
                for o in outs]

        # a crash that fires once, after a stall: one retry recovers
        res = _serve(rank, mesh, grid, degrade,
                     ServeConfig(deadline_s=120.0, backoff_base_s=0.01),
                     FaultPlan().executor_crash(times=1).slow_collective(seconds=0.05, times=2),
                     lambda _: [[x]])
        if res is not None:
            outs, stats, _ = res
            info["crash"] = _summary(outs, stats)
            info["crash"]["bitwise_plan_forward"] = torch.equal(outs[0].value, clean)

        # staging a group's fields fails on one rank alone: every rank leaves
        # the group, rank 0 resolves it an error, the next group is served
        info["stage_fault"] = {}
        for faulty in range(SERVE_WORLD):
            with _StageFault(rank == faulty):
                res = _serve(rank, mesh, grid, degrade, ServeConfig(deadline_s=120.0), None,
                             lambda _: [[x], [x]])
            if res is not None:
                outs, stats, _ = res
                info["stage_fault"][str(faulty)] = {
                    **_summary(outs, stats), "errors": [o.error for o in outs],
                    "bitwise_plan_forward": torch.equal(outs[1].value, clean)}

        # the chaos soak: fresh servers per wave over one schedule cache
        cache = str(Path(out_dir) / "soak_cache.json")
        auto = PlanConfig(method="auto", comm_dtype="bf16", guard="degrade", tuner_cache=cache)
        strict_auto = auto.replace(guard="strict")
        gen = np.random.default_rng(1)

        def poison():
            # a well-formed bf16 entry the tuner never timed, so that the
            # strict wave's primary schedule meets the bf16 wire fault;
            # every rank drops its memo of the key
            probe = ParallelFFT(mesh, SERVE_SHAPE, grid, config=strict_auto)
            if rank == 0:
                FaultPlan.poison_cache(cache, probe, [("fused", 1, "bf16", "torch", "stacked")])
            tuner.forget(tuner.plan_key(probe))

        waves = [
            ("clean", auto, None, 4, 4, None),
            ("transient", auto, FaultPlan().executor_crash(times=1)
             .slow_collective(seconds=0.05, times=2), 4, 4, None),
            ("corrupt-degrade", auto, FaultPlan().corrupt_wire(codec="bf16"), 3, 4, None),
            ("breaker-strict", strict_auto, FaultPlan().corrupt_wire(codec="bf16"), 4, 1,
             poison),
            ("cache-corruption-burst", auto, FaultPlan().cache_corruption(mode="garbage", times=1)
             .request_burst(factor=2, times=1), 3, 4, None),
        ]
        soak, trips = {}, 0
        for name, pc, fp, n, mb, setup in waves:
            if setup is not None:
                setup()
            sc = ServeConfig(deadline_s=SOAK_DEADLINE, grace_s=SOAK_GRACE, max_batch=mb,
                             max_queue=16, backoff_base_s=0.01, breaker_threshold=2,
                             breaker_cooldown_s=60.0)
            fields = [gen.standard_normal(SERVE_SHAPE).astype(np.float32) for _ in range(2 * n)]
            res = _serve(rank, mesh, grid, pc, sc, fp, lambda burst: [fields[:n * burst]])
            if res is None:
                continue
            outs, stats, fired = res
            trips += stats["registry"]["breaker_trips"]
            soak[name] = {
                "n": len(outs), "statuses": [o.status for o in outs],
                "trips": [o.trip for o in outs], "unresolved": sum(o is None for o in outs),
                "bad_status": [o.status for o in outs if o.status not in OUTCOME_STATUSES],
                "over_deadline": [o.latency_s for o in outs
                                  if o.latency_s > SOAK_DEADLINE + SOAK_GRACE + 1.0],
                "errors": stats["error"], "breaker_trips": stats["registry"]["breaker_trips"],
                "retunes": stats["retunes"], "fired": len(fired)}
        if rank == 0:
            disk = tuner.load_cache(cache)
            info["soak"] = {"waves": soak, "total_breaker_trips": trips,
                            "total_quarantines": sum(v.get("quarantines", 0) for v in disk.values()
                                                     if isinstance(v, dict)),
                            "cache_well_formed": bool(disk)}
            (Path(out_dir) / "serve.json").write_text(json.dumps(info))
            np.savez(Path(out_dir) / "serve.npz", **arrays)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# composed groups and plan-level parity (tests/test_torch_composed.py)
# ---------------------------------------------------------------------------

COMPOSED_WORLD = 8

#: the (2, 4) mesh of tests/test_pfft.py and tests/test_redistribute.py
MESH_2D = ((2, 4), ("p0", "p1"))

#: the (2, 2, 2) mesh of tests/test_pfft.py:37-42 and tests/test_redistribute.py:197-215
MESH_3D = ((2, 2, 2), ("a", "b", "c"))

#: a composed slab group in mesh order and out of it (JAX's index of the
#: device at (c_p0, c_p1) is c_p1 * 2 + c_p0 for the second)
COMPOSED_GROUPS = {"p0p1": ("p0", "p1"), "p1p0": ("p1", "p0")}

#: the composed slab exchange of tests/test_redistribute.py:17-40,55-70:
#: (global shape, placement with the group at axis 1, divisors, v, w)
COMPOSED_EXCHANGE = ((16, 12, 10), (8, 8, 1), 0, 1)

#: every engine the composed exchange runs under
COMPOSED_ENGINES = {"fused": ("fused", {}), **ENGINES}

#: tests/test_redistribute.py:197-215: (shape, placement, divisors), v=2 -> w=1
#: and back
ROUNDTRIP_3D = ((8, 8, 8), (("a", "b"), "c", None), (4, 4, 4))

#: the composed slab plans against the reference: reference PlanConfig fields
COMPOSED_PLAN_SHAPE = (16, 12, 20)
COMPOSED_PLAN_CONFIGS = {
    "default": {"method": "fused"},
    "traditional": {"method": "traditional"},
    "pipelined": {"method": "pipelined", "chunks": 3},
    "slice": PLAN_CONFIGS["slice"],
}


def composed_placement(group: str) -> tuple:
    return (None, COMPOSED_GROUPS[group], None)


def composed_exchange_cases() -> list[tuple[str, str, str, str]]:
    """``(key, group, engine, comm_dtype)`` of every composed exchange."""
    return [(f"{g}-{eng}-{comm}", g, eng, comm)
            for g in COMPOSED_GROUPS for eng in COMPOSED_ENGINES for comm in COMM_DTYPES]


def composed_inputs() -> dict[str, np.ndarray]:
    """The composed exchange's field (logical shape), the round trip's real
    field and the composed plans' field."""
    rng = np.random.default_rng(1100)
    return {"exchange": _complex(rng, COMPOSED_EXCHANGE[0]),
            "roundtrip": rng.standard_normal(ROUNDTRIP_3D[0]).astype(np.float32),
            "plan": _complex(rng, COMPOSED_PLAN_SHAPE)}


def padded(x: np.ndarray, divisors) -> np.ndarray:
    """``x`` zero-padded to a multiple of ``divisors`` on every axis (a
    pencil's physical extents, which the JAX side shards)."""
    pads = [(0, -n % d) for n, d in zip(x.shape, divisors)]
    return np.pad(x, pads)


#: plan-level parity against numpy/scipy oracles.  name -> (mesh, shape,
#: grid, transforms, kind): the matrix of tests/test_pfft.py:17-42 (the
#: composed slab also out of mesh order), its 4-D plan on (2, 2, 2), the odd
#: r2c extents of :169-200 and the plans of tests/test_transforms.py:149-266.
#: ``kind`` names the oracle: "fftn" (forward vs np.fft.fftn/rfftn and the
#: round trip), "odd_r2c" (also the backward of np.fft.rfftn), "scipy" (the
#: scipy composition), "pruned" and "pruned_r2c" (the dealias checks)
_TRIG_CASES = (("dct2", "dct2", "dct2"), ("dst2", "dst2", "dst2"), ("dct3", "dst3", "dct2"),
               ("dct2", "c2c", "r2c"), ("c2c", "r2c", "dst2"))
_GRIDS = {"slab": ("p0",), "pencil": ("p0", "p1")}
PRUNE_N, PRUNE_M = 8, 12  # fftcore.dealias_grid(8)
PARITY_PLANS = {
    "slab": ("2d", (16, 12, 20), ("p0",), None, "fftn"),
    "pencil": ("2d", (16, 12, 20), ("p0", "p1"), None, "fftn"),
    "slab_composed": ("2d", (16, 12, 20), (("p0", "p1"),), None, "fftn"),
    "slab_composed_reversed": ("2d", (16, 12, 20), (("p1", "p0"),), None, "fftn"),
    "pencil_r2c": ("2d", (16, 12, 20), ("p0", "p1"), ("c2c", "c2c", "r2c"), "fftn"),
    "nondiv": ("2d", (13, 9, 11), ("p0", "p1"), None, "fftn"),
    "nondiv_r2c": ("2d", (13, 9, 11), ("p0", "p1"), ("c2c", "c2c", "r2c"), "fftn"),
    "4d_on_2d": ("2d", (8, 6, 10, 12), ("p0", "p1"), None, "fftn"),
    "4d_on_3d": ("3d", (8, 8, 8, 8), ("a", "b", "c"), None, "fftn"),
    **{f"odd_r2c_{'_'.join(map(str, s))}_{g}": ("2d", s, grid, ("c2c", "c2c", "r2c"), "odd_r2c")
       for s in ((8, 6, 11), (12, 10, 9), (13, 9, 7)) for g, grid in _GRIDS.items()},
    **{f"{'_'.join(t)}_{g}": ("2d", (16, 12, 20), grid, t, "scipy")
       for g, grid in _GRIDS.items() for t in _TRIG_CASES},
    **{f"pruned_{g}": ("2d", (PRUNE_M,) * 3, grid, (("pruned", PRUNE_N),) * 3, "pruned")
       for g, grid in _GRIDS.items()},
    **{f"pruned_r2c_{g}": ("2d", (PRUNE_M,) * 3, grid,
                           (("pruned", PRUNE_N), ("pruned", PRUNE_N), ("r2c", PRUNE_N // 2 + 1)),
                           "pruned_r2c")
       for g, grid in _GRIDS.items()},
}

#: (engine, method, options) each parity plan runs under
PARITY_ENGINES = (("fused", "fused", {}), ("traditional", "traditional", {}),
                  ("pipelined", "pipelined", {"chunks": 3}))


def parity_inputs(name: str) -> dict[str, np.ndarray]:
    """A parity plan's seeded inputs: ``x`` (real where the plan's first
    transform is real-to-something) and, for the pruned plan, a spectrum
    ``s`` of the retained modes."""
    mesh, shape, grid, tags, kind = PARITY_PLANS[name]
    rng = np.random.default_rng(1200 + list(PARITY_PLANS).index(name))
    real = tags is not None and kind != "pruned"
    out = {"x": rng.standard_normal(shape).astype(np.float32) if real else _complex(rng, shape)}
    if kind == "pruned":
        out["s"] = _complex(rng, (PRUNE_N,) * 3)
    return out


def run_composed_rank(rank: int, init_file: str, out_dir: str):
    """One of eight ranks: the composed exchanges (each rank's output block),
    the composed round trip on (2, 2, 2), each rank's input block of every
    composed pencil, the composed slab plans, an auto plan under a
    stand-in timer, ``forward_many`` under every ``batch_fusion``, guarded
    plans and a ``PlanRegistry`` over a composed grid (``composed<rank>.npz``
    and ``composed<rank>.json``); then every parity plan under each engine
    and wire (rank 0: ``parity.npz``)."""
    from collections import Counter

    import torch
    import torch.distributed as dist

    from repro_torch.core import tuner
    from repro_torch.core.meshutil import make_mesh
    from repro_torch.core.pencil import allgather_global, make_pencil, scatter_global
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig, config_from_reference
    from repro_torch.core.redistribute import exchange_shard
    from repro_torch.robustness import FaultPlan
    from repro_torch.serve.registry import PlanRegistry

    torch.set_num_threads(1)  # eight ranks share the host's cores
    calls = Counter()
    _count_calls(dist, ("all_to_all_single",), calls)
    _init(rank, init_file, world=COMPOSED_WORLD)
    try:
        d = Path(out_dir)
        mesh = make_mesh(*MESH_2D, device="cpu")
        mesh3 = make_mesh(*MESH_3D, device="cpu")
        data = composed_inputs()
        res, info = {}, {}

        # the composed slab exchanges: each rank's block, every engine and wire
        shape, divisors, v, w = COMPOSED_EXCHANGE
        for g in COMPOSED_GROUPS:
            pin = make_pencil(mesh, shape, composed_placement(g), divisors=divisors)
            block = scatter_global(data["exchange"], pin, rank)
            res[f"block:{g}"] = block.numpy()
            for key, grp, eng, comm in composed_exchange_cases():
                if grp != g:
                    continue
                method, opts = COMPOSED_ENGINES[eng]
                y, st = exchange_shard(block, v, w, COMPOSED_GROUPS[g], mesh=mesh, method=method,
                                       comm_dtype=comm, impl="cuda", guard=True, **opts)
                res[key] = y.numpy()
                res[key + ":stats"] = np.array([float(st["nonfinite"]), float(st["saturated"])])

        # the round trip of a composed pencil on (2, 2, 2), every engine
        rshape, rplace, rdiv = ROUNDTRIP_3D
        src = make_pencil(mesh3, rshape, rplace, divisors=rdiv)
        block = scatter_global(data["roundtrip"], src, rank)
        res["roundtrip:block"] = block.numpy()
        for eng, method, opts in PARITY_ENGINES:
            y = exchange_shard(block, 2, 1, rplace[1], mesh=mesh3, method=method, **opts)
            z = exchange_shard(y, 1, 2, rplace[1], mesh=mesh3, method=method, **opts)
            res[f"roundtrip:{eng}:mid"] = y.numpy()
            info[f"roundtrip:{eng}"] = torch.equal(z, block)

        # the composed slab plans
        u = data["plan"]
        for g, grp in COMPOSED_GROUPS.items():
            for name, cfg in COMPOSED_PLAN_CONFIGS.items():
                plan = ParallelFFT(mesh, COMPOSED_PLAN_SHAPE, (grp,),
                                   config=config_from_reference(cfg))
                uh = plan.forward(u)
                res[f"plan:{g}:{name}:fwd"] = uh.numpy()
                res[f"plan:{g}:{name}:back"] = plan.backward(uh).numpy()
                res[f"plan:{g}:{name}:block"] = scatter_global(u, plan.input_pencil, rank).numpy()

        # an auto plan under a stand-in timer, its cache and its replay
        timed = Counter()

        def stand_in(plan, *args, **kwargs):
            timed["calls"] += 1
            return fake_stage_seconds(*args, **kwargs)

        real_time_stage, tuner._time_stage = tuner._time_stage, stand_in
        try:
            for g, grp in COMPOSED_GROUPS.items():
                cache = d / f"tune_{g}.json"

                def auto(cache=cache, grp=grp):
                    return ParallelFFT(mesh, COMPOSED_PLAN_SHAPE, (grp,), config=PlanConfig(
                        method="auto", comm_dtype="int8", exchange_impl="cuda",
                        tuner_cache=str(cache)))

                plan = auto()
                sched = plan.schedule
                explicit = ParallelFFT(mesh, COMPOSED_PLAN_SHAPE, (grp,))
                block = scatter_global(u, explicit.input_pencil, rank)
                want = allgather_global(explicit._execute(block, "forward", sched, guard=False),
                                        explicit.output_pencil)
                tuner._MEMO.clear()
                timed.clear()
                again = auto()
                info[f"auto:{g}"] = {
                    "schedule": as_reference_rows(sched), "key": tuner.plan_key(plan),
                    "forward_equal": torch.equal(plan.forward(u), want),
                    "replay_schedule": as_reference_rows(again.schedule),
                    "replay_timed": timed["calls"],
                    "entry": bool(tuner.load_cache(cache).get(tuner.plan_key(plan)))
                    if rank == 0 else None}
        finally:
            tuner._time_stage = real_time_stage
            tuner._MEMO.clear()
            tuner._STAGE_MEMO.clear()

        # forward_many / backward_many under every batch_fusion, lossless and
        # int8, against the per-field loop; the collectives of each call
        xs = np.stack([u, 2 * u, u - 1])
        for g, grp in COMPOSED_GROUPS.items():
            for comm in ("complex64", "int8"):
                base = ParallelFFT(mesh, COMPOSED_PLAN_SHAPE, (grp,),
                                   config=PlanConfig(comm_dtype=comm, exchange_impl="cuda"))
                loop_f = torch.stack([base.forward(f) for f in xs])
                loop_b = torch.stack([base.backward(f) for f in loop_f])
                for fusion in BATCH_FUSIONS:
                    p = ParallelFFT(mesh, COMPOSED_PLAN_SHAPE, (grp,), config=PlanConfig(
                        comm_dtype=comm, exchange_impl="cuda", batch_fusion=fusion))
                    blk = torch.zeros((NFIELDS, *p.input_pencil.local_shape),
                                      dtype=torch.complex64)
                    calls.clear()
                    p.forward_many_padded(NFIELDS)(blk)
                    n = calls["all_to_all_single"]
                    info[f"many:{g}:{comm}:{fusion}"] = {
                        "equal_loop": torch.equal(p.forward_many(xs), loop_f)
                        and torch.equal(p.backward_many(loop_f), loop_b),
                        "collectives": n,
                        "model": p.model_collective_launches(nfields=NFIELDS)
                        * (2 if comm == "int8" else 1)}

        # guarded plans: strict clean equals the unguarded forward; a bf16
        # wire corrupted under degrade ends ok after degrading
        for g, grp in COMPOSED_GROUPS.items():
            plain = ParallelFFT(mesh, COMPOSED_PLAN_SHAPE, (grp,))
            want = plain.forward(u)
            strict = ParallelFFT(mesh, COMPOSED_PLAN_SHAPE, (grp,),
                                 config=PlanConfig(guard="strict"))
            ys, rep = strict.forward(u)
            deg = ParallelFFT(mesh, COMPOSED_PLAN_SHAPE, (grp,), config=PlanConfig(
                guard="degrade", comm_dtype="bf16", exchange_impl="cuda"))
            with FaultPlan().corrupt_wire(engine="fused", codec="bf16"):
                yd, rep_d = deg.forward(u)
            info[f"guard:{g}"] = {
                "strict_ok": rep.ok, "strict_equal": torch.equal(ys, want),
                "degrade_ok": rep_d.ok, "kinds": [t["kind"] for t in rep_d.transitions],
                "degrade_rel": float(torch.linalg.vector_norm(yd - want)
                                     / torch.linalg.vector_norm(want))}

        # a PlanRegistry over a composed grid
        for g, grp in COMPOSED_GROUPS.items():
            reg = PlanRegistry(mesh, (grp,), config=PlanConfig())
            key, plan = reg.get(COMPOSED_PLAN_SHAPE)
            again_key, again = reg.get(COMPOSED_PLAN_SHAPE)
            direct = ParallelFFT(mesh, COMPOSED_PLAN_SHAPE, (grp,))
            info[f"registry:{g}"] = {
                "key_equal": key == tuner.plan_key(direct) == again_key,
                "same_plan": again is plan, "builds": reg.builds,
                "grid": [list(x) for x in plan.grid],
                "forward_equal": torch.equal(plan.forward(u), direct.forward(u))}

        np.savez(d / f"composed{rank}.npz", **res)
        (d / f"composed{rank}.json").write_text(json.dumps(info))

        # plan-level parity: every plan under each engine and wire
        meshes = {"2d": mesh, "3d": mesh3}
        arrays = {}
        for name, (mkey, shape, grid, tags, kind) in PARITY_PLANS.items():
            inp = parity_inputs(name)
            x = inp["x"]
            for eng, method, opts in PARITY_ENGINES:
                for comm in COMM_DTYPES:
                    plan = ParallelFFT(meshes[mkey], shape, grid,
                                       transforms=bitwise_transforms(tags),
                                       config=PlanConfig(method=method, comm_dtype=comm,
                                                         exchange_impl="cuda", **opts))
                    pre = f"{name}|{eng}|{comm}|"
                    y = plan.forward(x)
                    out = {"fwd": y, "back": plan.backward(y)}
                    if kind == "odd_r2c":
                        out["back_np"] = plan.backward(
                            torch.from_numpy(np.fft.rfftn(x).astype(np.complex64)))
                    if kind == "pruned":
                        out["rt"] = plan.forward(plan.backward(torch.from_numpy(inp["s"])))
                    if kind == "pruned_r2c":
                        s = y.clone()
                        s[PRUNE_N // 2, :, :] = 0
                        s[:, PRUNE_N // 2, :] = 0
                        out["s"] = s
                        out["rt"] = plan.forward(plan.backward(s))
                    if rank == 0:
                        for k, a in out.items():
                            arrays[pre + k] = a.numpy()
        if rank == 0:
            np.savez(d / "parity.npz", **arrays)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# LM serving across ranks (tests/test_torch_tp.py)
# ---------------------------------------------------------------------------

#: ("data", "model") meshes of the comparison with the reference
TP_MESHES = ((1, 2), (1, 4), (2, 2))
TP_ARCHS = ("glm4_9b", "phi35_moe_42b")
#: Phi-3.5-MoE's smoke config with DeepSeek's structure (without MLA): two
#: shared experts beside the routed ones and one leading dense block
TP_SHARED = "phi35_moe_42b+shared"
TP_VARIANTS = {TP_SHARED: ("phi35_moe_42b", {"n_shared": 2, "first_k_dense": 1})}
#: (layers, of which with experts, shared experts) of each smoke LM
TP_LAYERS = {"glm4_9b": (2, 0, 0), "phi35_moe_42b": (2, 2, 0), TP_SHARED: (2, 1, 1)}
TP_B, TP_S = 2, 8
#: a prompt length no mesh's tp divides: the MoE prefill takes the local path
TP_S_ODD = 7
#: the (dtype, optimized flags) of each mesh's runs of both archs, so that
#: each arch meets all four pairs and each mesh both dtypes
TP_FLAGS = {(1, 2): (("float32", False), ("bfloat16", True)),
            (1, 4): (("float32", True), ("bfloat16", False)),
            (2, 2): (("float32", True), ("bfloat16", True))}
#: the MoE's capacity factor in fp32: Phi-3.5-MoE's own 1.25, which drops
#: assignments at these sizes (the smoke config's 8.0 drops none, and bf16
#: keeps it: a bf16 router margin may fall apart in the two packages)
TP_CAPACITY_FP32 = 1.25
#: the frontend rows (the VLM's embeddings, the audio encoder's frames) of
#: each smoke config's run on (1, 4) in ``run_tp_rank``'s family sweep
TP_BUILD_FRONTEND = 4
#: tests/test_moe.py's (1, 4) layer: (E, k, d_ff, D, B, S), and the
#: (path, capacity factor) cases run on it
TP_MOE_DIMS = (8, 2, 16, 12, 2, 8)
TP_MOE_CASES = (("a2a", 8.0), ("a2a", 1.0), ("local", 8.0))
#: the serve_lm run on the (2, 2) mesh
TP_SERVE_ARGV = ["--arch", "phi35_moe_42b", "--preset", "smoke", "--device", "cpu", "--opt",
                 "--model-parallel", "2", "--batch", "2", "--prompt-len", "8", "--gen", "3"]


def tp_cases(mesh_shape) -> list[tuple[str, str, bool, int]]:
    """(arch, dtype, optimized, S) of a mesh's runs; the shared-experts
    variant on the meshes of tp 4 and of two data ranks."""
    cases = [(arch, dt, opt, TP_S) for arch in TP_ARCHS for dt, opt in TP_FLAGS[mesh_shape]]
    if mesh_shape != (1, 2):
        cases.append((TP_SHARED, "float32", True, TP_S))
    return cases + [("phi35_moe_42b", "float32", True, TP_S_ODD)]


def tp_key(arch, dtype, opt, S) -> str:
    return f"{arch}:{dtype}:{'opt' if opt else 'base'}:{S}"


def tp_config(configs, arch: str, dtype: str):
    """The smoke config of ``arch`` (or of a ``TP_VARIANTS`` key) from
    ``configs`` (either package's) at ``dtype``, its MoE at
    ``TP_CAPACITY_FP32`` in fp32."""
    import dataclasses

    base, moe = TP_VARIANTS.get(arch, (arch, {}))
    cfg = dataclasses.replace(configs.smoke(base), dtype=dtype)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    if cfg.moe is not None and dtype == "float32":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=TP_CAPACITY_FP32))
    return cfg


def tp_tokens(S: int) -> np.ndarray:
    """(TP_B, S + 3) token ids: the prompt and 3 teacher-forced ones."""
    return np.random.default_rng(11 + S).integers(0, 256, (TP_B, S + 3)).astype(np.int64)


def tp_make_weights(path) -> None:
    """Numpy-seeded fp32 weights of each ``TP_ARCHS`` smoke LM, keyed
    ``arch:<the port's state-dict key>`` (per layer, as the port holds them;
    the reference's side stacks the layers), and tests/test_moe.py's (1, 4)
    layer (``moe:router``, ``moe:w_gate``, ... and its input ``moe:x``),
    saved to the npz ``path``.  Norm weights lie around 1 and biases around
    0; a matrix (or expert stack) is normal over the square root of its
    input dim, the embedding normal.  Each side rounds to its config's dtype."""
    from repro_torch import configs
    from repro_torch.models import lm

    rng, arrays = np.random.default_rng(7), {}
    for arch in TP_LAYERS:
        _seeded_state(rng, lm.LM(tp_config(configs, arch, "float32"), device="cpu"), arch,
                      arrays)
    E, k, ff, D, B, S = TP_MOE_DIMS
    for name, shape in (("router", (D, E)), ("w_gate", (E, D, ff)), ("w_up", (E, D, ff)),
                        ("w_down", (E, ff, D))):
        arrays["moe:" + name] = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    arrays["moe:x"] = rng.standard_normal((B, S, D)).astype(np.float32)
    np.savez(path, **arrays)


def _seeded_state(rng, model, arch: str, arrays: dict) -> None:
    """``model``'s state dict drawn from ``rng`` into ``arrays`` under
    ``arch:<key>``: norm weights around 1 and biases around 0 (MLA's
    ``kv_norm`` too), a matrix (or expert stack) normal over the square root
    of its input dim, the embedding normal."""
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        x = rng.standard_normal(shape).astype(np.float32)
        if key.endswith((".w", ".b", ".kv_norm")):  # a norm's weight or bias
            x = (key.endswith((".w", ".kv_norm")) + 0.1 * x).astype(np.float32)
        elif key != "embed":
            x /= np.float32(np.sqrt(shape[-2]))
        arrays[f"{arch}:{key}"] = x


def tp_weights(weights, arch: str) -> dict:
    """The port's state dict of ``arch`` out of ``tp_make_weights``' npz
    (numpy fp32 arrays)."""
    pre = arch + ":"
    return {key[len(pre):]: weights[key] for key in weights.files if key.startswith(pre)}


def run_tp_rank(rank: int, init_file: str, out_dir: str, mesh_shape=(1, 4)):
    """One rank of a ``mesh_shape`` mesh: every ``tp_cases`` run of the LM
    (``tp_make_weights``' from ``out_dir/../weights.npz``: prefill, cache, 3
    call, each expert-parallel send), the weights' slices, every smoke
    config built on (1, 4) with a prefill and a decode step, the MoE layer
    cases on (1, 4), ``serve_lm`` on (2, 2), and at one rank the sharded LM
    against the mesh-less one bit for bit.  Writes
    ``tp{rank}.npz`` and ``tp{rank}.json`` to ``out_dir``."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the meshes' ranks share the host's cores
    from repro_torch import configs
    from repro_torch.launch import serve_lm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, moe, sharding
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.convert import shard_params

    world = mesh_shape[0] * mesh_shape[1]
    _init(rank, init_file, world)
    d = Path(out_dir)
    weights = np.load(d.parent / "weights.npz")
    try:
        mesh = make_host_mesh(mesh_shape[1], device="cpu")
        shard = sharding.Shard(mesh)
        sends, real_a2a = [], dist.all_to_all_single

        def logged(output, inp, *args, **kw):
            # whether the sent tensor is the dispatch buffer's prefix (E cap
            # rows of its E cap + 1): no pack copy before the collective
            base = inp._base
            sends.append(base is not None and inp.data_ptr() == base.data_ptr()
                         and tuple(base.shape) == (inp.shape[0] + 1, *inp.shape[1:]))
            return real_a2a(output, inp, *args, **kw)

        dist.all_to_all_single = logged
        arrays, info = {}, {"coord": [shard.drank, shard.rank], "cases": {}}

        if world == 1:
            info["world1"] = _tp_world_one(torch, lm, moe, sharding, configs, MoEConfig, mesh,
                                           shard)
        for arch, dtype, opt, S in ([] if world == 1 else tp_cases(mesh_shape)):
            key = tp_key(arch, dtype, opt, S)
            cfg = tp_config(configs, arch, dtype)
            port = lm.LM(cfg, mesh=mesh, q_block=4, perf=lm.OPTIMIZED if opt else lm.PerfFlags(),
                         device="cpu")
            full = {k: torch.from_numpy(a) for k, a in tp_weights(weights, arch).items()}
            port.load_state_dict(shard_params(cfg, full, mesh), strict=True)
            toks = torch.from_numpy(tp_tokens(S))
            moe.assignments.clear()
            sharding.collectives.clear()
            sends.clear()
            cache, lg = port.prefill({"tokens": toks[:, :S]}, max_len=S + 3)
            case = {"counts": [dict(sharding.collectives)], "sends": list(sends),
                    "dropped": int(moe.assignments["dropped"]),
                    "want": [dict(port.collectives_per_call(TP_B, S)),
                             dict(port.collectives_per_call(TP_B))]}
            logits = [lg[:, 0]]
            for t in range(3):
                sharding.collectives.clear()
                cache, lg = port.decode_step(cache, toks[:, S + t], S + t)
                case["counts"].append(dict(sharding.collectives))
                logits.append(lg)
            info["cases"][key] = case
            arrays["lg:" + key] = torch.stack(logits).float().numpy()
            for kv in ("k", "v"):
                arrays[kv + ":" + key] = cache["blocks"][kv].float().numpy()

        if world > 1:
            info["weights"] = {}
            for arch in TP_LAYERS:
                cfg = tp_config(configs, arch, "bfloat16")
                whole = lm.LM(cfg, q_block=4, device="cpu", seed=5)
                mine = lm.LM(cfg, mesh=mesh, q_block=4, device="cpu", seed=5).state_dict()
                cut = shard_params(cfg, whole.state_dict(), mesh)
                moved = whole.sharded(mesh).state_dict()
                info["weights"][arch] = (set(mine) == set(cut) == set(moved) and all(
                    torch.equal(mine[k], cut[k]) and torch.equal(mine[k], moved[k])
                    for k in mine))
        if mesh_shape == (1, 4):
            info["builds"] = {arch: _tp_build(torch, lm, sharding, configs, arch, mesh)
                              for arch in configs.ARCH_NAMES}
            E, k, ff, D, B, S = TP_MOE_DIMS
            for path, cf in TP_MOE_CASES:
                cfg = MoEConfig(n_experts=E, top_k=k, d_ff_expert=ff, capacity_factor=cf)
                p = {n: sharding.take(torch.from_numpy(weights["moe:" + n]),
                                      0 if n != "router" else None, shard.rank, shard.tp)
                     for n in ("router", "w_gate", "w_up", "w_down")}
                x = torch.from_numpy(weights["moe:x"])
                moe.assignments.clear()
                if path == "a2a":
                    y, _, _ = moe.moe_apply_a2a(p, x, shard, cfg=cfg, mlp_kind="swiglu")
                else:
                    y, _, _ = moe.moe_apply_local(p, x, cfg=cfg, mlp_kind="swiglu", shard=shard)
                arrays[f"moe:{path}:{cf}"] = y.numpy()
                info[f"moe_dropped:{path}:{cf}"] = int(moe.assignments["dropped"])
        if mesh_shape == (2, 2):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                res = serve_lm.main(TP_SERVE_ARGV)
            info["serve"] = {"lines": out.getvalue().splitlines(), "ids": res.ids.tolist(),
                             "vocab_padded": res.lm.vocab_padded,
                             "mesh": [res.lm.shard.dp, res.lm.shard.tp]}
        np.savez(d / f"tp{rank}.npz", **arrays)
        (d / f"tp{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


def _tp_build(torch, lm, sharding, configs, arch: str, mesh) -> dict:
    """``arch``'s smoke LM (bf16, the optimized flags) built on ``mesh``: a
    prefill of ``TP_S`` tokens (after ``TP_BUILD_FRONTEND`` frontend rows
    where the family takes them) and one decode step, each call's
    collectives by kind beside ``LM.collectives_per_call``'s, and whether
    the logits are finite."""
    cfg = configs.smoke(arch)
    port = lm.LM(cfg, mesh=mesh, q_block=4, perf=lm.OPTIMIZED, device="cpu")
    toks = torch.from_numpy(tp_tokens(TP_S))
    batch = {"tokens": toks[:, :TP_S]}
    F = TP_BUILD_FRONTEND if cfg.family in ("vlm", "audio") else 0
    if F:
        batch["frontend"] = torch.randn((TP_B, F, cfg.d_model),
                                        generator=torch.Generator().manual_seed(3))
    M = (F if cfg.family == "vlm" else 0) + TP_S  # the cache positions of the prompt
    sharding.collectives.clear()
    cache, lg = port.prefill(batch, max_len=M + 1)
    counts = [dict(sharding.collectives)]
    sharding.collectives.clear()
    lg2 = port.decode_step(cache, toks[:, TP_S], M)[1]
    counts.append(dict(sharding.collectives))
    want = [dict(port.collectives_per_call(TP_B, M)), dict(port.collectives_per_call(TP_B))]
    return {"family": cfg.family, "counts": counts, "want": want,
            "finite": bool(torch.isfinite(lg).all() and torch.isfinite(lg2).all())}


def _tp_world_one(torch, lm, moe, sharding, configs, MoEConfig, mesh, shard) -> dict:
    """At one rank: each arch's sharded LM (``LM.sharded``, the very
    tensors) against the mesh-less one (a prefill, 3 greedy decode steps:
    logits, ids and every cache leaf bit for bit), and the MoE paths with
    the shard against those without."""
    out = {}
    for arch in TP_LAYERS:
        whole = lm.LM(tp_config(configs, arch, "bfloat16"), q_block=4, perf=lm.OPTIMIZED,
                      device="cpu", seed=2)
        par = whole.sharded(mesh)
        shared = all(a.data_ptr() == b.data_ptr()
                     for a, b in zip(whole.parameters(), par.parameters()))
        toks = torch.from_numpy(tp_tokens(TP_S)[:, :TP_S])
        runs = []
        for m in (whole, par):
            cache, lg = m.prefill({"tokens": toks}, max_len=TP_S + 3)
            logits, tok = [lg], lg[:, -1].argmax(-1)
            ids = [tok]
            for t in range(3):
                cache, lg = m.decode_step(cache, tok, TP_S + t)
                tok = lg.argmax(-1)
                logits.append(lg)
                ids.append(tok)
            runs.append((logits, ids, cache))
        (la, ia, ca), (lb, ib, cb) = runs
        out[arch] = {"shares_tensors": shared,
                     "logits": all(torch.equal(a, b) for a, b in zip(la, lb)),
                     "ids": all(torch.equal(a, b) for a, b in zip(ia, ib)),
                     "cache": all(torch.equal(ca[g][k], cb[g][k]) for g in ca for k in ca[g])}
    gen = torch.Generator().manual_seed(0)
    E, k, ff, D, B, S = TP_MOE_DIMS
    cfg = MoEConfig(n_experts=E, top_k=k, d_ff_expert=ff, capacity_factor=1.0)
    p = moe.moe_init(gen, D, cfg, "swiglu", torch.bfloat16)
    x = torch.randn((B, S, D), generator=gen).to(torch.bfloat16)
    out["moe"] = {
        "a2a": torch.equal(moe.moe_apply_a2a(p, x, shard, cfg=cfg, mlp_kind="swiglu")[0],
                           moe.moe_apply_capacity(p, x, cfg=cfg, mlp_kind="swiglu")[0]),
        "local": torch.equal(moe.moe_apply_local(p, x, cfg=cfg, mlp_kind="swiglu",
                                                 shard=shard)[0],
                             moe.moe_apply_local(p, x, cfg=cfg, mlp_kind="swiglu")[0])}
    return out


# ---------------------------------------------------------------------------
# The attention families across ranks (tests/test_torch_tp_attention.py)
# ---------------------------------------------------------------------------

#: LLaVA-NeXT's smoke config with LLaVA's own GQA group of 7 (14 q heads
#: over 2 kv heads): on two ranks each holds one whole group
TPA_G7 = "llava_next_34b+g7"
TPA_VARIANTS = {TPA_G7: ("llava_next_34b", {"n_heads": 14, "n_kv_heads": 2})}
TPA_ARCHS = ("deepseek_v2_lite_16b", "llava_next_34b", "seamless_m4t_medium")
#: each mesh's runs, (arch, dtype, optimized flags): each arch meets both
#: dtypes and both flag sets, each mesh both dtypes; the audio run on (1, 4)
#: holds TPA_SE = 6 frames in blocks of 2, so that rank 3 holds padding alone
TPA_CASES = {
    (1, 2): (("deepseek_v2_lite_16b", "float32", False), ("llava_next_34b", "bfloat16", True),
             ("seamless_m4t_medium", "float32", True), (TPA_G7, "float32", True)),
    (1, 4): (("deepseek_v2_lite_16b", "bfloat16", True), ("llava_next_34b", "float32", False),
             ("seamless_m4t_medium", "bfloat16", False)),
    (2, 2): (("deepseek_v2_lite_16b", "float32", True), ("llava_next_34b", "float32", True),
             ("seamless_m4t_medium", "bfloat16", True)),
}
#: batch, prompt, the VLM's frontend rows and the audio encoder's frames
TPA_B, TPA_S, TPA_F, TPA_SE = 2, 8, 4, 6
#: the serve_lm runs on the (2, 2) mesh, by arch
TPA_SERVE_ARGV = {arch: ["--arch", arch, "--preset", "smoke", "--device", "cpu", "--opt",
                         "--model-parallel", "2", "--batch", "2", "--prompt-len", "6",
                         "--gen", "3"]
                  for arch in ("llava_next_34b", "seamless_m4t_medium")}


def tpa_config(configs, arch: str, dtype: str):
    """The smoke config of ``arch`` (or of a ``TPA_VARIANTS`` key) from
    ``configs`` (either package's) at ``dtype``."""
    import dataclasses

    base, kw = TPA_VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(configs.smoke(base), dtype=dtype, **kw)


def tpa_key(arch, dtype, opt) -> str:
    return f"{arch}:{dtype}:{'opt' if opt else 'base'}"


def tpa_front(arch: str) -> int:
    """The cache positions before the prompt's: the VLM's frontend rows."""
    return TPA_F if arch.startswith("llava") else 0


def tpa_frontend(arch: str) -> np.ndarray | None:
    """(TPA_B, F or Se, 64) fp32 frontend of the VLM (its embeddings) or the
    audio family (its frames), numpy-seeded; None for MLA."""
    if arch.startswith("deepseek"):
        return None
    n = TPA_SE if arch.startswith("seamless") else TPA_F
    return np.random.default_rng(23 + n).standard_normal((TPA_B, n, 64)).astype(np.float32)


def tpa_make_weights(path) -> None:
    """Numpy-seeded fp32 weights of each smoke LM of ``TPA_CASES``, keyed
    ``arch:<the port's state-dict key>`` as ``tp_make_weights``' are."""
    from repro_torch import configs
    from repro_torch.models import lm

    rng, arrays = np.random.default_rng(17), {}
    for arch in (*TPA_ARCHS, TPA_G7):
        _seeded_state(rng, lm.LM(tpa_config(configs, arch, "float32"), device="cpu"), arch,
                      arrays)
    np.savez(path, **arrays)


def tpa_leaves(cache) -> dict:
    """A cache's leaves by path (``blocks.k``, ``dense0.ckv``, ``ck``, ...)."""
    out = {}
    for key, t in cache.items():
        if isinstance(t, dict):
            out.update({f"{key}.{k}": v for k, v in t.items()})
        else:
            out[key] = t
    return out


def _tpa_steps(torch, sharding, port, arch: str, absorbed: bool = True):
    """A prefill of ``arch``'s prompt and frontend (max_len F + S + 3) and 3
    teacher-forced decode steps (MLA's in the ``absorbed`` form) of the LM
    ``port``: (logits (4, B, V) fp32, the cache after them, the collectives
    of each call by kind)."""
    F = tpa_front(arch)
    toks = torch.from_numpy(tp_tokens(TPA_S))
    batch = {"tokens": toks[:, :TPA_S]}
    if tpa_frontend(arch) is not None:
        batch["frontend"] = torch.from_numpy(tpa_frontend(arch))
    sharding.collectives.clear()
    cache, lg = port.prefill(batch, max_len=F + TPA_S + 3)
    counts, logits = [dict(sharding.collectives)], [lg[:, 0]]
    for t in range(3):
        sharding.collectives.clear()
        cache, lg = port.decode_step(cache, toks[:, TPA_S + t], F + TPA_S + t, absorbed=absorbed)
        counts.append(dict(sharding.collectives))
        logits.append(lg)
    return torch.stack(logits).float(), cache, counts


def run_tpa_rank(rank: int, init_file: str, out_dir: str, mesh_shape=(1, 4)):
    """One rank of a ``mesh_shape`` mesh: every ``TPA_CASES`` run
    (``tpa_make_weights``' from ``out_dir/../weights.npz``: the prefill, 3
    teacher-forced decode steps, the cache after them and the collectives
    by call; MLA's expanded decode beside the mesh-less LM's), the weights'
    slices, ``serve_lm`` on (2, 2), and at one rank each sharded LM against
    the mesh-less one bit for bit.  Writes ``tpa{rank}.npz`` and
    ``tpa{rank}.json`` to ``out_dir``."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the meshes' ranks share the host's cores
    from repro_torch import configs
    from repro_torch.launch import serve_lm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, sharding
    from repro_torch.models.convert import shard_params

    world = mesh_shape[0] * mesh_shape[1]
    _init(rank, init_file, world)
    d = Path(out_dir)
    weights = np.load(d.parent / "weights.npz")
    try:
        mesh = make_host_mesh(mesh_shape[1], device="cpu")
        shard = sharding.Shard(mesh)
        arrays, info = {}, {"coord": [shard.drank, shard.rank], "cases": {}}
        if world == 1:
            info["world1"] = _tpa_world_one(torch, lm, sharding, configs, mesh)
        for arch, dtype, opt in TPA_CASES.get(mesh_shape, ()):
            key = tpa_key(arch, dtype, opt)
            cfg = tpa_config(configs, arch, dtype)
            perf = lm.OPTIMIZED if opt else lm.PerfFlags()
            full = {k: torch.from_numpy(a) for k, a in tp_weights(weights, arch).items()}
            port = lm.LM(cfg, mesh=mesh, q_block=4, perf=perf, device="cpu")
            port.load_state_dict(shard_params(cfg, full, mesh), strict=True)
            logits, cache, counts = _tpa_steps(torch, sharding, port, arch)
            F = tpa_front(arch)
            case = {"counts": counts,
                    "want": [dict(port.collectives_per_call(TPA_B, F + TPA_S)),
                             dict(port.collectives_per_call(TPA_B))]}
            arrays["lg:" + key] = logits.numpy()
            for path, t in tpa_leaves(cache).items():
                arrays[f"{path}:{key}"] = t.float().numpy()
            if cfg.mla is not None:  # the expanded step, beside the mesh-less LM's
                exp_lg, _, exp_counts = _tpa_steps(torch, sharding, port, arch, absorbed=False)
                whole = lm.LM(cfg, q_block=4, perf=perf, device="cpu")
                whole.load_state_dict(full, strict=True)
                arrays["expanded:" + key] = exp_lg.numpy()
                arrays["expanded_meshless:" + key] = _tpa_steps(
                    torch, sharding, whole, arch, absorbed=False)[0].numpy()
                case["expanded_counts"] = exp_counts[1:]
                case["expanded_want"] = dict(port.collectives_per_call(TPA_B, absorbed=False))
            info["cases"][key] = case
        if world > 1:
            info["weights"] = {}
            for arch in TPA_ARCHS:
                cfg = tpa_config(configs, arch, "bfloat16")
                whole = lm.LM(cfg, q_block=4, device="cpu", seed=5)
                mine = lm.LM(cfg, mesh=mesh, q_block=4, device="cpu", seed=5).state_dict()
                cut = shard_params(cfg, whole.state_dict(), mesh)
                moved = whole.sharded(mesh).state_dict()
                info["weights"][arch] = (set(mine) == set(cut) == set(moved) and all(
                    torch.equal(mine[k], cut[k]) and torch.equal(mine[k], moved[k])
                    for k in mine))
        if mesh_shape == (2, 2):
            info["serve"] = {}
            for arch, argv in TPA_SERVE_ARGV.items():
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    res = serve_lm.main(argv)
                info["serve"][arch] = {"lines": out.getvalue().splitlines(),
                                       "ids": res.ids.tolist(),
                                       "mesh": [res.lm.shard.dp, res.lm.shard.tp]}
        np.savez(d / f"tpa{rank}.npz", **arrays)
        (d / f"tpa{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


def _tpa_world_one(torch, lm, sharding, configs, mesh) -> dict:
    """At one rank, each ``TPA_ARCHS`` smoke LM (bf16, the optimized flags)
    sharded (``LM.sharded``: the very tensors) against the mesh-less one: a
    prefill and 3 greedy decode steps (logits, ids, every cache leaf) and,
    for MLA, one expanded decode step from copies of the prefill's cache,
    each bit for bit; the sharded run's collectives by call against
    ``LM.collectives_per_call``."""
    out = {}
    for arch in TPA_ARCHS:
        whole = lm.LM(tpa_config(configs, arch, "bfloat16"), q_block=4, perf=lm.OPTIMIZED,
                      device="cpu", seed=2)
        par = whole.sharded(mesh)
        shared = all(a.data_ptr() == b.data_ptr()
                     for a, b in zip(whole.parameters(), par.parameters()))
        F = tpa_front(arch)
        batch = {"tokens": torch.from_numpy(tp_tokens(TPA_S)[:, :TPA_S])}
        if tpa_frontend(arch) is not None:
            batch["frontend"] = torch.from_numpy(tpa_frontend(arch))
        runs = []
        for m in (whole, par):
            sharding.collectives.clear()
            cache, lg = m.prefill(batch, max_len=F + TPA_S + 3)
            counts = [dict(sharding.collectives)]
            expanded = None
            if m.cfg.mla is not None:
                copy = {g: {k: t.clone() for k, t in c.items()} for g, c in cache.items()}
                sharding.collectives.clear()
                expanded = m.decode_step(copy, lg[:, -1].argmax(-1), F + TPA_S,
                                         absorbed=False)[1]
                counts.append(dict(sharding.collectives))
            logits, tok = [lg[:, 0]], lg[:, -1].argmax(-1)
            ids = [tok]
            for t in range(3):
                sharding.collectives.clear()
                cache, lg = m.decode_step(cache, tok, F + TPA_S + t)
                counts.append(dict(sharding.collectives))
                tok = lg.argmax(-1)
                logits.append(lg)
                ids.append(tok)
            runs.append((logits, ids, tpa_leaves(cache), expanded, counts))
        (la, ia, ca, ea, _), (lb, ib, cb, eb, counts) = runs
        want = [dict(par.collectives_per_call(TPA_B, F + TPA_S))]
        if eb is not None:
            want.append(dict(par.collectives_per_call(TPA_B, absorbed=False)))
        want += [dict(par.collectives_per_call(TPA_B))] * 3
        out[arch] = {"shares_tensors": shared,
                     "logits": all(torch.equal(a, b) for a, b in zip(la, lb)),
                     "ids": all(torch.equal(a, b) for a, b in zip(ia, ib)),
                     "cache": set(ca) == set(cb) and all(torch.equal(ca[k], cb[k]) for k in ca),
                     "expanded": None if ea is None else torch.equal(ea, eb),
                     "collectives": counts == want}
    return out


# ---------------------------------------------------------------------------
# The SSM and hybrid families across ranks (tests/test_torch_tp_ssm.py)
# ---------------------------------------------------------------------------

TPS_ARCHS = ("falcon_mamba_7b", "zamba2_2p7b")
#: each mesh's runs, (arch, dtype, optimized flags): each arch meets both
#: dtypes and both flag sets, each mesh both dtypes
TPS_CASES = {
    (1, 2): (("falcon_mamba_7b", "float32", False), ("zamba2_2p7b", "bfloat16", True)),
    (1, 4): (("falcon_mamba_7b", "bfloat16", True), ("zamba2_2p7b", "float32", False)),
    (2, 2): (("falcon_mamba_7b", "float32", True), ("zamba2_2p7b", "bfloat16", False)),
}
#: batch and prompt: S is longer than the smoke scan chunk of 16, so that the
#: prefill runs a padded second chunk
TPS_B, TPS_S = 2, 20
#: the serve_lm runs on the (2, 2) mesh, by arch
TPS_SERVE_ARGV = {arch: ["--arch", arch, "--preset", "smoke", "--device", "cpu", "--opt",
                         "--model-parallel", "2", "--batch", "2", "--prompt-len", "6",
                         "--gen", "3"]
                  for arch in TPS_ARCHS}


def tps_config(configs, arch: str, dtype: str):
    """The smoke config of ``arch`` from ``configs`` (either package's) at
    ``dtype``."""
    import dataclasses

    return dataclasses.replace(configs.smoke(arch), dtype=dtype)


def tps_make_weights(path) -> None:
    """Each ``TPS_ARCHS`` smoke LM's fp32 weights, keyed ``arch:<the port's
    state-dict key>``: a seeded mesh-less port LM's (its own draws keep
    ``A_log`` and ``dt_bias`` in their working range), with the leaves it
    draws constant made to differ by channel, so that a misplaced slice
    shows: every norm's weight (``norm_w`` too) and ``D`` 1 + 0.1 n, its
    bias and ``conv_b`` 0.1 n, ``A_log`` plus 0.1 n (n normal, numpy seed
    19)."""
    from repro_torch import configs
    from repro_torch.models import lm

    rng, arrays = np.random.default_rng(19), {}
    for arch in TPS_ARCHS:
        model = lm.LM(tps_config(configs, arch, "float32"), device="cpu", seed=4)
        for key, t in model.state_dict().items():
            x = t.numpy().copy()
            n = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
            if key.endswith((".w", ".norm_w", ".D")):
                x = 1 + n
            elif key.endswith((".b", ".conv_b")):
                x = n
            elif key.endswith(".A_log"):
                x = x + n
            arrays[f"{arch}:{key}"] = x
    np.savez(path, **arrays)


def _tps_steps(torch, sharding, port):
    """A prefill of ``TPS_S`` tokens (max_len S + 3) and 3 teacher-forced
    decode steps of the LM ``port``: (logits (4, B, V) fp32, the cache
    after them, the collectives of each call by kind)."""
    toks = torch.from_numpy(tp_tokens(TPS_S))
    sharding.collectives.clear()
    cache, lg = port.prefill({"tokens": toks[:, :TPS_S]}, max_len=TPS_S + 3)
    counts, logits = [dict(sharding.collectives)], [lg[:, 0]]
    for t in range(3):
        sharding.collectives.clear()
        cache, lg = port.decode_step(cache, toks[:, TPS_S + t], TPS_S + t)
        counts.append(dict(sharding.collectives))
        logits.append(lg)
    return torch.stack(logits).float(), cache, counts


def run_tps_rank(rank: int, init_file: str, out_dir: str, mesh_shape=(1, 4)):
    """One rank of a ``mesh_shape`` mesh: every ``TPS_CASES`` run
    (``tps_make_weights``' from ``out_dir/../weights.npz``: the prefill, 3
    teacher-forced decode steps, the cache after them and the collectives
    by call), the weights' slices, ``serve_lm`` on (2, 2), and at one rank
    each sharded LM against the mesh-less one bit for bit.  Writes
    ``tps{rank}.npz`` and ``tps{rank}.json`` to ``out_dir``."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the meshes' ranks share the host's cores
    from repro_torch import configs
    from repro_torch.launch import serve_lm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, sharding
    from repro_torch.models.convert import shard_params

    world = mesh_shape[0] * mesh_shape[1]
    _init(rank, init_file, world)
    d = Path(out_dir)
    weights = np.load(d.parent / "weights.npz")
    try:
        mesh = make_host_mesh(mesh_shape[1], device="cpu")
        shard = sharding.Shard(mesh)
        arrays, info = {}, {"coord": [shard.drank, shard.rank], "cases": {}}
        if world == 1:
            info["world1"] = _tps_world_one(torch, lm, sharding, configs, mesh)
        for arch, dtype, opt in TPS_CASES.get(mesh_shape, ()):
            key = tpa_key(arch, dtype, opt)
            cfg = tps_config(configs, arch, dtype)
            full = {k: torch.from_numpy(a) for k, a in tp_weights(weights, arch).items()}
            port = lm.LM(cfg, mesh=mesh, q_block=4, perf=lm.OPTIMIZED if opt else lm.PerfFlags(),
                         device="cpu")
            port.load_state_dict(shard_params(cfg, full, mesh), strict=True)
            logits, cache, counts = _tps_steps(torch, sharding, port)
            info["cases"][key] = {"counts": counts,
                                  "want": [dict(port.collectives_per_call(TPS_B, TPS_S)),
                                           dict(port.collectives_per_call(TPS_B))]}
            arrays["lg:" + key] = logits.numpy()
            for path, t in tpa_leaves(cache).items():
                arrays[f"{path}:{key}"] = t.float().numpy()
        if world > 1:
            info["weights"] = {}
            for arch in TPS_ARCHS:
                cfg = tps_config(configs, arch, "bfloat16")
                whole = lm.LM(cfg, q_block=4, device="cpu", seed=5)
                mine = lm.LM(cfg, mesh=mesh, q_block=4, device="cpu", seed=5).state_dict()
                cut = shard_params(cfg, whole.state_dict(), mesh)
                moved = whole.sharded(mesh).state_dict()
                info["weights"][arch] = (set(mine) == set(cut) == set(moved) and all(
                    torch.equal(mine[k], cut[k]) and torch.equal(mine[k], moved[k])
                    for k in mine))
        if mesh_shape == (2, 2):
            info["serve"] = {}
            for arch, argv in TPS_SERVE_ARGV.items():
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    res = serve_lm.main(argv)
                info["serve"][arch] = {"lines": out.getvalue().splitlines(),
                                       "ids": res.ids.tolist(),
                                       "mesh": [res.lm.shard.dp, res.lm.shard.tp]}
        np.savez(d / f"tps{rank}.npz", **arrays)
        (d / f"tps{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


def _tps_world_one(torch, lm, sharding, configs, mesh) -> dict:
    """At one rank, each ``TPS_ARCHS`` smoke LM (bf16, the optimized flags)
    sharded (``LM.sharded``: the very tensors) against the mesh-less one: a
    prefill and 3 greedy decode steps (logits, ids, every cache leaf), bit
    for bit; the sharded run's collectives by call against
    ``LM.collectives_per_call``."""
    out = {}
    for arch in TPS_ARCHS:
        whole = lm.LM(tps_config(configs, arch, "bfloat16"), q_block=4, perf=lm.OPTIMIZED,
                      device="cpu", seed=2)
        par = whole.sharded(mesh)
        shared = all(a.data_ptr() == b.data_ptr()
                     for a, b in zip(whole.parameters(), par.parameters()))
        batch = {"tokens": torch.from_numpy(tp_tokens(TPS_S)[:, :TPS_S])}
        runs = []
        for m in (whole, par):
            sharding.collectives.clear()
            cache, lg = m.prefill(batch, max_len=TPS_S + 3)
            counts = [dict(sharding.collectives)]
            logits, tok = [lg[:, 0]], lg[:, -1].argmax(-1)
            ids = [tok]
            for t in range(3):
                sharding.collectives.clear()
                cache, lg = m.decode_step(cache, tok, TPS_S + t)
                counts.append(dict(sharding.collectives))
                tok = lg.argmax(-1)
                logits.append(lg)
                ids.append(tok)
            runs.append((logits, ids, tpa_leaves(cache), counts))
        (la, ia, ca, _), (lb, ib, cb, counts) = runs
        want = ([dict(par.collectives_per_call(TPS_B, TPS_S))]
                + [dict(par.collectives_per_call(TPS_B))] * 3)
        out[arch] = {"shares_tensors": shared,
                     "logits": all(torch.equal(a, b) for a, b in zip(la, lb)),
                     "ids": all(torch.equal(a, b) for a, b in zip(ia, ib)),
                     "cache": set(ca) == set(cb) and all(torch.equal(ca[k], cb[k]) for k in ca),
                     "collectives": counts == want}
    return out

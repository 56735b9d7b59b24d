"""``python -m repro_torch.serve`` — run the spectral serving engine on a
synthetic request load and print a JSON report (the port of
``python -m repro.serve``, with its flags).

Demo / smoke entrypoint, not a network server: it builds a device mesh over
the ranks, starts a :class:`~repro_torch.serve.engine.SpectralServer`, fires
``--requests`` forward transforms at it from rank 0 (mixing ``--shapes``
round-robin so the LRU registry and the coalescer both get exercised),
waits for every future, and reports the outcome histogram plus engine stats.
``--chaos`` arms a serve-level fault matrix (slow collectives, executor
crashes, cache corruption, request bursts) on every rank: every request
still terminates in a structured outcome within its deadline.

It runs on the CUDA card unless ``--device cpu`` is given (and raises
without a card).  With no process group it starts a one-rank group itself
(NCCL on the card, gloo on the CPU); more ranks come through ``torchrun``,
rank 0 admitting the load and the others following:

    python -m repro_torch.serve --shapes 64,64,64 --requests 12 --chaos
    torchrun --nproc-per-node 4 -m repro_torch.serve --grid pencil
    python -m repro_torch.serve --device cpu --shapes 16,16,16 --requests 6
"""

from __future__ import annotations

import argparse
import json


def _parse_shapes(spec: str):
    shapes = []
    for part in spec.split(";"):
        shapes.append(tuple(int(s) for s in part.split(",")))
    return shapes


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="32,32,32",
                    help="semicolon-separated global shapes, e.g. "
                         "'32,32,32;16,16,16'")
    ap.add_argument("--grid", choices=["slab", "pencil"], default="slab")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--method", default="fused",
                    help="plan method (fused/traditional/pipelined/auto)")
    ap.add_argument("--deadline", type=float, default=60.0,
                    help="per-request deadline in seconds")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--tune-cache", default=None,
                    help="schedule cache path (method=auto)")
    ap.add_argument("--chaos", action="store_true",
                    help="arm the serve-level fault matrix")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the CUDA card (default) or on the CPU")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.core.meshutil import balanced_dims, default_group, make_mesh
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.robustness import faults
    from repro_torch.serve import ServeConfig, SpectralServer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("python -m repro_torch.serve: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    with default_group(device.type):
        ndev, rank = dist.get_world_size(), dist.get_rank()
        if args.grid == "slab":
            mesh, grid = make_mesh((ndev,), ("p0",), device=device.type), ("p0",)
        else:
            mesh = make_mesh(balanced_dims(ndev), ("p0", "p1"), device=device.type)
            grid = ("p0", "p1")
        shapes = _parse_shapes(args.shapes)
        pc = PlanConfig(method=args.method, tuner_cache=args.tune_cache, guard="degrade")
        sc = ServeConfig(deadline_s=args.deadline, max_batch=args.max_batch,
                         max_queue=args.max_queue)

        fault_ctx = None
        if args.chaos:  # armed on every rank, so each fault fires on every rank
            fault_ctx = (faults.FaultPlan()
                         .slow_collective(seconds=0.05, times=2)
                         .executor_crash(times=1)
                         .cache_corruption(mode="garbage", times=1)
                         .request_burst(factor=2, times=1))
            fault_ctx.__enter__()
        try:
            with SpectralServer(mesh, grid, plan_config=pc, config=sc) as srv:
                if rank != 0:
                    srv.follow()
                    return 0
                gen = torch.Generator(device=srv.device).manual_seed(args.seed)
                futures = []
                n = args.requests * faults.serve_burst()
                for i in range(n):
                    shape = shapes[i % len(shapes)]
                    x = torch.randn(shape, generator=gen, device=srv.device)
                    futures.append(srv.submit(x, deadline_s=args.deadline))
                outcomes = [f.result(grace=sc.grace_s) for f in futures]
                stats = srv.stats()
        finally:
            if fault_ctx is not None:
                fault_ctx.__exit__(None, None, None)

    hist: dict[str, int] = {}
    for o in outcomes:
        hist[o.status] = hist.get(o.status, 0) + 1
    unresolved = [o for o in outcomes if o is None]
    report = {
        "requests": len(outcomes),
        "outcomes": hist,
        "unresolved": len(unresolved),
        "chaos": bool(args.chaos),
        "device": str(srv.device),
        "ranks": ndev,
        "fired_faults": (fault_ctx.fired if fault_ctx is not None else []),
        "stats": stats,
        "sample": [o.summary() for o in outcomes[:4]],
    }
    print(json.dumps(report, indent=1, default=str))
    return 1 if unresolved else 0


if __name__ == "__main__":
    raise SystemExit(main())

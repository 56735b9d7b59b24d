"""Quickstart — the twin of ``examples/quickstart.py`` (the paper's Appendix
A): a full 3-D complex FFT of a ``(42, 63, 64)`` field (non-divisible
extents, to exercise the padding) with a 2-D pencil decomposition on the
``balanced_dims(world)`` mesh over ``("p0", "p1")``, forward and backward on
this rank's blocks, checked against ``np.fft.fftn`` with the example's
limits.

Run:  torchrun --nproc-per-node 4 -m repro_torch.examples.quickstart --device cpu
      python -m repro_torch.examples.quickstart          # one rank, on the card
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pencil import scatter_global
from repro_torch.core.pfft import ParallelFFT
from repro_torch.core.planconfig import PlanConfig
from repro_torch.examples import _common

SHAPE = (42, 63, 64)
#: the example's limits: ``assert_allclose(u_back, u, rtol, atol)`` and
#: ``assert_allclose(u_hat, fftn(u), rtol, atol)``
ROUNDTRIP_TOL = (1e-4, 1e-4)
FORWARD_TOL = (1e-4, 1e-2)


def _excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> torch.Tensor:
    """max(|got - want| - rtol |want|) - atol over this rank's block, reduced
    over the ranks: <= 0 where ``assert_allclose`` passes."""
    e = ((got - want).abs() - rtol * want.abs()).max() - atol
    e = e.reshape(1).to(torch.float32)
    dist.all_reduce(e, op=dist.ReduceOp.MAX)
    return e


def _max_abs(x: torch.Tensor) -> float:
    e = x.abs().max().reshape(1).to(torch.float32)
    dist.all_reduce(e, op=dist.ReduceOp.MAX)
    return float(e)


def quickstart_plan(mesh, config: PlanConfig | None = None, *, shape=SHAPE) -> ParallelFFT:
    """The example's plan: the fused pencil plan of ``shape`` over
    ``("p0", "p1")`` (``config`` overrides it)."""
    return ParallelFFT(mesh, shape, ("p0", "p1"),
                       config=PlanConfig(method="fused") if config is None else config)


def run(mesh, config: PlanConfig | None = None, *, shape=SHAPE, seed: int = 0) -> dict:
    """Forward and backward of the seeded field on this rank's blocks;
    returns the plan, the errors (max over every rank's block, padding
    included) and whether the example's limits hold."""
    plan = quickstart_plan(mesh, config, shape=shape)
    rank = dist.get_rank()
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    block = scatter_global(torch.from_numpy(u), plan.input_pencil, rank).to(plan.device)
    u_hat = plan.forward_padded(block)
    u_back = plan.backward_padded(u_hat)
    want_hat = scatter_global(torch.from_numpy(np.fft.fftn(u).astype(np.complex64)),
                              plan.output_pencil, rank).to(plan.device)
    excess_back = float(_excess(u_back, block, *ROUNDTRIP_TOL))
    excess_fwd = float(_excess(u_hat, want_hat, *FORWARD_TOL))
    return {"plan": plan, "shape": list(shape),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "roundtrip_err": _max_abs(u_back - block), "forward_err": _max_abs(u_hat - want_hat),
            "ok": excess_back <= 0 and excess_fwd <= 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with _common.process_group(args.device) as mesh:
        out = run(mesh, seed=args.seed)
        plan = out.pop("plan")
        if dist.get_rank() == 0:
            print(json.dumps(out))
            print(f"roundtrip {'ok' if out['ok'] else 'FAILED'}: shape={tuple(plan.shape)}, "
                  f"mesh={out['mesh']}, plan: {len(plan.stages)} stages "
                  f"({plan.d} FFTs + {plan.k} exchanges)")
            print("input pencil:", plan.input_pencil.placement, "->",
                  "output pencil:", plan.output_pencil.placement)
        if not out["ok"]:
            raise AssertionError(f"quickstart outside the example's limits: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

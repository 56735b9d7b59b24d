"""Chebyshev-Dirichlet Poisson solver on a pencil-decomposed 3-D domain — the
twin of ``examples/poisson.py``.

Solves  -lap(u) = f  on [-1, 1] x [0, 2pi)^2 with homogeneous Dirichlet
walls u(x=+-1) = 0 and periodic y, z.  The transform is the mixed plan
``("dct2", "c2c", "r2c")``: DCT-II along x (the Chebyshev transform on
Chebyshev-Gauss points), c2c along y, r2c along z.  Per (ky, kz) mode the
1-D Helmholtz problem  u'' - (ky^2 + kz^2) u = -f_hat,  u(+-1) = 0  is
solved in Chebyshev coefficient space with the tau method (the last two
coefficient equations replaced by the boundary rows).

Everything runs on this rank's blocks: the source is evaluated on the
rank's input block, the solve runs on its output block, where x is whole
(``output_pencil.placement[0] is None``) and ``ky, kz`` are the block's
(``output_pencil.block_slices``), in float64 with ``torch.linalg.solve`` as
the reference solves in numpy; padded slots stay zero.

Run:  torchrun --nproc-per-node 4 -m repro_torch.examples.poisson --device cpu
      python -m repro_torch.examples.poisson            # one rank, on the card
"""

from __future__ import annotations

import argparse
import json
import math

import torch
import torch.distributed as dist

from repro_torch.core.pfft import ParallelFFT
from repro_torch.core.planconfig import PlanConfig
from repro_torch.examples import _common

SHAPE = (32, 32, 32)
#: the example's limit on max |u - u*|
TOL = 1e-3


def grid_block(pencil, rank: int, device):
    """``(X, Y, Z, valid)`` of this rank's block: Chebyshev-Gauss points
    along x, uniform periodic y and z (float64), and the mask of its logical
    slots."""
    nx, ny, nz = pencil.logical
    (ix, vx), (iy, vy), (iz, vz) = (_common.block_indices(pencil, rank, a, device)
                                    for a in range(3))
    x = torch.cos((2 * ix + 1).double() * math.pi / (2 * nx))
    y = iy.double() * 2 * math.pi / ny
    z = iz.double() * 2 * math.pi / nz
    X, Y, Z = torch.meshgrid(x, y, z, indexing="ij")
    valid = vx[:, None, None] & vy[None, :, None] & vz[None, None, :]
    return X, Y, Z, valid


def manufactured(X, Y, Z):
    """``u*`` honouring u(x=+-1) = 0, and ``f = -lap(u*)``."""
    u_star = torch.sin(math.pi * X) * torch.cos(2 * Y) * torch.sin(3 * Z)
    return u_star, (math.pi ** 2 + 2 ** 2 + 3 ** 2) * u_star


def chebyshev_d2(nx: int, device) -> torch.Tensor:
    """The Chebyshev second-derivative operator in coefficient space:
    ``(D2 a)_k = (1/c_k) sum_{p=k+2, p-k even} p (p^2 - k^2) a_p``, c_0 = 2."""
    d2 = torch.zeros((nx, nx), dtype=torch.float64, device=device)
    for k in range(nx):
        for p in range(k + 2, nx, 2):
            d2[k, p] = p * (p ** 2 - k ** 2)
    d2[0] /= 2.0
    return d2


def solve_block(f_hat: torch.Tensor, plan, rank: int) -> torch.Tensor:
    """The tau solve on this rank's output block ``f_hat`` (DCT-II x c2c x
    r2c of f); returns the spectral block of u (complex64), zero on padded
    slots."""
    pen = plan.output_pencil
    if pen.placement[0] is not None:
        raise ValueError(f"the solve needs whole x lines; output placement {pen.placement}")
    nx, ny, _ = plan.shape
    dev = f_hat.device
    (iy, vy), (iz, vz) = (_common.block_indices(pen, rank, a, dev) for a in (1, 2))
    ky = _common.fftfreq(iy, ny).double()
    kz = iz.double()
    valid = vy[:, None] & vz[None, :]
    # DCT-II output -> Chebyshev series coefficients: a_0 = X_0/(2N), a_k = X_k/N
    a_f = f_hat[:nx].to(torch.complex128) / nx
    a_f[0] /= 2.0
    lam = ky[:, None] ** 2 + kz[None, :] ** 2
    eye = torch.eye(nx, dtype=torch.float64, device=dev)
    A = chebyshev_d2(nx, dev) - lam[..., None, None] * eye  # (ky, kz, nx, nx)
    A[..., nx - 2, :] = 1.0                                                   # u(1) = 0
    A[..., nx - 1, :] = (-1.0) ** torch.arange(nx, dtype=torch.float64, device=dev)  # u(-1) = 0
    g = -torch.movedim(a_f, 0, -1)                                           # (ky, kz, nx)
    g[..., nx - 2:] = 0.0
    g = torch.where(valid[..., None], g, torch.zeros((), dtype=g.dtype, device=dev))
    # real A: the real and imaginary parts of g are two right-hand sides
    sol = torch.linalg.solve(A, torch.stack([g.real, g.imag], dim=-1))
    a_u = torch.movedim(torch.complex(sol[..., 0], sol[..., 1]), -1, 0)
    # Chebyshev coefficients -> DCT-II spectral values
    u_hat = a_u * nx
    u_hat[0] *= 2.0
    out = torch.zeros_like(f_hat)
    out[:nx] = u_hat.to(torch.complex64)
    return out


def poisson_plan(mesh, config: PlanConfig | None = None, *, shape=SHAPE) -> ParallelFFT:
    """The example's mixed plan ``("dct2", "c2c", "r2c")`` of ``shape`` over
    ``("p0", "p1")``, fused unless ``config`` says otherwise."""
    return ParallelFFT(mesh, shape, ("p0", "p1"), transforms=("dct2", "c2c", "r2c"),
                       config=PlanConfig(method="fused") if config is None else config)


def run(mesh, config: PlanConfig | None = None, *, shape=SHAPE) -> dict:
    """Solve on this rank's blocks; returns the plan and ``max |u - u*|``
    over every rank's logical slots."""
    plan = poisson_plan(mesh, config, shape=shape)
    rank = dist.get_rank()
    X, Y, Z, valid = grid_block(plan.input_pencil, rank, plan.device)
    u_star, f = manufactured(X, Y, Z)
    f = torch.where(valid, f, torch.zeros((), dtype=f.dtype, device=f.device))
    f_hat = plan.forward_padded(f.to(torch.float32))
    u = plan.backward_padded(solve_block(f_hat, plan, rank))
    err = torch.where(valid, (u.double() - u_star).abs(), 0.0).max().reshape(1)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return {"plan": plan, "shape": list(shape),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), "err": float(err),
            "ok": float(err) < TOL}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.poisson",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--shape", default="32,32,32", help="NX,NY,NZ (default: %(default)s)")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split(","))
    with _common.process_group(args.device) as mesh:
        out = run(mesh, shape=shape)
        out.pop("plan")
        if dist.get_rank() == 0:
            print(json.dumps(out))
            print(f"Chebyshev-Dirichlet Poisson: {shape}, mesh={out['mesh']}, "
                  f"transforms=(dct2, c2c, r2c), max|u - u*| = {out['err']:.2e}")
        if not out["ok"]:
            raise AssertionError(f"max|u - u*| = {out['err']} (limit {TOL})")
        if dist.get_rank() == 0:
            print("ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

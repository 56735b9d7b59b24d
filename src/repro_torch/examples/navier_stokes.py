"""Pseudo-spectral incompressible Navier-Stokes on a pencil-decomposed box —
the twin of ``examples/navier_stokes.py``, the paper's motivating DNS.

Taylor-Green vortex in [0, 2pi)^3, vorticity-free projection form:

    du/dt = P[-(u . grad) u] - nu k^2 u_hat      (spectral space)

The nonlinear term is evaluated pseudo-spectrally with RK2 time stepping.
Dealiasing is the 3/2 rule fused into the transforms: the state lives on
N^3 retained modes and every transform runs on the padded M = 3N/2 grid
through ``TransformSpec.pruned`` / ``r2c(n_keep=...)``, so the exchanges
ship only the retained modes.  Each RHS makes three batched calls: the
3-field backward of u, the 9-field backward of the gradients and the
3-field forward of the convective term (one collective per exchange stage
each under ``batch_fusion="stacked"``, instead of the 15 a per-field loop
pays).

The solver works on **this rank's blocks**: the state is the rank's output
block, the wavenumbers and the Hermitian mask come from that block's global
indices (``block_slices``) and are zero on padded slots, the physical fields
are the rank's input blocks, and the energy sum (in float64) and the
divergence max are ``all_reduce``s.  Nothing is gathered inside a step.

Explicit RK2 is stable for the viscous term while ``dt nu k_max^2 <= 2``
(``k_max^2 = 3 (N / 2)^2``): the example's ``dt = 5e-3`` is 0.19 of the
bound at its 32 modes and 12.3 times it at 256, where ``dt = 5e-4`` holds.

Checks (the example's): the batched forward is bitwise the per-field loop
(lossless wires), the flow stays solenoidal, the energy decays
monotonically at the viscous rate (dE/dt = -6 nu E at t = 0 for
Taylor-Green), and a guarded plan (``guard="degrade"``) recovers from a NaN
injected into its first stage.

Run:  torchrun --nproc-per-node 4 -m repro_torch.examples.navier_stokes --device cpu
      python -m repro_torch.examples.navier_stokes         # one rank, on the card
"""

from __future__ import annotations

import argparse
import json
import math

import torch
import torch.distributed as dist

from repro_torch.core.fftcore import TransformSpec, dealias_grid
from repro_torch.core.pfft import ParallelFFT
from repro_torch.core.planconfig import PlanConfig
from repro_torch.examples import _common

#: the example's defaults
N, NU, DT, STEPS = 32, 0.05, 5e-3, 8


def dns_plan(mesh, n: int, config: PlanConfig | None = None) -> ParallelFFT:
    """The DNS plan: ``dealias_grid(n)^3`` physical grid, ``n`` retained
    modes on the first two axes (pruned c2c), ``n / 2 + 1`` rfft bins on
    the last."""
    m = dealias_grid(n)
    return ParallelFFT(mesh, (m, m, m), ("p0", "p1"),
                       config=PlanConfig(method="fused") if config is None else config,
                       transforms=(TransformSpec.pruned(n), TransformSpec.pruned(n),
                                   TransformSpec.r2c(n_keep=n // 2 + 1)))


class TaylorGreen:
    """The RK2 Taylor-Green DNS on this rank's blocks of ``plan``
    (:func:`dns_plan`).  ``fwd3``, ``bwd3`` and ``bwd9`` are the three
    batched transforms of a RHS; :meth:`rhs` and :meth:`step` are the
    reference's."""

    def __init__(self, plan: ParallelFFT, n: int, nu: float = NU, dt: float = DT):
        self.plan, self.n, self.nu, self.dt = plan, n, nu, dt
        self.m = plan.shape[0]
        self.scale = float(self.m) ** 3  # unnormalized fft sums -> Fourier coefficients
        self.rank = dist.get_rank()
        dev = plan.device
        out = plan.output_pencil
        (ix, vx), (iy, vy), (iz, vz) = (_common.block_indices(out, self.rank, a, dev)
                                        for a in range(3))
        # the centered-keep ordering of a pruned axis is fftfreq order
        kx = torch.where(vx, _common.fftfreq(ix, n), 0.0)
        ky = torch.where(vy, _common.fftfreq(iy, n), 0.0)
        kz = torch.where(vz, iz.to(torch.float32), 0.0)
        self.KX, self.KY, self.KZ = kx[:, None, None], ky[None, :, None], kz[None, None, :]
        self.K2 = self.KX ** 2 + self.KY ** 2 + self.KZ ** 2
        self.K2_safe = torch.where(self.K2 == 0, 1.0, self.K2)
        valid = vx[:, None, None] & vy[None, :, None] & vz[None, None, :]
        # the -N/2 rows have no +N/2 partner in the retained set; keep them
        # empty so spectra stay Hermitian-consistent (and padded slots zero)
        self.HERM = (valid & (self.KX != -(n // 2)) & (self.KY != -(n // 2))).to(torch.float32)
        # Parseval on the rfft grid: kz > 0 modes count twice
        self.weight = torch.where(self.KZ == 0, 1.0, 2.0)
        self._fwd3 = plan.forward_many_padded(3)
        self._bwd3 = plan.backward_many_padded(3)
        self._bwd9 = plan.backward_many_padded(9)

    # -- the three batched transforms of a RHS ------------------------------

    def fwd3(self, u):
        """Physical (3, M^3 block) -> dealiased coefficients, one batched call."""
        return self._fwd3(u) / self.scale

    def bwd3(self, c):
        return self._bwd3(c * self.scale)

    def bwd9(self, c):
        return self._bwd9(c * self.scale)

    def fwd1(self, u):
        """One field's forward, for the batched-vs-loop check."""
        return self.plan.forward_padded(u) / self.scale

    # -- the solver ----------------------------------------------------------

    def initial(self) -> torch.Tensor:
        """The Taylor-Green velocity on this rank's input block (3, ...),
        zero on padded slots."""
        pen = self.plan.input_pencil
        dev = self.plan.device
        xs = []
        for a in range(3):
            idx, valid = _common.block_indices(pen, self.rank, a, dev)
            x = (idx.to(torch.int32) * 2).to(torch.float32) * math.pi / self.m
            xs.append((x, valid))
        (x, vx), (y, vy), (z, vz) = xs
        X, Y, Z = torch.meshgrid(x, y, z, indexing="ij")
        valid = vx[:, None, None] & vy[None, :, None] & vz[None, None, :]
        u0 = torch.stack([torch.cos(X) * torch.sin(Y) * torch.sin(Z),
                          -torch.sin(X) * torch.cos(Y) * torch.sin(Z),
                          torch.zeros_like(X)])
        return torch.where(valid, u0, 0.0)

    def project(self, v_hat):
        """Leray projection: remove the compressible part (k . v) k / |k|^2."""
        div = self.KX * v_hat[0] + self.KY * v_hat[1] + self.KZ * v_hat[2]
        return torch.stack([v_hat[0] - self.KX * div / self.K2_safe,
                            v_hat[1] - self.KY * div / self.K2_safe,
                            v_hat[2] - self.KZ * div / self.K2_safe])

    def gradient_hat(self, u_hat):
        """The nine ``i k_j u_hat_i``, stacked for one batched backward."""
        return torch.stack([1j * k * u_hat[i]
                            for i in range(3) for k in (self.KX, self.KY, self.KZ)])

    @staticmethod
    def convection(u, grads):
        """``(u . grad) u``: ``sum_j u_j du_i/dx_j`` on the physical blocks,
        as three elementwise products (the reference's einsum; torch's runs
        it as a batched matmul of 3 x 3 matrices, one a grid point)."""
        return u[0] * grads[:, 0] + u[1] * grads[:, 1] + u[2] * grads[:, 2]

    def rhs(self, u_hat):
        """P[-(u.grad)u] - nu k^2 u_hat; products on the padded grid are
        dealiased by the plan's fused 3/2-rule truncation."""
        u = self.bwd3(u_hat)                                            # physical (3, ...)
        grads = self.bwd9(self.gradient_hat(u_hat)).reshape(3, 3, *u.shape[1:])  # du_i/dx_j
        conv_hat = self.fwd3(self.convection(u, grads)) * self.HERM
        return self.project(-conv_hat) - self.nu * self.K2 * u_hat

    def step(self, u_hat):
        k1 = self.rhs(u_hat)
        k2 = self.rhs(u_hat + self.dt * k1)
        return self.project(u_hat + 0.5 * self.dt * (k1 + k2))

    def energy(self, u_hat) -> float:
        """0.5 sum w |u_hat|^2 over every rank: each rank's sum in float64,
        then one all_reduce."""
        e = (0.5 * torch.sum(self.weight * (u_hat.real ** 2 + u_hat.imag ** 2),
                             dtype=torch.float64)).reshape(1)
        dist.all_reduce(e, op=dist.ReduceOp.SUM)
        return float(e)

    def max_divergence(self, u_hat) -> float:
        d = (self.KX * u_hat[0] + self.KY * u_hat[1] + self.KZ * u_hat[2]).abs().max()
        d = d.reshape(1).to(torch.float32)
        dist.all_reduce(d, op=dist.ReduceOp.MAX)
        return float(d)


def _all_max(x: torch.Tensor) -> float:
    x = x.reshape(1).to(torch.float32)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return float(x)


def _all_and(flag: bool, device) -> bool:
    t = torch.tensor([0.0 if flag else 1.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t) == 0.0


def guarded_demo(mesh, n: int, config: PlanConfig, u0: torch.Tensor, u0_hat: torch.Tensor,
                 scale: float) -> dict:
    """The same plan with ``guard="degrade"``, a NaN injected into stage 0's
    input on the fused engine: the guarded 3-field forward must recover a
    spectrum within 1e-4 max|u0_hat| of the healthy one, with transitions."""
    from repro_torch.robustness import FaultPlan, runner

    with FaultPlan().nan_input(stage=0, engine="fused"):
        guarded = dns_plan(mesh, n, config.replace(guard="degrade"))
        g_hat, rep = runner.run_guarded(guarded, u0, "forward", 3)
    g_hat = g_hat / scale
    err = _all_max((g_hat - u0_hat).abs().max())
    limit = 1e-4 * _all_max(u0_hat.abs().max())
    return {"ok": rep.ok, "attempts": rep.attempts,
            "transitions": [t["kind"] for t in rep.transitions],
            "schedule": [list(e) for e in rep.schedule], "max_err": err, "limit": limit,
            "recovered": bool(rep.ok and rep.transitions and err <= limit)}


def run(mesh, n: int = N, *, nu: float = NU, dt: float = DT, steps: int = STEPS,
        config: PlanConfig | None = None, guard_demo: bool = True) -> dict:
    """The example on this rank's blocks; returns the energies of every
    step, the final divergence, the initial decay rate, the checks, and the
    guarded demo's outcome."""
    config = PlanConfig(method="fused") if config is None else config
    plan = dns_plan(mesh, n, config)
    tg = TaylorGreen(plan, n, nu, dt)
    u0 = tg.initial()
    u0_hat = tg.fwd3(u0)                 # one batched call for all three components
    loop = torch.stack([tg.fwd1(u0[i]) for i in range(3)])
    bitwise = _all_and(torch.equal(u0_hat, loop), plan.device)
    u_hat = tg.project(u0_hat)
    energies = [tg.energy(u_hat)]
    div0 = tg.max_divergence(u_hat)
    for _ in range(steps):
        u_hat = tg.step(u_hat)
        energies.append(tg.energy(u_hat))
    div = tg.max_divergence(u_hat)
    e0 = energies[0]
    # Taylor-Green: dE/dt(0) = -2 nu Z(0) with Z(0) = 3 E(0) -> decay rate 6 nu
    rate = (energies[0] - energies[1]) / (dt * e0) if steps else float("nan")
    lossless = all(e.comm_dtype == "complex64" for e in plan.batched_schedule(3))
    out = {
        "N": n, "M": tg.m, "nu": nu, "dt": dt, "steps": steps,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "schedule": [list(e) for e in plan.batched_schedule(3)],
        "energies": energies, "E0": e0, "div0": div0, "div": div, "rate": rate,
        "bitwise_batched": bitwise,
        "checks": {
            "bitwise_batched": bitwise or not lossless,
            "energy_decays": all(e2 < e1 + 1e-9 for e1, e2 in zip(energies, energies[1:])),
            "solenoidal": div < 1e-3 * math.sqrt(e0),
            "viscous_rate": steps > 0 and abs(rate - 6 * nu) < 0.1 * 6 * nu,
        },
    }
    if guard_demo:
        out["guarded"] = guarded_demo(mesh, n, config, u0, u0_hat, tg.scale)
        out["checks"]["guarded_recovers"] = out["guarded"]["recovered"]
    out["ok"] = all(out["checks"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.navier_stokes",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=N, help="retained modes per axis")
    ap.add_argument("--nu", type=float, default=NU)
    ap.add_argument("--dt", type=float, default=DT)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--method", default="fused")
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--impl", default="torch", help="local FFT: torch or matmul (K4)")
    ap.add_argument("--exchange-impl", default="torch", help="torch or cuda (K1/K3)")
    ap.add_argument("--comm-dtype", default="complex64")
    ap.add_argument("--batch-fusion", default="stacked")
    ap.add_argument("--no-guard-demo", action="store_true")
    args = ap.parse_args(argv)
    config = PlanConfig(method=args.method, chunks=args.chunks, impl=args.impl,
                        exchange_impl=args.exchange_impl, comm_dtype=args.comm_dtype,
                        batch_fusion=args.batch_fusion)
    with _common.process_group(args.device) as mesh:
        out = run(mesh, args.n, nu=args.nu, dt=args.dt, steps=args.steps, config=config,
                  guard_demo=not args.no_guard_demo)
        if dist.get_rank() == 0:
            print(json.dumps(out))
            print(f"Taylor-Green DNS: {out['N']}^3 retained modes on a {out['M']}^3 grid "
                  f"(3/2-rule fused dealiasing), mesh={out['mesh']}, nu={out['nu']}, "
                  f"dt={out['dt']}")
            print(f"t={out['steps'] * out['dt']:.3f}  E={out['energies'][-1]:.6f}  "
                  f"max|div|={out['div']:.2e}; initial decay rate {out['rate']:.3f} vs "
                  f"6*nu = {6 * out['nu']:.3f}")
        if not out["ok"]:
            raise AssertionError(f"navier_stokes checks failed: {out['checks']}")
        if dist.get_rank() == 0:
            print("ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

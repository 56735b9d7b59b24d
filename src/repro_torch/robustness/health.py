"""Runtime health: guard statistics and the HealthReport — the port of
``repro/robustness/health.py``.

Two halves:

* **Reductions on the device** (:func:`count_nonfinite`,
  :func:`payload_stats`, :func:`output_probe`, :func:`block_energy`,
  :func:`zero_stats`, :func:`add_stats`, :func:`pack_stats`) that the plan
  executor runs when ``ParallelFFT(guard != "off")``:

  - always: the :func:`output_probe`, a single-plane sum that goes
    non-finite iff the execution produced any non-finite value (every 1-D
    transform mixes all inputs of a line into each output mode, and the
    index-0 plane meets every line of the last FFT stage);
  - only for schedules with lossy wire stages (:func:`schedule_is_lossy`):
    the block-energy Parseval bracket, per-stage non-finite counts over bf16
    payloads and the int8 saturation count (from the codec itself).

  A stacked multi-field block goes through the same reductions: the
  executor shifts the probe's axis past the field axis, so the plane holds
  index 0 of every field, and the energies sum over all fields.

  Each rank packs its own vector (:func:`pack_stats`); the guarded executor
  sums the vectors over the plan's world with one ``all_reduce``, so every
  rank evaluates the same totals.

* **Host side** (:func:`unpack_partials`, :func:`build_report`): the summed
  vector becomes a :class:`HealthReport` with per-stage
  :class:`StageHealth` rows, trip codes and, for all-c2c plans, the
  Parseval relative error — same codes and tolerances as the reference.

This module imports nothing of :mod:`repro_torch.core` at module scope (the
exchange code imports it); the plan-shape helpers do so lazily.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

#: guard modes ParallelFFT accepts
GUARD_MODES = ("off", "strict", "degrade")

#: int8 saturation fraction above which a stage trips (per-block max-abs
#: scaling saturates ~1 element per block in healthy runs)
SAT_FRACTION_TRIP = 0.05

#: per-stage Parseval tolerance contribution by wire payload (the lossy
#: codecs' round-trip error bounds, with headroom)
PARSEVAL_TOL = {"complex64": 1e-3, "bf16": 5e-2, "int8": 2e-1}


# ---------------------------------------------------------------------------
# reductions on the device
# ---------------------------------------------------------------------------


def count_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """f32 scalar count of non-finite elements (complex: either part)."""
    return (~torch.isfinite(x)).sum(dtype=torch.float32)


def zero_stats(device=None) -> dict:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"nonfinite": z, "saturated": z}


def payload_stats(x: torch.Tensor) -> dict:
    """Guard stats of a bf16 exchange payload's f32 planes: non-finite count
    only (saturation is the int8 codec's own count)."""
    return {"nonfinite": count_nonfinite(x),
            "saturated": torch.zeros((), dtype=torch.float32, device=x.device)}


def output_probe(block: torch.Tensor, axis: int | None) -> torch.Tensor:
    """Sum over the index-0 plane along the final FFT stage's ``axis``
    (the whole block when ``axis`` is None), as an f32 scalar; non-finite
    iff the execution produced a non-finite value."""
    plane = block if axis is None else block.select(axis, 0)
    s = plane.sum()
    if s.is_complex():
        s = s.real + s.imag
    return s.to(torch.float32)


def block_energy(x: torch.Tensor) -> torch.Tensor:
    """f32 scalar sum |x|^2 over this rank's block (zero padding adds 0),
    as ``re^2 + im^2``."""
    if x.is_complex():
        r, i = x.real, x.imag
        return ((r * r).sum() + (i * i).sum()).to(torch.float32)
    x = x.to(torch.float32)
    return (x * x).sum()


def add_stats(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def pack_stats(per_stage: list, energy_in, energy_out, probe) -> torch.Tensor:
    """This rank's flat f32 vector ``[energy_in, energy_out, probe,
    nonfinite_0..S-1, saturated_0..S-1]`` (``S`` exchange stages)."""
    parts = [torch.stack([energy_in, energy_out, probe])]
    if per_stage:
        parts.append(torch.stack([s["nonfinite"] for s in per_stage]))
        parts.append(torch.stack([s["saturated"] for s in per_stage]))
    return torch.cat(parts)


def unpack_partials(raw, nstages: int) -> dict:
    """Sum packed stat vectors (rows of ``raw``, any leading shape) into the
    stats dict :func:`build_report` evaluates.  The guarded executor hands
    over one vector already summed over the ranks."""
    width = 3 + 2 * nstages
    vec = np.asarray(raw, np.float64).reshape(-1, width).sum(axis=0)
    return {"energy_in": vec[0], "energy_out": vec[1], "probe": vec[2],
            "nonfinite": vec[3:3 + nstages],
            "saturated": vec[3 + nstages:]}


def schedule_is_lossy(entries) -> bool:
    """True when any schedule entry ships a lossy wire payload."""
    return any(e[2] in ("bf16", "int8") for e in entries)


# ---------------------------------------------------------------------------
# host-side report
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageHealth:
    """One exchange stage's guard outcome (counts summed over every rank)."""

    stage: int
    method: str
    comm_dtype: str
    nonfinite: int
    saturated: int
    elems: int  # payload elements the counters ran over (all ranks)
    tripped: tuple[str, ...] = ()

    @property
    def sat_fraction(self) -> float:
        return self.saturated / max(self.elems, 1)

    def to_dict(self) -> dict:
        return {"stage": self.stage, "method": self.method,
                "comm_dtype": self.comm_dtype, "nonfinite": self.nonfinite,
                "saturated": self.saturated, "elems": self.elems,
                "sat_fraction": self.sat_fraction,
                "tripped": list(self.tripped)}


@dataclass(frozen=True)
class HealthReport:
    """Guard outcome of one guarded plan execution.

    ``tripped`` collects every trip code: per-stage ``"stage{i}:nonfinite"``
    / ``"stage{i}:saturation"``, plus the global ``"input:nonfinite"``,
    ``"output:nonfinite"`` and ``"parseval"``.  The energies and the
    Parseval error are None for all-lossless schedules.  ``transitions``
    records every degradation step the runner took; ``attempts`` counts
    executions including the final one."""

    guard: str
    direction: str
    nfields: int
    schedule: tuple
    stages: tuple[StageHealth, ...]
    energy_in: float | None
    energy_out: float | None
    parseval_rel_err: float | None
    parseval_tol: float | None
    tripped: tuple[str, ...]
    transitions: tuple = ()
    attempts: int = 1
    fired_faults: tuple = field(default=(), compare=False)

    @property
    def ok(self) -> bool:
        return not self.tripped

    def tripped_stage_indices(self) -> tuple[int, ...]:
        """Exchange-stage indices named by per-stage trip codes."""
        out = []
        for code in self.tripped:
            if code.startswith("stage") and ":" in code:
                out.append(int(code.split(":")[0][len("stage"):]))
        return tuple(sorted(set(out)))

    @property
    def has_global_trip(self) -> bool:
        return any(not c.startswith("stage") for c in self.tripped)

    def to_dict(self) -> dict:
        return {
            "guard": self.guard, "direction": self.direction,
            "nfields": self.nfields,
            "schedule": [list(e) for e in self.schedule],
            "stages": [s.to_dict() for s in self.stages],
            "energy_in": self.energy_in, "energy_out": self.energy_out,
            "parseval_rel_err": self.parseval_rel_err,
            "parseval_tol": self.parseval_tol,
            "tripped": list(self.tripped),
            "transitions": [dict(t) for t in self.transitions],
            "attempts": self.attempts,
        }


def _walk(plan, direction: str):
    """(stages, pencils, dtypes) in execution order for ``direction``."""
    from repro_torch.core.pfft import _reverse_plan

    if direction == "forward":
        return plan.stages, plan.pencil_trace, plan.dtype_trace
    stages, pencils = _reverse_plan(plan.stages, plan.pencil_trace)
    return stages, pencils, plan.dtype_trace[::-1]


def parseval_factor(plan, direction: str) -> float | None:
    """Expected ``energy_out / energy_in``, or None when the plan does not
    conserve energy analytically (any non-c2c axis).  The unnormalized
    forward multiplies energy by ``prod(shape)``; the backward divides it
    back out."""
    if any(sp.kind != "c2c" for sp in plan.transforms):
        return None
    n = float(math.prod(plan.shape))
    return n if direction == "forward" else 1.0 / n


def build_report(plan, *, direction: str, nfields: int, schedule, stats,
                 guard: str, transitions=(), attempts: int = 1,
                 fired_faults=()) -> HealthReport:
    """Evaluate one execution's summed guard stats into a HealthReport
    (``stats`` from :func:`unpack_partials`; payload element counts from the
    plan's pencil and dtype traces)."""
    from repro_torch.core.pfft import ExchangeStage

    stages, pencils, dtypes = _walk(plan, direction)
    # the schedule is in forward order; stats rows are in execution order
    entries = list(schedule) if direction == "forward" else list(schedule)[::-1]
    lossy = schedule_is_lossy(entries)
    nonfinite = [float(v) for v in stats["nonfinite"]]
    saturated = [float(v) for v in stats["saturated"]]
    e_in = float(stats["energy_in"])
    e_out = float(stats["energy_out"])
    probe = float(stats.get("probe", 0.0))

    rows: list[StageHealth] = []
    tripped: list[str] = []
    ex_i = 0
    for i, st in enumerate(stages):
        if not isinstance(st, ExchangeStage):
            continue
        method, comm_dtype = entries[ex_i][0], entries[ex_i][2]
        planes = 2 if dtypes[i] == torch.complex64 else 1
        elems = max(1, nfields) * planes * math.prod(pencils[i].physical)
        codes = []
        if nonfinite[ex_i] > 0:
            codes.append(f"stage{ex_i}:nonfinite")
        if comm_dtype == "int8" and saturated[ex_i] / elems > SAT_FRACTION_TRIP:
            codes.append(f"stage{ex_i}:saturation")
        rows.append(StageHealth(
            stage=ex_i, method=method, comm_dtype=comm_dtype,
            nonfinite=int(nonfinite[ex_i]), saturated=int(saturated[ex_i]),
            elems=elems, tripped=tuple(codes)))
        tripped.extend(codes)
        ex_i += 1

    if lossy and not math.isfinite(e_in):
        tripped.append("input:nonfinite")
    if (lossy and not math.isfinite(e_out)) or not math.isfinite(probe):
        tripped.append("output:nonfinite")

    factor = parseval_factor(plan, direction) if lossy else None
    rel_err = tol = None
    if factor is not None and math.isfinite(e_in) and math.isfinite(e_out):
        want = factor * e_in
        rel_err = abs(e_out - want) / max(want, 1e-30)
        tol = max(1e-3, sum(PARSEVAL_TOL.get(e[2], 1e-3) for e in entries))
        if rel_err > tol:
            tripped.append("parseval")

    return HealthReport(
        guard=guard, direction=direction, nfields=nfields,
        schedule=tuple(tuple(e) for e in entries), stages=tuple(rows),
        energy_in=e_in if lossy else None,
        energy_out=e_out if lossy else None,
        parseval_rel_err=rel_err, parseval_tol=tol, tripped=tuple(tripped),
        transitions=tuple(transitions), attempts=attempts,
        fired_faults=tuple(fired_faults))

"""Distributed multidimensional FFT (paper Secs. 3.3, 3.5, 3.6) on rank-local
blocks — the port of ``repro/core/pfft.py``.

``ParallelFFT`` plans a d-dimensional transform of a global array
decomposed on a k-dimensional mesh subgrid (k <= d-1: slab, pencil, ...):

  forward:  F_{d-1} ... F_k (local trailing axes), then for i = k-1 ... 0:
            exchange(v=i+1 -> w=i over subgroup P_i); F_i
  backward: the exact reverse.

torch runs one process per rank: :meth:`ParallelFFT.forward_padded` and
:meth:`~ParallelFFT.backward_padded` transform this rank's padded block,
and :meth:`~ParallelFFT.forward` / :meth:`~ParallelFFT.backward` take a
logical-shape global tensor that every rank holds, cut out this rank's
block, run, and all-gather the result.

``method`` is ``"fused"`` (the paper's single all-to-all), ``"traditional"``
(pack + all-to-all + unpack) or ``"pipelined"`` (sliced exchanges, each
slice's next-stage FFT issued before the wait of the next slice); the tuned
``"auto"`` raises ``NotImplementedError`` until the tuner is ported
(ROADMAP).  ``guard="strict"|"degrade"`` routes ``forward``/``backward``
through :func:`repro_torch.robustness.runner.run_guarded` and returns
``(result, HealthReport)``; the guarded executor sums its stat vector over
the plan's world with one ``all_reduce``, the one collective the
reference's single controller does not need.  Plans run single-field blocks
(``forward_many``, ROADMAP).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import cached_property

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import fftcore
from repro_torch.core.decomp import pad_to_multiple
from repro_torch.core.fftcore import TransformSpec, as_spec
from repro_torch.core.meshutil import mesh_device
from repro_torch.core.pencil import (Group, Pencil, allgather_global, group_size, make_pencil,
                                     scatter_global)
from repro_torch.core.planconfig import PlanConfig, StageEntry
from repro_torch.core.redistribute import exchange_shard, exchange_shard_sliced
from repro_torch.robustness import faults, health


@dataclass(frozen=True)
class FFTStage:
    axis: int
    spec: TransformSpec
    n: int  # full transform length; the spectral extent is spec.spectral_extent(n)


@dataclass(frozen=True)
class ExchangeStage:
    v: int
    w: int
    group: Group


Stage = FFTStage | ExchangeStage


class ParallelFFT:
    """Plan + executor for a distributed d-dim transform.

    Args:
      mesh:   a ``DeviceMesh`` with ``mesh_dim_names`` (see
              :func:`repro_torch.core.meshutil.make_mesh`); blocks live on
              its device.
      shape:  logical global array shape (d axes).
      grid:   k mesh dimension names decomposing array axes 0..k-1.
      config: a :class:`~repro_torch.core.planconfig.PlanConfig`
              (``None``: defaults).
      transforms: per-axis :class:`TransformSpec` or tag strings, length d
              (default all c2c).
    """

    def __init__(self, mesh: DeviceMesh, shape: tuple[int, ...], grid: tuple[Group, ...], *,
                 config: PlanConfig | None = None, transforms=None):
        d, k = len(shape), len(grid)
        if not 1 <= k <= d - 1:
            raise ValueError(f"need 1 <= len(grid)={k} <= d-1={d - 1}")
        config = PlanConfig() if config is None else config
        if config.method == "auto":
            raise NotImplementedError(
                "method='auto' needs the schedule tuner (core/tuner.py), not ported yet "
                "(ROADMAP); pass method='fused', 'traditional' or 'pipelined'")
        if transforms is not None:
            specs = tuple(as_spec(s) for s in transforms)
            if len(specs) != d:
                raise ValueError(f"transforms must have one spec per axis: got {len(specs)}, need {d}")
        else:
            specs = (TransformSpec.c2c(),) * d
        # dtype legality in apply order (axis d-1 -> 0): r2c must see real data
        seen_complex = False
        for a in range(d - 1, -1, -1):
            if specs[a].kind == "r2c":
                if seen_complex:
                    raise ValueError(
                        f"r2c on axis {a} would see complex data: every axis after it "
                        f"(higher index) must be dct/dst, and only one r2c is allowed")
                seen_complex = True
            elif specs[a].kind == "c2c":
                seen_complex = True
        self.transforms = specs
        self.mesh, self.shape, self.grid = mesh, tuple(shape), tuple(grid)
        self.config = config
        self.method, self.chunks, self.guard = config.method, config.chunks, config.guard
        self.impl, self.exchange_impl = config.impl, config.exchange_impl
        self.comm_dtype = config.comm_dtype
        self.d, self.k = d, k
        self.device = mesh_device(mesh)

        sizes = [group_size(mesh, g) for g in grid]
        # every subgroup an axis is ever distributed over, in either direction
        divisors = [1] * d
        for j in range(k):
            divisors[j] = math.lcm(divisors[j], sizes[j])
        for j in range(1, k + 1):
            divisors[j] = math.lcm(divisors[j], sizes[j - 1])
        # subgroup an axis is split over after its own transform
        future_div = [sizes[j - 1] if 1 <= j <= k else 1 for j in range(d)]

        placement: list[Group | None] = [grid[i] if i < k else None for i in range(d)]
        self.input_pencil = make_pencil(mesh, self.shape, tuple(placement),
                                        divisors=tuple(divisors))

        first_complex = next((specs[a].kind for a in range(d - 1, -1, -1)
                              if not specs[a].real_to_real), None)
        in_real = first_complex in (None, "r2c")
        out_real = first_complex is None

        # pencil_trace[i] / dtype_trace[i] describe the block before stages[i]
        stages: list[Stage] = []
        pencils: list[Pencil] = [self.input_pencil]
        dtypes: list = [torch.float32 if in_real else torch.complex64]
        cur, cur_dt = self.input_pencil, dtypes[0]

        def push_fft(axis: int):
            nonlocal cur, cur_dt
            sp = specs[axis]
            n = self.shape[axis]
            stages.append(FFTStage(axis, sp, n))
            ext = sp.spectral_extent(n)
            if ext != cur.logical[axis]:
                cur = _repad(cur.with_axis_extent(axis, ext), axis, future_div[axis])
            if not sp.real_to_real:
                cur_dt = torch.complex64
            pencils.append(cur)
            dtypes.append(cur_dt)

        for axis in range(d - 1, k - 1, -1):
            push_fft(axis)
        for i in range(k - 1, -1, -1):
            stages.append(ExchangeStage(v=i + 1, w=i, group=grid[i]))
            cur = cur.exchanged(i + 1, i)
            pencils.append(cur)
            dtypes.append(cur_dt)
            push_fft(i)
        self.stages = tuple(stages)
        self.pencil_trace = tuple(pencils)
        self.dtype_trace = tuple(dtypes)
        self.output_pencil = cur
        self.input_dtype = dtypes[0]
        self.spectral_dtype = torch.float32 if out_real else torch.complex64

    @property
    def n_exchanges(self) -> int:
        return sum(isinstance(s, ExchangeStage) for s in self.stages)

    @cached_property
    def schedule(self) -> tuple[StageEntry, ...]:
        """:class:`StageEntry` per exchange stage, forward order."""
        entry = self.config.stage_entry()._replace(batch_fusion="stacked").validate()
        return (entry,) * self.n_exchanges

    # -- executors on this rank's padded block -------------------------------

    def _walk(self, direction: str):
        """(stages, pencils, sign, input pencil) of ``direction``."""
        if direction == "forward":
            return self.stages, self.pencil_trace, fftcore.FORWARD, self.input_pencil
        if direction == "backward":
            stages, pencils = _reverse_plan(self.stages, self.pencil_trace)
            return stages, pencils, fftcore.BACKWARD, self.output_pencil
        raise ValueError(f"unknown direction {direction!r}")

    def _execute(self, block, direction: str, schedule, guard: bool):
        stages, pencils, sign, pen = self._walk(direction)
        self._check_block(block, pen)
        sched = schedule if direction == "forward" else schedule[::-1]
        return _run_stages(block, stages=stages, pencils=pencils, schedule=sched,
                           impl=self.impl, sign=sign, mesh=self.mesh, guard=guard)

    def forward_padded(self, block: torch.Tensor) -> torch.Tensor:
        """Forward transform of this rank's padded block (input pencil)."""
        return self._execute(block, "forward", self.schedule, guard=False)

    def backward_padded(self, block: torch.Tensor) -> torch.Tensor:
        """Backward transform of this rank's padded block (output pencil)."""
        return self._execute(block, "backward", self.schedule, guard=False)

    def guarded_padded(self, direction: str = "forward", *, schedule=None):
        """Guarded executor on this rank's padded block: ``fn(block) ->
        (block, stats)``, ``stats`` the packed guard-stat vector
        (:func:`repro_torch.robustness.health.pack_stats`) summed over the
        plan's world by one ``all_reduce``, in float64.  ``schedule``
        (forward order) overrides the plan's own; the degradation ladder
        runs through here with widened entries."""
        schedule = self.schedule if schedule is None else tuple(schedule)
        world = dist.get_world_size()
        if self.mesh.size() != world:
            raise ValueError(f"a guarded plan's mesh of {self.mesh.size()} ranks must cover "
                             f"the world of {world}")

        def fn(block):
            y, vec = self._execute(block, direction, schedule, guard=True)
            vec = vec.to(torch.float64)
            dist.all_reduce(vec, op=dist.ReduceOp.SUM)
            return y, vec

        return fn

    def warm(self, directions=("forward", "backward")) -> int:
        """Run each requested direction once on a zero block (through the
        guarded executor when the plan is guarded), so that the kernels'
        build and the first launches happen before the first real call.
        Returns the number of executors run."""
        n = 0
        for direction in directions:
            _, _, _, pen = self._walk(direction)
            dt = self.input_dtype if direction == "forward" else self.spectral_dtype
            block = torch.zeros(pen.local_shape, dtype=dt, device=self.device)
            if self.guard != "off":
                self.guarded_padded(direction)(block)
            else:
                self._execute(block, direction, self.schedule, guard=False)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def _check_block(self, block: torch.Tensor, pencil: Pencil):
        if tuple(block.shape) != pencil.local_shape:
            raise ValueError(f"block shape {tuple(block.shape)} != local shape {pencil.local_shape}")
        if block.device != self.device:
            raise ValueError(f"block on {block.device}, plan on {self.device}")

    # -- logical-shape global tensors ---------------------------------------

    def forward(self, x):
        """Forward transform of the logical global array ``x`` (every rank
        passes the same array); returns the logical global spectrum on the
        plan's device, with the :class:`~repro_torch.robustness.health.HealthReport`
        when the plan is guarded."""
        return self._global(x, "forward", self.input_dtype, self.output_pencil)

    def backward(self, x):
        return self._global(x, "backward", self.spectral_dtype, self.input_pencil)

    def _global(self, x, direction: str, dtype, out_pen: Pencil):
        _, _, _, in_pen = self._walk(direction)
        xt = torch.as_tensor(x).to(device=self.device, dtype=dtype)
        block = scatter_global(xt, in_pen, dist.get_rank())
        if self.guard != "off":
            from repro_torch.robustness import runner

            y, report = runner.run_guarded(self, block, direction)
            return allgather_global(y, out_pen), report
        return allgather_global(self._execute(block, direction, self.schedule, guard=False),
                                out_pen)


def _repad(pencil: Pencil, axis: int, divisor: int) -> Pencil:
    m = divisor
    if pencil.placement[axis] is not None:
        m = math.lcm(m, group_size(pencil.mesh, pencil.placement[axis]))
    new_physical = list(pencil.physical)
    new_physical[axis] = pad_to_multiple(pencil.logical[axis], m)
    return replace(pencil, physical=tuple(new_physical))


def _reverse_plan(stages, pencils):
    """Backward schedule: reversed stages, exchanges with v/w swapped; the
    BACKWARD sign selects each FFT stage's inverse."""
    rev_stages: list[Stage] = []
    rev_pencils: list[Pencil] = [pencils[-1]]
    for idx in range(len(stages) - 1, -1, -1):
        st = stages[idx]
        if isinstance(st, ExchangeStage):
            rev_stages.append(ExchangeStage(v=st.w, w=st.v, group=st.group))
        else:
            rev_stages.append(st)
        rev_pencils.append(pencils[idx])
    return tuple(rev_stages), tuple(rev_pencils)


def _run_stages(block, *, stages, pencils, schedule, impl, sign, mesh, guard=False):
    """Execute the plan on this rank's block; each exchange is followed by
    the FFT of its newly aligned axis.  ``guard=True`` also returns this
    rank's packed guard-stat vector: the output probe always, the Parseval
    energy bracket and the per-stage counts for lossy schedules."""
    lossy = guard and health.schedule_is_lossy(schedule)
    zero = torch.zeros((), dtype=torch.float32, device=block.device)
    energy_in = health.block_energy(block) if lossy else zero
    per_stage = []
    ex_i = i = 0
    while i < len(stages):
        st = stages[i]
        if isinstance(st, ExchangeStage):
            nxt = stages[i + 1] if i + 1 < len(stages) else None
            fft_st = nxt if isinstance(nxt, FFTStage) and nxt.axis == st.w else None
            block, stats = _run_exchange_stage(
                block, st, fft_st, pencils[i + 1],
                pencils[i + 2] if fft_st is not None else None,
                schedule[ex_i], impl=impl, sign=sign, mesh=mesh, guard=guard, stage_index=ex_i)
            per_stage.append(stats)
            ex_i += 1
            i += 2 if fft_st is not None else 1
        else:
            block = _fft_padded_axis(block, st, pencils[i], pencils[i + 1], impl=impl, sign=sign)
            i += 1
    if not guard:
        return block
    energy_out = health.block_energy(block) if lossy else zero
    last = stages[-1]
    probe = health.output_probe(block, last.axis if isinstance(last, FFTStage) else None)
    return block, health.pack_stats(per_stage, energy_in, energy_out, probe)


def _run_exchange_stage(block, ex: ExchangeStage, fft_st: FFTStage | None, mid: Pencil,
                        after: Pencil | None, entry: StageEntry, *, impl, sign, mesh,
                        guard=False, stage_index=None):
    """One exchange stage (+ the FFT of its newly aligned axis) under one
    schedule entry; returns ``(block, stats)``, ``stats`` None unless
    ``guard``.  The fault taps return their input when no FaultPlan is
    armed."""
    method, chunks, comm_dtype, ex_impl, _ = entry
    with faults.stage_context(stage_index, method, comm_dtype):
        faults.check_compile(method, comm_dtype)
        block = faults.tap_stage_input(block)
        if fft_st is not None and method == "pipelined" and chunks > 1:
            return _exchange_then_fft(block, ex, fft_st, mid, after, chunks=chunks,
                                      comm_dtype=comm_dtype, exchange_impl=ex_impl, impl=impl,
                                      sign=sign, mesh=mesh, guard=guard)
        res = exchange_shard(block, ex.v, ex.w, ex.group, mesh=mesh, method=method,
                             chunks=chunks, comm_dtype=comm_dtype, impl=ex_impl, guard=guard)
        block, stats = res if guard else (res, None)
        if fft_st is not None:
            block = _fft_padded_axis(block, fft_st, mid, after, impl=impl, sign=sign)
        return block, stats


def _exchange_then_fft(block, ex: ExchangeStage, fft_st: FFTStage, mid: Pencil, after: Pencil,
                       *, chunks, comm_dtype, exchange_impl, impl, sign, mesh, guard):
    """Pipelined exchange fused with the next stage's 1-D FFT: every
    slice's collective is issued, then each slice's FFT is issued right
    after its wait, before the wait of the next slice, so the card can run
    slice ``i + 1``'s collective under slice ``i``'s FFT.  Slicing commutes
    with the FFT along ``w``, so the concat equals the unpipelined result
    (bitwise for lossless payloads)."""
    res = exchange_shard_sliced(
        block, ex.v, ex.w, ex.group, mesh=mesh, chunks=chunks, comm_dtype=comm_dtype,
        guard=guard, impl=exchange_impl,
        then=lambda p: _fft_padded_axis(p, fft_st, mid, after, impl=impl, sign=sign))
    out, stats = res if guard else (res, None)
    out = out[0] if len(out) == 1 else torch.cat(out, dim=ex.v)
    return out, stats


def _fft_padded_axis(block, st: FFTStage, cur: Pencil, nxt: Pencil, *, impl, sign):
    """One transform stage along a locally complete axis: slice to the
    logical extent, transform at the true length, zero-pad to the next
    physical extent."""
    axis = st.axis
    n_log_in = cur.logical[axis]
    if block.shape[axis] != cur.physical[axis]:
        raise AssertionError(
            f"axis {axis}: local extent {block.shape[axis]} != physical {cur.physical[axis]}")
    if n_log_in != block.shape[axis]:
        block = torch.narrow(block, axis, 0, n_log_in)
    block = fftcore.local_transform(block, axis, sign, st.spec, n=st.n, impl=impl)
    n_phys_out = nxt.physical[axis]
    if block.shape[axis] != n_phys_out:
        shape = list(block.shape)
        shape[axis] = n_phys_out - block.shape[axis]
        block = torch.cat([block, block.new_zeros(shape)], dim=axis)
    return block

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
(pack + all-to-all + unpack), ``"pipelined"`` (sliced exchanges, each
slice's next-stage FFT issued before the wait of the next slice) or
``"auto"``, a per-stage schedule timed on this plan's stages and cached on
disk (:mod:`repro_torch.core.tuner`; every rank resolves the same one).
``guard="strict"|"degrade"`` routes ``forward``/``backward``
through :func:`repro_torch.robustness.runner.run_guarded` and returns
``(result, HealthReport)``; the guarded executor sums its stat vector over
the plan's world with one ``all_reduce``, the one collective the
reference's single controller does not need.

Batched multi-field execution (``forward_many``/``backward_many``, and
``forward``/``backward`` of a ``d+1``-dim input): N fields go through the
plan as one stacked block with a leading field axis, replicated on every
rank.  FFT stages transform all fields in one call; each exchange stage
follows its schedule entry's ``batch_fusion``:

``"stacked"`` (default)       — one collective per exchange ships every
    field (one per slice when pipelined); a lossy codec runs once over the
    stack, int8 with one scale per (field, chunk).
``"pipelined-across-fields"`` — per-field collectives, field ``f``'s issued
    (``async_op=True``, :func:`~repro_torch.core.redistribute.exchange_shard_start`)
    before field ``f - 1``'s FFT is launched and waited for after it, so the
    card can run the one under the other.  The traditional and pipelined
    engines exchange each field to completion, as the reference does.
``"per-field"``               — N serialized exchange + FFT pairs.

Every mode is bitwise equal to the per-field loop for a lossless wire.
``forward_many`` takes a tensor with a leading field axis, or a list, tuple
or dict of logical-shape fields, and returns the same structure; other
containers are not taken.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import cached_property

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import fftcore
from repro_torch.core.decomp import local_lengths, pad_to_multiple
from repro_torch.core.fftcore import TransformSpec, as_spec
from repro_torch.core.meshutil import mesh_device
from repro_torch.core.pencil import (Group, Pencil, allgather_global, group_size, make_pencil,
                                     scatter_global)
from repro_torch.core.hardware import HBM_BW, ICI_BW, ICI_LATENCY_S, PEAK_FLOPS
from repro_torch.core.planconfig import PlanConfig, StageEntry, as_schedule
from repro_torch.core.quant import canonical_comm_dtype
from repro_torch.core.redistribute import (exchange_collective_launches,
                                           exchange_local_copy_elems, exchange_shard,
                                           exchange_shard_sliced, exchange_shard_start,
                                           exchange_takes_any_layout, exchange_time_model,
                                           exchange_wire_bytes, pipeline_slices)
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
      grid:   k groups decomposing array axes 0..k-1, each a mesh dimension
              name or a tuple of names (a composed group, e.g. a slab over
              ``(("p0", "p1"),)``).
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
        self.comm_dtype, self.tuner_cache = config.comm_dtype, config.tuner_cache
        self._batched_sched_memo: dict[int, tuple[StageEntry, ...]] = {}
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
        """:class:`StageEntry` per exchange stage, forward order: uniform for
        the explicit methods; for ``method="auto"`` tuned within the plan's
        ``comm_dtype`` and ``exchange_impl`` budgets and cached on disk
        (``tuner_cache``), the same on every rank."""
        if self.method == "auto":
            from repro_torch.core import tuner

            return as_schedule(tuner.get_or_tune(self, cache_path=self.tuner_cache))
        entry = self.config.stage_entry()._replace(batch_fusion="stacked").validate()
        return (entry,) * self.n_exchanges

    def batched_schedule(self, nfields: int) -> tuple[StageEntry, ...]:
        """:class:`StageEntry` per exchange stage of an ``nfields``-field
        execution, forward order: the plan's uniform ``batch_fusion`` (one
        field: ``"stacked"``); ``method="auto"`` tunes the batch-aware
        candidates, cached per field count."""
        if nfields <= 1:
            return tuple(e._replace(batch_fusion="stacked") for e in self.schedule)
        if nfields not in self._batched_sched_memo:
            if self.method == "auto":
                from repro_torch.core import tuner

                sched = as_schedule(tuner.get_or_tune(self, cache_path=self.tuner_cache,
                                                      nfields=nfields))
            else:
                sched = (self.config.stage_entry().validate(),) * self.n_exchanges
            self._batched_sched_memo[nfields] = sched
        return self._batched_sched_memo[nfields]

    # -- executors on this rank's padded block -------------------------------

    def _walk(self, direction: str):
        """(stages, pencils, sign, input pencil) of ``direction``."""
        if direction == "forward":
            return self.stages, self.pencil_trace, fftcore.FORWARD, self.input_pencil
        if direction == "backward":
            stages, pencils = _reverse_plan(self.stages, self.pencil_trace)
            return stages, pencils, fftcore.BACKWARD, self.output_pencil
        raise ValueError(f"unknown direction {direction!r}")

    def _execute(self, block, direction: str, schedule, guard: bool, nbatch: int = 0):
        stages, pencils, sign, pen = self._walk(direction)
        self._check_block(block, pen, nbatch)
        sched = schedule if direction == "forward" else schedule[::-1]
        return _run_stages(block, stages=stages, pencils=pencils, schedule=sched,
                           impl=self.impl, sign=sign, mesh=self.mesh, nbatch=nbatch, guard=guard)

    def forward_padded(self, block: torch.Tensor) -> torch.Tensor:
        """Forward transform of this rank's padded block (input pencil)."""
        return self._execute(block, "forward", self.schedule, guard=False)

    def backward_padded(self, block: torch.Tensor) -> torch.Tensor:
        """Backward transform of this rank's padded block (output pencil)."""
        return self._execute(block, "backward", self.schedule, guard=False)

    def forward_many_padded(self, nfields: int):
        """Batched forward on this rank's stacked padded block ``(nfields,
        *local_shape)``: ``fn(block) -> block``."""
        return self._many_padded(nfields, "forward")

    def backward_many_padded(self, nfields: int):
        return self._many_padded(nfields, "backward")

    def _many_padded(self, nfields: int, direction: str):
        schedule = self.batched_schedule(nfields)

        def fn(block):
            if block.shape[0] != nfields:
                raise ValueError(f"stacked block of {block.shape[0]} fields, need {nfields}")
            return self._execute(block, direction, schedule, guard=False, nbatch=1)

        return fn

    def guarded_padded(self, direction: str = "forward", *, schedule=None, nfields: int = 1):
        """Guarded executor on this rank's padded block (stacked
        ``(nfields, ...)`` when ``nfields > 1``): ``fn(block) -> (block,
        stats)``, ``stats`` the packed guard-stat vector
        (:func:`repro_torch.robustness.health.pack_stats`) summed over the
        plan's world by one ``all_reduce``, in float64.  ``schedule``
        (forward order) overrides the plan's own; the degradation ladder
        runs through here with widened entries."""
        schedule = self.batched_schedule(nfields) if schedule is None else tuple(schedule)
        nbatch = 1 if nfields > 1 else 0
        world = dist.get_world_size()
        if self.mesh.size() != world:
            raise ValueError(f"a guarded plan's mesh of {self.mesh.size()} ranks must cover "
                             f"the world of {world}")

        def fn(block):
            y, vec = self._execute(block, direction, schedule, guard=True, nbatch=nbatch)
            vec = vec.to(torch.float64)
            dist.all_reduce(vec, op=dist.ReduceOp.SUM)
            return y, vec

        return fn

    def warm(self, directions=("forward", "backward"), *, nfields: int = 1) -> int:
        """Resolve the schedule (the tuner's sweep for ``method="auto"``),
        then run each requested direction once on a zero block (through the
        guarded executor when the plan is guarded; stacked when ``nfields >
        1``), so that the kernels' build and the first launches happen before
        the first real call.  Returns the number of executors run."""
        self.batched_schedule(nfields)
        n = 0
        for direction in directions:
            _, _, _, pen = self._walk(direction)
            dt = self.input_dtype if direction == "forward" else self.spectral_dtype
            lead = (nfields,) if nfields > 1 else ()
            block = torch.zeros(lead + pen.local_shape, dtype=dt, device=self.device)
            if self.guard != "off":
                self.guarded_padded(direction, nfields=nfields)(block)
            elif nfields > 1:
                self._many_padded(nfields, direction)(block)
            else:
                self._execute(block, direction, self.schedule, guard=False)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def _check_block(self, block: torch.Tensor, pencil: Pencil, nbatch: int = 0):
        if tuple(block.shape[nbatch:]) != pencil.local_shape or block.dim() != nbatch + self.d:
            raise ValueError(f"block shape {tuple(block.shape)} != {nbatch} field axes + local "
                             f"shape {pencil.local_shape}")
        if block.device != self.device:
            raise ValueError(f"block on {block.device}, plan on {self.device}")

    # -- logical-shape global tensors ---------------------------------------

    def forward(self, x):
        """Forward transform of the logical global array ``x`` (every rank
        passes the same array); returns the logical global spectrum on the
        plan's device, with the :class:`~repro_torch.robustness.health.HealthReport`
        when the plan is guarded.  A ``d+1``-dim ``x`` is a stack of fields
        and goes through :meth:`forward_many`."""
        if torch.as_tensor(x).dim() == self.d + 1:
            return self.forward_many(x)
        return self._global(x, "forward")

    def backward(self, x):
        if torch.as_tensor(x).dim() == self.d + 1:
            return self.backward_many(x)
        return self._global(x, "backward")

    def _pencils(self, direction: str):
        """(input pencil, output pencil, input dtype) of ``direction``."""
        if direction == "forward":
            return self.input_pencil, self.output_pencil, self.input_dtype
        return self.output_pencil, self.input_pencil, self.spectral_dtype

    def _global(self, x, direction: str):
        in_pen, out_pen, dtype = self._pencils(direction)
        xt = torch.as_tensor(x).to(device=self.device, dtype=dtype)
        block = scatter_global(xt, in_pen, dist.get_rank())
        if self.guard != "off":
            from repro_torch.robustness import runner

            y, report = runner.run_guarded(self, block, direction)
            return allgather_global(y, out_pen), report
        return allgather_global(self._execute(block, direction, self.schedule, guard=False),
                                out_pen)

    def forward_many(self, xs):
        """Transform N fields through one batched execution.  ``xs`` is a
        tensor (or numpy array) with a leading field axis, ``(N, *shape)``,
        or a list, tuple or dict of N logical-shape fields; the result has
        the same structure (with the HealthReport when guarded).  Each
        exchange stage ships the fields by its ``batch_fusion`` mode: one
        collective per stage under ``"stacked"`` instead of the N of a
        per-field loop."""
        return self._apply_many(xs, "forward")

    def backward_many(self, xs):
        return self._apply_many(xs, "backward")

    def _apply_many(self, xs, direction: str):
        in_pen, out_pen, dtype = self._pencils(direction)
        if isinstance(xs, dict):
            keys, leaves = list(xs), list(xs.values())
        elif isinstance(xs, (list, tuple)):
            keys, leaves = None, list(xs)
        else:
            keys, leaves = None, None
        if leaves is None:
            stacked = torch.as_tensor(xs).to(device=self.device, dtype=dtype)
            if stacked.dim() != self.d + 1:
                raise ValueError(f"stacked {direction} input must be (nfields, *{in_pen.logical});"
                                 f" got {stacked.dim()} dims for a d={self.d} plan")
        elif not leaves:
            raise ValueError(f"{direction}_many needs at least one field")
        else:
            stacked = torch.stack([torch.as_tensor(f).to(device=self.device, dtype=dtype)
                                   for f in leaves])
        nfields = stacked.shape[0]
        block = scatter_global(stacked, in_pen, dist.get_rank(), nbatch=1)
        report = None
        if self.guard != "off":
            from repro_torch.robustness import runner

            if nfields == 1:  # the guarded executors take a stack only for nfields > 1
                y, report = runner.run_guarded(self, block[0], direction)
                y = y[None]
            else:
                y, report = runner.run_guarded(self, block, direction, nfields)
        else:
            y = self._many_padded(nfields, direction)(block)
        y = allgather_global(y, out_pen, nbatch=1)
        if leaves is not None:
            fields = list(y.unbind(0))
            if keys is not None:
                y = dict(zip(keys, fields))
            else:
                y = type(xs)(fields)
        return y if report is None else (y, report)

    # -- counts and the time model: pure arithmetic, the reference's values ---
    # (the local copies are the port's: redistribute.exchange_local_copy_elems)

    def model_flops(self, nfields: int = 1) -> float:
        """5 n log2 n per 1-D transform summed over the plan (transforms of
        real data, r2c and dct/dst on a still-real block, counted as half);
        ``nfields`` scales the whole plan."""
        return nfields * sum(self._stage_flops_at(i) for i, st in enumerate(self.stages)
                             if isinstance(st, FFTStage))

    def _stage_flops_at(self, i: int, stages=None, pencils=None, dtypes=None) -> float:
        """Nominal flops of FFT stage ``i``: 5 n log2 n per transform times
        the other axes' current logical extents (from the pencil trace)."""
        stages = self.stages if stages is None else stages
        pencils = self.pencil_trace if pencils is None else pencils
        dtypes = self.dtype_trace if dtypes is None else dtypes
        st = stages[i]
        batch = 1.0
        for ax, ext in enumerate(pencils[i].logical):
            if ax != st.axis:
                batch *= ext
        flops = 5.0 * st.n * math.log2(max(st.n, 2)) * batch
        if st.spec.kind == "r2c" or dtypes[i] == torch.float32:
            flops *= 0.5
        return flops

    def _stage_itemsize(self, i: int, dtypes=None) -> int:
        dtypes = self.dtype_trace if dtypes is None else dtypes
        return 8 if dtypes[i] == torch.complex64 else 4

    def comm_bytes_per_device(self, itemsize: int | None = None, *, method: str | None = None,
                              comm_dtype=None, nfields: int = 1) -> int:
        """Wire bytes each rank sends over all exchanges, at each stage's
        payload width: the plan's resolved schedule by default (the tuned
        payloads of ``method="auto"`` once resolved), or a uniform
        ``comm_dtype``.  ``method`` adds that engine's local copies
        (:func:`~repro_torch.core.redistribute.exchange_local_copy_elems`);
        ``itemsize=None`` prices each stage at its dtype (complex64 8, a
        still-real float32 stage 4); ``nfields`` stacks fields; a pipelined
        ``method`` is priced at the plan's ``chunks``.  Pure
        arithmetic: a byte count never triggers the tuner."""
        if comm_dtype is None:
            batched = self._batched_sched_memo.get(nfields) if nfields > 1 else None
            if batched is not None:
                entries = [tuple(e)[:3] for e in batched]
            elif self.method == "auto" and "schedule" not in self.__dict__:
                # no schedule resolved yet: price the uniform budget
                entries = [("fused", 1, self.comm_dtype)] * self.n_exchanges
            else:
                entries = [tuple(e)[:3] for e in self.schedule]
        else:
            entries = [("fused", 1, canonical_comm_dtype(comm_dtype))] * self.n_exchanges
        total, ex_i = 0, 0
        for i, st in enumerate(self.stages):
            if not isinstance(st, ExchangeStage):
                continue
            isz = itemsize if itemsize is not None else self._stage_itemsize(i)
            e_method, e_chunks, e_dtype = entries[ex_i]
            src = self.pencil_trace[i]
            slices = (pipeline_slices(src, st.v, st.w, chunks=e_chunks)
                      if e_method == "pipelined" else 1)
            total += exchange_wire_bytes(src, st.v, st.w, itemsize=isz, comm_dtype=e_dtype,
                                         nfields=nfields, slices=slices)
            ex_i += 1
            if method is not None:
                total += (exchange_local_copy_elems(src, st.v, st.w, method=method,
                                                    chunks=self.chunks) * isz * nfields)
        return total

    def model_time_s(self, *, itemsize: int | None = None, peak_flops: float = PEAK_FLOPS,
                     ici_bw: float = ICI_BW, hbm_bw: float = HBM_BW,
                     ici_latency_s: float | None = None, schedule=None,
                     direction: str = "forward", nfields: int = 1,
                     batch_fusion: str | None = None, exchange_only: bool = False) -> float:
        """Modeled seconds of one transform at this card's constants
        (:mod:`repro_torch.core.hardware`) unless given: FFT stages at
        ``peak_flops``, each exchange by
        :func:`~repro_torch.core.redistribute.exchange_time_model` with the
        FFT after it as its overlap partner.  ``schedule`` defaults to the
        plan's (resolved; ``method="auto"`` tunes); ``direction="backward"``
        walks the reversed plan; ``nfields`` prices a batched execution, each
        stage's fusion from its entry or uniformly ``batch_fusion``;
        ``exchange_only`` prices the exchanges alone.  The coefficients are
        free so :mod:`repro_torch.core.modelfit` can fit them."""
        if ici_latency_s is None:
            ici_latency_s = ICI_LATENCY_S
        if schedule is None:
            schedule = self.batched_schedule(nfields)
        schedule = as_schedule(schedule)
        if direction == "forward":
            stages, pencils, dtypes = self.stages, self.pencil_trace, self.dtype_trace
        elif direction == "backward":
            stages, pencils = _reverse_plan(self.stages, self.pencil_trace)
            dtypes = self.dtype_trace[::-1]
            schedule = schedule[::-1]
        else:
            raise ValueError(f"unknown direction {direction!r}")
        ndev = math.prod(group_size(self.mesh, g) for g in self.grid)
        total, ex_i, i = 0.0, 0, 0
        while i < len(stages):
            st = stages[i]
            if isinstance(st, ExchangeStage):
                method, chunks, comm_dtype, ex_impl, fusion = schedule[ex_i]
                if batch_fusion is not None:
                    fusion = batch_fusion
                ex_i += 1
                src_pen = pencils[i]  # the block before this exchange
                isz = itemsize if itemsize is not None else self._stage_itemsize(i, dtypes)
                nxt = stages[i + 1] if i + 1 < len(stages) else None
                fft_s = 0.0
                if isinstance(nxt, FFTStage) and nxt.axis == st.w:
                    if not exchange_only:
                        fft_s = (self._stage_flops_at(i + 1, stages, pencils, dtypes)
                                 / ndev / peak_flops)
                    i += 1  # folded into the exchange's term
                total += exchange_time_model(
                    src_pen, st.v, st.w, itemsize=isz, method=method, chunks=chunks,
                    comm_dtype=comm_dtype, impl=ex_impl, ici_bw=ici_bw, hbm_bw=hbm_bw,
                    ici_latency_s=ici_latency_s, overlap_compute_s=fft_s, nfields=nfields,
                    batch_fusion=fusion)
            elif not exchange_only:
                total += nfields * self._stage_flops_at(i, stages, pencils, dtypes) / ndev / peak_flops
            i += 1
        return total

    def model_collective_launches(self, *, nfields: int = 1, schedule=None,
                                  batch_fusion: str | None = None,
                                  direction: str = "forward") -> int:
        """Payload collectives one transform issues under its schedule
        (:func:`~repro_torch.core.redistribute.exchange_collective_launches`
        per exchange; int8's scale collectives not counted)."""
        if schedule is None:
            schedule = self.batched_schedule(nfields)
        if direction == "backward":
            schedule = tuple(schedule)[::-1]
        elif direction != "forward":
            raise ValueError(f"unknown direction {direction!r}")
        total, ex_i = 0, 0
        for i, st in enumerate(self.stages):
            if not isinstance(st, ExchangeStage):
                continue
            entry = StageEntry.make(schedule[ex_i])
            ex_i += 1
            fusion = batch_fusion if batch_fusion is not None else entry.batch_fusion
            total += exchange_collective_launches(
                self.pencil_trace[i], st.v, st.w, method=entry.method, chunks=entry.chunks,
                nfields=nfields, batch_fusion=fusion)
        return total

    def audit(self, *, nfields: int = 1, direction: str = "forward", schedule=None):
        """Audit one run of this plan's executor against its schedule
        contracts (collective counts, wire bytes, the engine's copies, dtype
        flow, guard and kernel containment): a thin wrapper of
        :func:`repro_torch.analysis.planlint.audit_plan`, returning its
        :class:`~repro_torch.analysis.planlint.AuditReport`.  Collective:
        every rank calls it alike."""
        from repro_torch.analysis.planlint import audit_plan

        return audit_plan(self, nfields=nfields, direction=direction, schedule=schedule)


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


def _run_stages(block, *, stages, pencils, schedule, impl, sign, mesh, nbatch=0, guard=False):
    """Execute the plan on this rank's block; each exchange is followed by
    the FFT of its newly aligned axis.  ``nbatch=1``: a stacked multi-field
    block; FFT stages transform every field in one call and exchange stages
    follow their entry's ``batch_fusion``.  ``guard=True`` also returns this
    rank's packed guard-stat vector: the output probe always, the Parseval
    energy bracket and the per-stage counts (summed over fields) for lossy
    schedules."""
    lossy = guard and health.schedule_is_lossy(schedule)
    zero = torch.zeros((), dtype=torch.float32, device=block.device)
    energy_in = health.block_energy(block) if lossy else zero
    per_stage = []
    ex_i = i = 0

    def contiguous_before(j, k):
        """Whether the transform at stage ``j`` hands on a contiguous block:
        stage ``j + 1`` is the ``k``-th exchange and takes its block as it
        lies (a strided view would be copied by its pack, outside every
        contract; ``exchange_takes_any_layout``)."""
        ex = stages[j + 1] if j + 1 < len(stages) else None
        if not isinstance(ex, ExchangeStage):
            return False
        method, chunks, comm_dtype, ex_impl, fusion = schedule[k]
        return not exchange_takes_any_layout(
            pencils[j + 1], ex.v, ex.w, method=method, chunks=chunks, comm_dtype=comm_dtype,
            impl=ex_impl, nbatch=nbatch if fusion == "stacked" else 0)

    while i < len(stages):
        st = stages[i]
        if isinstance(st, ExchangeStage):
            nxt = stages[i + 1] if i + 1 < len(stages) else None
            fft_st = nxt if isinstance(nxt, FFTStage) and nxt.axis == st.w else None
            block, stats = _run_exchange_stage(
                block, st, fft_st, pencils[i + 1],
                pencils[i + 2] if fft_st is not None else None,
                schedule[ex_i], impl=impl, sign=sign, mesh=mesh, nbatch=nbatch, guard=guard,
                stage_index=ex_i,
                contiguous=fft_st is not None and contiguous_before(i + 1, ex_i + 1))
            per_stage.append(stats)
            ex_i += 1
            i += 2 if fft_st is not None else 1
        else:
            block = _fft_padded_axis(block, st, pencils[i], pencils[i + 1], impl=impl, sign=sign,
                                     nbatch=nbatch, contiguous=contiguous_before(i, ex_i))
            i += 1
    if not guard:
        return block
    energy_out = health.block_energy(block) if lossy else zero
    last = stages[-1]
    probe = health.output_probe(block, last.axis + nbatch if isinstance(last, FFTStage) else None)
    return block, health.pack_stats(per_stage, energy_in, energy_out, probe)


def _run_exchange_stage(block, ex: ExchangeStage, fft_st: FFTStage | None, mid: Pencil,
                        after: Pencil | None, entry: StageEntry, *, impl, sign, mesh, nbatch=0,
                        guard=False, stage_index=None, contiguous=False):
    """One exchange stage (+ the FFT of its newly aligned axis) under one
    schedule entry; returns ``(block, stats)``, ``stats`` None unless
    ``guard``.  A stacked block (``nbatch=1``) goes through the entry's
    ``batch_fusion`` mode (module docstring).  ``contiguous``: the output
    block must be contiguous (:func:`_fft_padded_axis`).  The fault taps
    return their input when no FaultPlan is armed."""
    method, chunks, comm_dtype, ex_impl, fusion = entry
    with faults.stage_context(stage_index, method, comm_dtype):
        faults.check_compile(method, comm_dtype)
        block = faults.tap_stage_input(block)
        if nbatch and fusion != "stacked":
            return _run_fields(block, ex, fft_st, mid, after, method=method, chunks=chunks,
                               comm_dtype=comm_dtype, exchange_impl=ex_impl, fusion=fusion,
                               impl=impl, sign=sign, mesh=mesh, guard=guard)
        return _exchange_and_fft(block, ex, fft_st, mid, after, method=method, chunks=chunks,
                                 comm_dtype=comm_dtype, exchange_impl=ex_impl, impl=impl,
                                 sign=sign, mesh=mesh, nbatch=nbatch, guard=guard,
                                 contiguous=contiguous)


def _exchange_and_fft(block, ex: ExchangeStage, fft_st: FFTStage | None, mid: Pencil,
                      after: Pencil | None, *, method, chunks, comm_dtype, exchange_impl, impl,
                      sign, mesh, nbatch, guard, contiguous=False):
    """One exchange of ``block`` (every field of a stacked block at once),
    then the FFT of its newly aligned axis; a chunked pipelined engine
    interleaves its slices with that FFT.  Returns ``(block, stats)``."""
    if fft_st is not None and method == "pipelined" and chunks > 1:
        return _exchange_then_fft(block, ex, fft_st, mid, after, chunks=chunks,
                                  comm_dtype=comm_dtype, exchange_impl=exchange_impl, impl=impl,
                                  sign=sign, mesh=mesh, nbatch=nbatch, guard=guard,
                                  contiguous=contiguous)
    res = exchange_shard(block, ex.v, ex.w, ex.group, mesh=mesh, method=method, chunks=chunks,
                         comm_dtype=comm_dtype, nbatch=nbatch, impl=exchange_impl, guard=guard)
    block, stats = res if guard else (res, None)
    if fft_st is not None:
        block = _fft_padded_axis(block, fft_st, mid, after, impl=impl, sign=sign, nbatch=nbatch,
                                 contiguous=contiguous)
    return block, stats


def _run_fields(block, ex: ExchangeStage, fft_st: FFTStage | None, mid: Pencil,
                after: Pencil | None, *, method, chunks, comm_dtype, exchange_impl, fusion, impl,
                sign, mesh, guard):
    """The per-field exchange modes of a stacked block, the stats summed
    over fields.  ``"per-field"``: each field's exchange and FFT in turn (a
    chunked pipelined engine interleaves its slices with the FFT as for one
    field).  ``"pipelined-across-fields"``: field ``f``'s exchange is
    started before field ``f - 1``'s FFT is launched, and finished after it."""
    stats = health.zero_stats(block.device) if guard else None

    def add(s):
        nonlocal stats
        if guard:
            stats = health.add_stats(stats, s)

    def fft(b):
        if fft_st is None:
            return b
        return _fft_padded_axis(b, fft_st, mid, after, impl=impl, sign=sign)

    outs = []
    if fusion == "per-field":
        for fb in block.unbind(0):
            out, s = _exchange_and_fft(fb, ex, fft_st, mid, after, method=method, chunks=chunks,
                                       comm_dtype=comm_dtype, exchange_impl=exchange_impl,
                                       impl=impl, sign=sign, mesh=mesh, nbatch=0, guard=guard)
            add(s)
            outs.append(out)
    elif fusion == "pipelined-across-fields":
        pending = None
        for fb in block.unbind(0):
            finish, s = exchange_shard_start(fb, ex.v, ex.w, ex.group, mesh=mesh, method=method,
                                             chunks=chunks, comm_dtype=comm_dtype,
                                             impl=exchange_impl, guard=guard, async_op=True)
            add(s)
            if pending is not None:  # field f's collective is issued; now f - 1's FFT
                outs.append(fft(pending()))
            pending = finish
        outs.append(fft(pending()))
    else:
        raise ValueError(f"unknown batch_fusion {fusion!r}")
    return torch.stack(outs), stats


def _exchange_then_fft(block, ex: ExchangeStage, fft_st: FFTStage, mid: Pencil, after: Pencil,
                       *, chunks, comm_dtype, exchange_impl, impl, sign, mesh, nbatch=0, guard,
                       contiguous=False):
    """Pipelined exchange fused with the next stage's 1-D FFT: every
    slice's collective is issued, then each slice's FFT is issued right
    after its wait, before the wait of the next slice, so the card can run
    slice ``i + 1``'s collective under slice ``i``'s FFT.  Slicing commutes
    with the FFT along ``w``, so the concat equals the unpipelined result
    (bitwise for lossless payloads).  With ``nbatch=1`` each slice carries
    every field's sub-range.  ``contiguous``: the output block is
    contiguous (the slices are concatenated in the block's own order; one
    slice is the transform's, :func:`_fft_padded_axis`)."""
    b = block.shape[ex.v + nbatch] // group_size(mid.mesh, ex.group)
    whole = len([n for n in local_lengths(b, max(1, min(chunks, b))) if n > 0]) == 1
    res = exchange_shard_sliced(
        block, ex.v, ex.w, ex.group, mesh=mesh, chunks=chunks, comm_dtype=comm_dtype,
        nbatch=nbatch, guard=guard, impl=exchange_impl,
        then=lambda p: _fft_padded_axis(p, fft_st, mid, after, impl=impl, sign=sign,
                                        nbatch=nbatch, contiguous=contiguous and whole))
    out, stats = res if guard else (res, None)
    if len(out) > 1:
        # into a contiguous buffer: torch.cat of 4-D moved views comes out
        # channels-last, a strided block for the next exchange
        shape = list(out[0].shape)
        shape[ex.v + nbatch] = sum(p.shape[ex.v + nbatch] for p in out)
        out = [torch.cat(out, dim=ex.v + nbatch, out=out[0].new_empty(shape))]
    return out[0], stats


def _fft_padded_axis(block, st: FFTStage, cur: Pencil, nxt: Pencil, *, impl, sign, nbatch=0,
                     contiguous=False):
    """One transform stage along a locally complete axis: slice to the
    logical extent, transform at the true length, zero-pad to the next
    physical extent.  ``st.axis`` is field-relative; ``nbatch`` leading
    field axes transform in the same call.  The transform of an axis that
    is not last leaves it moved back as a view; ``contiguous=True`` hands
    on a contiguous block instead, for an exchange that takes its block as
    it lies (:func:`~repro_torch.core.redistribute.exchange_takes_any_layout`),
    as the reference's ``jnp.fft`` moves its axis back."""
    axis = st.axis + nbatch
    n_log_in = cur.logical[st.axis]
    if block.shape[axis] != cur.physical[st.axis]:
        raise AssertionError(
            f"axis {st.axis}: local extent {block.shape[axis]} != physical "
            f"{cur.physical[st.axis]}")
    if n_log_in != block.shape[axis]:
        block = torch.narrow(block, axis, 0, n_log_in)
    block = fftcore.local_transform(block, st.axis, sign, st.spec, n=st.n, impl=impl,
                                    nbatch=nbatch)
    return fftcore.pad_axis(block, axis, nxt.physical[st.axis], contiguous=contiguous)

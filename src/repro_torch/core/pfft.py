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

This slice runs ``method="fused"`` without ``guard`` on single-field blocks;
the traditional, pipelined and tuned (``"auto"``) engines, batched fields
and guarded execution raise ``NotImplementedError`` (ROADMAP).
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
from repro_torch.core.redistribute import exchange_shard


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
        if config.method != "fused":
            raise NotImplementedError(
                f"method={config.method!r}: the port runs method='fused' only (ROADMAP: "
                "traditional and pipelined engines; tuner for 'auto')")
        if config.guard != "off":
            raise NotImplementedError("guard: ROADMAP item 'guard + robustness'")
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

    def forward_padded(self, block: torch.Tensor) -> torch.Tensor:
        """Forward transform of this rank's padded block (input pencil)."""
        self._check_block(block, self.input_pencil)
        return _run_stages(block, stages=self.stages, pencils=self.pencil_trace,
                           schedule=self.schedule, impl=self.impl, sign=fftcore.FORWARD,
                           mesh=self.mesh)

    def backward_padded(self, block: torch.Tensor) -> torch.Tensor:
        """Backward transform of this rank's padded block (output pencil)."""
        self._check_block(block, self.output_pencil)
        stages, pencils = _reverse_plan(self.stages, self.pencil_trace)
        return _run_stages(block, stages=stages, pencils=pencils,
                           schedule=self.schedule[::-1], impl=self.impl,
                           sign=fftcore.BACKWARD, mesh=self.mesh)

    def _check_block(self, block: torch.Tensor, pencil: Pencil):
        if tuple(block.shape) != pencil.local_shape:
            raise ValueError(f"block shape {tuple(block.shape)} != local shape {pencil.local_shape}")
        if block.device != self.device:
            raise ValueError(f"block on {block.device}, plan on {self.device}")

    # -- logical-shape global tensors ---------------------------------------

    def forward(self, x) -> torch.Tensor:
        """Forward transform of the logical global array ``x`` (every rank
        passes the same array); returns the logical global spectrum on the
        plan's device."""
        return self._global(x, self.input_pencil, self.output_pencil, self.input_dtype,
                            self.forward_padded)

    def backward(self, x) -> torch.Tensor:
        return self._global(x, self.output_pencil, self.input_pencil, self.spectral_dtype,
                            self.backward_padded)

    def _global(self, x, in_pen: Pencil, out_pen: Pencil, dtype, run) -> torch.Tensor:
        xt = torch.as_tensor(x).to(device=self.device, dtype=dtype)
        return allgather_global(run(scatter_global(xt, in_pen, dist.get_rank())), out_pen)


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


def _run_stages(block, *, stages, pencils, schedule, impl, sign, mesh):
    """Execute the plan on this rank's block; each exchange is followed by
    the FFT of its newly aligned axis."""
    ex_i = i = 0
    while i < len(stages):
        st = stages[i]
        if isinstance(st, ExchangeStage):
            nxt = stages[i + 1] if i + 1 < len(stages) else None
            fft_st = nxt if isinstance(nxt, FFTStage) and nxt.axis == st.w else None
            block = _run_exchange_stage(
                block, st, fft_st, pencils[i + 1],
                pencils[i + 2] if fft_st is not None else None,
                schedule[ex_i], impl=impl, sign=sign, mesh=mesh)
            ex_i += 1
            i += 2 if fft_st is not None else 1
        else:
            block = _fft_padded_axis(block, st, pencils[i], pencils[i + 1], impl=impl, sign=sign)
            i += 1
    return block


def _run_exchange_stage(block, ex: ExchangeStage, fft_st: FFTStage | None, mid: Pencil,
                        after: Pencil | None, entry: StageEntry, *, impl, sign, mesh):
    """One exchange stage (+ the FFT of its newly aligned axis)."""
    block = exchange_shard(block, ex.v, ex.w, ex.group, mesh=mesh, method=entry.method,
                           comm_dtype=entry.comm_dtype, impl=entry.impl)
    if fft_st is not None:
        block = _fft_padded_axis(block, fft_st, mid, after, impl=impl, sign=sign)
    return block


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

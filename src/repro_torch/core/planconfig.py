"""Plan configuration of the PyTorch port — the validated surface of
:class:`repro_torch.core.pfft.ParallelFFT`.

The fields and vocabulary mirror the JAX package's ``PlanConfig`` with the
port's own implementation names:

``impl``          local 1-D FFT: ``"torch"`` (``torch.fft``, the counterpart
                  of ``jnp.fft``) or ``"matmul"`` (the four-step DFT kernel,
                  :mod:`repro_torch.kernels.fft`).
``exchange_impl`` exchange-local codec/pack: ``"torch"`` (plain tensor code,
                  :mod:`repro_torch.kernels.exchange.ref`) or ``"cuda"`` (the
                  hand-written exchange kernels, :mod:`repro_torch.kernels.exchange`).
                  For ``method="auto"`` it is a candidate budget: the tuner
                  sweeps the kernels (on lossy payloads) only under ``"cuda"``.

:func:`config_from_reference` maps a JAX config's fields
(``dataclasses.asdict``) onto this one, so a test can build both plans from
one description.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import NamedTuple

from repro_torch.core.quant import canonical_comm_dtype
from repro_torch.robustness.health import GUARD_MODES

#: exchange-local implementations a stage entry may carry
EXCHANGE_IMPLS = ("torch", "cuda")

#: local 1-D FFT implementations
FFT_IMPLS = ("torch", "matmul")

#: batch_fusion execution modes for a stacked multi-field exchange stage
BATCH_FUSIONS = ("stacked", "pipelined-across-fields", "per-field")

#: exchange engines a stage entry may carry ("auto" is plan-level only)
METHODS = ("fused", "traditional", "pipelined")

#: the reference's implementation names -> the port's
_REFERENCE_IMPLS = {"jnp": "torch", "pallas": "cuda", "matmul": "matmul"}


class StageEntry(NamedTuple):
    """One exchange stage's execution entry: ``(method, chunks, comm_dtype,
    impl, batch_fusion)``, ``impl`` being the exchange-local implementation."""

    method: str
    chunks: int
    comm_dtype: str
    impl: str = "torch"
    batch_fusion: str = "stacked"

    @classmethod
    def make(cls, entry) -> "StageEntry":
        """Normalize any schedule-entry form into a validated StageEntry: a
        StageEntry, a legacy ``(method, chunks, comm_dtype)`` or ``(...,
        batch_fusion)`` row, or a full 5-tuple.  A legacy 4-tuple's last
        field is classified by vocabulary (``impl`` and ``batch_fusion``
        values are disjoint)."""
        if isinstance(entry, cls):
            return entry.validate()
        t = tuple(entry)
        if len(t) == 3:
            return cls(t[0], int(t[1]), t[2]).validate()
        if len(t) == 4:
            if t[3] in BATCH_FUSIONS:
                return cls(t[0], int(t[1]), t[2], "torch", t[3]).validate()
            return cls(t[0], int(t[1]), t[2], t[3]).validate()
        if len(t) == 5:
            return cls(t[0], int(t[1]), t[2], t[3], t[4]).validate()
        raise ValueError(f"schedule entry {entry!r} has {len(t)} fields; expected 3-5")

    def validate(self) -> "StageEntry":
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; expected one of {METHODS}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.impl not in EXCHANGE_IMPLS:
            raise ValueError(f"unknown exchange impl {self.impl!r}; expected one of {EXCHANGE_IMPLS}")
        if self.batch_fusion not in BATCH_FUSIONS:
            raise ValueError(
                f"unknown batch_fusion {self.batch_fusion!r}; expected one of {BATCH_FUSIONS}")
        d = canonical_comm_dtype(self.comm_dtype)
        return self if d == self.comm_dtype else self._replace(comm_dtype=d)


def as_schedule(entries) -> tuple[StageEntry, ...]:
    """Normalize an iterable of schedule entries (any legacy form) into a
    tuple of :class:`StageEntry`: the one normalizer every consumer of a
    user- or disk-provided schedule shares."""
    return tuple(StageEntry.make(e) for e in entries)


@dataclass(frozen=True)
class PlanConfig:
    """Validated execution config for one ParallelFFT (fields as in the
    reference; see the module docstring for the implementation names)."""

    method: str = "fused"
    impl: str = "torch"
    exchange_impl: str = "torch"
    chunks: int = 4
    comm_dtype: str | None = None
    batch_fusion: str = "stacked"
    tuner_cache: str | None = None  # schedule-cache path for method="auto"
    guard: str = "off"

    def __post_init__(self):
        if self.method not in (*METHODS, "auto"):
            raise ValueError(f"unknown method {self.method!r}; expected one of {(*METHODS, 'auto')}")
        if self.impl not in FFT_IMPLS:
            raise ValueError(f"unknown FFT impl {self.impl!r}; expected one of {FFT_IMPLS}")
        if self.exchange_impl not in EXCHANGE_IMPLS:
            raise ValueError(
                f"unknown exchange_impl {self.exchange_impl!r}; expected one of {EXCHANGE_IMPLS}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.batch_fusion not in BATCH_FUSIONS:
            raise ValueError(
                f"unknown batch_fusion {self.batch_fusion!r}; expected one of {BATCH_FUSIONS}")
        if self.guard not in GUARD_MODES:
            raise ValueError(f"unknown guard {self.guard!r}; expected one of {GUARD_MODES}")
        object.__setattr__(self, "comm_dtype", canonical_comm_dtype(self.comm_dtype))

    def replace(self, **changes) -> "PlanConfig":
        """Functional update (re-validates through ``__post_init__``)."""
        return replace(self, **changes)

    def stage_entry(self) -> StageEntry:
        """The uniform StageEntry an explicit-method config implies for
        every exchange stage."""
        chunks = self.chunks if self.method == "pipelined" else 1
        return StageEntry(self.method, chunks, self.comm_dtype,
                          self.exchange_impl, self.batch_fusion)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


def config_from_reference(d: dict) -> PlanConfig:
    """The port's config for a reference ``PlanConfig``'s fields
    (``dataclasses.asdict`` of it): ``"jnp"`` -> ``"torch"`` and
    ``"pallas"`` -> ``"cuda"``; every other field carries over."""
    d = dict(d)
    for key in ("impl", "exchange_impl"):
        if d.get(key) is not None:
            if d[key] not in _REFERENCE_IMPLS:
                raise ValueError(f"unknown reference {key} {d[key]!r}")
            d[key] = _REFERENCE_IMPLS[d[key]]
    return PlanConfig(**d)

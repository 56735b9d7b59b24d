"""Deterministic fault injection for guarded-execution and serving tests —
the port of ``repro/robustness/faults.py``.

:class:`FaultPlan` is a context manager that arms injectors; the plan
executor calls tap functions at fixed points of every exchange stage (wire
buffers after the collective, stage inputs, the int8 codec's scale, the
start of a stage) and each tap perturbs its tensor only while a matching
fault is armed.  With no active FaultPlan every tap returns its input
untouched and launches nothing.

Faults target a (stage, engine, codec) triple, ``None`` being a wildcard,
so a fault pinned to ``engine="fused"`` stops matching once the runner's
ladder moves the stage to another engine.

Injectors: :meth:`FaultPlan.corrupt_wire` (exponent burst on element 0 of
a received wire buffer; int8 payloads flip a magnitude bit, so target
``label="scale"`` for a detectable int8 hit), :meth:`FaultPlan.nan_input`
(a NaN/Inf element 0 in a stage's input block), :meth:`FaultPlan.saturate`
(divides the int8 codec's scale so the payload clips),
:meth:`FaultPlan.fail_compile` (raises :class:`FaultInjected` at the start
of a matching stage) and :meth:`FaultPlan.poison_cache` (a tuner-cache
entry naming a schedule the tuner never timed).

The reference injects while it traces an executor, so a fault lives in the
compiled artifact; the port runs eagerly and its taps act on every call.
Tests build fresh plans inside ``with FaultPlan()`` in both packages, so the
outcomes agree.  Each rank arms its own FaultPlan: every rank's block gets
the same fault, as every shard's does in the reference.

Serve-level injectors (:mod:`repro_torch.serve`) act on the host side of the
serving engine's request lifecycle: :meth:`FaultPlan.slow_collective` (a
plan execution stalls ``seconds``), :meth:`FaultPlan.executor_crash` (an
execution attempt raises :class:`FaultInjected`), :meth:`FaultPlan.cache_corruption`
(the schedule cache is scribbled over between dispatches: ``"garbage"``
bytes or an empty file) and :meth:`FaultPlan.request_burst` (the load
harness multiplies its offered load).  Each takes ``times`` (``None``:
unlimited); a fault disarms itself after firing that many times.

The stage context the taps match is kept per thread, so a thread that runs
one schedule never sees another thread's (stage, engine, codec).
"""

from __future__ import annotations

import threading
import time as _time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path

import torch


class FaultInjected(RuntimeError):
    """Raised by an armed compile-failure fault at the start of a matching
    exchange stage (the stand-in for a schedule that cannot run)."""


@dataclass
class _Fault:
    kind: str                 # corrupt_wire | nan_input | saturate | compile_fail
                              # | slow_collective | executor_crash
                              # | cache_corruption | request_burst
    stage: int | None = None  # exchange index (execution order); None = any
    engine: str | None = None
    codec: str | None = None
    label: str | None = None  # corrupt_wire: "payload" | "scale"; cache_corruption: mode
    value: float = 0.0
    times: int | None = None  # fires left before the fault disarms (None: unlimited)


#: the armed FaultPlan (one at a time)
_ACTIVE: "FaultPlan | None" = None

#: the (stage, engine, codec) the executor is running, per thread
_CTX_LOCAL = threading.local()


def _ctx() -> dict:
    if not hasattr(_CTX_LOCAL, "ctx"):
        _CTX_LOCAL.ctx = {"stage": None, "engine": None, "codec": None}
    return _CTX_LOCAL.ctx


class FaultPlan:
    """Armed set of deterministic faults (see the module docstring).  Use as
    a context manager; injector methods return ``self`` so they chain.
    ``fired`` records every injection, with the context it matched."""

    def __init__(self):
        self._faults: list[_Fault] = []
        self.fired: list[dict] = []

    def corrupt_wire(self, *, stage=None, engine=None, codec=None, label="payload"):
        self._faults.append(_Fault("corrupt_wire", stage, engine, codec, label))
        return self

    def nan_input(self, *, stage=None, engine=None, codec=None, value=float("nan")):
        self._faults.append(_Fault("nan_input", stage, engine, codec, None, value))
        return self

    def saturate(self, *, stage=None, engine=None, factor=64.0):
        self._faults.append(_Fault("saturate", stage, engine, "int8", None, factor))
        return self

    def fail_compile(self, *, stage=None, engine=None, codec=None):
        self._faults.append(_Fault("compile_fail", stage, engine, codec))
        return self

    # -- serve-level injectors (host side of the request lifecycle) ---------

    def slow_collective(self, *, seconds=1.0, times=None):
        """Stall plan executions by ``seconds`` (a slow collective as the
        serving engine sees it)."""
        self._faults.append(_Fault("slow_collective", value=seconds, times=times))
        return self

    def executor_crash(self, *, times=1):
        """Raise :class:`FaultInjected` from ``times`` plan execution
        attempts (a crashed executor; the retry path's hook)."""
        self._faults.append(_Fault("executor_crash", times=times))
        return self

    def cache_corruption(self, *, mode="garbage", times=1):
        """Corrupt the schedule cache between dispatches: ``"garbage"``
        writes unparseable bytes, ``"truncate"`` empties the file."""
        if mode not in ("garbage", "truncate"):
            raise ValueError(f"unknown cache_corruption mode {mode!r}")
        self._faults.append(_Fault("cache_corruption", label=mode, times=times))
        return self

    def request_burst(self, *, factor=4, times=1):
        """Tell the load harness to multiply its offered load by ``factor``
        for ``times`` waves."""
        self._faults.append(_Fault("request_burst", value=float(factor), times=times))
        return self

    @staticmethod
    def poison_cache(path, plan, schedule, *, nfields: int = 1) -> str:
        """Write a well-formed tuner-cache entry for ``plan``'s key naming
        ``schedule``, which the tuner never timed; returns the key.  Paired
        with :meth:`fail_compile` on that schedule's engine, it is a cache
        entry that replays but cannot run.  Call it on one rank (the cache
        reader) or on each: the entry is the same."""
        from repro_torch.core import tuner

        key = tuner.plan_key(plan, nfields=nfields)
        tuner.save_cache(path, {key: {"schedule": [list(s) for s in schedule],
                                      "timings": {"poisoned": {}}}})
        return key

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already active")
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return False


@contextmanager
def stage_context(stage, engine, codec):
    """Executor hook: scope the (stage, engine, codec) the taps match, in
    this thread."""
    ctx = _ctx()
    prev = dict(ctx)
    ctx.update(stage=stage, engine=engine, codec=codec)
    try:
        yield
    finally:
        ctx.update(prev)


def _matching(kind: str, label: str | None = None):
    if _ACTIVE is None:
        return []
    out = []
    ctx = _ctx()
    for f in _ACTIVE._faults:
        if f.kind != kind:
            continue
        if f.times is not None and f.times <= 0:
            continue  # a bounded fault that has used up its fires
        if f.stage is not None and f.stage != ctx["stage"]:
            continue
        if f.engine is not None and f.engine != ctx["engine"]:
            continue
        if f.codec is not None and f.codec != ctx["codec"]:
            continue
        if label is not None and f.label is not None and f.label != label:
            continue
        out.append(f)
    return out


def _fire(f: _Fault, **note):
    if f.times is not None:
        f.times -= 1
    _ACTIVE.fired.append({"kind": f.kind, **_ctx(), **note})


# -- taps (each returns its input untouched when nothing matches) -----------


def check_compile(engine: str, codec: str):
    """Raise :class:`FaultInjected` if a compile-failure fault matches the
    current stage."""
    for f in _matching("compile_fail"):
        _fire(f)
        raise FaultInjected(
            f"injected schedule-compile failure (engine={engine!r}, "
            f"codec={codec!r}, stage={_ctx()['stage']})")


def tap_stage_input(block: torch.Tensor) -> torch.Tensor:
    """A copy of ``block`` with element 0 poisoned, when a nan_input fault
    matches."""
    for f in _matching("nan_input"):
        _fire(f, value=f.value)
        block = block.clone(memory_format=torch.contiguous_format)
        block.view(-1)[0] = f.value
    return block


def scale_div():
    """Combined scale divisor armed saturation faults impose on the int8
    codec (None when none match)."""
    div = 1.0
    for f in _matching("saturate"):
        _fire(f, factor=f.value)
        div *= f.value
    return div if div != 1.0 else None


#: exponent-burst masks: OR-ing forces the exponent field to all ones
#: (Inf/NaN) for float payloads; int8 flips a magnitude bit (bounded)
_BURST = {torch.float32: (torch.int32, 0x7F800000),
          torch.bfloat16: (torch.int16, 0x7F80),
          torch.int8: (torch.int8, 0x40)}


def tap_wire(x: torch.Tensor, label: str = "payload") -> torch.Tensor:
    """A copy of a received wire buffer (after the collective, before the
    decode) with element 0 corrupted, when a matching corrupt_wire fault is
    armed."""
    for f in _matching("corrupt_wire", label):
        _fire(f, label=label, dtype=str(x.dtype))
        x = _burst(x)
    return x


def _burst(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous().clone()
    # complex: the real part of element 0, as the reference bursts real(x)
    flat = (torch.view_as_real(x) if x.is_complex() else x).view(-1)
    ity, mask = _BURST[flat.dtype]
    u = flat.view(ity)
    if x.dtype == torch.int8:
        u[0] ^= mask  # single bit flip: bounded by the codec
    else:
        u[0] |= mask  # stuck-at-ones exponent burst -> Inf/NaN
    return x


# -- serve-level taps (host side; no-ops when nothing matches) ---------------


def tap_serve_execute():
    """Serving-engine hook at the start of every plan execution attempt: an
    armed ``slow_collective`` stalls, then an armed ``executor_crash``
    raises :class:`FaultInjected` (after any stall, so arming both models a
    slow executor that then dies)."""
    for f in _matching("slow_collective"):
        _fire(f, seconds=f.value)
        _time.sleep(f.value)
    for f in _matching("executor_crash"):
        _fire(f)
        raise FaultInjected("injected executor crash")


def tap_serve_cache(path) -> bool:
    """Serving-engine hook between dispatches: an armed ``cache_corruption``
    scribbles over the schedule cache at ``path`` (the torn write a crashed
    replica could leave).  Returns whether a corruption fired."""
    fired = False
    for f in _matching("cache_corruption"):
        _fire(f, mode=f.label, path=str(path))
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("" if f.label == "truncate" else '{"schema": 6, "trunca')
        fired = True
    return fired


def serve_burst() -> int:
    """Load-harness hook: the offered-load multiplier armed
    ``request_burst`` faults impose this wave (1 when none match)."""
    factor = 1.0
    for f in _matching("request_burst"):
        _fire(f, factor=f.value)
        factor *= f.value
    return max(1, int(factor))

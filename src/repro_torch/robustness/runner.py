"""Guarded plan execution: evaluate the guards, degrade, retry — the port of
``repro/robustness/runner.py``.

:func:`run_guarded` is what ``ParallelFFT.forward/backward`` and
``forward_many/backward_many`` route through when ``guard != "off"``.  One
attempt runs the plan's guarded executor on this rank's block (a stack of
``nfields`` fields when ``nfields > 1``) under the current schedule; the
executor sums the stat
vector over the ranks, so every rank builds the same
:class:`~.health.HealthReport` and takes the same step below.

``guard="strict"``: a tripped guard or an injected failure raises
:class:`GuardError` carrying the report.

``guard="degrade"``: the runner walks the degradation ladder and runs
again, at most :data:`MAX_ATTEMPTS` times.  A tripped stage widens that
stage's wire payload one rung (int8 -> bf16 -> complex64), then drops the
CUDA exchange kernels for the plain torch codec (cuda -> torch), then falls
back through the engines (pipelined -> fused -> traditional); a global trip
(Parseval, non-finite output) degrades every stage.  A ``method="auto"``
plan whose schedule fails to execute instead quarantines the cache entry
that produced it (:func:`repro_torch.core.tuner.quarantine`) and retunes,
at most :data:`~repro_torch.core.tuner.MAX_QUARANTINE_RETUNES` times; rank
0 quarantines and every rank drops its memos and agrees on the count.  A
ladder with no rung left raises :class:`GuardError`.

Unlike the reference, which degrades on any exception, the runner degrades
only on :class:`~.faults.FaultInjected` and on a tripped guard.  A kernel
that fails to build or launch (the ``ops.py`` wrappers raise) propagates to
the caller, so a broken kernel never looks like a recovered run on the
plain torch codec.
"""

from __future__ import annotations

import logging

from repro_torch.core.planconfig import StageEntry, as_schedule
from repro_torch.robustness import faults, health

log = logging.getLogger("repro_torch.robustness")

#: hard cap on executions per guarded call (2 payload rungs + 1 impl rung +
#: 2 engine rungs, plus headroom)
MAX_ATTEMPTS = 8

#: one-rung payload widening (lossier -> less lossy)
DTYPE_LADDER = {"int8": "bf16", "bf16": "complex64"}

#: engine fallback order once the payload is lossless
ENGINE_LADDER = {"pipelined": "fused", "fused": "traditional"}


class GuardError(RuntimeError):
    """A guarded execution could not produce a clean result.  ``report``
    carries the last :class:`~.health.HealthReport` (None when no execution
    completed)."""

    def __init__(self, message: str, report=None):
        super().__init__(message)
        self.report = report


def degrade_entry(entry) -> StageEntry | None:
    """One ladder rung for a schedule entry: widen the payload, then drop
    the CUDA exchange kernels for the plain torch codec, then fall back
    through the engines; None at the bottom (traditional @ complex64 @
    torch)."""
    e = StageEntry.make(entry)
    if e.comm_dtype in DTYPE_LADDER:
        return e._replace(comm_dtype=DTYPE_LADDER[e.comm_dtype])
    if e.impl == "cuda":
        return e._replace(impl="torch")
    if e.method in ENGINE_LADDER:
        return e._replace(method=ENGINE_LADDER[e.method], chunks=1)
    return None


def degrade_schedule(schedule, stages=None):
    """Degrade the entries at ``stages`` (all when None) one rung each; the
    new schedule, or None when no targeted entry has a rung left."""
    target = set(stages) if stages else set(range(len(schedule)))
    out, moved = [], False
    for i, e in enumerate(schedule):
        d = degrade_entry(e) if i in target else None
        if d is not None:
            out.append(d)
            moved = True
        else:
            out.append(e)
    return tuple(out) if moved else None


def _quarantine_and_retune(plan, nfields: int, err) -> int:
    """Mark the plan's cache entry bad (rank 0), drop every rank's copies of
    the schedule it produced, and return the entry's quarantine count, the
    same on every rank; the retune happens at the next resolve."""
    from repro_torch.core import tuner

    key = tuner.plan_key(plan, nfields=nfields)
    n = None
    if tuner.is_root(plan):
        n = tuner.quarantine(plan.tuner_cache or tuner.default_cache_path(), key,
                             repr(err)[:300])
    else:
        tuner.forget(key)
    plan.__dict__.pop("schedule", None)  # the cached_property
    plan._batched_sched_memo.pop(nfields, None)
    return tuner.broadcast(plan, n)


def run_guarded(plan, xpad, direction: str, nfields: int = 1, *, schedule=None):
    """Run ``plan`` on this rank's padded block ``xpad`` (``(nfields, ...)``
    stacked when ``nfields > 1``) under its guard mode; returns ``(ypad,
    HealthReport)``.  The schedule is ``plan.batched_schedule(nfields)``,
    resolved inside the attempt loop, unless ``schedule`` (forward order)
    forces where the ladder starts; a forced schedule that fails walks the
    ladder and never quarantines the tuner cache (it is not the cache's)."""
    from repro_torch.core import tuner

    strict = plan.guard == "strict"
    forced = schedule is not None
    if forced:
        schedule = as_schedule(schedule)
    transitions: list[dict] = []
    report = None
    for attempt in range(1, MAX_ATTEMPTS + 1):
        try:
            if schedule is None:
                schedule = plan.batched_schedule(nfields)
            y, raw = plan.guarded_padded(direction, schedule=schedule, nfields=nfields)(xpad)
        except faults.FaultInjected as err:
            log.warning("guarded %s execution failed (attempt %d): %r",
                        direction, attempt, err)
            if strict:
                raise GuardError(f"schedule failed to execute: {err!r}") from err
            if plan.method == "auto" and not forced:
                n = _quarantine_and_retune(plan, nfields, err)
                if n > tuner.MAX_QUARANTINE_RETUNES:
                    raise GuardError(f"cache entry quarantined {n}x and still failing: "
                                     f"{err!r}") from err
                transitions.append({"attempt": attempt, "kind": "retune", "quarantines": n,
                                    "reason": repr(err)[:200]})
                log.warning("quarantined tuner cache entry (count %d); retuning", n)
                schedule = None
                continue
            new = degrade_schedule(schedule)
            if new is None:
                raise GuardError(
                    f"degradation ladder exhausted after execution failure: {err!r}") from err
            transitions.append({"attempt": attempt, "kind": "degrade",
                                "from": [list(e) for e in schedule],
                                "to": [list(e) for e in new],
                                "reason": repr(err)[:200]})
            schedule = new
            continue

        stats = health.unpack_partials(raw.cpu().numpy(), len(schedule))
        report = health.build_report(
            plan, direction=direction, nfields=nfields, schedule=schedule, stats=stats,
            guard=plan.guard, transitions=transitions, attempts=attempt,
            fired_faults=tuple(faults._ACTIVE.fired) if faults._ACTIVE else ())
        if report.ok:
            if transitions:
                log.info("guarded %s recovered after %d attempt(s): %s", direction, attempt,
                         [t["kind"] for t in transitions])
            return y, report
        if strict:
            raise GuardError(f"runtime guard tripped: {report.tripped}", report)
        stages = None if report.has_global_trip else report.tripped_stage_indices()
        if stages and direction == "backward":
            # report indices are execution order; the schedule is forward order
            stages = tuple(len(schedule) - 1 - i for i in stages)
        new = degrade_schedule(schedule, stages)
        if new is None:
            raise GuardError(
                f"degradation ladder exhausted; still tripping {report.tripped}", report)
        transitions.append({"attempt": attempt, "kind": "degrade",
                            "tripped": list(report.tripped),
                            "from": [list(e) for e in schedule],
                            "to": [list(e) for e in new]})
        log.warning("guard tripped %s; degrading %s -> %s", report.tripped, schedule, new)
        schedule = new
    raise GuardError(f"guarded execution hit the {MAX_ATTEMPTS}-attempt cap", report)

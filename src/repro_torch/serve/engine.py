"""The resilient spectral serving engine — the port of ``repro/serve/engine.py``.

:class:`SpectralServer` turns :class:`~repro_torch.core.pfft.ParallelFFT`
into a long-running service.  One dispatch worker drains a bounded admission
queue; requests for the same ``(shape, direction)`` are **coalesced** into
one batched ``forward_many``/``backward_many`` execution (one collective per
exchange stage for the whole group instead of one per request).  Every
request rides the reference's lifecycle:

admission    — the queue is bounded (``max_queue``); overload is *shed* at
               submit time with a structured ``shed`` outcome.
deadline     — per request; the future self-resolves ``deadline-exceeded``,
               so a wedged execution is observable (``late_results``) but
               never hangs a caller.
retry        — transient failures (injected crashes, other exceptions)
               re-dispatch with exponential backoff and deterministic
               jitter, bounded by ``max_retries`` and the group's earliest
               deadline (a kernel that fails to build or launch ends there,
               as an ``error`` outcome: the fallback does not serve it).
breaker      — terminal ``GuardError`` failures count against the plan's
               circuit breaker; a trip serves the group through the bottom
               of the degradation ladder (:func:`~repro_torch.serve.registry.
               fallback_schedule`) as ``degraded`` / ``circuit-open``, then
               quarantines an auto plan's cache entry and retunes and
               re-warms the plan.

**Several ranks.**  The reference is one controller; the port runs one
process per rank, and a plan's ``forward`` takes the global array on every
rank.  So rank 0 controls: only rank 0 admits requests (``submit``) and
holds the queue, the futures, the deadlines, the breakers and the stats.
Its dispatch worker broadcasts each group to every rank — a small control
message (``broadcast_object_list``: op, shape, direction, field count), then
the stacked global fields (``broadcast``) — and the other ranks run
:meth:`SpectralServer.follow`, which executes each message until the stop
message :meth:`~SpectralServer.close` sends.  Building and warming a plan
(``registry.get``) is collective, so it runs on every rank as part of the
group.  The ranks agree (``all_reduce(MAX)`` of ok / transient / guard
error) on every step that can fail on one rank alone: the build, staging
the group's fields on each rank's device (the cast, the receiving block)
and each primary or fallback attempt.  Rank 0 alone then picks the next
step (retry, fallback, retune, done) and broadcasts it, so a fault armed on
every rank fires on every rank while only rank 0's clock decides deadlines
and backoff.  The retune after a trip is a control message of its own,
between groups, on every rank: no collective of it runs beside a dispatch.  An exception that one rank alone raises in the middle
of a collective leaves the others waiting in it; the faults this engine
recovers from fire before a collective, on every rank.

Fault hooks (:mod:`repro_torch.robustness.faults`): ``tap_serve_execute``
before every execution attempt, ``tap_serve_cache`` against the schedule
cache before each group (rank 0, which alone reads and writes the cache).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.core.meshutil import mesh_device
from repro_torch.core.pencil import allgather_global, scatter_global
from repro_torch.robustness import faults
from repro_torch.robustness.runner import GuardError, run_guarded
from repro_torch.serve.lifecycle import (
    TRIP_CIRCUIT, TRIP_SHED, TRIP_TIMEOUT,
    Outcome, Request, RequestFuture, backoff_s, next_request_id,
)
from repro_torch.serve.registry import PlanRegistry, fallback_schedule

log = logging.getLogger("repro_torch.serve")

_COUNTERS = ("submitted", "ok", "degraded", "shed", "deadline_exceeded",
             "error", "retries", "coalesced_batches", "batched_requests",
             "fallback_served", "late_results", "expired_before_dispatch",
             "retunes")

#: an attempt's status, agreed over the ranks by MAX
_OK, _TRANSIENT, _GUARD = 0, 1, 2


@dataclass
class ServeConfig:
    """Engine knobs (plan-level knobs live in the PlanConfig template)."""

    capacity: int = 8              #: LRU plan slots
    max_queue: int = 64            #: admission bound; beyond -> shed
    max_batch: int = 8             #: coalescing cap per dispatch
    deadline_s: float = 30.0       #: default per-request deadline
    grace_s: float = 0.25          #: result() slack past the deadline
    max_retries: int = 2           #: transient re-dispatches per group
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0
    breaker_threshold: int = 3     #: consecutive GuardErrors to trip
    breaker_cooldown_s: float = 5.0
    warm_directions: tuple = ("forward",)
    warm_nfields: int = 1


class SpectralServer:
    """Long-running spectral FFT service over one device mesh.

    ``submit`` (rank 0) is thread-safe and non-blocking (shed rather than
    block); results come back through
    :class:`~repro_torch.serve.lifecycle.RequestFuture`.  The other ranks
    call :meth:`follow`.  Plans are forced to ``guard="degrade"`` unless the
    template already asks for ``"strict"``: an unguarded plan has no ladder
    to serve through.
    """

    def __init__(self, mesh, grid, *, plan_config=None,
                 config: ServeConfig | None = None):
        from repro_torch.core.planconfig import PlanConfig

        self.config = config if config is not None else ServeConfig()
        pc = plan_config if plan_config is not None else PlanConfig()
        if pc.guard == "off":
            pc = pc.replace(guard="degrade")
        self.plan_config = pc
        self.device = mesh_device(mesh)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.registry = PlanRegistry(
            mesh, grid, config=pc, capacity=self.config.capacity,
            warm_directions=self.config.warm_directions,
            warm_nfields=self.config.warm_nfields,
            breaker_threshold=self.config.breaker_threshold,
            breaker_cooldown_s=self.config.breaker_cooldown_s)
        self._queue: deque[Request] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._stats = dict.fromkeys(_COUNTERS, 0)
        self._stats_lock = threading.Lock()
        self._retune = None  # rank 0: the retune a trip asked for
        self._worker = None
        if self.rank == 0:
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="repro-torch-serve-dispatch",
                                            daemon=True)
            self._worker.start()

    # -- public surface ------------------------------------------------------

    def submit(self, x, *, direction: str = "forward",
               deadline_s: float | None = None) -> RequestFuture:
        """Admit one logical-shape field (a tensor or numpy array) for
        transform; returns its future immediately.  A full queue sheds the
        request (structured ``shed`` outcome).  Rank 0 only."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 admits requests; the other ranks call follow()")
        if direction not in ("forward", "backward"):
            raise ValueError(f"unknown direction {direction!r}")
        deadline_s = self.config.deadline_s if deadline_s is None else deadline_s
        rid = next_request_id()
        fut = RequestFuture(rid, time.monotonic() + deadline_s)
        with self._cv:
            if self._closed:
                raise RuntimeError("server is closed")
            self._bump("submitted")
            if len(self._queue) >= self.config.max_queue:
                fut.resolve(Outcome("shed", rid, trip=TRIP_SHED))
                self._bump("shed")
                return fut
            self._queue.append(Request(x=x, shape=tuple(x.shape),
                                       direction=direction, future=fut))
            self._cv.notify()
        return fut

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["queue_depth"] = len(self._queue)
        out["registry"] = self.registry.stats()
        return out

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until the queue is empty and the worker is idle."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self._cv:
                if not self._queue and not self._dispatching:
                    return True
            time.sleep(0.01)
        return False

    def close(self, timeout: float = 30.0):
        """Stop admitting, drain in-flight work, stop the other ranks'
        :meth:`follow`, join the worker (rank 0; a no-op elsewhere)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)

    def follow(self):
        """The other ranks' side of every dispatch: receive each control
        message from rank 0 and execute it, until the stop message."""
        if self.rank == 0:
            raise RuntimeError("rank 0 dispatches; follow() runs on the other ranks")
        self._on_device()
        while True:
            msg = self._bcast(None)
            if msg["op"] == "stop":
                return
            if msg["op"] == "group":
                self._run_group(msg, None)
            elif msg["op"] == "retune":
                self._run_retune(msg)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the ranks' agreement ------------------------------------------------

    def _on_device(self):
        if self.device.type == "cuda":  # the current device is per thread
            torch.cuda.set_device(self.device)

    def _bcast(self, msg):
        """Rank 0's control message on every rank."""
        if self.world == 1:
            return msg
        box = [msg]
        dist.broadcast_object_list(box, src=0,
                                   device=self.device if self.device.type == "cuda" else None)
        return box[0]

    def _bcast_tensor(self, t: torch.Tensor):
        """Rank 0's ``t`` into every rank's ``t`` (same shape and dtype)."""
        if self.world > 1:
            dist.broadcast(torch.view_as_real(t) if t.is_complex() else t, src=0)

    def _agree(self, code: int) -> int:
        """The worst attempt status over the ranks."""
        if self.world == 1:
            return code
        t = torch.tensor([code], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    # -- dispatch (rank 0) ---------------------------------------------------

    _dispatching = False

    def _bump(self, counter: str, n: int = 1):
        with self._stats_lock:
            self._stats[counter] += n

    def _worker_loop(self):
        self._on_device()
        try:
            while True:
                with self._cv:
                    while not self._queue and not self._closed:
                        self._cv.wait(0.05)
                    if not self._queue:
                        if self._closed:
                            return
                        continue
                    group = self._take_group_locked()
                    self._dispatching = True
                try:
                    self._execute_group(group)
                    if self._retune is not None:
                        msg, self._retune = self._bcast(self._retune), None
                        self._run_retune(msg)
                except Exception as e:  # the worker must never die silently
                    log.exception("dispatch group failed terminally: %r", e)
                    for r in group:
                        self._resolve(r, Outcome("error", r.future.request_id,
                                                 error=repr(e)[:300],
                                                 batched=len(group)))
                finally:
                    with self._cv:
                        self._dispatching = False
        finally:
            self._bcast({"op": "stop"})

    def _take_group_locked(self) -> list[Request]:
        """Pop the head request plus every queued request with the same
        ``(shape, direction)``, up to ``max_batch`` — the coalescer."""
        head = self._queue.popleft()
        group = [head]
        rest = deque()
        while self._queue and len(group) < self.config.max_batch:
            r = self._queue.popleft()
            (group if r.group_key == head.group_key else rest).append(r)
        self._queue.extendleft(reversed(rest))
        return group

    def _resolve(self, req: Request, outcome: Outcome):
        if req.future.resolve(outcome):
            self._bump(outcome.status.replace("-", "_"))
        else:
            self._bump("late_results")

    def _resolve_all(self, reqs, status, **kw):
        for r in reqs:
            self._resolve(r, Outcome(status, r.future.request_id, batched=len(reqs), **kw))

    def _tuner_path(self):
        from repro_torch.core import tuner

        return self.plan_config.tuner_cache or tuner.default_cache_path()

    def _execute_group(self, group: list[Request]):
        # mid-flight cache-corruption fault point: the schedule cache may be
        # scribbled on between any two dispatches
        faults.tap_serve_cache(self._tuner_path())

        now = time.monotonic()
        reqs = []
        for r in group:
            if r.future.deadline <= now:
                self._bump("expired_before_dispatch")
                self._resolve(r, Outcome("deadline-exceeded", r.future.request_id,
                                         trip=TRIP_TIMEOUT))
            else:
                reqs.append(r)
        if not reqs:
            return
        try:
            stacked = torch.stack([torch.as_tensor(r.x) for r in reqs])
        except Exception as e:
            self._resolve_all(reqs, "error", error=f"bad input: {e!r}"[:300])
            return
        if len(reqs) > 1:
            self._bump("coalesced_batches")
            self._bump("batched_requests", len(reqs))
        msg = {"op": "group", "shape": reqs[0].shape, "direction": reqs[0].direction,
               "n": len(reqs)}
        self._run_group(self._bcast(msg), reqs, stacked)

    # -- one group, on every rank --------------------------------------------

    def _run_group(self, msg, reqs, stacked=None):
        """Execute one coalesced group on this rank; ``reqs`` (rank 0) holds
        its requests and ``stacked`` their fields, None elsewhere."""
        lead = reqs is not None
        shape, direction, n = tuple(msg["shape"]), msg["direction"], msg["n"]
        try:
            key, plan = self.registry.get(shape)
            build_err = None
        except Exception as e:
            build_err = e
        if self._agree(_OK if build_err is None else _TRANSIENT) != _OK:
            if lead:
                self._resolve_all(reqs, "error",
                                  error=f"plan build failed: {build_err!r}"[:300])
            return
        dtype = plan.input_dtype if direction == "forward" else plan.spectral_dtype
        try:
            stacked = self._stage(stacked, (n, *shape), dtype, plan.device)
            stage_err = None
        except Exception as e:  # out of device memory, on this rank alone
            stacked, stage_err = None, e
        if self._agree(_OK if stage_err is None else _TRANSIENT) != _OK:
            if lead:
                where = repr(stage_err) if stage_err is not None else "on another rank"
                self._resolve_all(reqs, "error",
                                  error=f"staging the fields failed: {where}"[:300])
            return
        self._bcast_tensor(stacked)

        breaker = self.registry.breaker(key) if lead else None
        earliest = min(r.future.deadline for r in reqs) if lead else None
        attempt, trip, cause = 0, None, None
        step = self._bcast(("primary" if breaker.allow() else "fallback") if lead else None)
        if lead and step == "fallback":
            trip = TRIP_CIRCUIT
        while step == "primary":
            y, report, err = None, None, None
            try:
                faults.tap_serve_execute()
                out = plan._apply_many(stacked, direction)
                y, report = out if isinstance(out, tuple) else (out, None)
                if plan.device.type == "cuda":
                    torch.cuda.synchronize(plan.device)
                code = _OK
            except GuardError as e:
                code, err = _GUARD, e
            except Exception as e:  # transient: injected crash, a failed call
                code, err = _TRANSIENT, e
            code = self._agree(code)
            nxt = None
            if lead:
                if code == _OK:
                    breaker.record_success()
                    transitions = len(report.transitions) if report is not None else 0
                    status = "degraded" if transitions else "ok"
                    for i, r in enumerate(reqs):
                        self._resolve(r, Outcome(status, r.future.request_id, value=y[i],
                                                 trip="guard-degrade" if transitions else None,
                                                 retries=attempt, transitions=transitions,
                                                 batched=len(reqs)))
                    nxt = "done"
                elif code == _GUARD:
                    cause = err if err is not None else GuardError("guard error on another rank")
                    tripped = breaker.record_failure()
                    if tripped:
                        self._on_trip(plan, key, direction, len(reqs), cause)
                    trip = TRIP_CIRCUIT if tripped else "guard-error"
                    nxt = "fallback"
                else:
                    attempt += 1
                    self._bump("retries")
                    wait = backoff_s(reqs[0].future.request_id, attempt,
                                     base=self.config.backoff_base_s,
                                     cap=self.config.backoff_cap_s)
                    out_of_time = time.monotonic() + wait >= earliest
                    if attempt > self.config.max_retries or out_of_time:
                        breaker.record_failure()
                        status = ("deadline-exceeded" if out_of_time
                                  and attempt <= self.config.max_retries else "error")
                        self._resolve_all(reqs, status, error=repr(err)[:300], retries=attempt,
                                          trip=(TRIP_TIMEOUT if status == "deadline-exceeded"
                                                else "retries-exhausted"))
                        nxt = "done"
                    else:
                        log.warning("transient failure (attempt %d), retrying in %.3fs: %r",
                                    attempt, wait, err)
                        time.sleep(wait)
                        nxt = "primary" if breaker.allow() else "fallback"
                        trip = TRIP_CIRCUIT
            step = self._bcast(nxt)
        if step == "fallback":
            self._serve_fallback(reqs, plan, stacked, direction, n, trip=trip,
                                 retries=attempt, cause=cause)

    @staticmethod
    def _stage(stacked, shape, dtype, device):
        """The group's fields on this rank's device: rank 0's ``stacked``
        cast, elsewhere an empty block of ``shape`` for the broadcast."""
        if stacked is not None:
            return stacked.to(device=device, dtype=dtype)
        return torch.empty(shape, dtype=dtype, device=device)

    def _serve_fallback(self, reqs, plan, stacked, direction, n, *, trip, retries=0,
                        cause=None):
        """Serve a group through the bottom of the degradation ladder — the
        breaker-open (or guard-error) path.  Still guarded: a fallback that
        fails too yields structured errors, not silence."""
        lead = reqs is not None
        y, report, err = None, None, None
        try:
            faults.tap_serve_execute()
            in_pen, out_pen, _ = plan._pencils(direction)
            sched = fallback_schedule(plan)
            # pad_global and this rank's block; unpad_global of the gathered result
            block = scatter_global(stacked, in_pen, self.rank, nbatch=1)
            if n == 1:
                y, report = run_guarded(plan, block[0], direction, schedule=sched)
                y = y[None]
            else:
                y, report = run_guarded(plan, block, direction, n, schedule=sched)
            y = allgather_global(y, out_pen, nbatch=1)
            if plan.device.type == "cuda":
                torch.cuda.synchronize(plan.device)
            code = _OK
        except Exception as e:
            code, err = _TRANSIENT, e
        code = self._agree(code)
        if not lead:
            return
        self._bump("fallback_served", len(reqs))
        if code != _OK:
            log.warning("fallback execution failed: %r (primary cause: %r)", err, cause)
            msg = repr(err)[:200] + (f" [primary: {cause!r}]"[:100] if cause is not None else "")
            self._resolve_all(reqs, "error", trip=trip, error=msg, retries=retries)
            return
        transitions = len(report.transitions) if report is not None else 0
        for i, r in enumerate(reqs):
            self._resolve(r, Outcome("degraded", r.future.request_id, value=y[i], trip=trip,
                                     retries=retries, transitions=transitions,
                                     batched=len(reqs)))

    def _on_trip(self, plan, key, direction, nfields, err):
        """Breaker just tripped: after the group is served through the
        fallback, the worker sends a retune message (:meth:`_run_retune`)."""
        log.warning("circuit breaker tripped for plan %s...: %r", key[:60], err)
        self._retune = {"op": "retune", "shape": plan.shape, "direction": direction,
                        "nfields": nfields if nfields > 1 else 1, "reason": repr(err)[:300]}

    def _run_retune(self, msg):
        """On every rank: quarantine an auto plan's cache entry and retune,
        then re-warm the plan, between groups."""
        from repro_torch.robustness import runner

        nfields = msg["nfields"]
        try:
            key, plan = self.registry.get(tuple(msg["shape"]))
            if plan.method == "auto":
                try:
                    runner._quarantine_and_retune(plan, nfields, RuntimeError(msg["reason"]))
                except Exception as qe:  # quarantine is best effort
                    log.warning("quarantine failed: %r", qe)
            plan.warm((msg["direction"],), nfields=nfields)
            if self.rank == 0:
                self._bump("retunes")
            log.info("retune/rewarm complete for %s...", key[:60])
        except Exception as re_:  # the retune is best effort
            log.warning("retune failed: %r", re_)

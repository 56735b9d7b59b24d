"""Request lifecycle primitives: outcomes, self-resolving futures, backoff —
the port of ``repro/serve/lifecycle.py`` (pure Python, copied so that the
port imports nothing of the reference).

Every request submitted to the serving engine terminates in exactly one
structured :class:`Outcome` — the engine has **no silent terminal state**:

``ok``                 — clean execution, no degradation.
``degraded``           — the result is valid but something gave way: the
                         guard ladder widened a stage, or the circuit
                         breaker routed the request through the fallback
                         schedule (``trip="circuit-open"``).
``shed``               — admission control refused the request at submit
                         time (bounded queue full, ``trip="overload-shed"``).
``deadline-exceeded``  — the deadline passed before a result landed
                         (``trip="timeout"``).  The future *self-resolves*:
                         a wedged executor (slow collective, compile hang)
                         can never hang the caller — the late completion is
                         counted in the engine's ``late_results`` stat
                         instead of silently discarded.
``error``              — a structured failure (exhausted retries, exhausted
                         degradation ladder); ``error`` carries the repr.

:class:`RequestFuture` is the one-shot synchronization cell: the first
``resolve`` wins (worker vs. deadline race is explicit — the loser's
attempt returns ``False``), and ``result()`` never waits past
``deadline + grace``.

Retry backoff is exponential with **deterministic jitter**: the jitter
fraction is a hash of ``(request_id, attempt)``, so chaos tests replay
byte-identical schedules while concurrent retries still decorrelate.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any

#: terminal request states (see module docstring)
OUTCOME_STATUSES = ("ok", "degraded", "shed", "deadline-exceeded", "error")

#: serve-level trip codes (extends the guard trip codes of
#: :mod:`repro_torch.robustness.health`)
TRIP_TIMEOUT = "timeout"
TRIP_SHED = "overload-shed"
TRIP_CIRCUIT = "circuit-open"

_rid_counter = itertools.count()


@dataclass
class Outcome:
    """Structured terminal state of one request."""

    status: str                     #: one of :data:`OUTCOME_STATUSES`
    request_id: str
    value: Any = None               #: the spectrum (ok/degraded only)
    trip: str | None = None         #: serve/guard trip code, None for clean ok
    error: str | None = None        #: repr of the terminal failure
    retries: int = 0                #: re-dispatch attempts consumed
    transitions: int = 0            #: guard-ladder transitions on the winning run
    latency_s: float = 0.0          #: submit -> resolve wall time
    batched: int = 1                #: coalesced group size this request rode in

    def __post_init__(self):
        if self.status not in OUTCOME_STATUSES:
            raise ValueError(f"unknown outcome status {self.status!r}")

    def summary(self) -> dict:
        """JSON-safe view (drops the array payload)."""
        return {"status": self.status, "request_id": self.request_id,
                "trip": self.trip, "error": self.error,
                "retries": self.retries, "transitions": self.transitions,
                "latency_s": round(self.latency_s, 6), "batched": self.batched}


class RequestFuture:
    """One-shot result cell with a hard deadline.

    ``resolve`` is first-write-wins and returns whether this call won;
    ``result()`` blocks until resolution but never past the deadline plus
    ``grace`` — if nothing resolved it by then, it resolves *itself* with
    ``deadline-exceeded``.  That self-resolution is the engine's zero-hang
    guarantee: no fault (slow collective, wedged compile, dead worker) can
    make a caller wait unboundedly or receive nothing."""

    def __init__(self, request_id: str, deadline: float,
                 submitted: float | None = None):
        self.request_id = request_id
        self.deadline = deadline          #: absolute, time.monotonic() scale
        self.submitted = time.monotonic() if submitted is None else submitted
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._outcome: Outcome | None = None

    @property
    def resolved(self) -> bool:
        return self._event.is_set()

    def resolve(self, outcome: Outcome) -> bool:
        """Install ``outcome`` unless something already won the race;
        returns True when this call was the winner."""
        with self._lock:
            if self._outcome is not None:
                return False
            outcome.latency_s = time.monotonic() - self.submitted
            self._outcome = outcome
            self._event.set()
            return True

    def result(self, *, grace: float = 0.25) -> Outcome:
        """The terminal outcome, waiting at most until ``deadline+grace``."""
        remaining = self.deadline + grace - time.monotonic()
        if remaining > 0:
            self._event.wait(remaining)
        if not self._event.is_set():
            self.resolve(Outcome("deadline-exceeded", self.request_id,
                                 trip=TRIP_TIMEOUT))
        return self._outcome


@dataclass
class Request:
    """One unit of admitted work: a field to transform under a plan key."""

    x: Any                          #: logical-shape field (array-like)
    shape: tuple[int, ...]
    direction: str                  #: "forward" | "backward"
    future: RequestFuture
    retries: int = 0
    meta: dict = field(default_factory=dict)

    @property
    def group_key(self):
        """Coalescing identity: same shape + direction ride one batch."""
        return (self.shape, self.direction)


def next_request_id(prefix: str = "r") -> str:
    return f"{prefix}{next(_rid_counter)}"


def backoff_s(request_id: str, attempt: int, *, base: float = 0.05,
              cap: float = 1.0) -> float:
    """Exponential backoff with deterministic jitter.

    ``min(cap, base * 2^(attempt-1)) * frac`` where ``frac ∈ [0.5, 1.0)``
    is derived from ``sha1(request_id:attempt)`` — replayable (chaos tests
    assert exact schedules) yet decorrelated across concurrent retriers,
    which is what jitter is for (no retry convoy re-hitting a recovering
    resource in lockstep)."""
    if attempt < 1:
        return 0.0
    raw = min(cap, base * (2.0 ** (attempt - 1)))
    h = hashlib.sha1(f"{request_id}:{attempt}".encode()).digest()
    frac = 0.5 + (int.from_bytes(h[:4], "big") / 2**32) * 0.5
    return raw * frac

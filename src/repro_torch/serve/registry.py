"""Hot plan registry (warm-started LRU) and per-plan circuit breakers — the
port of ``repro/serve/registry.py``.

The registry keeps :class:`~repro_torch.core.pfft.ParallelFFT` plans hot,
keyed by :func:`repro_torch.core.tuner.plan_key` — the same identity the
schedule cache uses.  ``get(shape)`` builds a missing plan from the
registry's :class:`~repro_torch.core.planconfig.PlanConfig` template and
**warms** it (:meth:`ParallelFFT.warm`): schedule resolution (a tuned entry
loads from the cache, see :mod:`repro_torch.core.tuner`; an auto plan's
admission reads the cache, not the process's memo, so a torn cache is
rejected, retuned and rewritten), the kernels' build
and their first launches all happen at admission, never on a request's
path.  ``get`` runs collectives (the warm-up executes the plan, an auto
plan agrees on its schedule), so on several ranks every rank calls it, in
the same order (:mod:`repro_torch.serve.engine`).  Capacity eviction is
LRU; an evicted plan's tuned schedule survives in the cache, so
re-admission rebuilds but never retunes.

Each registry slot carries a :class:`CircuitBreaker` (classic three-state):

``closed``     — primary path; consecutive ``GuardError`` terminal failures
                 count toward ``threshold``.
``open``       — tripped: the engine stops offering requests to the failing
                 primary schedule and serves them through the bottom of the
                 degradation ladder (:func:`fallback_schedule`); the
                 quarantine-and-retune runs between dispatches.
``half-open``  — after ``cooldown_s`` one probe request is let through; a
                 clean probe closes the breaker, a failure re-opens it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from repro_torch.core import tuner
from repro_torch.core.pfft import ParallelFFT
from repro_torch.core.planconfig import PlanConfig, StageEntry


class CircuitBreaker:
    """Three-state breaker; thread-safe, monotonic-clock based."""

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 5.0):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._failures = 0
        self._opened_at: float | None = None
        self._probing = False
        self._lock = threading.Lock()
        self.trips = 0  #: lifetime trip count

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if time.monotonic() - self._opened_at >= self.cooldown_s:
            return "half-open"
        return "open"

    def allow(self) -> bool:
        """May the primary path be attempted right now?  In half-open,
        only the first caller gets the probe slot until it reports back."""
        with self._lock:
            st = self._state_locked()
            if st == "closed":
                return True
            if st == "half-open" and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> bool:
        """Count a terminal primary-path failure; returns True when this
        call tripped (or re-tripped) the breaker open."""
        with self._lock:
            was_open = self._opened_at is not None
            self._probing = False
            self._failures += 1
            if self._failures >= self.threshold or was_open:
                self._opened_at = time.monotonic()
                self._failures = 0
                self.trips += 1
                return True
            return False


def fallback_schedule(plan) -> tuple[StageEntry, ...]:
    """The bottom of the degradation ladder for every exchange stage —
    ``traditional @ complex64 @ torch @ stacked``: lossless wire, the plain
    torch codec, the engine with no overlap machinery to go wrong.  This is
    what a tripped breaker serves through while the primary schedule
    retunes."""
    bottom = StageEntry("traditional", 1, "complex64", "torch", "stacked")
    return (bottom,) * plan.n_exchanges


class PlanRegistry:
    """Warm-started LRU of plans + their breakers.

    Thread-safe; ``get`` may build and warm (slow) under a per-registry
    lock so concurrent first requests for one shape build once."""

    def __init__(self, mesh, grid, *, config: PlanConfig | None = None,
                 capacity: int = 8, warm_directions=("forward",),
                 warm_nfields: int = 1, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 5.0):
        self.mesh, self.grid = mesh, grid
        self.config = config if config is not None else PlanConfig()
        self.capacity = max(1, int(capacity))
        self.warm_directions = tuple(warm_directions)
        self.warm_nfields = int(warm_nfields)
        self._breaker_kw = {"threshold": breaker_threshold,
                            "cooldown_s": breaker_cooldown_s}
        self._plans: OrderedDict[str, object] = OrderedDict()  # plan_key -> plan
        self._breakers: dict[str, CircuitBreaker] = {}
        self._shape_key: dict[tuple, str] = {}  # shape -> plan_key memo
        self._lock = threading.RLock()
        self.evictions = 0
        self.builds = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def key_for(self, shape: tuple[int, ...]) -> str | None:
        with self._lock:
            return self._shape_key.get(tuple(shape))

    def breaker(self, key: str) -> CircuitBreaker:
        with self._lock:
            if key not in self._breakers:
                self._breakers[key] = CircuitBreaker(**self._breaker_kw)
            return self._breakers[key]

    def get(self, shape: tuple[int, ...]):
        """The hot plan for ``shape`` (LRU-touched), building + warming on
        miss.  Returns ``(plan_key, plan)``."""
        shape = tuple(shape)
        with self._lock:
            key = self._shape_key.get(shape)
            if key is not None and key in self._plans:
                self._plans.move_to_end(key)
                return key, self._plans[key]
            # build under the registry lock: one build per shape even
            # when N requests race the first admission
            plan = ParallelFFT(self.mesh, shape, self.grid,
                                     config=self.config)
            key = tuner.plan_key(plan, nfields=self.warm_nfields)
            self.builds += 1
            if plan.method == "auto":
                # admission reads the cache (rank 0), not this process's
                # memo: a cache another replica tore is rejected, retuned
                # and rewritten here.  Every rank drops its memo alike.
                tuner.forget(key)
            plan.warm(self.warm_directions, nfields=self.warm_nfields)
            self._plans[key] = plan
            self._shape_key[shape] = key
            while len(self._plans) > self.capacity:
                old_key, _ = self._plans.popitem(last=False)
                self.evictions += 1
                # keep the breaker: a flapping plan must not reset its
                # failure history by being evicted and re-admitted
                for s, k in list(self._shape_key.items()):
                    if k == old_key:
                        del self._shape_key[s]
            return key, plan

    def stats(self) -> dict:
        with self._lock:
            return {"plans": len(self._plans), "capacity": self.capacity,
                    "builds": self.builds, "evictions": self.evictions,
                    "breakers": {k[:40]: b.state
                                 for k, b in self._breakers.items()},
                    "breaker_trips": sum(b.trips
                                         for b in self._breakers.values())}

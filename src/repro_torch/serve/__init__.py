"""Resilient spectral serving engine (``python -m repro_torch.serve``) — the
port of ``repro/serve/``.

A long-running service over the distributed-FFT core: hot plans in a
warm-started LRU registry, same-shape request coalescing into batched
multi-field executions, and a per-request resilience lifecycle — deadlines,
bounded retry with deterministic-jitter backoff, admission control with
load shedding, and per-plan circuit breakers wired into the guarded
execution's degradation ladder and the tuner's cache.

Layers: :mod:`~repro_torch.serve.lifecycle` (outcomes, self-resolving
futures, backoff), :mod:`~repro_torch.serve.registry` (plan LRU + breakers),
:mod:`~repro_torch.serve.engine` (the :class:`SpectralServer` dispatch loop;
rank 0 controls, the other ranks :meth:`~SpectralServer.follow`).  Chaos
hooks live in :mod:`repro_torch.robustness.faults` (``slow_collective``,
``executor_crash``, ``cache_corruption``, ``request_burst``).

Not the LM demo — that is :mod:`repro_torch.launch.serve_lm`.
"""

from repro_torch.serve.engine import ServeConfig, SpectralServer
from repro_torch.serve.lifecycle import (
    OUTCOME_STATUSES, TRIP_CIRCUIT, TRIP_SHED, TRIP_TIMEOUT,
    Outcome, RequestFuture, backoff_s,
)
from repro_torch.serve.registry import CircuitBreaker, PlanRegistry, fallback_schedule

__all__ = [
    "SpectralServer", "ServeConfig", "PlanRegistry", "CircuitBreaker",
    "fallback_schedule", "Outcome", "RequestFuture", "backoff_s",
    "OUTCOME_STATUSES", "TRIP_TIMEOUT", "TRIP_SHED", "TRIP_CIRCUIT",
]

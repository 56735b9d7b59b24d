"""Guarded execution for the port's ParallelFFT — the port of
``repro/robustness/``: runtime health checks (:mod:`.health`), deterministic
fault injection (:mod:`.faults`) and the strict/degrade runner
(:mod:`.runner`).

Import-light like the reference's: the exchange code imports :mod:`.faults`
and :mod:`.health` at module scope, so ``GuardError``/``run_guarded``
resolve lazily.
"""

from repro_torch.robustness.faults import FaultInjected, FaultPlan
from repro_torch.robustness.health import GUARD_MODES, HealthReport, StageHealth

__all__ = ["FaultInjected", "FaultPlan", "GUARD_MODES", "HealthReport",
           "StageHealth", "GuardError", "run_guarded"]


def __getattr__(name):
    if name in ("GuardError", "run_guarded"):
        from repro_torch.robustness import runner

        return getattr(runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

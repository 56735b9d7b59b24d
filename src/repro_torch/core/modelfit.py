"""Fit the analytic time model's coefficients to measured series — the port
of ``repro/core/modelfit.py`` (pure numpy, no torch).

:meth:`repro_torch.core.pfft.ParallelFFT.model_time_s` (on
:func:`repro_torch.core.redistribute.exchange_time_model`) prices a plan.
Given a series of measured points, :func:`fit_series` least-squares fits
the model's wire bandwidth and per-collective latency, computes each
point's residual, and flags points the model misses by more than
``miss_factor``; :func:`fit_report` aggregates series into priors that the
tuner reads (:func:`active_priors`, candidate pruning in
:func:`repro_torch.core.tuner.tune_plan`).

Each point carries the model's linear surrogate:

* ``compute_s``  — the model's comm-free residual (FFT flops at
  ``peak_flops`` plus codec and copy passes at ``hbm_bw``), i.e.
  ``model_time_s(ici_bw=huge, ici_latency_s=0)``;
* ``wire_bytes`` — bytes on the wire per rank
  (:meth:`~repro_torch.core.pfft.ParallelFFT.comm_bytes_per_device`);
* ``launches``   — latency-priced collectives
  (:meth:`~repro_torch.core.pfft.ParallelFFT.model_collective_launches`);

and the fit solves ``measured ≈ compute_s + wire_bytes/ici_bw +
launches·ici_latency_s`` for ``(1/ici_bw, ici_latency_s)`` by ordinary
least squares with a nonnegativity clamp (a negative coefficient refits
the other alone).  The surrogate drops the pipelined engine's overlap
``max()`` credit: the structural misses the >2× flag is for.

:data:`REFERENCE_COEFFS` are this card's (:mod:`repro_torch.core.hardware`).
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np

from repro_torch.core.hardware import HBM_BW, ICI_BW, ICI_LATENCY_S, PEAK_FLOPS

#: coefficients the model terms are evaluated at: the defaults of
#: exchange_time_model / model_time_s, this card's
REFERENCE_COEFFS = {
    "ici_bw": ICI_BW,
    "hbm_bw": HBM_BW,
    "peak_flops": PEAK_FLOPS,
    "ici_latency_s": ICI_LATENCY_S,
}

#: a point whose measured/fitted ratio leaves [1/f, f] is a model miss
DEFAULT_MISS_FACTOR = 2.0


def _point_features(p: dict) -> tuple[float, float, float, float]:
    """(measured_s, compute_s, wire_bytes, launches) of one sweep point.

    Accepts both the nested sweep form (``{"best_s": ..., "model":
    {"compute_s": ..., "wire_bytes_per_dev": ..., "launches": ...}}``) and
    an already-flat dict (the synthetic-series test form)."""
    model = p.get("model") or p
    return (float(p["best_s"] if "best_s" in p else p["measured_s"]),
            float(model["compute_s"]),
            float(model["wire_bytes_per_dev"]),
            float(model["launches"]))


def fit_series(points: list[dict], *, miss_factor: float = DEFAULT_MISS_FACTOR,
               ) -> dict:
    """Least-squares fit of (1/ici_bw, ici_latency_s) for one scaling
    series; returns a JSON-able dict with the fitted coefficients, per-point
    fitted times and residual ratios, and the flagged >``miss_factor``
    misses.

    ``points`` need ≥1 entries; with a single point only the bandwidth
    coefficient is fit (latency pinned to 0 — one equation cannot separate
    the two terms)."""
    feats = [_point_features(p) for p in points]
    meas = np.array([f[0] for f in feats])
    comp = np.array([f[1] for f in feats])
    bytes_ = np.array([f[2] for f in feats])
    launch = np.array([f[3] for f in feats])
    rhs = meas - comp

    def _solve(cols):
        a = np.stack(cols, axis=1)
        sol, *_ = np.linalg.lstsq(a, rhs, rcond=None)
        return sol

    beta = lat = 0.0
    # column-normalized rank probe (raw bytes dwarf launch counts; an
    # unscaled rank test would call any matrix rank-1)
    two_col = np.stack([bytes_ / max(bytes_.max(), 1.0),
                        launch / max(launch.max(), 1.0)], axis=1)
    if (len(points) >= 2 and np.ptp(bytes_) > 0 and np.ptp(launch) > 0
            and np.linalg.matrix_rank(two_col, tol=1e-6) == 2):
        # rank check: a series whose launches scale exactly with its bytes
        # (e.g. a uniform-chunked sweep) cannot separate the two terms —
        # attribute everything to bandwidth rather than splitting by the
        # minimum-norm accident
        beta, lat = _solve([bytes_, launch])
    if beta < 0 or lat < 0 or (beta == 0 and lat == 0):
        # clamp: refit the surviving single coefficient alone
        beta = lat = 0.0
        if bytes_.any():
            (beta,) = _solve([bytes_])
        if beta <= 0 and launch.any():
            beta = 0.0
            (lat,) = _solve([launch])
        beta, lat = max(beta, 0.0), max(lat, 0.0)
    fitted = comp + beta * bytes_ + lat * launch
    with np.errstate(divide="ignore", invalid="ignore"):
        resid = np.where(fitted > 0, meas / fitted, np.inf)
    log_err = np.log(np.clip(resid, 1e-30, None))
    misses = []
    per_point = []
    for i, p in enumerate(points):
        entry = {
            "ndev": p.get("ndev"),
            "shape": p.get("shape"),
            "measured_s": float(meas[i]),
            "fit_time_s": float(fitted[i]),
            "model_time_s": (p.get("model") or {}).get("time_s", p.get("model_time_s")),
            "residual": float(resid[i]),
        }
        per_point.append(entry)
        if not (1.0 / miss_factor <= resid[i] <= miss_factor):
            misses.append({**entry, "why": (
                "model underestimates (measured slower than fit)"
                if resid[i] > miss_factor else
                "model overestimates (measured faster than fit)")})
    return {
        "ici_bw": float(1.0 / beta) if beta > 0 else math.inf,
        "ici_latency_s": float(lat),
        "npoints": len(points),
        "miss_factor": miss_factor,
        "rmse_log": float(np.sqrt(np.mean(log_err**2))) if len(points) else 0.0,
        "points": per_point,
        "misses": misses,
    }


def fit_report(series_points: dict[str, list[dict]], *,
               device_kind: str | None = None, backend: str | None = None,
               miss_factor: float = DEFAULT_MISS_FACTOR) -> dict:
    """Fit every series and aggregate the finite fitted coefficients into
    one priors block (median across series — robust to a series whose
    sweep never stressed one of the terms)."""
    fits = {name: fit_series(pts, miss_factor=miss_factor)
            for name, pts in series_points.items() if pts}
    bws = [f["ici_bw"] for f in fits.values() if math.isfinite(f["ici_bw"])]
    lats = [f["ici_latency_s"] for f in fits.values() if f["ici_latency_s"] > 0]
    priors = {
        "ici_bw": float(np.median(bws)) if bws else REFERENCE_COEFFS["ici_bw"],
        "ici_latency_s": (float(np.median(lats)) if lats
                          else REFERENCE_COEFFS["ici_latency_s"]),
        # the surrogate holds these at reference; recorded so a prior
        # consumer prices the non-fitted terms consistently
        "hbm_bw": REFERENCE_COEFFS["hbm_bw"],
        "peak_flops": REFERENCE_COEFFS["peak_flops"],
    }
    n_misses = sum(len(f["misses"]) for f in fits.values())
    return {
        "schema": "modelfit-v1",
        "device_kind": device_kind,
        "backend": backend,
        "priors": priors,
        "n_misses": n_misses,
        "series": fits,
    }


# -- tuner priors -----------------------------------------------------------
#
# The fitted coefficients double as *tuner priors*: with a priors file
# armed (REPRO_MODEL_PRIORS), repro_torch.core.tuner ranks each stage's candidate
# set by modeled time at the fitted coefficients and micro-benchmarks only
# the top-K — measurements steer the model, the model then prunes the sweep.


def default_priors_path() -> Path | None:
    """Priors are armed only via ``$REPRO_MODEL_PRIORS`` (an explicit
    opt-in: a stray priors file must never silently change what the tuner
    measures on an unrelated machine)."""
    env = os.environ.get("REPRO_MODEL_PRIORS")
    return Path(env) if env else None


def save_priors(report: dict, path: str | Path) -> Path:
    """Write a fit report (or a bare priors dict) where the tuner will find
    it; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")
    return path


def load_priors(path: str | Path) -> dict | None:
    """The priors block of a fit report at ``path`` (or of a bare priors
    dict), or None for anything unusable — like the tuner cache, a corrupt
    priors file must never raise."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict):
        return None
    block = data.get("priors", data)
    if not isinstance(block, dict) or "ici_bw" not in block:
        return None
    out = dict(REFERENCE_COEFFS)
    for k in out:
        try:
            v = float(block.get(k, out[k]))
        except (TypeError, ValueError):
            return None
        if math.isfinite(v) and v > 0:
            out[k] = v
    return out


def active_priors() -> dict | None:
    """The armed priors, or None (the common case: no env override)."""
    path = default_priors_path()
    return load_priors(path) if path else None

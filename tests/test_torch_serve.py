"""The port's spectral server (``repro_torch.serve``), twinning
tests/test_serve.py: the lifecycle units in this process, then the engine
cases and a twin of the chaos soak on 2 gloo ranks (tests/_torch_ranks.py
``run_serve_rank``: rank 0 admits and dispatches, rank 1 follows), beside a
JAX subprocess on 4 virtual devices that transforms the same numpy-seeded
fields.

Tolerances: a served spectrum is bitwise equal to the port's own unguarded
plan ``forward`` of that field alone (the server's guarded, coalesced
execution is the batched = per-field-loop contract), and within 1e-5
relative L2 of the JAX package's ``ParallelFFT.forward`` (lossless, f32).
The breaker's fallback is lossless: within 1e-5 of the clean spectrum.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as R
from repro_torch.robustness import faults
from repro_torch.serve import (
    OUTCOME_STATUSES, TRIP_SHED, TRIP_TIMEOUT,
    Outcome, RequestFuture, backoff_s,
)
from repro_torch.serve.registry import CircuitBreaker, fallback_schedule

TESTS = Path(__file__).resolve().parent


# -- lifecycle units (no ranks) ---------------------------------------------


def test_backoff_equals_reference():
    """The same (request id, attempt) gives the same float as the
    reference's backoff, every attempt from 0 to 50."""
    from repro.serve import backoff_s as ref_backoff

    for rid in ("r0", "r1", "r17", "q3"):
        for k in range(51):
            for kw in ({}, {"base": 0.01, "cap": 0.5}):
                assert backoff_s(rid, k, **kw) == ref_backoff(rid, k, **kw), (rid, k, kw)


def test_backoff_deterministic_and_bounded():
    a = [backoff_s("r1", k, base=0.05, cap=1.0) for k in range(1, 8)]
    assert a == [backoff_s("r1", k, base=0.05, cap=1.0) for k in range(1, 8)]
    assert a != [backoff_s("r2", k, base=0.05, cap=1.0) for k in range(1, 8)]
    for k, v in enumerate(a, start=1):
        raw = min(1.0, 0.05 * 2 ** (k - 1))
        assert 0.5 * raw <= v < raw
    assert backoff_s("r1", 0) == 0.0
    assert backoff_s("r1", 50) < 1.0


def test_outcome_status_validated():
    from repro.serve import OUTCOME_STATUSES as REF_STATUSES

    with pytest.raises(ValueError):
        Outcome("exploded", "r0")
    o = Outcome("shed", "r0", trip=TRIP_SHED)
    assert o.summary()["status"] == "shed"
    assert OUTCOME_STATUSES == REF_STATUSES


def test_request_future_first_resolve_wins():
    fut = RequestFuture("r0", time.monotonic() + 5.0)
    assert fut.resolve(Outcome("ok", "r0", value=1))
    assert not fut.resolve(Outcome("error", "r0"))
    assert fut.result().status == "ok" and fut.result().value == 1


def test_request_future_deadline_self_resolves():
    fut = RequestFuture("r0", time.monotonic() + 0.05)
    t0 = time.monotonic()
    out = fut.result(grace=0.05)
    assert time.monotonic() - t0 < 2.0
    assert out.status == "deadline-exceeded" and out.trip == TRIP_TIMEOUT
    assert not fut.resolve(Outcome("ok", "r0", value=1))
    assert fut.result().status == "deadline-exceeded"


def test_request_future_result_concurrent_with_resolve():
    fut = RequestFuture("r0", time.monotonic() + 5.0)
    got = []
    t = threading.Thread(target=lambda: got.append(fut.result()))
    t.start()
    time.sleep(0.02)
    fut.resolve(Outcome("ok", "r0"))
    t.join(timeout=5.0)
    assert got and got[0].status == "ok"


def test_circuit_breaker_transitions():
    b = CircuitBreaker(threshold=2, cooldown_s=0.05)
    assert b.state == "closed" and b.allow()
    assert not b.record_failure()
    assert b.record_failure()
    assert b.state == "open" and not b.allow()
    time.sleep(0.06)
    assert b.state == "half-open"
    assert b.allow()
    assert not b.allow()
    assert b.record_failure()
    assert b.state == "open"
    time.sleep(0.06)
    assert b.allow()
    b.record_success()
    assert b.state == "closed" and b.trips == 2
    b.record_failure()
    b.record_success()
    assert not b.record_failure()


def test_fallback_schedule_is_the_ladder_bottom():
    from repro_torch.robustness.runner import degrade_entry

    class Plan:
        n_exchanges = 2

    sched = fallback_schedule(Plan())
    assert sched == (("traditional", 1, "complex64", "torch", "stacked"),) * 2
    assert degrade_entry(sched[0]) is None


def test_serve_taps_unarmed_are_noops(tmp_path):
    t0 = time.monotonic()
    faults.tap_serve_execute()
    assert time.monotonic() - t0 < 0.05
    assert faults.serve_burst() == 1
    p = tmp_path / "cache.json"
    assert faults.tap_serve_cache(p) is False
    assert not p.exists()


def test_serve_faults_bounded_times(tmp_path):
    from repro_torch.core import tuner

    with faults.FaultPlan().executor_crash(times=2).request_burst(
            factor=3, times=1).cache_corruption(mode="truncate", times=1):
        assert faults.serve_burst() == 3
        assert faults.serve_burst() == 1
        p = tmp_path / "db.json"
        assert faults.tap_serve_cache(p) and p.read_text() == ""
        assert not faults.tap_serve_cache(p)
        for _ in range(2):
            with pytest.raises(faults.FaultInjected):
                faults.tap_serve_execute()
        faults.tap_serve_execute()
    with faults.FaultPlan().cache_corruption(mode="garbage"):
        assert faults.tap_serve_cache(p)
    assert p.read_text() == '{"schema": 6, "trunca'
    assert tuner.load_cache(p) == {}  # torn bytes: rejected, retuned, rewritten


def test_fault_context_is_thread_local():
    with faults.FaultPlan().corrupt_wire(codec="bf16"):
        seen = {}

        def other():
            seen["match"] = bool(faults._matching("corrupt_wire"))

        with faults.stage_context(0, "fused", "bf16"):
            assert faults._matching("corrupt_wire")
            t = threading.Thread(target=other)
            t.start()
            t.join()
        assert seen["match"] is False


def test_follow_is_for_the_other_ranks_and_submit_for_rank_0():
    """One process with no process group is rank 0: it admits, and has no
    follower's loop to run."""
    import torch

    from repro_torch.serve import SpectralServer

    class Mesh:  # the attributes the server's set-up reads
        device_type, shape, mesh_dim_names = "cpu", (1,), ("p0",)

        def size(self, dim=None):
            return 1

    with SpectralServer(Mesh(), ("p0",)) as srv:
        assert srv.plan_config.guard == "degrade"  # "off" is forced up
        with pytest.raises(RuntimeError, match="rank 0"):
            srv.follow()
        with pytest.raises(ValueError):
            srv.submit(torch.zeros(4, 4), direction="sideways")
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(torch.zeros(4, 4))


def test_concurrent_submitters_lose_no_request(tmp_path):
    """16 threads submit to one server (a 1-rank gloo group in this
    process) with a tiny switch interval: every request resolves, and the
    counters add up to what was submitted."""
    import sys

    import torch
    import torch.distributed as dist

    from repro_torch.core.meshutil import make_mesh
    from repro_torch.serve import ServeConfig, SpectralServer

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mesh = make_mesh((1,), ("p0",), device="cpu")
        x = torch.randn(8, 8, 8, generator=torch.Generator().manual_seed(0))
        futs, lock = [], threading.Lock()
        with SpectralServer(mesh, ("p0",), config=ServeConfig(max_queue=8, max_batch=4,
                                                              deadline_s=60.0)) as srv:
            def submitter():
                for _ in range(10):
                    f = srv.submit(x)
                    with lock:
                        futs.append(f)

            threads = [threading.Thread(target=submitter) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            assert not any(t.is_alive() for t in threads)
            outs = [f.result() for f in futs]
            assert srv.drain(timeout=60.0)
            stats = srv.stats()
    finally:
        sys.setswitchinterval(interval)
        dist.destroy_process_group()
    statuses = [o.status for o in outs]
    assert len(outs) == 160 and set(statuses) <= {"ok", "shed"}
    assert stats["submitted"] == 160
    assert (stats["ok"], stats["shed"]) == (statuses.count("ok"), statuses.count("shed"))
    assert stats["late_results"] == 0
    assert stats["batched_requests"] <= statuses.count("ok")


# -- engine cases on 2 gloo ranks, beside the JAX package --------------------

_REFERENCE = """
import sys
sys.path.insert(0, {tests!r})
import numpy as np
from repro.core.meshutil import make_mesh
from repro.core.pfft import ParallelFFT
from repro.core.planconfig import PlanConfig
import _torch_ranks as R

mesh = make_mesh((4,), ("p0",))
data = R.serve_inputs()
res = {{}}
for key, x in data.items():
    plan = ParallelFFT(mesh, x.shape, ("p0",), config=PlanConfig(method="fused"))
    res[key] = np.asarray(plan.forward(x))
np.savez({out!r}, **res)
"""


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``(info, served arrays, the JAX side's arrays)``: the ranks and the
    JAX subprocess run side by side."""
    d = tmp_path_factory.mktemp("torch_serve")
    ref = d / "reference.npz"
    join = R.start(R.run_serve_rank, d, world=R.SERVE_WORLD)
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), out=str(ref)), ndev=4)
    finally:
        join()
    return (json.loads((d / "serve.json").read_text()), dict(np.load(d / "serve.npz")),
            dict(np.load(ref)))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_serve_clean_coalescing(runs):
    out = runs[0]["clean"]
    assert out["statuses"] == ["ok"] * 5
    assert out["stats"]["coalesced_batches"] >= 1
    assert out["stats"]["batched_requests"] >= 4
    assert max(out["batched"]) >= 4
    assert out["stats"]["registry"]["plans"] == 1


@pytest.mark.parametrize("case", ("clean", "lru"))
def test_served_spectra_equal_plan_forward_and_reference(runs, case):
    """Bitwise equal to the port's plan forward of each field alone, and
    within 1e-5 of the JAX package's forward of the same field."""
    info, served, ref = runs
    assert all(info[case]["bitwise_plan_forward"]), info[case]["bitwise_plan_forward"]
    keys = [k for k in ref if k.startswith(case)]
    assert len(keys) == len(info[case]["statuses"])
    for k in keys:
        assert served[k].shape == ref[k].shape
        assert _rel(served[k], ref[k]) < 1e-5, k


def test_serve_lru_eviction(runs):
    out = runs[0]["lru"]
    assert out["statuses"] == ["ok"] * 3
    assert out["shapes"] == [list(s) for s in R.SERVE_LRU_SHAPES]
    reg = out["stats"]["registry"]
    assert (reg["plans"], reg["builds"], reg["evictions"]) == (1, 3, 2)


def test_serve_overload_shed(runs):
    out = runs[0]["shed"]
    assert out["burst"] == 4
    statuses = out["statuses"]
    assert len(statuses) == 8
    n_shed = statuses.count("shed")
    assert n_shed >= 4
    assert n_shed == out["stats"]["shed"]
    assert statuses.count("ok") + n_shed == len(statuses)
    assert max(t for s, t in zip(statuses, out["latency"]) if s == "shed") < 0.1


def test_serve_breaker_trips_and_degrades(runs):
    out = runs[0]["breaker"]
    assert out["statuses"] == ["degraded"] * 4
    assert out["trips"][0] == "guard-error"
    assert set(out["trips"][2:]) == {"circuit-open"}
    assert out["stats"]["registry"]["breaker_trips"] >= 1
    assert out["stats"]["fallback_served"] == 4
    assert out["stats"]["error"] == 0
    assert out["stats"]["retunes"] == 1  # one trip, one retune between groups
    assert max(out["rel_vs_lossless"]) < 1e-5  # the lossless fallback


def test_serve_crash_retry_recovers(runs):
    out = runs[0]["crash"]
    assert out["statuses"] == ["ok"] and out["retries"] == [1]
    assert out["stats"]["retries"] == 1 and out["stats"]["error"] == 0
    assert out["bitwise_plan_forward"]


@pytest.mark.parametrize("faulty", range(R.SERVE_WORLD))
def test_serve_staging_fault_on_one_rank(runs, faulty):
    """Staging a group's fields fails on one rank alone: the ranks agree,
    the group ends in an error and the next group is served."""
    out = runs[0]["stage_fault"][str(faulty)]
    assert out["statuses"] == ["error", "ok"]
    assert "staging the fields failed" in out["errors"][0]
    assert ("injected" in out["errors"][0]) == (faulty == 0)
    assert out["stats"]["error"] == 1 and out["stats"]["ok"] == 1
    assert out["bitwise_plan_forward"]


def test_chaos_soak_twin(runs):
    """tests/test_serve.py's soak on the port: fresh servers per wave over
    one schedule cache; every request resolves in a structured outcome
    within its deadline, and a torn cache is rebuilt."""
    out = runs[0]["soak"]
    waves = out["waves"]
    assert set(waves) == {"clean", "transient", "corrupt-degrade", "breaker-strict",
                          "cache-corruption-burst"}
    for name, w in waves.items():
        assert w["unresolved"] == 0, (name, w)
        assert w["bad_status"] == [], (name, w)
        assert w["over_deadline"] == [], (name, w)
        assert len(w["statuses"]) == w["n"]
    assert waves["clean"]["statuses"] == ["ok"] * waves["clean"]["n"]
    assert waves["clean"]["breaker_trips"] == 0
    assert waves["transient"]["errors"] == 0
    assert set(waves["corrupt-degrade"]["statuses"]) <= {"ok", "degraded"}
    bs = waves["breaker-strict"]
    assert bs["breaker_trips"] >= 1
    assert set(bs["statuses"]) <= {"degraded", "error"}
    assert bs["statuses"].count("degraded") >= bs["n"] - 1
    assert waves["cache-corruption-burst"]["n"] == 6
    assert out["total_quarantines"] <= out["total_breaker_trips"]
    assert out["cache_well_formed"]

"""Guarded execution in the port (repro_torch.robustness) against the JAX
package: the fault matrix of tests/test_robustness.py on 4 gloo ranks and on
4 virtual devices, the degradation ladder, the stat packing, the health
reductions and the fault taps.

Each matrix case must agree with the reference on raised or not, the trip
codes, the field count, the transition kinds and the final schedule (``"pallas"`` and
``"jnp"`` read as the port's ``"cuda"`` and ``"torch"``), and every rank on
one outcome.  Outputs: within the reference matrix's own tolerances of the
reference's output (1e-5 relative L2 where the run ends lossless, 1e-4 after
a bf16 fault, 0.05 where int8 is involved).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro.robustness import faults as jfaults, health as jhealth, runner as jrunner
from repro_torch.robustness import faults, health, runner
from repro_torch.robustness.faults import FaultPlan

TESTS = Path(__file__).resolve().parent

#: relative L2 tolerance of the port's output against the reference's
_TOL = {"complex64": 1e-5, "bf16": 1e-4, "int8": 0.05}


#: the JAX side: the same matrix through the reference's runner
_REFERENCE = """
import json, sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from repro.core.meshutil import make_mesh
from repro.core.pfft import ParallelFFT
from repro.core.planconfig import PlanConfig
from repro.robustness import FaultPlan
from repro.robustness.runner import GuardError
import _torch_ranks as R

# one jit per guarded executor instead of op-by-op dispatch: the same
# trace, inside the same FaultPlan, at a fraction of the compile time
_guarded = ParallelFFT.guarded_padded
ParallelFFT.guarded_padded = lambda self, *a, **k: jax.jit(_guarded(self, *a, **k))

mesh = make_mesh((2, 2), ("p0", "p1"))
x = jnp.asarray(R.inputs()["guard"])
y_ref = ParallelFFT(mesh, R.GUARD_SHAPE, ("p0", "p1"), config=PlanConfig()).forward(x)
outcomes, arrays = {{}}, {{}}
for key, impl, case in R.guard_keys():
    guard, comm, injectors, direction = R.GUARD_CASES[case]
    fp = FaultPlan()
    for name, kw in injectors:
        getattr(fp, name)(**kw)
    with fp:
        plan = ParallelFFT(mesh, R.GUARD_SHAPE, ("p0", "p1"),
                           config=PlanConfig(method="fused", guard=guard, comm_dtype=comm,
                                             exchange_impl=impl))
        arg = {{"forward": x, "backward": y_ref,
               "forward_many": jnp.asarray(R.guard_fields(np.asarray(x)))}}
        try:
            y, rep = getattr(plan, direction)(arg[direction])
        except GuardError as e:
            outcomes[key] = {{"raised": True,
                             "tripped": list(e.report.tripped) if e.report else []}}
            continue
    outcomes[key] = R.report_outcome(rep)
    arrays[key] = np.asarray(y)
open({outcomes!r}, "w").write(json.dumps(outcomes))
np.savez({arrays!r}, **arrays)
"""


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``((outcomes per rank, arrays), (outcomes, arrays))`` of the port and
    the reference: the 4 ranks run while the JAX side does."""
    d = tmp_path_factory.mktemp("torch_guard")
    ref_out, ref_arrays = d / "reference.json", d / "reference.npz"
    join = R.start(R.run_guard_rank, d)
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), outcomes=str(ref_out),
                                  arrays=str(ref_arrays)), ndev=R.WORLD)
    finally:
        join()
    port = ([json.loads((d / f"guard{r}.json").read_text()) for r in range(R.WORLD)],
            dict(np.load(d / "guard0.npz")))
    return port, (json.loads(ref_out.read_text()), dict(np.load(ref_arrays)))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("key,case", [(k, c) for k, _, c in R.guard_keys()])
def test_fault_case_matches_reference(runs, key, case):
    (outcomes, arrays), (want, want_arrays) = runs
    got = outcomes[0][key]
    assert all(o[key] == got for o in outcomes[1:]), "ranks disagree"
    want = want[key]
    assert got["raised"] == want["raised"]
    assert got["tripped"] == want["tripped"]
    if got["raised"]:
        return
    for field in ("ok", "nfields", "kinds", "schedule", "has_energy", "direction"):
        assert got[field] == want[field], field
    assert got["ok"]
    comm = R.GUARD_CASES[case][1]
    assert _rel(arrays[key], want_arrays[key]) <= _TOL[comm]
    if got["rel_err"] is not None:
        assert got["rel_err"] <= got["tol"] and got["tol"] == want["tol"]


def test_fault_matrix_outcomes(runs):
    """The reference matrix's own assertions, on the port's outcomes."""
    out = runs[0][0][0]
    c = out["jnp:clean_strict"]
    assert c["ok"] and not c["has_energy"] and c["rel_err"] is None
    assert out["jnp:clean_bf16"]["has_energy"]
    s = out["jnp:wire_c64_strict"]
    assert s["raised"] and "output:nonfinite" in s["tripped"]
    assert any(e[0] != "fused" for e in out["jnp:wire_c64_degrade"]["schedule"])
    assert out["jnp:nan_input_strict"]["raised"]
    assert any("nonfinite" in t for t in out["jnp:wire_bf16_strict"]["tripped"])
    assert any(e[2] == "complex64" for e in out["jnp:wire_bf16_degrade"]["schedule"])
    assert any(e[2] != "int8" for e in out["jnp:int8_scale_degrade"]["schedule"])
    assert any("saturation" in t for t in out["jnp:saturate_strict"]["tripped"])
    assert out["jnp:saturate_backward"]["direction"] == "backward"
    assert out["jnp:exhausted"]["raised"]
    assert out["pallas:saturate_degrade"]["kinds"] == ["degrade"]
    assert out["jnp:fail_compile_degrade"]["kinds"] == ["degrade"]
    b = out["jnp:batched_clean"]
    assert b["ok"] and b["nfields"] == 3 and not b["kinds"]
    ys = runs[0][1]["jnp:batched_clean"]
    y1 = ys[1] / 2  # field 1 is 2x: its spectrum is twice field 0's
    assert _rel(y1, ys[0]) < 1e-5


def test_runner_lets_kernel_errors_through(runs):
    """A kernel wrapper that raises under guard="degrade" reaches the caller
    as itself: no degradation onto the plain codec, no GuardError."""
    for o in runs[0][0]:
        assert o["kernel_error"] == "RuntimeError: exchange kernel failed"


# ---------------------------------------------------------------------------
# the ladder and the stats, without ranks
# ---------------------------------------------------------------------------


def test_degrade_entry_walks_the_reference_ladder():
    names = {"cuda": "pallas", "torch": "jnp"}
    e, ej = ("pipelined", 4, "int8", "cuda", "stacked"), ("pipelined", 4, "int8", "pallas",
                                                         "stacked")
    while e is not None or ej is not None:
        assert (e[0], e[1], e[2], names[e[3]], e[4]) == tuple(ej)
        e, ej = runner.degrade_entry(e), jrunner.degrade_entry(ej)
    assert runner.degrade_entry(("traditional", 1, "complex64", "torch", "stacked")) is None


@pytest.mark.parametrize("stages", [None, (1,), (0, 1)])
def test_degrade_schedule_matches_reference(stages):
    sched = (("fused", 1, "int8", "cuda", "stacked"), ("pipelined", 3, "complex64", "torch",
                                                        "stacked"))
    jsched = (("fused", 1, "int8", "pallas", "stacked"), ("pipelined", 3, "complex64", "jnp",
                                                          "stacked"))
    got, want = runner.degrade_schedule(sched, stages), jrunner.degrade_schedule(jsched, stages)
    assert [tuple(e)[:3] + tuple(e)[4:] for e in got] == [tuple(e)[:3] + tuple(e)[4:]
                                                           for e in want]
    assert runner.degrade_schedule((("traditional", 1, "complex64", "torch", "stacked"),)) is None


def test_pack_unpack_partials_match_reference():
    rng = np.random.default_rng(1)
    stats = [{"nonfinite": float(a), "saturated": float(b)} for a, b in rng.integers(0, 9, (3, 2))]
    e_in, e_out, probe = 3.5, 7.25, -1.0
    got = health.pack_stats([{k: torch.tensor(v) for k, v in s.items()} for s in stats],
                            torch.tensor(e_in), torch.tensor(e_out), torch.tensor(probe))
    want = jhealth.pack_stats([{k: jnp.float32(v) for k, v in s.items()} for s in stats],
                              jnp.float32(e_in), jnp.float32(e_out), jnp.float32(probe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = np.stack([got.numpy(), 2 * got.numpy()])
    a, b = health.unpack_partials(rows, 3), jhealth.unpack_partials(rows, 3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("axis", [None, 0, 2])
def test_probe_and_energy_against_numpy(axis):
    rng = np.random.default_rng(axis or 7)
    x = (rng.standard_normal((5, 6, 7)) + 1j * rng.standard_normal((5, 6, 7))).astype(np.complex64)
    plane = x if axis is None else np.take(x, 0, axis=axis)
    s = plane.astype(np.complex128).sum()
    assert float(health.output_probe(torch.from_numpy(x), axis)) == pytest.approx(
        s.real + s.imag, rel=1e-5, abs=1e-4)
    want = float(np.sum(np.abs(x.astype(np.complex128)) ** 2))
    assert float(health.block_energy(torch.from_numpy(x))) == pytest.approx(want, rel=1e-5)
    xr = x.real.copy()
    assert float(health.block_energy(torch.from_numpy(xr))) == pytest.approx(
        float(np.sum(xr.astype(np.float64) ** 2)), rel=1e-5)
    x[1, 2, 3] = np.nan
    assert float(health.count_nonfinite(torch.from_numpy(x))) == 1
    assert not np.isfinite(float(health.output_probe(torch.from_numpy(x), None)))


def test_taps_are_noops_when_unarmed():
    x = torch.randn(4, 5, dtype=torch.complex64)
    with faults.stage_context(0, "fused", "complex64"):
        assert faults.tap_wire(x) is x and faults.tap_stage_input(x) is x
        assert faults.scale_div() is None
        faults.check_compile("fused", "complex64")
    with FaultPlan().saturate(engine="pipelined"):  # armed, but for another engine
        with faults.stage_context(0, "fused", "int8"):
            assert faults.scale_div() is None and faults.tap_wire(x) is x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "complex64"])
def test_wire_burst_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 4)).astype(np.float32) * 50
    if dtype == "complex64":
        x = (x + 1j * x[::-1]).astype(np.complex64)
        t, j = torch.from_numpy(x), jnp.asarray(x)
    elif dtype == "int8":
        t, j = torch.from_numpy(x.astype(np.int8)), jnp.asarray(x.astype(np.int8))
    else:
        t, j = torch.from_numpy(x).to(getattr(torch, dtype)), jnp.asarray(x, dtype=dtype)
    with FaultPlan().corrupt_wire() as fp:
        got = faults.tap_wire(t)
    with jfaults.FaultPlan().corrupt_wire():
        want = np.asarray(jfaults.tap_wire(j))
    assert len(fp.fired) == 1
    if dtype == "bfloat16":
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        got = got.numpy()
    assert not np.array_equal(got, x if dtype != "bfloat16" else t.view(torch.int16).numpy())
    np.testing.assert_array_equal(got, want)

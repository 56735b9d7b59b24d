"""The port's run-time plan audit (``repro_torch.analysis.planlint``,
``ParallelFFT.audit``) on 4 gloo ranks, against the reference's
``audit_plan`` (tests/test_planlint.py's contracts) in a subprocess with 4
virtual devices.

* Every engine x comm_dtype x exchange impl x batch fusion on the (2, 2)
  pencil and the slab plan, forward and backward, and the DNS and mixed
  (dct2, c2c, r2c) plans under both FFT impls, audit clean: the
  collectives, their payload bytes, the engine's copies and concatenates
  and their bytes (the tuner's copy model), dtypes, guard and kernel
  containment all as the schedule says.
* Launches and off-rank payload bytes equal the reference's audit of the
  same plan (its jaxpr ``all_to_all`` count and its payload multiset).
* ``exchange_engine_ops`` equals the reference's wherever its docstring
  says so (lossy fused and pipelined, traditional), on every exchange of
  the pencil and slab plans, stacked or not, transposed out or not.
* The reference's negative claims are caught with its codes: a
  traditional plan claiming fused (PLAN003; on a bf16 wire, since on a
  lossless one the port's fused engine makes traditional's two copies too),
  a mis-counted launch (a
  pipelined plan claiming fused: PLAN001), a quantized plan claiming
  lossless and the reverse (PLAN006; int8 also PLAN001), the codec leak
  (the plain codec claiming the kernels: PLAN009), a wrong-length schedule
  (ValueError); and a float64 upcast planted on the data path (PLAN005), a
  guard op in an unguarded plan (PLAN008), and a transform that hands its
  moved view to an exchange that takes its block as it lies (PLAN003: the
  pack's realignment is reported, not absorbed into the contract).
* The CLI audits every example plan ``ok`` on the 4 ranks.
"""

import json
from pathlib import Path

import pytest

import _torch_ranks as R

TESTS = Path(__file__).resolve().parent

#: the reference's audits of R.AUDIT_REFERENCE_PLANS (jaxpr only) and its
#: exchange_engine_ops on the stages of the pencil and slab plans
_REFERENCE = """
import json, sys
sys.path.insert(0, {tests!r})
from repro.analysis.planlint import audit_plan
from repro.core import fftcore
from repro.core.meshutil import make_mesh
from repro.core.pfft import ExchangeStage, ParallelFFT
from repro.core.planconfig import PlanConfig
from repro.core.redistribute import exchange_engine_ops
import _torch_ranks as R

mesh = make_mesh((2, 2), ("p0", "p1"))
out = {{"audits": {{}}, "ops": {{}}}}
for label, (g, fields, nf, tag) in R.AUDIT_REFERENCE_PLANS.items():
    plan = ParallelFFT(mesh, R.audit_shape(tag), R.AUDIT_GRIDS[g], config=PlanConfig(**fields),
                       transforms=R.audit_transforms(tag, fftcore))
    rep = audit_plan(plan, nfields=nf, check_hlo=False)
    out["audits"][label] = {{"ok": rep.ok, "all_to_alls": rep.observed["jaxpr_all_to_alls"],
                            "payload_bytes": rep.expected["payload_bytes"]}}
for g, grid in R.AUDIT_GRIDS.items():
    plan = ParallelFFT(mesh, R.AUDIT_SHAPE, grid)
    for i, st in enumerate(plan.stages):
        if not isinstance(st, ExchangeStage):
            continue
        for key, kw in R.engine_op_cases():
            out["ops"][f"{{g}}/{{i}}/{{key}}"] = exchange_engine_ops(
                plan.pencil_trace[i], st.v, st.w, **kw)
open({out!r}, "w").write(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``(port, reference)``: the ranks' results and the JAX side's."""
    d = tmp_path_factory.mktemp("torch_planlint")
    ref = d / "reference.json"
    join = R.start(R.run_planlint_rank, d)
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), out=str(ref)), ndev=R.WORLD)
    finally:
        join()
    port = json.loads((d / "planlint.json").read_text())
    port["cli_report"] = json.loads((d / "plan_audit.json").read_text())
    return port, json.loads(ref.read_text())


def _matrix_keys():
    keys = [f"{g}/{m}/{c}/{i}/{nf}/{f}/{d}" for g in R.AUDIT_GRIDS for m in R.AUDIT_METHODS
            for c in R.COMM_DTYPES for i in ("torch", "cuda") for nf, f in R.AUDIT_FUSIONS
            for d in ("forward", "backward")]
    keys += [f"{t}/{fi}/{m}/{nf}/{d}" for t in ("ns", ("dct2", "c2c", "r2c"))
             for fi in ("torch", "matmul") for m in R.AUDIT_METHODS for d in ("forward", "backward")
             for nf in (1, 3)]
    return keys


@pytest.mark.parametrize("key", _matrix_keys())
def test_every_plan_audits_clean(runs, key):
    rec = runs[0]["matrix"][key]
    assert rec["ok"] and rec["codes"] == [], (key, rec)


def test_fused_engine_makes_no_copy_on_a_lossy_wire(runs):
    """The no-realignment invariant where the port holds it: a lossy fused
    exchange (the codec packs and scatters) makes no engine copy."""
    matrix = runs[0]["matrix"]
    for key, rec in matrix.items():
        if key.count("/") == 6 and key.split("/")[1] == "fused" and key.split("/")[2] != "complex64":
            assert rec["engine_copies"] == 0, (key, rec)


@pytest.mark.parametrize("label", list(R.AUDIT_REFERENCE_PLANS))
def test_launches_and_payload_bytes_equal_the_reference(runs, label):
    port, ref = runs
    got, want = port["reference"][label], ref["audits"][label]
    assert want["ok"] and got["codes"] == [], (got, want)
    assert got["report_type"] == "AuditReport"
    assert got["all_to_alls"] == want["all_to_alls"]
    assert got["payload_bytes"] == want["payload_bytes"]


def test_engine_ops_equal_the_reference_where_claimed(runs):
    from repro_torch.core.pfft import ExchangeStage, ParallelFFT
    from repro_torch.core.redistribute import exchange_engine_ops

    _, ref = runs
    compared = 0
    for g, grid in R.AUDIT_GRIDS.items():
        plan = ParallelFFT(R.StandInMesh((2, 2), ("p0", "p1")), R.AUDIT_SHAPE, grid)
        for i, st in enumerate(plan.stages):
            if not isinstance(st, ExchangeStage):
                continue
            for key, kw in R.engine_op_cases():
                if not R.engine_ops_claimed_equal(kw):
                    continue
                port_kw = dict(kw, impl={"jnp": "torch", "pallas": "cuda"}[kw["impl"]])
                got = exchange_engine_ops(plan.pencil_trace[i], st.v, st.w, **port_kw)
                assert got == ref["ops"][f"{g}/{i}/{key}"], (g, i, key, got)
                compared += 1
    assert compared > 50


@pytest.mark.parametrize("claim,codes", [
    ("traditional_claims_fused", {"PLAN003"}),
    ("pipelined_claims_fused", {"PLAN001"}),
    ("lossless_claims_bf16", {"PLAN006"}),
    ("bf16_claims_lossless", {"PLAN006"}),
    ("int8_claims_lossless", {"PLAN001", "PLAN006"}),
    ("torch_codec_claims_kernels", {"PLAN009"}),
    ("kernels_claim_torch_codec", {"PLAN009"}),
    ("float64_on_path", {"PLAN005"}),
    ("guard_op_unguarded", {"PLAN008"}),
    ("strided_arrival", {"PLAN003"}),
])
def test_negative_claims_are_caught(runs, claim, codes):
    got = set(runs[0]["negative"][claim])
    assert codes <= got, (claim, got)


def test_wrong_length_schedule_is_a_usage_error(runs):
    assert "exchange stages" in runs[0]["negative"]["wrong_length"]


def test_guarded_plan_has_guard_ops_and_its_float64_stats_are_allowed(runs):
    g = runs[0]["guarded"]
    assert g["codes"] == [] and g["guard_ops"] > 0


def test_cli_audits_every_example_plan(runs):
    port = runs[0]
    report = port["cli_report"]
    assert port["cli_rc"] == 0 and report["ok"] and report["world"] == R.WORLD
    assert set(report["plans"]) == {"quickstart", "quickstart[guarded]", "quickstart[int8-cuda]",
                                    "quickstart[bf16-cuda-trad]", "navier_stokes",
                                    "navier_stokes[batched]", "poisson"}
    assert all(p["ok"] for p in report["plans"].values())

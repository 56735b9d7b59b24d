"""The example twins (``repro_torch.examples``) on 4 gloo ranks against the
JAX examples (``examples/*.py``, run whole in a subprocess with 4 virtual
devices), at the examples' sizes.

The ranks (tests/_torch_ranks.py ``run_examples_rank``) run while the JAX
side does.  Tolerances:

* quickstart: the example's own limits (round trip rtol = atol = 1e-4; the
  forward against ``np.fft.fftn`` rtol 1e-4, atol 1e-2), on both sides;
* Poisson: the port's ``max|u - u*|`` within 1e-6 of the reference's (both
  are ~2e-7 at 32^3: the float32 transforms' rounding, the solve in
  float64), and under the example's 1e-3;
* Navier-Stokes: the energy at every step within 1e-5 relative of the
  reference's (float32 throughout on both sides; the port sums the energy
  in float64, the reference pairwise in float32, ~1e-7 apart), the initial
  decay rate within 1e-3 of the reference's and within 10 % of 6 nu, the
  final divergence under 1e-3 sqrt(E0), the batched forward bitwise the
  per-field loop, and the guarded demo's outcome (ok, attempts, transition
  kinds) the reference's;
* the solver works on rank-local blocks: no all-gather in the whole run,
  and one RK2 step issues exactly the ``all_to_all_single`` calls of its six
  batched transforms (``model_collective_launches``).
"""

import json
import math
from pathlib import Path

import pytest

import _torch_ranks as R

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

#: the JAX side: the three example scripts run whole, their globals read back
_REFERENCE = """
import json, runpy
import numpy as np
out = {{}}
g = runpy.run_path({qs!r})
out["quickstart"] = {{
    "roundtrip_err": float(np.abs(np.asarray(g["u_back"]) - g["u"]).max()),
    "forward_err": float(np.abs(np.asarray(g["u_hat"]) - np.fft.fftn(g["u"])).max())}}
g = runpy.run_path({ps!r})
out["poisson"] = {{"err": float(g["err"])}}
g = runpy.run_path({ns!r})
rep = g["rep"]
out["navier_stokes"] = {{
    "energies": [float(e) for e in g["Es"]], "div": float(g["div"]), "rate": float(g["rate"]),
    "guarded": {{"ok": bool(rep.ok), "attempts": int(rep.attempts),
                 "transitions": [t["kind"] for t in rep.transitions]}}}}
open({out!r}, "w").write(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``(port, reference)`` results of the three examples, run side by side."""
    d = tmp_path_factory.mktemp("torch_examples")
    ref = d / "reference.json"
    join = R.start(R.run_examples_rank, d)
    try:
        subproc(_REFERENCE.format(qs=str(REPO / "examples" / "quickstart.py"),
                                  ps=str(REPO / "examples" / "poisson.py"),
                                  ns=str(REPO / "examples" / "navier_stokes.py"),
                                  out=str(ref)), ndev=R.WORLD)
    finally:
        join()
    return json.loads((d / "examples.json").read_text()), json.loads(ref.read_text())


def test_quickstart_within_the_examples_limits(runs):
    """The port's blocks meet the example's assert_allclose limits (the JAX
    script asserts its own), and its errors are of the reference's order."""
    port, ref = runs
    qs = port["quickstart"]
    assert qs["ok"] and qs["mesh"] == {"p0": 2, "p1": 2}
    assert qs["roundtrip_err"] < 10 * ref["quickstart"]["roundtrip_err"] + 1e-6
    assert qs["forward_err"] < 10 * ref["quickstart"]["forward_err"] + 1e-4


def test_poisson_error_matches_the_reference(runs):
    port, ref = runs
    ps = port["poisson"]
    assert ps["ok"] and ps["err"] < 1e-3
    assert abs(ps["err"] - ref["poisson"]["err"]) <= 1e-6, (ps["err"], ref["poisson"]["err"])


@pytest.mark.parametrize("step", range(9))
def test_navier_stokes_energy_each_step(runs, step):
    port, ref = runs
    got = port["navier_stokes"]["energies"]
    want = ref["navier_stokes"]["energies"]
    assert len(got) == len(want) == 9
    assert abs(got[step] - want[step]) <= 1e-5 * abs(want[step]), (step, got[step], want[step])


def test_navier_stokes_checks(runs):
    port, ref = runs
    ns = port["navier_stokes"]
    assert ns["ok"], ns["checks"]
    assert abs(ns["E0"] - 0.125) <= 1e-5 * 0.125
    assert ns["div"] < 1e-3 * math.sqrt(ns["E0"])
    assert abs(ns["rate"] - 6 * ns["nu"]) < 0.1 * 6 * ns["nu"]
    assert abs(ns["rate"] - ref["navier_stokes"]["rate"]) <= 1e-3
    assert ns["bitwise_batched"]


def test_navier_stokes_guarded_recovery_matches_the_reference(runs):
    port, ref = runs
    g, want = port["navier_stokes"]["guarded"], ref["navier_stokes"]["guarded"]
    assert g["recovered"] and g["max_err"] <= g["limit"]
    assert (g["ok"], g["attempts"], g["transitions"]) == (want["ok"], want["attempts"],
                                                          want["transitions"])


def test_navier_stokes_runs_on_rank_blocks(runs):
    """No all-gather anywhere in the run; one step's collectives are its six
    batched transforms' (two RHS of a 3-field backward, a 9-field backward
    and a 3-field forward)."""
    ns = runs[0]["navier_stokes"]
    assert ns["collectives_in_run"]["gathers"] == 0
    assert ns["collectives_per_step"] == {"all_to_all_single": ns["model_collectives_per_step"],
                                          "gathers": 0}
    assert ns["model_collectives_per_step"] == 12  # 2 RHS x 3 calls x 2 exchanges, stacked

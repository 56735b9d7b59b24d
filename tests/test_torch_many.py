"""Batched multi-field execution in the port (``forward_many`` /
``backward_many``, the three ``batch_fusion`` modes, stacked exchanges,
guarded batches, the batch-aware counts) on 4 gloo ranks, against the
port's own per-field loop and, for a few cases, the JAX package on 4
virtual devices (tests/test_batched.py's contracts).

The ranks (tests/_torch_ranks.py ``run_many_rank``) run while the JAX side
does; both build the same numpy-seeded inputs.  Tolerances:

* lossless ``forward_many``/``backward_many``: bitwise equal to the per-field
  loop of ``forward``/``backward``, every plan, mode and direction; the round
  trip within rtol 3e-4, atol 3e-3 (tests/test_batched.py);
* stacked ``exchange_shard(..., nbatch=1)``: bitwise equal to the per-field
  loop for every engine and payload (one int8 scale per (field, chunk) gives
  each field the scales of its own exchange); each field within 5e-3 (bf16)
  / 2e-2 (int8) relative L2 of its lossless exchange although field 1 is
  1000x the others (tests/test_batched.py's bounds);
* against the JAX package: ``forward_many`` of fields with field 1 at 1000x
  the others, within 1e-5 relative L2 lossless, and 1e-3 for bf16 and int8.
  Both packages make the same roundings, so a lossy wire differs only where
  the two FFTs round a value to either side of a bf16 tie or an int8
  boundary; one int8 quantum flipped (max |x| / 127 against the field's
  norm) costs about 4e-4 of these small fields.  The limit still tells the
  wires apart: the port's lossless output reads about 1.1e-2 against the
  reference's int8 and 2.4e-3 against its bf16, and an int8 scale shared
  across fields reads of order 1 on the unit-scale fields.  The
  traditional int8 exchange of stacked fields within 1.25 quanta of each
  field (max |x_f| / 127, as tests/test_torch_pfft.py); the counts exactly;
* the collectives each call issues (``all_to_all_single`` counted in the
  ranks): ``model_collective_launches`` exactly, plus one scale collective
  per int8 payload collective.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as R

TESTS = Path(__file__).resolve().parent

#: port vs the JAX package's forward_many, relative L2 (module docstring)
_REF_TOL = {"complex64": 1e-5, "bf16": 1e-3, "int8": 1e-3}
#: a lossy stacked exchange's field vs its lossless exchange, relative L2
_LOSSY_TOL = {"bf16": 5e-3, "int8": 2e-2}

#: the JAX side: forward_many of the pencil plan, the traditional int8
#: exchanges of stacked fields, and the counts of every plan
_REFERENCE = """
import json, sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.meshutil import make_mesh, shard_map
from repro.core.pfft import ExchangeStage, ParallelFFT
from repro.core.planconfig import PlanConfig
from repro.core.redistribute import exchange_shard
import _torch_ranks as R

# one jit per batched executor instead of op-by-op dispatch
_many = ParallelFFT._many_padded
ParallelFFT._many_padded = lambda self, *a: jax.jit(_many(self, *a))

mesh = make_mesh((2, 2), ("p0", "p1"))
res, counts = {{}}, {{}}
x = jnp.asarray(R.many_reference_input())
for fusion, comm in R.MANY_REFERENCE_CASES:
    plan = ParallelFFT(mesh, R.MANY_SHAPE, ("p0", "p1"),
                       config=PlanConfig(batch_fusion=fusion, comm_dtype=comm,
                                         exchange_impl="pallas"))
    res["ref:" + fusion + ":" + comm] = np.asarray(plan.forward_many(x))
for name, (grid, cfg, transforms) in R.MANY_PLANS.items():
    plan = ParallelFFT(mesh, R.MANY_SHAPE, grid, config=PlanConfig(**cfg),
                       transforms=transforms)
    counts[name] = R.many_counts(plan, ExchangeStage)
for key, lay, tout in R.TRAD_INT8_CASES:
    mshape, names, fshape, placement, v, w = R.EXCHANGE_LAYOUTS[lay]
    m = make_mesh(mshape, names)

    def shard(b, v=v, w=w, g=placement[w], tout=tout):
        return exchange_shard(b, v, w, g, method="traditional", comm_dtype="int8", nbatch=1,
                              transposed_out=tout)[None]

    fn = shard_map(shard, mesh=m, in_specs=P(None, *placement), out_specs=P(names),
                   check_vma=False)
    res["trad_int8:" + key] = np.asarray(jax.jit(fn)(jnp.asarray(R.stacked_exchange_input(lay))))
np.savez({arrays!r}, **res)
open({counts!r}, "w").write(json.dumps(counts))
"""


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``((info, arrays), (counts, arrays))`` of the port's ranks and the
    JAX side, run side by side."""
    d = tmp_path_factory.mktemp("torch_many")
    ref_arrays, ref_counts = d / "reference.npz", d / "reference.json"
    join = R.start(R.run_many_rank, d)
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), arrays=str(ref_arrays),
                                  counts=str(ref_counts)), ndev=R.WORLD)
    finally:
        join()
    port = (json.loads((d / "many.json").read_text()), dict(np.load(d / "many.npz")))
    return port, (json.loads(ref_counts.read_text()), dict(np.load(ref_arrays)))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


_PLAN_CASES = [(p, f, d) for p in R.MANY_PLANS for f in R.BATCH_FUSIONS
               for d in ("forward", "backward")]


@pytest.mark.parametrize("plan,fusion,direction", _PLAN_CASES)
def test_many_bitwise_equals_per_field_loop(runs, plan, fusion, direction):
    """forward_many/backward_many of 3 fields equal the per-field loop of
    forward/backward bit for bit (lossless wire)."""
    arrays = runs[0][1]
    d = "fwd" if direction == "forward" else "back"
    got, want = arrays[f"{plan}:{fusion}:{d}"], arrays[f"{plan}:loop:{d}"]
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plan", list(R.MANY_PLANS))
def test_many_round_trip(runs, plan):
    arrays = runs[0][1]
    real = plan == "pencil_r2c"
    x = R.many_fields(plan, real=real)
    fwd = arrays[f"{plan}:loop:fwd"]
    want = (np.fft.rfftn if real else np.fft.fftn)(x, axes=(1, 2, 3))
    assert _rel(fwd, want) <= 1e-5
    np.testing.assert_allclose(arrays[f"{plan}:stacked:back"], x, rtol=3e-4, atol=3e-3)


@pytest.mark.parametrize("plan,fusion,direction", _PLAN_CASES)
def test_collectives_per_call_match_the_model(runs, plan, fusion, direction):
    """The stacked path issues n_exchanges collectives a call (one field's
    count), the per-field modes N times that; each is
    model_collective_launches."""
    info = runs[0][0]
    key = f"{plan}:{fusion}:{direction}"
    got = info["counts"][key]
    assert got == info["model"][key]
    single = info["counts"][f"{plan}:single:forward"]
    assert got == (single if fusion == "stacked" else R.NFIELDS * single)


@pytest.mark.parametrize("fusion,want", [
    ("stacked", "F" + "AF" * 2),
    ("per-field", "F" + "AFAFAF" * 2),
    # field f's collective is issued before field f - 1's transform, and
    # waited for after it
    ("pipelined-across-fields", "F" + "AAWFAWFWF" * 2),
])
def test_issue_order_of_each_mode(runs, fusion, want):
    """The host's order of collectives (A), waits (W) and transform stages
    (F) in one 3-field pencil forward."""
    assert runs[0][0]["issue_order"][fusion] == want


@pytest.mark.parametrize("fusion", ["stacked", "per-field"])
def test_int8_adds_one_scale_collective_per_payload(runs, fusion):
    info = runs[0][0]
    assert info["counts"][f"int8:{fusion}"] == 2 * info["model"][f"int8:{fusion}"]


@pytest.mark.parametrize("item", ["dict", "list", "tuple", "forward_routes", "backward_routes",
                                  "one_field"])
def test_many_structures(runs, item):
    """A dict, list or tuple of fields comes back as the same structure, a
    d+1-dim forward()/backward() input takes the batched path, one field
    equals forward()."""
    s = runs[0][0]["structures"]
    if item == "dict":
        assert s["dict_keys"] == ["u", "v", "w"] and s["dict_equal"]
    elif item in ("list", "tuple"):
        assert s[item] == item and s[f"{item}_equal"]
    else:
        assert s[item]


def test_pencil_nbatch_scatter_and_gather(runs):
    s = runs[0][0]["structures"]
    assert s["gather_nbatch"] and s["allgather_nbatch"]


_EXCHANGE_CASES = [(lay, eng, impl, comm) for lay in R.EXCHANGE_LAYOUTS
                   for eng, _, _ in R.MANY_ENGINES for impl in ("torch", "cuda")
                   for comm in R.COMM_DTYPES]


@pytest.mark.parametrize("lay,eng,impl,comm", _EXCHANGE_CASES)
def test_stacked_exchange_equals_per_field_loop(runs, lay, eng, impl, comm):
    """exchange_shard(..., nbatch=1) of 3 fields, field 1 at 1000x, equals
    the per-field loop (transposed out: chunk axis first, fields second)."""
    r = runs[0][0]["exchange"][f"ex:{lay}:{eng}:{impl}:{comm}"]
    assert r["shape"] == r["want_shape"] and r["equal_loop"]
    if eng == "trad_tout":
        assert r["shape"][1] == R.NFIELDS
    if comm == "complex64":
        assert max(r["rel_vs_lossless"]) == 0.0
    else:
        assert max(r["rel_vs_lossless"]) <= _LOSSY_TOL[comm]


@pytest.mark.parametrize("key,lay,tout", R.TRAD_INT8_CASES)
def test_traditional_int8_stacked_matches_reference(runs, key, lay, tout):
    """The repaired path: one int8 scale per (chunk, field), within one
    quantum of each field of the reference's exchange."""
    got, want = runs[0][1][f"trad_int8:{key}"], runs[1][1][f"trad_int8:{key}"]
    assert got.shape == want.shape
    x = R.stacked_exchange_input(lay)
    field_axis = 2 if tout else 1  # (ranks, [chunks,] fields, ...)
    for f in range(R.NFIELDS):
        quantum = float(np.max(np.abs(np.stack([x[f].real, x[f].imag])))) / 127.0
        np.testing.assert_allclose(np.take(got, f, axis=field_axis),
                                   np.take(want, f, axis=field_axis), atol=1.25 * quantum, rtol=0)


@pytest.mark.parametrize("fusion,comm", R.MANY_REFERENCE_CASES)
def test_forward_many_matches_reference(runs, fusion, comm):
    got, want = runs[0][1][f"ref:{fusion}:{comm}"], runs[1][1][f"ref:{fusion}:{comm}"]
    assert got.shape == want.shape and got.dtype == want.dtype
    for f in range(R.NFIELDS):
        assert _rel(got[f], want[f]) <= _REF_TOL[comm]


@pytest.mark.parametrize("plan", list(R.MANY_PLANS))
def test_counts_match_reference(runs, plan):
    """model_flops, model_collective_launches, exchange_cost_bytes,
    exchange_wire_bytes, pipeline_slices and exchange_collective_launches."""
    got, want = runs[0][0]["plan_counts"][plan], runs[1][0][plan]
    assert got == want


def test_guarded_batch_strict_is_the_unguarded_batch(runs):
    g = runs[0][0]["guard_strict"]
    assert g["ok"] and g["nfields"] == R.NFIELDS and g["equal_unguarded"]


@pytest.mark.parametrize("fusion", R.BATCH_FUSIONS)
def test_guarded_batch_degrades_past_a_corrupted_wire(runs, fusion):
    g = runs[0][0][f"guard_degrade:{fusion}"]
    assert g["ok"] and g["nfields"] == R.NFIELDS and g["kinds"] == ["degrade"]
    assert all(e[2] == "complex64" and e[4] == fusion for e in g["schedule"])
    assert g["rel"] <= 1e-5


def test_run_guarded_starts_from_a_forced_schedule(runs):
    g = runs[0][0]["guard_forced"]
    assert g["ok"] and g["nfields"] == R.NFIELDS and g["equal"]
    assert g["schedule"] == [["traditional", 1, "complex64", "torch", "per-field"]] * 2


def test_warm_runs_batched_executors(runs):
    assert runs[0][0]["warm"] == [2, 1]

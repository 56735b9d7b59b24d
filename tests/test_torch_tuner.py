"""The port's schedule tuner (``method="auto"``, ``core/tuner.py``), its
time model (``model_time_s``, ``exchange_time_model``,
``comm_bytes_per_device``) and ``core/modelfit.py``, against the JAX
package.

* Unit cases ported from tests/test_tuner.py (plan keys, candidates, the
  atomic and locked cache writes, quarantine) and tests/test_scalebench.py's
  modelfit cases; plans built over a stand-in mesh (``R.StandInMesh``: the mesh
  attributes a plan's arithmetic reads), no process group.
* Parity with the reference, computed in one JAX subprocess (8 virtual
  devices): the candidate sets in order under the name map (``"jnp"`` ->
  ``"torch"``, ``"pallas"`` -> ``"cuda"``); the models of the plans of
  tests/test_pfft.py:17-42 (the slab on a composed group in mesh order and
  out of it included) at the same coefficients, passed explicitly, to 1e-12
  relative, both directions, 1 and 3 fields, every candidate entry as the
  uniform schedule.  The one difference is the local copies: the port
  prices the copies its code makes (``exchange_local_copy_elems``: a
  lossless fused or pipelined exchange over M > 1 ranks packs and scatters
  where they move data, a composed group out of mesh order gathers its
  chunks, a pack or unpack of a leading axis is free; written out here
  apart from the model in ``_port_copy_elems``, and held to the copies a
  run makes by tests/test_torch_planlint.py); the port's count less the
  reference's is added to the reference's value before the comparison;
  and ``tune_plan`` under one deterministic stand-in
  ``_time_stage`` picks the reference's schedule, also with model priors
  armed (top 6).
* Four gloo ranks (tests/_torch_ranks.py ``run_tune_rank``) on the (16, 8,
  8) pencil plan of tests/test_robustness.py: every rank resolves the same
  schedule, only rank 0 writes the cache, a replay times nothing, the auto
  plan's forward and ``forward_many(3)`` are bitwise equal to the explicit
  plan under the tuned schedule and within 1e-5 relative L2 of the
  reference's fused forward (lossless budget: f32 rounding only), the int8
  budget, stale and corrupt caches, a rank-skewed timer, and the poisoned
  entry under a compile fault (the reference's ``poison_auto``: ok, a
  ``"retune"``, one quarantine on disk, within 1e-4 of the clean forward).
"""

import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro_torch.core import modelfit, tuner
from repro_torch.core.pfft import ExchangeStage, ParallelFFT
from repro_torch.core.decomp import local_lengths
from repro_torch.core.meshutil import in_mesh_order
from repro_torch.core.pencil import group_names, group_size
from repro_torch.core.quant import wire_ratio
from repro_torch.core.planconfig import PlanConfig, StageEntry

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

#: the port's models against the reference's, relative
_MODEL_RTOL = 1e-12


def _plan(name, **config):
    mshape, names, shape, grid, transforms = R.MODEL_PLANS[name]
    return ParallelFFT(R.StandInMesh(mshape, names), shape, grid, transforms=transforms,
                       config=PlanConfig(**config))


# -- the reference, in one subprocess ----------------------------------------

_REFERENCE = """
import json, os, sys
sys.path.insert(0, {tests!r})
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import tuner
from repro.core.meshutil import make_mesh
from repro.core.pfft import ExchangeStage, ParallelFFT
from repro.core.planconfig import PlanConfig
import _torch_ranks as R

out = {{"candidates": {{}}, "models": {{}}, "tuned": {{}}}}
for budget, impl in R.CANDIDATE_BUDGETS:
    out["candidates"][budget + ":" + impl] = [list(e) for e in tuner.candidates_for(budget, impl)]
    out["candidates"][budget + ":" + impl + ":batched"] = [
        list(e) for e in tuner.batched_candidates_for(budget, impl)]
meshes = {{}}
plans = {{}}
for name, (mshape, names, shape, grid, transforms) in R.MODEL_PLANS.items():
    if mshape not in meshes:
        meshes[mshape] = make_mesh(mshape, names)
    plans[name] = ParallelFFT(meshes[mshape], shape, grid, transforms=transforms)
    out["models"][name] = R.model_numbers(plans[name], ExchangeStage,
                                          tuner.batched_candidates_for("int8", "pallas"))

tuner._time_stage = lambda plan, *a, **k: R.fake_stage_seconds(*a, **k)
for priors in ({priors!r}, None):
    if priors:
        os.environ["REPRO_MODEL_PRIORS"] = priors
        os.environ["REPRO_TUNER_PRIOR_TOPK"] = "6"
    else:
        os.environ.pop("REPRO_MODEL_PRIORS", None)
    for name in R.MODEL_PLANS:
        plan = ParallelFFT(plans[name].mesh, plans[name].shape, plans[name].grid,
                           transforms=plans[name].transforms,
                           config=PlanConfig(comm_dtype="int8", exchange_impl="pallas"))
        for nf in (1, 3):
            tuner._STAGE_MEMO.clear()
            sched, timings = tuner.tune_plan(plan, nfields=nf)
            out["tuned"][f"{{name}}:{{nf}}:{{bool(priors)}}"] = [list(e) for e in sched]

guard = ParallelFFT(Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("p0", "p1")),
                    R.TUNE_SHAPE, ("p0", "p1"))
x = R.inputs()["guard"]
np.savez({arrays!r}, forward=np.asarray(guard.forward(x)),
         forward_many=np.stack([np.asarray(guard.forward(f)) for f in R.guard_fields(x)]))
open({out!r}, "w").write(json.dumps(out))
"""


def _write_priors(path: Path) -> Path:
    """A priors file giving all four coefficients, so both packages rank at
    the same ones."""
    return modelfit.save_priors({"priors": dict(R.MODEL_COEFFS, ici_bw=4.4e10)}, path)


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``(ranks, reference)``: the four ranks' outcomes with rank 0's arrays,
    and the reference's numbers with its arrays, run side by side."""
    d = tmp_path_factory.mktemp("torch_tuner")
    ref_out, ref_arrays = d / "reference.json", d / "reference.npz"
    priors = _write_priors(d / "priors.json")
    join = R.start(R.run_tune_rank, d)
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), priors=str(priors), out=str(ref_out),
                                  arrays=str(ref_arrays)), ndev=8)
    finally:
        join()
    ranks = [json.loads((d / f"tune{r}.json").read_text()) for r in range(R.WORLD)]
    return ((ranks, dict(np.load(d / "tune.npz"))),
            (json.loads(ref_out.read_text()), dict(np.load(ref_arrays)), priors))


@pytest.fixture(autouse=True)
def _fresh_memos():
    tuner._MEMO.clear()
    tuner._STAGE_MEMO.clear()
    yield
    tuner._MEMO.clear()
    tuner._STAGE_MEMO.clear()


# -- candidates ----------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("budget,impl", R.CANDIDATE_BUDGETS)
def test_candidates_equal_reference_in_order(runs, budget, impl, batched):
    """The port's candidates are the reference's, in its order, under the
    implementation name map."""
    _, (ref, _, _) = runs
    port_impl = {"jnp": "torch", "pallas": "cuda"}[impl]
    fn = tuner.batched_candidates_for if batched else tuner.candidates_for
    key = f"{budget}:{impl}" + (":batched" if batched else "")
    assert R.as_reference_rows(fn(budget, port_impl)) == ref["candidates"][key]


def test_candidates_cover_the_matrix():
    assert ("fused", 1) in tuner.ENGINE_CANDIDATES
    assert ("traditional", 1) in tuner.ENGINE_CANDIDATES
    for c in (2, 4, 8):
        assert ("pipelined", c) in tuner.ENGINE_CANDIDATES
    assert {e.comm_dtype for e in tuner.DEFAULT_CANDIDATES} == {"complex64"}
    assert set(tuner.candidates_for("bf16")) > set(tuner.candidates_for(None))
    assert set(tuner.candidates_for("int8")) > set(tuner.candidates_for("bf16"))
    for e in tuner.candidates_for("int8"):
        assert (e.method, e.chunks) in tuner.ENGINE_CANDIDATES
        assert e.impl == "torch"
    cuda = tuner.candidates_for("int8", "cuda")
    extra = set(cuda) - set(tuner.candidates_for("int8"))
    assert extra and all(e.impl == "cuda" and e.comm_dtype != "complex64" for e in extra)
    assert len(cuda) == 25
    batched = tuner.batched_candidates_for("bf16")
    assert len(batched) == 3 * len(tuner.candidates_for("bf16"))
    assert {e.batch_fusion for e in batched} == {"stacked", "pipelined-across-fields",
                                                 "per-field"}
    assert {e._replace(batch_fusion="stacked") for e in batched} == set(
        tuner.candidates_for("bf16"))


# -- the models ------------------------------------------------------------------


def _port_copy_elems(src, v, w, entry, nbatch) -> int:
    """The port's local copies of one exchange, written out from what its
    engines do (``core/redistribute.py``): a pack into chunk-major order
    where the moved axis ``v`` does not lead, a scatter where ``w`` does not
    lead after the exchange, traditional's pack and unpack alike unless the
    codec kernels do them, the pipelined slices' packs and their
    concatenate, and a composed group's gathers out of mesh order."""
    lossless = entry.comm_dtype == "complex64"
    kernels = entry.impl == "cuda" and not lossless
    local = math.prod(src.local_shape)
    m = group_size(src.mesh, src.placement[w])
    dst_shape = src.exchanged(v, w).local_shape
    ordered = in_mesh_order(src.mesh, group_names(src.placement[w]))

    def leads(shape, axis):  # moving ``axis`` to the front moves data
        return nbatch > 0 or math.prod(shape[:axis]) > 1

    def gathers(n):  # send and receive out of mesh order, at the wire's width
        return 0 if ordered or m == 1 else 2 * (n if lossless else n // wire_ratio(entry.comm_dtype))

    pack = m > 1 and leads(src.local_shape, v)
    if entry.method == "traditional" and not kernels:
        return gathers(local) + local * (pack + (m > 1 and leads(dst_shape, w)))
    if entry.method in ("fused", "traditional"):
        if not lossless:
            return gathers(local)
        return gathers(local) + local * ((ordered and pack) + (m > 1 and leads(dst_shape, w)))
    b = src.local_shape[v] // m
    sizes = [n for n in local_lengths(b, max(1, min(entry.chunks, b))) if n > 0]
    total = local if len(sizes) > 1 else 0  # the concatenate of the slices
    for n in sizes:
        piece = local * n // b
        total += gathers(piece)
        if lossless:
            shape = list(dst_shape)
            shape[v] = n
            sliced = len(sizes) > 1 and (m > 1 or leads(src.local_shape, v))
            total += piece * ((ordered and (pack or sliced)) + (m > 1 and leads(shape, w)))
    return total


def _extra_copy_elems(src, v, w, entry, nfields=1) -> int:
    """The port's copies beyond the reference's count, as
    ``exchange_time_model`` prices an ``nfields``-field exchange under
    ``entry``: :func:`_port_copy_elems` less the reference's (traditional
    two passes, pipelined one, fused none; none of the engine's own under
    the kernels)."""
    local = math.prod(src.local_shape)
    kernels = entry.impl == "cuda" and entry.comm_dtype != "complex64"
    ref = {"fused": 0, "pipelined": local,
           "traditional": 0 if kernels else 2 * local}[entry.method]
    stacked = 1 if nfields > 1 and entry.batch_fusion == "stacked" else 0
    return _port_copy_elems(src, v, w, entry, stacked) - ref


def _model_extra(plan, key, cands):
    """Seconds or bytes the port's value of ``key`` adds to the
    reference's: the copies of :func:`_extra_copy_elems` at ``hbm_bw``."""
    kind, *rest = key.split(":")
    hbm = R.MODEL_COEFFS["hbm_bw"]
    if kind == "bytes":
        nf, method, isz = int(rest[0]), rest[2], rest[3]
        if method == "None":
            return 0.0
        # complex64, at the plan's chunks (comm_bytes_per_device's)
        lossless = cands[0]._replace(method=method, chunks=plan.chunks)
        total = 0
        for i, st in enumerate(plan.stages):
            if isinstance(st, ExchangeStage):
                size = int(isz) if isz != "None" else plan._stage_itemsize(i)
                total += _extra_copy_elems(plan.pencil_trace[i], st.v, st.w, lossless) * size * nf
        return float(total)
    entry = cands[int(rest[0])]
    if kind == "ex":  # ex:<candidate>:<stage>:<nfields>
        i, nf = int(rest[1]), int(rest[2])
        st = plan.stages[i]
        return (nf * _extra_copy_elems(plan.pencil_trace[i], st.v, st.w, entry, nf)
                * plan._stage_itemsize(i) / hbm)
    nf = int(rest[1])  # time:<candidate>:<nfields>:<direction>, time_ex:<candidate>:<nfields>
    direction = rest[2] if kind == "time" else "forward"
    stages, pencils, _, _ = plan._walk(direction)
    dtypes = plan.dtype_trace if direction == "forward" else plan.dtype_trace[::-1]
    return sum(nf * _extra_copy_elems(pencils[i], st.v, st.w, entry, nf)
               * plan._stage_itemsize(i, dtypes) / hbm
               for i, st in enumerate(stages) if isinstance(st, ExchangeStage))


@pytest.mark.parametrize("kind", ["time", "time_ex", "ex", "bytes"])
@pytest.mark.parametrize("name", list(R.MODEL_PLANS))
def test_models_equal_reference(runs, name, kind):
    """model_time_s (both directions, exchanges only), exchange_time_model
    and comm_bytes_per_device equal the reference's at the same explicit
    coefficients, to 1e-12 relative, once the port's named extra copies are
    added to the reference's value."""
    _, (ref, _, _) = runs
    plan = _plan(name)
    cands = tuner.batched_candidates_for("int8", "cuda")
    port = R.model_numbers(plan, ExchangeStage, cands)
    want = ref["models"][name]
    assert set(port) == set(want)
    keys = [k for k in port if k.split(":")[0] == kind]
    assert keys
    differs = 0
    for k in keys:
        extra = _model_extra(plan, k, cands)
        differs += extra != 0
        expected = want[k] + extra
        assert abs(port[k] - expected) <= _MODEL_RTOL * abs(expected), (k, port[k], expected)
    assert differs, "the named copy difference was never exercised"  # every plan has M > 1


def test_model_counts_the_port_copies_only_where_named():
    """exchange_local_copy_elems: the reference's count, but two passes
    more for a lossless fused/pipelined exchange over M > 1 (none at M =
    1, none on a lossy wire)."""
    from repro_torch.core.redistribute import exchange_local_copy_elems

    plan = _plan("pencil")
    i = next(i for i, st in enumerate(plan.stages) if isinstance(st, ExchangeStage))
    st, src = plan.stages[i], plan.pencil_trace[i]
    local = math.prod(src.local_shape)
    assert group_size(src.mesh, src.placement[st.w]) > 1

    def count(method, comm, impl="torch"):  # pipelined: two slices
        return exchange_local_copy_elems(src, st.v, st.w, method=method, comm_dtype=comm,
                                         impl=impl, chunks=2)

    assert count("fused", "complex64") == 2 * local  # the reference: 0
    assert count("pipelined", "complex64") == 3 * local  # the reference: local
    assert count("traditional", "complex64") == 2 * local
    assert count("fused", "bf16") == 0 and count("pipelined", "int8") == local
    assert count("traditional", "bf16", "cuda") == 0 and count("fused", "int8", "cuda") == 0
    one = ParallelFFT(R.StandInMesh((1, 1), ("p0", "p1")), (16, 12, 20), ("p0", "p1"))
    src1 = one.pencil_trace[i]
    assert exchange_local_copy_elems(src1, st.v, st.w, method="fused") == 0


def test_comm_bytes_never_tunes():
    """A byte count of an auto plan is pure arithmetic: it prices the
    uniform budget until a schedule is resolved, and never calls the
    tuner."""
    plan = _plan("pencil", method="auto", comm_dtype="bf16")
    real = tuner.get_or_tune
    tuner.get_or_tune = None  # any call raises
    try:
        want = _plan("pencil", comm_dtype="bf16").comm_bytes_per_device()
        assert plan.comm_bytes_per_device() == want
        assert "schedule" not in plan.__dict__
    finally:
        tuner.get_or_tune = real


def test_model_defaults_are_this_cards():
    """model_time_s and exchange_time_model default to the constants of
    core/hardware.py, the ones modelfit evaluates at."""
    from repro_torch.core import hardware

    plan = _plan("pencil")
    coeffs = {"peak_flops": hardware.PEAK_FLOPS, "ici_bw": hardware.ICI_BW,
              "hbm_bw": hardware.HBM_BW, "ici_latency_s": hardware.ICI_LATENCY_S}
    assert modelfit.REFERENCE_COEFFS == coeffs
    assert plan.model_time_s() == plan.model_time_s(**coeffs)
    assert plan.model_time_s(direction="backward", nfields=3) == plan.model_time_s(
        direction="backward", nfields=3, **coeffs)


# -- tune_plan under a stand-in timer ------------------------------------------------


@pytest.mark.parametrize("priors", [False, True])
@pytest.mark.parametrize("nfields", [1, 3])
@pytest.mark.parametrize("name", list(R.MODEL_PLANS))
def test_tune_plan_picks_the_references_schedule(runs, monkeypatch, name, nfields, priors):
    """Under one deterministic stand-in ``_time_stage`` (the same seconds per
    candidate in both packages) the port's tune_plan picks the reference's
    schedule, the int8 budget with the kernels swept; with model priors
    armed (every coefficient given, top 6 timed) too."""
    _, (ref, _, priors_path) = runs
    if priors:
        monkeypatch.setenv("REPRO_MODEL_PRIORS", str(priors_path))
        monkeypatch.setenv("REPRO_TUNER_PRIOR_TOPK", "6")
    else:
        monkeypatch.delenv("REPRO_MODEL_PRIORS", raising=False)
    monkeypatch.setattr(tuner, "_time_stage", lambda plan, *a, **k: R.fake_stage_seconds(*a, **k))
    plan = _plan(name, comm_dtype="int8", exchange_impl="cuda")
    sched, timings = tuner.tune_plan(plan, nfields=nfields)
    assert R.as_reference_rows(sched) == ref["tuned"][f"{name}:{nfields}:{priors}"]
    pruned = [k for per in timings.values() for k in per if k.startswith("pruned:")]
    assert bool(pruned) == priors


# -- keys and the cache file ------------------------------------------------------


def test_plan_key_discriminates():
    """The key changes with anything that changes the stage shapes, the
    candidates or the field count, and holds the schema, backend and
    device kind."""
    mesh = R.StandInMesh((1, 1), ("p0", "p1"))

    def plan(shape=(8, 8, 8), grid=("p0",), transforms=None, **kw):
        return ParallelFFT(mesh, shape, grid, transforms=transforms,
                           config=PlanConfig(method="auto", **kw))

    base = plan()
    keys = {tuner.plan_key(base)}
    for p in (plan((8, 8, 16)), plan(grid=("p0", "p1")), plan(transforms=("c2c", "c2c", "r2c")),
              plan(impl="matmul"), plan(comm_dtype="bf16"), plan(comm_dtype="int8"),
              plan(comm_dtype="int8", exchange_impl="cuda")):
        keys.add(tuner.plan_key(p))
    assert len(keys) == 8
    keys.add(tuner.plan_key(base, nfields=3))
    keys.add(tuner.plan_key(base, nfields=8))
    assert len(keys) == 10
    assert tuner.plan_key(base) == tuner.plan_key(base)
    decoded = json.loads(tuner.plan_key(base))
    assert decoded["shape"] == [8, 8, 8] and decoded["mesh"] == [["p0", 1], ["p1", 1]]
    assert decoded["schema"] == tuner.SCHEMA_VERSION == 6
    assert decoded["backend"] == "cpu" and decoded["device_kind"] == "cpu"


def test_default_cache_path_is_the_ports(monkeypatch):
    monkeypatch.delenv("REPRO_TUNER_CACHE", raising=False)
    assert tuner.default_cache_path() == Path.home() / ".cache" / "repro_torch" / "fft_tuner.json"
    monkeypatch.setenv("REPRO_TUNER_CACHE", "/elsewhere/t.json")
    assert tuner.default_cache_path() == Path("/elsewhere/t.json")


def test_save_cache_atomic(tmp_path):
    """save_cache never leaves partial JSON visible or temp files behind,
    and concurrent writers' keys all survive (merge under the lock)."""
    path = tmp_path / "sub" / "cache.json"
    data = {"k": {"schedule": [["fused", 1, "complex64"]], "timings": {}}}
    assert tuner.save_cache(path, data)
    assert json.loads(path.read_text()) == data
    errs = []

    def writer(i):
        try:
            assert tuner.save_cache(path, {f"key{i}": i})
            json.loads(path.read_text())
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs
    leftovers = [p for p in path.parent.iterdir() if p.name not in (path.name, path.name + ".lock")]
    assert leftovers == []
    assert {f"key{i}" for i in range(8)} <= set(json.loads(path.read_text()))


def test_save_cache_cross_process_lock(tmp_path):
    """Processes merging disjoint keys into one cache lose no update."""
    pytest.importorskip("fcntl")
    path = tmp_path / "shared.json"
    nproc, nkeys = 4, 12
    code = """
import sys
from repro_torch.core import tuner
path, wid = sys.argv[1], int(sys.argv[2])
for j in range({nkeys}):
    assert tuner.save_cache(path, {{"w%d-k%d" % (wid, j): {{"v": wid}}}})
print("WRITER-DONE")
""".format(nkeys=nkeys)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(path), str(i)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(nproc)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        assert "WRITER-DONE" in out
    final = json.loads(path.read_text())
    missing = {f"w{i}-k{j}" for i in range(nproc) for j in range(nkeys)} - set(final)
    assert not missing, f"lost {len(missing)} updates: {sorted(missing)[:5]}"


def test_quarantine_locks_without_self_deadlock(tmp_path):
    """quarantine holds the file lock over its read-bump-write and does not
    take it again inside save_cache; the marked entry stops parsing."""
    path = tmp_path / "cache.json"
    tuner.save_cache(path, {"k": {"schedule": [["fused", 1, "complex64"]], "timings": {}}})
    assert tuner._parse_entry(json.loads(path.read_text())["k"], 1) is not None
    assert tuner.quarantine(path, "k", "boom") == 1
    assert tuner.quarantine(path, "k", "boom again") == 2
    entry = json.loads(path.read_text())["k"]
    assert entry["bad"]["reason"] == "boom again" and entry["quarantines"] == 2
    assert tuner._parse_entry(entry, 1) is None


def test_legacy_rows_parse():
    """3- and 4-field rows upgrade through StageEntry.make (a 4th field is
    an impl or a batch fusion by vocabulary); unknown values do not parse."""
    from repro_torch.core.planconfig import as_schedule

    assert as_schedule([["fused", 1, "bf16"], ("pipelined", 2, "int8", "per-field"),
                        ("traditional", 1, "int8", "cuda")]) == (
        StageEntry("fused", 1, "bf16"), StageEntry("pipelined", 2, "int8", "torch", "per-field"),
        StageEntry("traditional", 1, "int8", "cuda"))
    for bad in (["bogus", 1, "complex64"], ["fused", 1, "float8"], ["fused"], ["fused", 0, "bf16"]):
        with pytest.raises((ValueError, IndexError)):
            StageEntry.make(bad)


# -- four gloo ranks ---------------------------------------------------------------


def _ranks(runs):
    (ranks, _), _ = runs
    return ranks


@pytest.mark.parametrize("case", ["tuned", "batched", "replay", "int8", "int8_replay", "skewed"])
def test_ranks_agree_and_rank0_alone_writes(runs, case):
    """Every rank resolves the same schedule; only rank 0 writes the cache
    (one write a sweep, none on a replay)."""
    ranks = _ranks(runs)
    scheds = [r[case]["schedule"] for r in ranks]
    assert all(s == scheds[0] for s in scheds)
    assert len(scheds[0]) == 2
    replay = case.endswith("replay")
    assert [r[case]["saves"] for r in ranks] == [0 if replay else 1, 0, 0, 0]
    if replay:
        assert all(r[case]["time_stage"] == 0 for r in ranks)


def test_tuned_cache_entry(runs):
    """The lossless sweep times every candidate of both stages on every rank
    and rank 0 writes the schema-6 entry under the plan's key."""
    ranks = _ranks(runs)
    r0 = ranks[0]["tuned"]
    assert all(r["tuned"]["time_stage"] == 10 for r in ranks)
    key = json.loads(r0["key"])
    assert key["schema"] == 6 and key["device_kind"] == "cpu" and key["nfields"] == 1
    entry = r0["entry"]
    assert entry["schedule"] == r0["schedule"]
    assert len(entry["timings"]) == 2
    tags = {tuner._tag(c) for c in tuner.DEFAULT_CANDIDATES}
    for per in entry["timings"].values():
        timed = {k: v for k, v in per.items() if ":" not in k}
        assert set(timed) == tags and all(t > 0 for t in timed.values())
    for method, chunks, comm, impl, fusion in r0["schedule"]:
        assert comm == "complex64" and impl == "torch" and fusion == "stacked"


def test_batched_sweep_times_every_fusion(runs):
    ranks = _ranks(runs)
    assert all(r["batched"]["time_stage"] == 30 for r in ranks)
    assert all(e[4] in ("stacked", "pipelined-across-fields", "per-field")
               for e in ranks[0]["batched"]["schedule"])


@pytest.mark.parametrize("what", ["forward", "forward_many"])
def test_auto_forward_equals_explicit_and_reference(runs, what):
    """The auto plan's forward and forward_many(3) are bitwise equal to the
    explicit plan run under the tuned schedule on every rank, and within
    1e-5 relative L2 of the reference's fused forward."""
    (ranks, arrays), (_, ref_arrays, _) = runs
    flag = {"forward": ("tuned", "forward_equal"),
            "forward_many": ("batched", "forward_many_equal")}[what]
    assert all(r[flag[0]][flag[1]] for r in ranks)
    got, want = arrays[f"auto_{what}"], ref_arrays[what]
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5


def test_replay_is_bitwise_and_warm_resolves(runs):
    ranks = _ranks(runs)
    assert all(r["replay"]["forward_equal"] for r in ranks)
    assert all(r["replay"]["schedule"] == r["tuned"]["schedule"] for r in ranks)
    assert all(r["warm"] == 2 for r in ranks)


def test_int8_budget_round_trip(runs):
    """An int8 budget sweeps engines × {complex64, bf16, int8}; its choice
    replays from the cache with no timing."""
    ranks = _ranks(runs)
    entry = ranks[0]["int8"]["entry"]
    want = {tuner._tag(c) for c in tuner.candidates_for("int8")}
    for per in entry["timings"].values():
        assert {k for k in per if ":" not in k} == want
    # the 5 lossless candidates of each stage come from the stage memo of
    # the lossless sweep before; the 10 lossy ones are timed
    assert all(r["int8"]["time_stage"] == 20 for r in ranks)
    assert all(e[2] in ("complex64", "bf16", "int8") for e in ranks[0]["int8"]["schedule"])
    assert ranks[0]["int8_replay"]["schedule"] == ranks[0]["int8"]["schedule"]


@pytest.mark.parametrize("case", range(11))
def test_stale_or_corrupt_cache_ignored_and_rewritten(runs, case):
    """Corrupt bytes, a non-object, a stale schema, and entries of the
    plan's key that are junk, of the wrong stage count, with unknown values
    or outside the live candidates: each resolves by retuning, on every rank
    alike, and rank 0 rewrites a valid entry (tests/test_tuner.py's cases)."""
    ranks = _ranks(runs)
    got = [r["stale"][case] for r in ranks]
    assert all(g["schedule"] == got[0]["schedule"] for g in got)
    assert [g["saves"] for g in got] == [1, 0, 0, 0]
    live = {tuple(e) for e in tuner.candidates_for(None)}
    assert all(tuple(e) in live for e in got[0]["schedule"])
    assert got[0]["entry"]["schedule"] == got[0]["schedule"]


def test_rank_skewed_timer_still_agrees(runs):
    """Each rank's own times would pick a different engine; the MAX over
    ranks makes fused the winner on every rank."""
    ranks = _ranks(runs)
    own = [min(range(5), key=lambda i, r=r: (i + r) % 5) for r in range(R.WORLD)]
    assert len(set(own)) == R.WORLD
    for r in ranks:
        assert r["skewed"]["schedule"] == [["fused", 1, "complex64", "torch", "stacked"]] * 2
        assert r["skewed"]["time_stage"] == 0  # the stand-in replaced the counted timer
    per = ranks[0]["skewed"]["entry"]["timings"]["stage1"]
    assert per["fused@1@complex64@torch@stacked"] == pytest.approx(1.3)


def test_poison_auto_quarantines_and_retunes(runs):
    """A poisoned pipelined entry that cannot run (a compile fault on the
    pipelined engine) is quarantined once, retuned off pipelined, and the
    guarded forward ends ok (tests/test_robustness.py's poison_auto)."""
    for r in _ranks(runs):
        d = r["poison_auto"]
        assert d["ok"] and d["kinds"] == ["retune"] and d["rel"] < 1e-4
        assert d["quarantines"] == [1] and "compile_fail" in d["fired"]
        assert all(e[0] != "pipelined" for e in d["schedule"])


# -- modelfit (tests/test_scalebench.py) ----------------------------------------------


def _synthetic_points(ici_bw=40e9, lat=2e-6, *, perturb=None):
    """A series whose measured times are exactly the linear surrogate at
    (ici_bw, lat), bytes and launches not proportional."""
    pts = []
    for ndev, chunks in ((2, 1), (4, 2), (8, 4), (16, 8)):
        wire = 4.2e6 / ndev
        launches = 2 * chunks
        compute = 3e-4 / ndev
        t = compute + wire / ici_bw + launches * lat
        if perturb:
            t *= perturb.get(ndev, 1.0)
        pts.append({"shape": [16 * ndev, 16, 16], "ndev": ndev, "best_s": t,
                    "model": {"time_s": t, "compute_s": compute, "wire_bytes_per_dev": wire,
                              "launches": launches}})
    return pts


def test_fit_recovers_known_coefficients():
    fit = modelfit.fit_series(_synthetic_points(ici_bw=40e9, lat=2e-6))
    assert fit["ici_bw"] == pytest.approx(40e9, rel=1e-6)
    assert fit["ici_latency_s"] == pytest.approx(2e-6, rel=1e-6)
    assert not fit["misses"]
    assert fit["rmse_log"] == pytest.approx(0.0, abs=1e-9)
    for p in fit["points"]:
        assert p["residual"] == pytest.approx(1.0, rel=1e-9)


def test_fit_collinear_series_attributes_bandwidth_only():
    pts = _synthetic_points()
    for p in pts:
        p["model"]["launches"] = p["model"]["wire_bytes_per_dev"] / 1e6
        p["best_s"] = p["model"]["compute_s"] + p["model"]["wire_bytes_per_dev"] / 40e9
    fit = modelfit.fit_series(pts)
    assert math.isfinite(fit["ici_bw"])
    assert fit["ici_latency_s"] == 0.0
    assert all(p["residual"] == pytest.approx(1.0, rel=1e-6) for p in fit["points"])


def test_fit_flags_over_2x_model_miss():
    fit = modelfit.fit_series(_synthetic_points(perturb={8: 3.0}))
    assert 8 in {m["ndev"] for m in fit["misses"]}
    worst = next(m for m in fit["misses"] if m["ndev"] == 8)
    assert worst["residual"] > 2.0 and "underestimates" in worst["why"]


def test_fit_single_point_is_bandwidth_only():
    fit = modelfit.fit_series(_synthetic_points()[:1])
    assert fit["npoints"] == 1 and fit["ici_latency_s"] == 0.0
    assert math.isfinite(fit["ici_bw"]) and fit["ici_bw"] > 0


def test_fit_report_and_priors_roundtrip(tmp_path, monkeypatch):
    report = modelfit.fit_report({"a": _synthetic_points(ici_bw=40e9, lat=2e-6),
                                  "b": _synthetic_points(ici_bw=60e9, lat=4e-6)},
                                 device_kind="cpu", backend="cpu")
    assert report["schema"] == "modelfit-v1"
    assert report["priors"]["ici_bw"] == pytest.approx(50e9, rel=1e-6)
    assert report["priors"]["ici_latency_s"] == pytest.approx(3e-6, rel=1e-6)
    path = tmp_path / "priors.json"
    modelfit.save_priors(report, path)
    loaded = modelfit.load_priors(path)
    assert loaded["ici_bw"] == pytest.approx(report["priors"]["ici_bw"])
    assert loaded["peak_flops"] == modelfit.REFERENCE_COEFFS["peak_flops"]
    (tmp_path / "bad.json").write_text("{not json")
    assert modelfit.load_priors(tmp_path / "bad.json") is None
    assert modelfit.load_priors(tmp_path / "absent.json") is None
    monkeypatch.delenv("REPRO_MODEL_PRIORS", raising=False)
    assert modelfit.active_priors() is None
    monkeypatch.setenv("REPRO_MODEL_PRIORS", str(path))
    assert modelfit.active_priors()["ici_bw"] == pytest.approx(report["priors"]["ici_bw"])


def test_model_time_surrogate_matches_launch_count():
    """The latency term of model_time_s is model_collective_launches ×
    ici_latency_s (the count the fit regresses on), every fusion."""
    plan = _plan("pencil")
    for nf in (1, 3):
        for fusion in ("stacked", "pipelined-across-fields", "per-field"):
            sched = (StageEntry("pipelined", 4, "complex64", "torch", fusion),) * 2
            kw = dict(schedule=sched, nfields=nf, ici_bw=1e30, hbm_bw=1e30, peak_flops=1e30)
            delta = plan.model_time_s(ici_latency_s=1e-3, **kw) - plan.model_time_s(
                ici_latency_s=0.0, **kw)
            launches = plan.model_collective_launches(nfields=nf, schedule=sched)
            assert delta == pytest.approx(launches * 1e-3, rel=1e-9)

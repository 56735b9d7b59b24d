"""Composed mesh-axis groups (a slab over ``("p0", "p1")`` and over
``("p1", "p0")``, a pencil over ``(("a", "b"), "c")``) on 8 gloo ranks,
against the JAX package on 8 virtual devices, and plan-level parity of the
reference's plan matrix against numpy/scipy oracles on the same ranks.

The ranks are spawned once (tests/_torch_ranks.py ``run_composed_rank``)
while one JAX subprocess runs the same numpy-seeded cases.  A composed
group's index is row-major over the tuple's own order, as JAX linearises
``PartitionSpec(("p1", "p0"))``: each rank's block is compared with the JAX
shard of the device of the same index.

Tolerances are the parity contracts (ROADMAP): lossless exchanges and the
bf16 codec bitwise; int8 within one quantum (max |x| / 127); plans within
1e-5 relative L2 of the reference lossless and 3e-3 bf16; lossless
traditional and pipelined plans bitwise equal to fused.  Against the
oracles, PERF.md §2's limits (relative L2): forward 1e-5 lossless, 3e-3
bf16, 3e-2 int8; round trip 1e-5, 5e-3, 4e-2.  One limit is added: the
bf16 forward of a plan of three exchanges (the 4-D plan on (2, 2, 2)).
Each exchange rounds every value to bf16 once, 1.7e-3 relative L2 for
normal data, and independent roundings add in quadrature, so k exchanges
give sqrt(k) * 1.7e-3: 2.4e-3 for two (under 3e-3), 2.94e-3 for three,
which a probe of this plan saw at 2.92e-3; its limit is 4e-3.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as R

TESTS = Path(__file__).resolve().parent

#: relative L2 limits against the oracles (PERF.md §2), by wire
FWD_LIMIT = {"complex64": 1e-5, "bf16": 3e-3, "int8": 3e-2}
ROUNDTRIP_LIMIT = {"complex64": 1e-5, "bf16": 5e-3, "int8": 4e-2}
#: the bf16 forward of a plan of three exchanges: sqrt(3) * 1.7e-3 = 2.94e-3
BF16_FWD_LIMIT_3_EXCHANGES = 4e-3


_REFERENCE = """
import json, sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import tuner
from repro.core.meshutil import make_mesh, shard_map
from repro.core.pencil import pad_global
from repro.core.pfft import ParallelFFT
from repro.core.planconfig import PlanConfig
from repro.core.redistribute import exchange_shard
import _torch_ranks as R

data = R.composed_inputs()
mesh, mesh3 = make_mesh(*R.MESH_2D), make_mesh(*R.MESH_3D)
names, names3 = R.MESH_2D[1], R.MESH_3D[1]
res, info = {{}}, {{}}


def per_device(fn, m, mnames, spec, x):
    # each device's output, stacked in device order (the global rank's)
    out = shard_map(lambda b: fn(b)[None], mesh=m, in_specs=spec, out_specs=P(mnames),
                    check_vma=False)
    return np.asarray(jax.jit(out)(x))


shape, divisors, v, w = R.COMPOSED_EXCHANGE
for g, grp in R.COMPOSED_GROUPS.items():
    spec = P(*R.composed_placement(g))
    xp = jnp.asarray(R.padded(data["exchange"], divisors))
    res["block:" + g] = per_device(lambda b: b, mesh, names, spec, xp)
    for key, gg, eng, comm in R.composed_exchange_cases():
        if gg != g:
            continue
        method, opts = R.COMPOSED_ENGINES[eng]

        def shard(b, method=method, opts=opts, comm=comm):
            y, st = exchange_shard(b, v, w, grp, method=method, comm_dtype=comm, guard=True,
                                   impl="jnp" if comm == "complex64" else "pallas", **opts)
            return y[None], jnp.stack([st["nonfinite"], st["saturated"]])[None]

        fn = shard_map(shard, mesh=mesh, in_specs=spec, out_specs=(P(names), P(names)),
                       check_vma=False)
        y, st = jax.jit(fn)(xp)
        res[key], res[key + ":stats"] = np.asarray(y), np.asarray(st)

rshape, rplace, rdiv = R.ROUNDTRIP_3D
xr = jnp.asarray(R.padded(data["roundtrip"], rdiv))
res["roundtrip:block"] = per_device(lambda b: b, mesh3, names3, P(*rplace), xr)
for eng, method, opts in R.PARITY_ENGINES:
    res["roundtrip:" + eng + ":mid"] = per_device(
        lambda b, method=method, opts=opts: exchange_shard(b, 2, 1, rplace[1], method=method,
                                                           **opts),
        mesh3, names3, P(*rplace), xr)

u = jnp.asarray(data["plan"])
for g, grp in R.COMPOSED_GROUPS.items():
    for name, cfg in R.COMPOSED_PLAN_CONFIGS.items():
        plan = ParallelFFT(mesh, R.COMPOSED_PLAN_SHAPE, (grp,), config=PlanConfig(**cfg))
        y = plan.forward(u)
        res["plan:" + g + ":" + name + ":fwd"] = np.asarray(y)
        res["plan:" + g + ":" + name + ":back"] = np.asarray(plan.backward(y))
        res["plan:" + g + ":" + name + ":block"] = per_device(
            lambda b: b, mesh, names, plan.input_pencil.spec, pad_global(u, plan.input_pencil))

tuner._time_stage = lambda plan, *a, **k: R.fake_stage_seconds(*a, **k)
for g, grp in R.COMPOSED_GROUPS.items():
    plan = ParallelFFT(mesh, R.COMPOSED_PLAN_SHAPE, (grp,),
                       config=PlanConfig(comm_dtype="int8", exchange_impl="pallas"))
    tuner._STAGE_MEMO.clear()
    sched, _ = tuner.tune_plan(plan)
    info["tuned:" + g] = [list(e) for e in sched]
    info["key:" + g] = json.loads(tuner.plan_key(plan))

np.savez({out!r}, **res)
open({info_out!r}, "w").write(json.dumps(info))
"""


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``(ranks, reference)``: each rank's arrays and outcomes, rank 0's
    parity arrays, and the reference's arrays and outcomes, run side by
    side."""
    d = tmp_path_factory.mktemp("torch_composed")
    out, info_out = d / "reference.npz", d / "reference.json"
    join = R.start(R.run_composed_rank, d, world=R.COMPOSED_WORLD)
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), out=str(out), info_out=str(info_out)),
                ndev=R.COMPOSED_WORLD)
    finally:
        join(timeout=400)
    ranks = [(dict(np.load(d / f"composed{r}.npz")),
              json.loads((d / f"composed{r}.json").read_text()))
             for r in range(R.COMPOSED_WORLD)]
    return ((ranks, dict(np.load(d / "parity.npz"))),
            (dict(np.load(out)), json.loads(info_out.read_text())))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _stacked(ranks, key):
    return np.stack([arrays[key] for arrays, _ in ranks])


# -- the composed groups against the JAX package ---------------------------------


@pytest.mark.parametrize("key,comm", [(k, c) for k, _, _, c in R.composed_exchange_cases()])
def test_composed_exchange_matches_reference(runs, key, comm):
    """Each rank's block after the composed slab exchange equals the JAX
    shard of its device: lossless and bf16 bitwise, int8 within one
    quantum; the guard stats exactly."""
    (ranks, _), (ref, _) = runs
    got, want = _stacked(ranks, key), ref[key]
    assert got.shape == want.shape and got.dtype == want.dtype
    if comm == "int8":
        x = R.composed_inputs()["exchange"]
        quantum = float(np.max(np.abs(np.stack([x.real, x.imag])))) / 127.0
        np.testing.assert_allclose(got, want, atol=quantum, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_stacked(ranks, key + ":stats"), ref[key + ":stats"])


@pytest.mark.parametrize("group", list(R.COMPOSED_GROUPS))
def test_blocks_equal_jax_shards(runs, group):
    """Each rank's block of a composed pencil is bitwise the JAX shard of
    the device of the same index: the exchange's input and every composed
    slab plan's input pencil."""
    (ranks, _), (ref, _) = runs
    keys = [f"block:{group}"] + [f"plan:{group}:{c}:block" for c in R.COMPOSED_PLAN_CONFIGS]
    for key in keys:
        np.testing.assert_array_equal(_stacked(ranks, key), ref[key], err_msg=key)


@pytest.mark.parametrize("engine", [e for e, _, _ in R.PARITY_ENGINES])
def test_composed_roundtrip_on_2x2x2(runs, engine):
    """tests/test_redistribute.py:197-215 under each engine: the pencil
    over ``(("a", "b"), "c")`` exchanges v=2 -> w=1 and back to itself,
    bitwise, and the middle blocks are the JAX shards bitwise."""
    (ranks, _), (ref, _) = runs
    np.testing.assert_array_equal(_stacked(ranks, "roundtrip:block"), ref["roundtrip:block"])
    np.testing.assert_array_equal(_stacked(ranks, f"roundtrip:{engine}:mid"),
                                  ref[f"roundtrip:{engine}:mid"])
    assert all(info[f"roundtrip:{engine}"] for _, info in ranks)


@pytest.mark.parametrize("group,config", [(g, c) for g in R.COMPOSED_GROUPS
                                          for c in R.COMPOSED_PLAN_CONFIGS])
def test_composed_plan_matches_reference(runs, group, config):
    """The slab plan over a composed group, forward and backward, against
    the reference (1e-5 lossless, 3e-3 bf16) and ``np.fft.fftn``."""
    (ranks, _), (ref, _) = runs
    u = R.composed_inputs()["plan"]
    lossy = R.COMPOSED_PLAN_CONFIGS[config].get("comm_dtype") == "bf16"
    tol_ref = 3e-3 if lossy else 1e-5
    wire = "bf16" if lossy else "complex64"
    pre = f"plan:{group}:{config}:"
    fwd, back = ranks[0][0][pre + "fwd"], ranks[0][0][pre + "back"]
    assert fwd.shape == R.COMPOSED_PLAN_SHAPE and fwd.dtype == np.complex64
    assert _rel(fwd, ref[pre + "fwd"]) <= tol_ref
    assert _rel(back, ref[pre + "back"]) <= tol_ref
    assert _rel(fwd, np.fft.fftn(u)) <= FWD_LIMIT[wire]
    assert _rel(back, u) <= ROUNDTRIP_LIMIT[wire]


@pytest.mark.parametrize("group", list(R.COMPOSED_GROUPS))
def test_composed_lossless_engines_equal_fused(runs, group):
    (ranks, _), _ = runs
    for arrays, _ in ranks:
        for config in ("traditional", "pipelined"):
            for what in ("fwd", "back"):
                np.testing.assert_array_equal(arrays[f"plan:{group}:{config}:{what}"],
                                              arrays[f"plan:{group}:default:{what}"])


@pytest.mark.parametrize("group", list(R.COMPOSED_GROUPS))
def test_composed_auto_plan(runs, group):
    """``method="auto"`` over a composed grid under a stand-in timer: every
    rank resolves the reference's schedule, rank 0 writes its entry, a
    replay times nothing, the tuned forward is bitwise the explicit plan's
    under that schedule, and the key holds the grid, mesh and shape as the
    reference's key does, the same on every rank."""
    (ranks, _), (_, ref) = runs
    outs = [info[f"auto:{group}"] for _, info in ranks]
    assert all(o["schedule"] == ref[f"tuned:{group}"] for o in outs)
    assert all(o["replay_schedule"] == o["schedule"] and o["replay_timed"] == 0 for o in outs)
    assert all(o["forward_equal"] for o in outs)
    assert outs[0]["entry"] is True
    assert len({o["key"] for o in outs}) == 1
    key, want = json.loads(outs[0]["key"]), ref[f"key:{group}"]
    for field in ("grid", "mesh", "shape", "transforms", "nfields"):
        assert key[field] == want[field], field
    assert key["grid"] == [list(R.COMPOSED_GROUPS[group])]


@pytest.mark.parametrize("group,comm,fusion", [(g, c, f) for g in R.COMPOSED_GROUPS
                                               for c in ("complex64", "int8")
                                               for f in R.BATCH_FUSIONS])
def test_composed_forward_many(runs, group, comm, fusion):
    """``forward_many``/``backward_many`` of three fields over a composed
    grid: bitwise the per-field loop of the same wire, and the
    ``all_to_all_single`` calls of one call as ``model_collective_launches``
    gives (int8: one scale collective beside each payload's)."""
    (ranks, _), _ = runs
    for _, info in ranks:
        got = info[f"many:{group}:{comm}:{fusion}"]
        assert got["equal_loop"]
        assert got["collectives"] == got["model"]


@pytest.mark.parametrize("group", list(R.COMPOSED_GROUPS))
def test_composed_guarded_plan(runs, group):
    """A guarded plan over a composed grid: strict and clean is ok and
    bitwise the unguarded forward; a corrupted bf16 wire under degrade ends
    ok after degrading to the lossless wire."""
    (ranks, _), _ = runs
    for _, info in ranks:
        got = info[f"guard:{group}"]
        assert got["strict_ok"] and got["strict_equal"]
        assert got["degrade_ok"] and got["kinds"] and got["degrade_rel"] <= 1e-5


@pytest.mark.parametrize("group", list(R.COMPOSED_GROUPS))
def test_composed_plan_registry(runs, group):
    """``PlanRegistry(mesh, grid)`` over a composed grid builds once, keys
    the plan by ``plan_key`` and serves the direct plan's forward bitwise."""
    (ranks, _), _ = runs
    for _, info in ranks:
        got = info[f"registry:{group}"]
        assert got["key_equal"] and got["same_plan"] and got["builds"] == 1
        assert got["grid"] == [list(R.COMPOSED_GROUPS[group])]
        assert got["forward_equal"]


# -- the model's copies of a composed exchange (no ranks) ---------------------------


def test_composed_index_is_row_major_in_the_tuple_order():
    from repro_torch.core.meshutil import composed_coordinate, composed_size, in_mesh_order

    mesh = R.StandInMesh((2, 4), ("p0", "p1"))
    assert composed_size(mesh, ("p0", "p1")) == composed_size(mesh, ("p1", "p0")) == 8
    assert composed_coordinate(mesh, ("p0", "p1"), (1, 2)) == 1 * 4 + 2
    assert composed_coordinate(mesh, ("p1", "p0"), (1, 2)) == 2 * 2 + 1
    assert composed_coordinate(mesh, ("p1",), (1, 2)) == 2
    assert in_mesh_order(mesh, ("p0", "p1")) and not in_mesh_order(mesh, ("p1", "p0"))
    assert in_mesh_order(R.StandInMesh((1, 4), ("p0", "p1")), ("p1", "p0"))  # a size-1 dim: no order
    mesh3 = R.StandInMesh((2, 2, 2), ("a", "b", "c"))
    assert in_mesh_order(mesh3, ("a", "c")) and not in_mesh_order(mesh3, ("c", "a", "b"))


@pytest.mark.parametrize("comm", R.COMM_DTYPES)
@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("method", ["fused", "traditional", "pipelined"])
def test_mesh_order_composed_group_adds_no_copy(method, impl, comm):
    """The model's local copies of the composed slab exchange in mesh order
    equal a one-name slab's of the same size (8); out of mesh order they add
    the gathers of the wire buffer's chunks: two passes over a lossy
    payload, one on a lossless fused or pipelined wire (the send's gather
    is its pack), two on a lossless traditional one."""
    from repro_torch.core.pfft import ExchangeStage, ParallelFFT
    from repro_torch.core.quant import wire_ratio
    from repro_torch.core.redistribute import exchange_local_copy_elems

    def count(mesh, grid):
        plan = ParallelFFT(mesh, (16, 12, 20), grid)
        i = next(i for i, st in enumerate(plan.stages) if isinstance(st, ExchangeStage))
        st, src = plan.stages[i], plan.pencil_trace[i]
        return (exchange_local_copy_elems(src, st.v, st.w, method=method, comm_dtype=comm,
                                          impl=impl), math.prod(src.local_shape))

    slab, local = count(R.StandInMesh((8,), ("s",)), ("s",))
    mesh = R.StandInMesh((2, 4), ("p0", "p1"))
    assert count(mesh, (("p0", "p1"),)) == (slab, local)
    if comm != "complex64":
        extra = 2 * local // wire_ratio(comm)
    else:
        extra = 2 * local if method == "traditional" else local
    assert count(mesh, (("p1", "p0"),)) == (slab + extra, local)


# -- plan-level parity against numpy/scipy oracles ----------------------------------


def _ref_nd(x, tags):
    """The reference's scipy composition (tests/test_transforms.py:164-180),
    in float64, in the plan's apply order."""
    import scipy.fft as sf

    y = np.asarray(x, np.float64)
    for axis in range(len(tags) - 1, -1, -1):
        t = tags[axis]
        if t == "r2c":
            y = np.fft.rfft(y, axis=axis)
        elif t == "c2c":
            y = np.fft.fft(y, axis=axis)
        else:
            fn = sf.dct if t.startswith("dct") else sf.dst
            kind = int(t[3])
            y = fn(y.real, type=kind, axis=axis) + (
                1j * fn(y.imag, type=kind, axis=axis) if np.iscomplexobj(y) else 0)
    return y


def _fwd_limit(name, comm):
    n_exchanges = len(R.PARITY_PLANS[name][2])
    if comm == "bf16" and n_exchanges == 3:
        return BF16_FWD_LIMIT_3_EXCHANGES
    return FWD_LIMIT[comm]


def _each_run(runs, name):
    """``(engine, wire, arrays)`` of a parity plan's nine runs (rank 0's
    global results)."""
    (_, parity), _ = runs
    for eng, _, _ in R.PARITY_ENGINES:
        for comm in R.COMM_DTYPES:
            pre = f"{name}|{eng}|{comm}|"
            yield eng, comm, {k[len(pre):]: v for k, v in parity.items() if k.startswith(pre)}


def _check(errors, what, rel, limit):
    if not rel <= limit:
        errors.append(f"{what}: {rel:.3e} > {limit:.0e}")


def _plans(kind):
    return [n for n, p in R.PARITY_PLANS.items() if p[4] == kind and p[0] == "2d"]


@pytest.mark.parametrize("name", _plans("fftn"))
def test_all_decompositions(runs, name):
    """tests/test_pfft.py:17-42's matrix on (2, 4) (the composed slab also
    out of mesh order) under fused, traditional and pipelined (3 chunks) x
    complex64, bf16 and int8: forward against ``np.fft.fftn``/``rfftn`` and
    the round trip."""
    _, shape, _, tags, _ = R.PARITY_PLANS[name]
    x = R.parity_inputs(name)["x"]
    want = np.fft.rfftn(x) if tags else np.fft.fftn(x)
    errors = []
    for eng, comm, a in _each_run(runs, name):
        assert a["fwd"].shape == want.shape and a["back"].shape == shape
        _check(errors, f"{eng} {comm} forward", _rel(a["fwd"], want), _fwd_limit(name, comm))
        _check(errors, f"{eng} {comm} round trip", _rel(a["back"], x), ROUNDTRIP_LIMIT[comm])
    assert not errors, errors


def test_4d_on_3d_grid(runs):
    """tests/test_pfft.py:37-42: the 4-D plan on the (2, 2, 2) grid, three
    exchanges, under every engine and wire (bf16 forward limit 4e-3, see
    the module docstring)."""
    name = "4d_on_3d"
    x = R.parity_inputs(name)["x"]
    want = np.fft.fftn(x)
    errors = []
    for eng, comm, a in _each_run(runs, name):
        _check(errors, f"{eng} {comm} forward", _rel(a["fwd"], want), _fwd_limit(name, comm))
        _check(errors, f"{eng} {comm} round trip", _rel(a["back"], x), ROUNDTRIP_LIMIT[comm])
    assert not errors, errors


@pytest.mark.parametrize("name", _plans("odd_r2c"))
def test_r2c_backward_odd_trailing_extents(runs, name):
    """tests/test_pfft.py:169-200: the backward of ``np.fft.rfftn(x)``
    gives ``x`` at the odd logical extent, and the plan's own spectrum round
    trips, under every engine and wire."""
    _, shape, _, _, _ = R.PARITY_PLANS[name]
    x = R.parity_inputs(name)["x"]
    want = np.fft.rfftn(x)
    errors = []
    for eng, comm, a in _each_run(runs, name):
        assert a["fwd"].shape[-1] == shape[-1] // 2 + 1 and a["back_np"].shape == shape
        _check(errors, f"{eng} {comm} forward", _rel(a["fwd"], want), _fwd_limit(name, comm))
        _check(errors, f"{eng} {comm} backward of rfftn", _rel(a["back_np"], x),
               ROUNDTRIP_LIMIT[comm])
        _check(errors, f"{eng} {comm} round trip", _rel(a["back"], x), ROUNDTRIP_LIMIT[comm])
    assert not errors, errors


@pytest.mark.parametrize("name", _plans("scipy"))
def test_transform_plans_vs_scipy(runs, name):
    """tests/test_transforms.py:149-191: DCT/DST/r2c/c2c plans against the
    scipy composition, and the round trip, under every engine and wire."""
    tags = R.PARITY_PLANS[name][3]
    x = R.parity_inputs(name)["x"]
    want = _ref_nd(x, tags)
    errors = []
    for eng, comm, a in _each_run(runs, name):
        assert a["fwd"].shape == want.shape
        _check(errors, f"{eng} {comm} forward", _rel(a["fwd"], want), _fwd_limit(name, comm))
        _check(errors, f"{eng} {comm} round trip", _rel(a["back"], x), ROUNDTRIP_LIMIT[comm])
    assert not errors, errors


@pytest.mark.parametrize("name", _plans("pruned") + _plans("pruned_r2c"))
def test_pruned_dealias_plans(runs, name):
    """tests/test_transforms.py:194-248: the pruned c2c plan's forward is
    the centred truncation of ``fftn``, a spectrum round trips through
    ``forward(backward(s))`` and ``backward(forward(x))`` is numpy's
    dealiasing projection; the pruned r2c plan's valid spectra round trip;
    under every engine and wire."""
    kind = R.PARITY_PLANS[name][4]
    n, m = R.PRUNE_N, R.PRUNE_M
    keep = np.r_[0:(n + 1) // 2, m - n // 2:m]
    inp = R.parity_inputs(name)
    x = inp["x"]
    errors = []
    for eng, comm, a in _each_run(runs, name):
        if kind == "pruned":
            full = np.fft.fftn(x)
            want = full[np.ix_(keep, keep, keep)]
            assert a["fwd"].shape == (n, n, n)
            _check(errors, f"{eng} {comm} forward", _rel(a["fwd"], want), _fwd_limit(name, comm))
            _check(errors, f"{eng} {comm} spectral round trip", _rel(a["rt"], inp["s"]),
                   ROUNDTRIP_LIMIT[comm])
            mask = np.zeros((m, m, m))
            mask[np.ix_(keep, keep, keep)] = 1.0
            _check(errors, f"{eng} {comm} projection", _rel(a["back"], np.fft.ifftn(full * mask)),
                   ROUNDTRIP_LIMIT[comm])
        else:
            assert a["fwd"].shape == (n, n, n // 2 + 1)
            _check(errors, f"{eng} {comm} spectral round trip", _rel(a["rt"], a["s"]),
                   ROUNDTRIP_LIMIT[comm])
    assert not errors, errors


@pytest.mark.parametrize("name", list(R.PARITY_PLANS))
def test_lossless_engines_equal_fused(runs, name):
    """Every parity plan's lossless traditional and pipelined runs are
    bitwise its fused run."""
    (_, parity), _ = runs
    fused = f"{name}|fused|complex64|"
    for eng in ("traditional", "pipelined"):
        pre = f"{name}|{eng}|complex64|"
        for k in parity:
            if k.startswith(fused):
                np.testing.assert_array_equal(parity[pre + k[len(fused):]], parity[k],
                                              err_msg=pre + k[len(fused):])

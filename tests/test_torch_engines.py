"""The port's traditional and pipelined engines on 4 gloo ranks, against the
JAX package on 4 virtual devices, with ``guard=True``.

Every ``EXCHANGE_LAYOUTS`` entry runs under traditional (``transposed_out``
False and True) and pipelined (``chunks`` 1 and 3) at each ``comm_dtype``;
each rank's output block and guard stats are compared with the reference
shard's.  The JAX side runs its lossy exchanges through the Pallas kernels
(interpret mode) where the reference takes them, as the port takes its
``exchange_impl="cuda"`` path (the kernels' plain versions on the CPU).

Tolerances: lossless and bf16 blocks bitwise; int8 within 1.25 quanta
(max |x| / 127, as tests/test_torch_pfft.py); the stats (non-finite and
saturated counts) exactly.  The quickstart plan under each engine: within
1e-5 relative L2 of the reference and of ``np.fft.fftn``.
"""

from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as R

TESTS = Path(__file__).resolve().parent


#: the JAX side: the same cases through the reference's exchange_shard
_REFERENCE = """
import sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.meshutil import make_mesh, shard_map
from repro.core.pfft import ParallelFFT
from repro.core.planconfig import PlanConfig
from repro.core.redistribute import exchange_shard
import _torch_ranks as R

data = R.inputs()
res = {{}}
meshes = {{}}
for key, lay, eng, comm in R.engine_cases():
    mshape, names, fshape, placement, v, w = R.EXCHANGE_LAYOUTS[lay]
    mesh = meshes.setdefault(mshape, make_mesh(mshape, names))
    method, opts = R.ENGINES[eng]

    def shard(b, v=v, w=w, g=placement[w], method=method, opts=opts, comm=comm):
        y, st = exchange_shard(b, v, w, g, method=method, comm_dtype=comm, guard=True,
                               impl="jnp" if comm == "complex64" else "pallas", **opts)
        return y[None], jnp.stack([st["nonfinite"], st["saturated"]])[None]

    fn = shard_map(shard, mesh=mesh, in_specs=P(*placement), out_specs=(P(names), P(names)),
                   check_vma=False)
    y, st = jax.jit(fn)(jnp.asarray(data[key]))
    res[key], res[key + ":stats"] = np.asarray(y), np.asarray(st)
mesh = meshes[(2, 2)]
for name, cfg in R.ENGINE_PLANS.items():
    plan = ParallelFFT(mesh, R.QS_SHAPE, ("p0", "p1"), config=PlanConfig(**cfg))
    res["plan-" + name + "-fwd"] = np.asarray(plan.forward(jnp.asarray(data["quickstart"])))
np.savez({out!r}, **res)
"""


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``(port, reference)``: the 4 ranks run while the JAX side does."""
    d = tmp_path_factory.mktemp("torch_engines")
    out = d / "reference.npz"
    join = R.start(R.run_engine_rank, d)
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), out=str(out)), ndev=R.WORLD)
    finally:
        join()
    return [dict(np.load(d / f"engines{r}.npz")) for r in range(R.WORLD)], dict(np.load(out))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("key,comm", [(k, c) for k, _, _, c in R.engine_cases()])
def test_engine_matches_reference(runs, key, comm):
    port, reference = runs
    got = np.stack([p[key] for p in port])
    want = reference[key]
    assert got.shape == want.shape and got.dtype == want.dtype
    if comm == "int8":
        x = R.inputs()[key]
        quantum = float(np.max(np.abs(np.stack([x.real, x.imag])))) / 127.0
        np.testing.assert_allclose(got, want, atol=1.25 * quantum, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)
    stats = np.stack([p[key + ":stats"] for p in port])
    np.testing.assert_array_equal(stats, reference[key + ":stats"])


def _expected_calls(lay, eng, comm):
    """``[pack_chunks, unpack_chunks]`` calls of one exchange: none for a
    lossless wire, else one of each per collective (per slice, pipelined)."""
    from repro_torch.core.decomp import local_lengths

    if comm == "complex64":
        return [0, 0]
    mshape, names, fshape, placement, v, w = R.EXCHANGE_LAYOUTS[lay]
    method, opts = R.ENGINES[eng]
    if method != "pipelined":
        return [1, 1]
    b = fshape[v] // mshape[names.index(placement[w])]
    n = sum(1 for k in local_lengths(b, min(opts["chunks"], b)) if k > 0)
    return [n, n]


@pytest.mark.parametrize("key,lay,eng,comm", R.engine_cases())
def test_cuda_impl_takes_the_exchange_kernels(runs, key, lay, eng, comm):
    """``impl="cuda"`` with a lossy wire packs and unpacks through the
    kernel wrappers in every engine, ``transposed_out`` included."""
    for p in runs[0]:
        assert p[key + ":calls"].tolist() == _expected_calls(lay, eng, comm)


@pytest.mark.parametrize("key", [k for k, _, eng, comm in R.engine_cases()
                                 if eng == "trad_tout" and comm != "complex64"])
def test_transposed_out_kernels_match_plain_codec(runs, key):
    """The kernels' transposed-out exchange equals the plain movedim path
    (same quantization blocks): output and stats bitwise, on every rank."""
    for p in runs[0]:
        np.testing.assert_array_equal(p[key], p[key + ":torch"])
        np.testing.assert_array_equal(p[key + ":stats"], p[key + ":torch:stats"])


@pytest.mark.parametrize("name", list(R.ENGINE_PLANS))
def test_quickstart_plan_engines_match_reference(runs, name):
    port, reference = runs
    u = R.inputs()["quickstart"]
    fwd = port[0][f"plan-{name}-fwd"]
    assert fwd.shape == R.QS_SHAPE and fwd.dtype == np.complex64
    assert _rel(fwd, reference[f"plan-{name}-fwd"]) <= 1e-5
    assert _rel(fwd, np.fft.fftn(u)) <= 1e-5
    assert _rel(port[0][f"plan-{name}-back"], u) <= 1e-5


def test_warm_runs_each_direction(runs):
    """``warm`` runs each requested direction once (guarded plans through the
    guarded executor), on every rank."""
    for p in runs[0]:
        assert p["warm"].tolist() == [2, 1]

"""The port's fused exchange and quickstart plan on 4 gloo ranks, against the
JAX package on 4 virtual devices.

The ranks are spawned once per module (tests/_torch_ranks.py) and the JAX
side runs once in a subprocess; both build the same numpy-seeded inputs.
The JAX side runs its lossy exchanges through the Pallas kernels (interpret
mode), whose payloads are the real bf16/int8 roundings.

Tolerances: lossless and bf16 exchanges bitwise; int8 within 1.25 quanta
(max |x| / 127, as tests/test_exchange_kernels.py).  Plans: relative L2 vs
``np.fft.fftn`` <= 1e-5 lossless and <= 3e-3 for bf16 — one bf16 rounding of
normal data costs 1.7e-3 relative L2 and the plan rounds twice, so
sqrt(2) * 1.7e-3 = 2.4e-3; port vs JAX <= 1e-5 lossless and <= 1e-3 bf16
(the same roundings, apart from values the two FFTs round to either side of
a bf16 tie).
"""

from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as R

TESTS = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ranks")
    R.start(R.run_rank, d)()
    return dict(np.load(d / "results.npz"))


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "results.npz"
    subproc(f"""
import sys
sys.path.insert(0, {str(TESTS)!r})
from functools import partial
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.meshutil import make_mesh, shard_map
from repro.core.pfft import ParallelFFT
from repro.core.planconfig import PlanConfig
from repro.core.redistribute import exchange_shard
import _torch_ranks as R

data = R.inputs()
res = {{}}
for key, lay, comm, nb in R.exchange_cases():
    mshape, names, fshape, placement, v, w = R.EXCHANGE_LAYOUTS[lay]
    mesh = make_mesh(mshape, names)
    outp = R.out_placement(placement, v, w)
    fn = shard_map(partial(exchange_shard, v=v, w=w, group=placement[w], comm_dtype=comm,
                           nbatch=nb, impl="jnp" if comm == "complex64" else "pallas"),
                   mesh=mesh, in_specs=P(*(None,) * nb, *placement),
                   out_specs=P(*(None,) * nb, *outp), check_vma=False)
    res[key] = np.asarray(jax.jit(fn)(jnp.asarray(data[key])))
mesh = make_mesh((2, 2), ("p0", "p1"))
for name, cfg in R.PLAN_CONFIGS.items():
    plan = ParallelFFT(mesh, R.QS_SHAPE, ("p0", "p1"), config=PlanConfig(**cfg))
    res["plan-" + name + "-fwd"] = np.asarray(plan.forward(jnp.asarray(data["quickstart"])))
np.savez({str(out)!r}, **res)
""", ndev=R.WORLD)
    return dict(np.load(out))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("key,comm", [(k, c) for k, _, c, _ in R.exchange_cases()])
def test_exchange_matches_reference(port, reference, key, comm):
    got, want = port[key], reference[key]
    assert got.shape == want.shape and got.dtype == want.dtype
    if comm == "int8":
        x = R.inputs()[key]
        quantum = float(np.max(np.abs(np.stack([x.real, x.imag])))) / 127.0
        np.testing.assert_allclose(got, want, atol=1.25 * quantum, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,tol_fftn,tol_ref", [
    ("default", 1e-5, 1e-5),
    ("slice", 3e-3, 1e-3),
])
def test_quickstart_plan_matches_reference(port, reference, name, tol_fftn, tol_ref):
    u = R.inputs()["quickstart"]
    fwd = port[f"plan-{name}-fwd"]
    assert fwd.shape == R.QS_SHAPE and fwd.dtype == np.complex64
    assert _rel(fwd, np.fft.fftn(u)) <= tol_fftn
    assert _rel(fwd, reference[f"plan-{name}-fwd"]) <= tol_ref
    assert _rel(port[f"plan-{name}-back"], u) <= tol_fftn


def test_scatter_gather_roundtrip(port):
    np.testing.assert_array_equal(port["gather-roundtrip"], R.inputs()["quickstart"])

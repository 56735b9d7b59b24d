"""The port's int8 gradient compression (``repro_torch.optim.compress``)
against the reference's (``repro.optim.compress``).

The quantizer's bounds and error feedback run on the CPU in one process,
mirroring tests/test_compress.py.  ``compressed_psum`` and
``ErrorFeedback.apply`` run on 2 gloo ranks (tests/_torch_train_ranks.py)
while one JAX subprocess runs the reference's inside ``shard_map`` on 2
virtual devices, on the same numpy-seeded gradients; each output is held to
the reference's within one quantum of the reduced sum's requantization
(its max over 127), the residuals likewise.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

import _torch_train_ranks as TR
from repro_torch.optim.compress import ErrorFeedback, quantize_roundtrip

TESTS = Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores, and the
    small ops here lose more to a crowded thread pool than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_REFERENCE = """
import sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.meshutil import make_mesh, shard_map
from repro.optim.compress import ErrorFeedback, compressed_psum, reduce_local_roundtrip
import _torch_train_ranks as TR

mesh = make_mesh((TR.WORLD,), ("data",))
spec = {{k: P("data", *(None,) * len(s)) for k, s in TR.COMPRESS_SHAPES.items()}}


def stacked(r):
    per = [TR.compress_grads(rank, r) for rank in range(TR.WORLD)]
    return {{k: jnp.asarray(np.stack([p[k] for p in per])) for k in TR.COMPRESS_SHAPES}}


def unstack(t):
    return {{k: jnp.asarray(v[0]) for k, v in t.items()}}


def body(g):
    g = unstack(g)
    out = compressed_psum(g, mesh, "data")
    loc = reduce_local_roundtrip(g, mesh, "data")
    return ({{k: v[None] for k, v in out.items()}}, {{k: v[None] for k, v in loc.items()}})


psum, local = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec),
                                check_vma=False))(stacked(0))
res = {{}}
for k in TR.COMPRESS_SHAPES:
    res["psum:" + k] = np.asarray(psum[k])
    res["local:" + k] = np.asarray(local[k])


def ef_body(g, e):
    g, e = unstack(g), unstack(e)
    sent, err = ErrorFeedback.apply(g, e, lambda c: compressed_psum(c, mesh, "data"),
                                    local_fn=lambda c: reduce_local_roundtrip(c, mesh, "data"))
    return ({{k: v[None] for k, v in sent.items()}}, {{k: v[None] for k, v in err.items()}})


ef = jax.jit(shard_map(ef_body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                       check_vma=False))
err = {{k: jnp.zeros((TR.WORLD, *s), jnp.float32) for k, s in TR.COMPRESS_SHAPES.items()}}
for r in range(TR.EF_ROUNDS):
    sent, err = ef(stacked(r), err)
    for k in TR.COMPRESS_SHAPES:
        res[f"ef{{r}}:sent:{{k}}"] = np.asarray(sent[k])
        res[f"ef{{r}}:err:{{k}}"] = np.asarray(err[k])
np.savez({out!r}, **res)
"""


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """(each rank's arrays, the reference's arrays stacked over ranks)."""
    d = tmp_path_factory.mktemp("torch_compress")
    join = TR.start(TR.run_compress_rank, d, world=TR.WORLD)
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), out=str(d / "reference.npz")),
                ndev=TR.WORLD)
    finally:
        join(timeout=300)
    return ([dict(np.load(d / f"compress{r}.npz")) for r in range(TR.WORLD)],
            dict(np.load(d / "reference.npz")))


def _quantum(want: np.ndarray) -> float:
    """One quantum of the requantized sum: its max |value| over 127."""
    return float(np.abs(want).max()) / 127 + 1e-12


@pytest.mark.parametrize("what", ["psum", "local"])
@pytest.mark.parametrize("leaf", sorted(TR.COMPRESS_SHAPES))
def test_compressed_psum_matches_reference(runs, what, leaf):
    """Every rank's reduced sum (and its local estimate) within one quantum
    of the reference's at its shard; the sum within 2 quanta of each wire's
    of the exact sum over ranks."""
    ranks, ref = runs
    exact = sum(TR.compress_grads(r)[leaf] for r in range(TR.WORLD))
    for r, arrays in enumerate(ranks):
        got, want = arrays[f"{what}:{leaf}"], ref[f"{what}:{leaf}"][r]
        assert got.shape == want.shape == TR.COMPRESS_SHAPES[leaf]
        assert np.abs(got - want).max() <= _quantum(want)
    if what == "psum":
        bound = 2 * sum(np.abs(TR.compress_grads(r)[leaf]).max() / 127 for r in range(TR.WORLD))
        assert np.abs(ranks[0]["psum:" + leaf] - exact).max() <= bound


@pytest.mark.parametrize("round_", range(TR.EF_ROUNDS))
def test_error_feedback_matches_reference(runs, round_):
    """``ErrorFeedback.apply`` around ``compressed_psum`` with the rank's
    local estimate: each round's sent sum and residual within one quantum
    of the reference's."""
    ranks, ref = runs
    for r, arrays in enumerate(ranks):
        for k in TR.COMPRESS_SHAPES:
            for part in ("sent", "err"):
                got, want = arrays[f"ef{round_}:{part}:{k}"], ref[f"ef{round_}:{part}:{k}"][r]
                assert np.abs(got - want).max() <= _quantum(ref[f"ef{round_}:sent:{k}"][r]), \
                    (r, k, part)


@given(scale=st.floats(1e-4, 1e3), seed=st.integers(0, 1000))
@settings(max_examples=30, deadline=None)
def test_quant_relative_error(scale, seed):
    rng = np.random.default_rng(seed)
    g = {"w": torch.from_numpy((rng.standard_normal((64,)) * scale).astype(np.float32))}
    out = quantize_roundtrip(g)
    amax = float(g["w"].abs().max())
    assert float((out["w"] - g["w"]).abs().max()) <= amax / 127.0 + 1e-9  # one step


def test_error_feedback_unbiased_over_time():
    """The running sum of sent gradients tracks the running sum of true ones
    (the residual stays bounded)."""
    rng = np.random.default_rng(0)
    err = ErrorFeedback.init({"w": torch.zeros(32)})
    tot_true, tot_sent = np.zeros(32), np.zeros(32)
    for _ in range(50):
        g = {"w": torch.from_numpy((rng.standard_normal(32) * 0.01).astype(np.float32))}
        sent, err = ErrorFeedback.apply(g, err, quantize_roundtrip)
        tot_true += g["w"].numpy()
        tot_sent += sent["w"].numpy()
    assert np.abs(tot_true - tot_sent).max() <= float(err["w"].abs().max()) + 1e-6


def test_quantize_roundtrip_matches_reference():
    """The lossy channel alone is the reference's bit for bit."""
    import jax.numpy as jnp
    from repro.optim.compress import quantize_roundtrip as ref_roundtrip

    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((9, 5)).astype(np.float32),
         "b": (rng.standard_normal(31) * 1e3).astype(np.float32)}
    want = ref_roundtrip({k: jnp.asarray(v) for k, v in g.items()})
    got = quantize_roundtrip({k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

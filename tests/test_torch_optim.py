"""The port's AdamW (``repro_torch.optim``) against the reference's
(``repro.optim``), on the same numpy-seeded parameters and gradients, fp32
and bf16 leaves, vectors and matrices (weight decay on matrices only).

* Unclipped gradients (global norm under ``max_grad_norm``) at a fixed lr:
  the updated parameters and both moments are bitwise the reference's over
  five steps: each leaf's fp32 operations are the reference's, in its
  order, each rounded once.
* Clipped gradients: the global norm sums each leaf's squares in another
  order than XLA's reduction, so the norm and the clip scale may differ by
  an ulp; parameters and moments stay within ``CLIP_ULPS`` ulps.
* The cosine schedule: float32 on the host; ``torch.cos`` and XLA's cosine
  differ by an ulp at some steps, which near the schedule's end (1 + cos
  close to 0) becomes a few ulps of lr: within ``SCHEDULE_ULPS`` of the
  reference's, eager and jitted (XLA fuses its multiply-adds).
* ``clip_by_global_norm`` and the shape of the schedule as
  tests/test_optim.py holds the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

from repro.optim import AdamW as RefAdamW, cosine_schedule as ref_cosine
from repro_torch.models.convert import to_tensor
from repro_torch.optim import AdamW, clip_by_global_norm, cosine_schedule

SHAPES = {"a": (8, 6), "b": (7,), "c": (5, 4, 3)}
CLIP_ULPS = 4
SCHEDULE_ULPS = 8
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores, and the
    small ops here lose more to a crowded thread pool than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Max distance in ulps of two float32 (or bf16 as float32) arrays."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def _run(dtype: str, gscale: float, lr):
    """Both optimizers over ``STEPS`` steps from the same state; yields the
    step's (reference params, mu, nu, metrics) and the port's."""
    rng = np.random.default_rng(0)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rp = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32), jd) for k, s in SHAPES.items()}
    rg = {k: jnp.asarray((rng.standard_normal(s) * gscale).astype(np.float32), jd)
          for k, s in SHAPES.items()}
    ropt, popt = RefAdamW(lr=lr[0]), AdamW(lr=lr[1])
    rst = ropt.init(rp)
    pp = {k: to_tensor(np.asarray(v)) for k, v in rp.items()}
    pst = popt.init(pp)
    for it in range(STEPS):
        g = {k: (rg[k] * (it + 1)).astype(jd) for k in rg}
        rp, rst, rm = ropt.update(g, rst, rp)
        pp, pst, pm = popt.update({k: to_tensor(np.asarray(v)) for k, v in g.items()}, pst, pp)
        yield (rp, rst.mu, rst.nu, rm), (pp, pst.mu, pst.nu, pm)


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_bitwise(dtype):
    """Unclipped: parameters, mu and nu bitwise at every step; the step's
    grad norm within an ulp, its lr equal."""
    for ref, port in _run(dtype, 0.01, (1e-2, 1e-2)):
        for k in SHAPES:
            for r, p in zip(ref[:3], port[:3]):
                np.testing.assert_array_equal(_as_np(p[k]), np.asarray(r[k], np.float32))
            assert port[0][k].dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
            assert port[1][k].dtype == port[2][k].dtype == torch.float32
        assert _ulps(float(ref[3]["grad_norm"]), port[3]["grad_norm"].numpy()) <= 1
        assert np.float32(ref[3]["lr"]) == port[3]["lr"].item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_clipped_within_ulps(dtype):
    """Clipped (global norm ~100x the limit): within ``CLIP_ULPS`` ulps."""
    for ref, port in _run(dtype, 10.0, (1e-2, 1e-2)):
        for k in SHAPES:
            for r, p in zip(ref[:3], port[:3]):
                assert _ulps(_as_np(p[k]), np.asarray(r[k], np.float32)) <= CLIP_ULPS, k
        assert _ulps(float(ref[3]["grad_norm"]), port[3]["grad_norm"].numpy()) <= CLIP_ULPS


def test_adamw_with_the_schedule_tracks_reference():
    """Under the cosine schedule, fp32: within ``CLIP_ULPS`` ulps of lr."""
    for ref, port in _run("float32", 0.01, (ref_cosine(1e-2, 2, 10), cosine_schedule(1e-2, 2, 10))):
        for k in SHAPES:
            np.testing.assert_allclose(_as_np(port[0][k]), np.asarray(ref[0][k]), rtol=1e-6,
                                       atol=1e-7)
        assert _ulps(float(ref[3]["lr"]), port[3]["lr"].numpy()) <= SCHEDULE_ULPS


@pytest.mark.parametrize("args", [(3e-4, 20, 100), (1e-3, 5, 30), (1.0, 10, 100)])
def test_cosine_schedule_matches_reference(args):
    """Every step 0 .. 1.5 x total within ``SCHEDULE_ULPS`` ulps of the
    reference's, eager and jitted."""
    ref, port = ref_cosine(*args), cosine_schedule(*args)
    steps = range(0, int(1.5 * args[2]))
    want = np.array([np.float32(ref(jnp.int32(s))) for s in steps])
    want_jit = np.asarray(jax.vmap(ref)(jnp.asarray(list(steps), jnp.int32)))
    got = np.array([port(s).item() for s in steps], np.float32)
    assert _ulps(got, want) <= SCHEDULE_ULPS
    assert _ulps(got, want_jit) <= SCHEDULE_ULPS


def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - 1.0)}
        params, state, _ = opt.update(g, state, params)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0], atol=1e-2)


@given(scale=st.floats(1e-3, 1e3), max_norm=st.floats(0.1, 10.0))
@settings(max_examples=50, deadline=None)
def test_clip_property(scale, max_norm):
    g = {"a": torch.full((4,), scale), "b": torch.full((3, 3), -scale)}
    want = float(np.sqrt(4 * scale ** 2 + 9 * scale ** 2))
    clipped, gnorm = clip_by_global_norm(g, max_norm)
    got = float(np.sqrt(sum(float(x.double().square().sum()) for x in clipped.values())))
    assert got <= max_norm * 1.001 + 1e-6
    np.testing.assert_allclose(float(gnorm), want, rtol=1e-5)
    if want <= max_norm:  # no-op below the threshold
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_clip_by_global_norm_matches_reference():
    """The same leaves (fp32 and bf16): the norm within an ulp, the clipped
    leaves within an ulp of the clip scale."""
    from repro.optim import clip_by_global_norm as ref_clip

    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((16, 9)).astype(np.float32) * 5,
         "b": rng.standard_normal(33).astype(np.float32)}
    rg = {"a": jnp.asarray(g["a"]), "b": jnp.asarray(g["b"], jnp.bfloat16)}
    want, wn = ref_clip(rg, 1.0)
    got, gn = clip_by_global_norm({k: to_tensor(np.asarray(v)) for k, v in rg.items()}, 1.0)
    assert _ulps(gn.numpy(), float(wn)) <= 1
    for k in g:
        assert _ulps(_as_np(got[k]), np.asarray(want[k], np.float32)) <= 1


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=100, min_frac=0.1)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 0.11
    assert float(lr(100)) >= 0.099
    assert float(lr(5)) < float(lr(10))


def test_bf16_params_fp32_moments():
    opt = AdamW(lr=1e-2)
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.mu["w"].dtype == torch.float32
    p2, s2, _ = opt.update({"w": torch.ones((4, 4), dtype=torch.bfloat16)}, state, params)
    assert p2["w"].dtype == torch.bfloat16
    assert int(s2.step) == 1


def test_update_leaves_the_gradients_clipped_only():
    """``update`` clips the gradients in place and writes nothing else into
    them (fp32 leaves too, whose fp32 view is the gradient itself)."""
    g = {"w": torch.full((3, 3), 0.125), "b": torch.full((3,), -0.125, dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in g.items()}
    opt = AdamW(lr=1e-2)
    params = {"w": torch.ones((3, 3)), "b": torch.ones(3, dtype=torch.bfloat16)}
    opt.update(g, opt.init(params), params)
    for k in g:
        assert torch.equal(g[k], want[k]), k  # the norm, 0.43, is under the clip

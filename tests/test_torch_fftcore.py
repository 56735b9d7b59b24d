"""The port's local transforms (repro_torch.core.fftcore) and four-step DFT
wrappers (repro_torch.kernels.fft, plain version on the CPU) against the
reference's, on the same numpy-seeded inputs.

Every TransformSpec kind of tests/test_transforms.py, both directions, both
FFT implementations (``"torch"`` vs ``"jnp"``, and ``"matmul"`` vs the
reference's ``"matmul"``, its Pallas kernel in interpret mode).  Tolerance:
f32 transforms in another order, ``rtol=1e-4`` and ``atol=1e-5 * max|ref|``
(the reference's own transform tests allow 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fftcore as jf
from repro.kernels.fft import ops as jops, ref as jref
from repro_torch.core import fftcore as tf
from repro_torch.kernels.fft import ops as tops, ref as tref

SPECS = [
    ("c2c", None), ("r2c", None), ("dct2", None), ("dct3", None), ("dst2", None),
    ("dst3", None), ("c2c", 8), ("r2c", 5),
]
IMPLS = [("torch", "jnp"), ("matmul", "matmul")]


def _spec(mod, tag, n_keep):
    if n_keep is None:
        return mod.as_spec(tag)
    return mod.TransformSpec(tag, n_keep=n_keep)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("tag,n_keep", SPECS)
@pytest.mark.parametrize("impl,ref_impl", IMPLS)
@pytest.mark.parametrize("n", [12, 9])
@pytest.mark.parametrize("sign", [-1, 1])
def test_local_transform_matches_reference(tag, n_keep, impl, ref_impl, n, sign):
    if n_keep is not None and n_keep > (n // 2 + 1 if tag == "r2c" else n):
        pytest.skip("n_keep exceeds the spectrum")
    tspec, jspec = _spec(tf, tag, n_keep), _spec(jf, tag, n_keep)
    rng = np.random.default_rng(n)
    if sign == tf.FORWARD:
        length = n
        real = tag != "c2c"
    else:
        length = tspec.spectral_extent(n)
        real = tspec.real_to_real
    shape = (3, length, 5)
    x = rng.standard_normal(shape).astype(np.float32)
    if not real:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    got = tf.local_transform(torch.from_numpy(x), 1, sign, tspec, n=n, impl=impl).numpy()
    want = jf.local_transform(jnp.asarray(x), 1, sign, jspec, n=n, impl=ref_impl)
    _close(got, want)


@pytest.mark.parametrize("tag", ["dct2", "dst3"])
def test_trig_transform_of_complex_block(tag):
    x = np.random.default_rng(1).standard_normal((4, 7)).astype(np.float32)
    x = (x + 1j * x[::-1]).astype(np.complex64)
    for impl, ref_impl in IMPLS:
        got = tf.local_transform(torch.from_numpy(x), 1, tf.FORWARD, tf.as_spec(tag), n=7,
                                 impl=impl).numpy()
        _close(got, jf.local_transform(jnp.asarray(x), 1, jf.FORWARD, jf.as_spec(tag), n=7,
                                       impl=ref_impl))


@pytest.mark.parametrize("n", [8, 17, 96, 384, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_matmul_matches_reference(n, inverse):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))).astype(np.complex64)
    got = tops.fft_matmul(torch.from_numpy(x), inverse=inverse).numpy()
    want = np.fft.ifft(x, axis=-1) if inverse else np.fft.fft(x, axis=-1)
    _close(got, want)
    # the reference's kernel runs bf16 passes on the TPU; on the CPU it is f32
    _close(got, jops.fft_matmul(jnp.asarray(x), inverse=inverse))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fft_matmul_axes_and_real(axis):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 10, 8)).astype(np.float32)
    xc = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    _close(tops.fft_matmul(torch.from_numpy(xc), axis=axis).numpy(), np.fft.fft(xc, axis=axis))
    r = tops.rfft_matmul(torch.from_numpy(x), axis=axis)
    _close(r.numpy(), jops.rfft_matmul(jnp.asarray(x), axis=axis))
    back = tops.irfft_matmul(r, n=x.shape[axis], axis=axis).numpy()
    _close(back, x)
    assert sum(tops.launches.values()) == 0  # CPU tensors take the plain version


def test_plan_factors_match_reference():
    for n in range(1, 4097):
        assert tops.plan_factors(n) == jops.plan_factors(n)


@pytest.mark.parametrize("n", [5, 12, 64])
def test_tables_bitwise(n):
    np.testing.assert_array_equal(tref.dft_matrix(n), jref.dft_matrix(n))
    np.testing.assert_array_equal(tref.twiddle_matrix(n, 3), jref.twiddle_matrix(n, 3))
    for t in (2, 3):
        np.testing.assert_array_equal(tref.dct_matrix(n, t), jref.dct_matrix(n, t))
        np.testing.assert_array_equal(tref.dst_matrix(n, t), jref.dst_matrix(n, t))


@pytest.mark.parametrize("n1,n2", [(4, 4), (12, 5), (32, 16)])
def test_fourstep_ref_matches_fft(n1, n2):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, n1 * n2)) + 1j * rng.standard_normal((3, n1 * n2))
         ).astype(np.complex64)
    _close(tref.fourstep_ref(torch.from_numpy(x), n1, n2).numpy(), np.fft.fft(x, axis=-1))


def test_spec_vocabulary_matches_reference():
    for tag in ("c2c", "r2c", "dct2", "dct3", "dst2", "dst3"):
        t, j = tf.as_spec(tag), jf.as_spec(tag)
        assert (t.kind, t.trig_type, t.n_keep, t.tag()) == (j.kind, j.trig_type, j.n_keep, j.tag())
    assert tf.TransformSpec.pruned(12).tag() == "c2c[12]"
    assert tf.TransformSpec.r2c(n_keep=3).spectral_extent(9) == 3
    assert tf.dealias_grid(32) == jf.dealias_grid(32) == 48
    for bad in (lambda: tf.TransformSpec("hartley"), lambda: tf.TransformSpec.dct(1),
                lambda: tf.TransformSpec("dct", n_keep=4), lambda: tf.TransformSpec.pruned(0),
                lambda: tf.as_spec("dft")):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        tf.as_spec(42)

"""The arithmetic of K4's tensor-core design on the CPU (no kernel here).

The design (``csrc/fourstep.cu``, ``fourstep_tc_kernel``) forms each
contraction of the four-step in 3xTF32: tables split on the host into TF32
``big + small`` (``kernels/fft/ops.py`` ``tc_matrices``), data split in the
kernel (big truncated, small rounded), and ``big.small + small.big +
big.big`` summed in fp32.
Here: (a) the split tables equal the fp32 tables within 2^-22 relative and
are TF32 values; (b) the plain emulation of that arithmetic
(``ref.fourstep_tf32_ref``) matches ``numpy.fft`` in float64 within the
kernel's tolerance, 1e-5 of max |y|; (c) the same emulation without the
small terms (1xTF32) does not, so that tolerance guards the split.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fft import ops, ref

SHAPES = [(32, 16), (32, 32), (64, 64)]
TOL = 1e-5


def _tables(n1, n2, inverse):
    """``ops.tc_matrices`` unpacked into its five tables."""
    flat = ops.tc_matrices(n1, n2, inverse, "cpu").numpy()
    sizes = [4 * n1 * n1, 4 * n1 * n1, 4 * n2 * n2, 4 * n2 * n2, 2 * n1 * n2]
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    f1b, f1s = (p.reshape(2 * n1, 2 * n1) for p in parts[:2])
    f2b, f2s = (p.reshape(2 * n2, 2 * n2) for p in parts[2:4])
    return f1b, f1s, f2b, f2s, parts[4].view(np.complex64).reshape(n1, n2)


def _rel_err(n1, n2, inverse, split):
    rng = np.random.default_rng(n1 * 100 + n2)
    n = n1 * n2
    x = (rng.standard_normal((6, n)) + 1j * rng.standard_normal((6, n))).astype(np.complex64)
    got = ref.fourstep_tf32_ref(torch.from_numpy(x), n1, n2, inverse=inverse, split=split)
    x64 = x.astype(np.complex128)
    want = np.fft.ifft(x64, axis=-1) if inverse else np.fft.fft(x64, axis=-1)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1,n2", SHAPES)
def test_split_tables_sum_to_fp32_and_are_tf32(n1, n2, inverse):
    f1b, f1s, f2b, f2s, tw = _tables(n1, n2, inverse)
    for big, small, m in ((f1b, f1s, n1), (f2b, f2s, n2)):
        f = ref.dft_block(m, inverse).astype(np.float64)
        k = np.arange(m)
        roots = np.exp((2j if inverse else -2j) * np.pi * (np.outer(k, k) % m) / m)
        np.testing.assert_array_equal(f[:m, :m], roots.real.astype(np.float32))
        np.testing.assert_array_equal(f[m:, :m], roots.imag.astype(np.float32))
        np.testing.assert_array_equal(f[m:, m:], f[:m, :m])
        np.testing.assert_array_equal(f[:m, m:], -f[m:, :m])
        err = np.abs(big.astype(np.float64) + small.astype(np.float64) - f)
        assert bool((err <= 2.0 ** -22 * np.abs(f)).all()), err.max()
        for part in (big, small):
            assert not (part.view(np.uint32) & 0x1FFF).any()
    k1, i2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    want_tw = np.exp((2j if inverse else -2j) * np.pi * k1 * i2 / (n1 * n2))
    np.testing.assert_allclose(tw, want_tw, rtol=0, atol=2e-7)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1,n2", SHAPES)
def test_3xtf32_emulation_matches_fft(n1, n2, inverse):
    assert _rel_err(n1, n2, inverse, split=True) <= TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1,n2", SHAPES)
def test_1xtf32_emulation_exceeds_the_tolerance(n1, n2, inverse):
    assert _rel_err(n1, n2, inverse, split=False) > TOL


@pytest.mark.parametrize("n,tc", [(512, True), (1024, True), (2048, True), (4096, True),
                                  (768, True), (256, False), (257, False), (1000, False),
                                  (320, False), (8192, False)])
def test_tensor_core_design_lengths(n, tc):
    assert ops.tensor_core_design(*ops.plan_factors(n)) is tc


def test_tf32_trunc_keeps_non_finite_values():
    bits = np.array([0x7FFFFFFF, 0xFFFFF000, 0x7F800001, 0x7F800000, 0xFF800000, 0x3FFFFFFF],
                    dtype=np.uint32)
    got = ref.tf32_trunc(bits.view(np.float32))
    np.testing.assert_array_equal(got.view(np.uint32), bits & 0xFFFFE000)
    assert np.isnan(got[:2]).all() and not np.isfinite(got[2:5]).any()
    assert np.signbit(got[1]) and np.signbit(got[4])


def test_tf32_round_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - np.float32(2.0 ** -23),
                  one + ulp + ulp / 2], dtype=np.float32)
    np.testing.assert_array_equal(ref.tf32_round(x),
                                  np.array([one + ulp, -(one + ulp), one, one + 2 * ulp],
                                           dtype=np.float32))

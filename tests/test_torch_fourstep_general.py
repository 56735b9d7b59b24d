"""The order of work of K4's general design on the CPU (no kernel here).

The design (``csrc/fourstep.cu``, ``fourstep_kernel``) splits a length its
own way (``ref.general_split``: n2 the largest divisor at most sqrt(n)),
reads float32 roots of the DFT-n1, DFT-n2 and twiddle tables and sums each
bin in a fixed chain of fp32 FMAs.  ``ref.fourstep_general_ref`` emulates
that; here it is held to float64 ``numpy.fft`` within the kernel's
tolerance, 1e-5 of max |y|, forward and inverse, complex and real input
(the first n // 2 + 1 bins), and at a few lengths to the reference's
``repro.kernels.fft.ops`` (its Pallas kernel in interpret mode on the
CPU).  The split itself: n1 * n2 = n, n1 >= n2, (n, 1) exactly for primes,
``plan_factors``' split above 256, and ``plan_factors`` /
``tensor_core_design`` untouched by it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fft import ops as jops
from repro_torch.kernels.fft import ops, ref

LENGTHS = [1, 2, 7, 42, 63, 64, 97, 128, 202, 251, 256, 257, 1000, 8192]
TOL = 1e-5


def _input(n, real, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, n)).astype(np.float32)
    if not real:
        x = (x + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    return x


def _assert_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulation_matches_fft(n, inverse):
    x = _input(n, False, n)
    got = ref.fourstep_general_ref(torch.from_numpy(x), inverse).numpy()
    x64 = x.astype(np.complex128)
    _assert_close(got, np.fft.ifft(x64, axis=-1) if inverse else np.fft.fft(x64, axis=-1))


@pytest.mark.parametrize("n", LENGTHS)
def test_emulation_of_real_input_first_bins(n):
    x = _input(n, True, n + 1)
    got = ref.fourstep_general_ref(torch.from_numpy(x), nout=n // 2 + 1).numpy()
    _assert_close(got, np.fft.rfft(x.astype(np.float64), axis=-1))


@pytest.mark.parametrize("n", [42, 63, 64, 97])
@pytest.mark.parametrize("inverse", [False, True])
def test_emulation_matches_reference(n, inverse):
    x = _input(n, False, n + 2)
    got = ref.fourstep_general_ref(torch.from_numpy(x), inverse).numpy()
    _assert_close(got, np.asarray(jops.fft_matmul(jnp.asarray(x), inverse=inverse)))


def test_emulation_of_real_input_matches_reference():
    x = _input(64, True, 3)
    got = ref.fourstep_general_ref(torch.from_numpy(x), nout=33).numpy()
    _assert_close(got, np.asarray(jops.rfft_matmul(jnp.asarray(x))))


def _is_prime(n):
    return n > 1 and all(n % d for d in range(2, int(n ** 0.5) + 1))


def test_general_split_rule():
    for n in range(1, 9686):
        n1, n2 = ref.general_split(n)
        assert n1 * n2 == n and n1 >= n2 >= 1, n
        assert not any(n % d == 0 for d in range(n2 + 1, math.isqrt(n) + 1)), n
        if _is_prime(n):
            assert (n1, n2) == (n, 1)
        if n > 256:
            assert (n1, n2) == ops.plan_factors(n)


@pytest.mark.parametrize("n,split", [(42, (7, 6)), (63, (9, 7)), (64, (8, 8)), (256, (16, 16)),
                                     (97, (97, 1)), (202, (101, 2)), (1000, (40, 25)),
                                     (8192, (128, 64))])
def test_general_split_of_path_lengths(n, split):
    assert ref.general_split(n) == split


def test_general_split_leaves_the_design_choice_alone():
    """``plan_factors`` still gives (n, 1) up to 256, so the quickstart's
    lengths stay on the general design, and it still matches the
    reference's rule everywhere."""
    for n in range(1, 4097):
        ref.general_split(n)
        assert ops.plan_factors(n) == jops.plan_factors(n)
        if n <= 256:
            assert ops.plan_factors(n) == (n, 1)
            assert not ops.tensor_core_design(*ops.plan_factors(n))

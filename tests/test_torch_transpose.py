"""The port's local transpose (K5, repro_torch.kernels.transpose) against the
reference's ``transpose01`` (Pallas, interpret mode on the CPU), over the
shapes and types of tests/test_kernels.py's sweep: A and B in 1..24, C in
1..8, float32 and complex64.  A transpose moves values and computes none,
so the comparison is bitwise.  On a CPU tensor the wrapper takes the plain
version and launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.transpose.ops import transpose01 as jtranspose01
from repro_torch.kernels.transpose import ops

SHAPES = [(1, 1, 1), (24, 24, 8), (7, 13, 3), (8, 8, 1), (16, 5, 2), (3, 24, 8), (17, 9, 5),
          (24, 1, 7)]


@pytest.mark.parametrize("dt", ["float32", "complex64"])
@pytest.mark.parametrize("a,b,c", SHAPES)
def test_transpose01_matches_reference(a, b, c, dt):
    rng = np.random.default_rng(a * 100 + b)
    x = rng.standard_normal((a, b, c)).astype(dt)
    if dt == "complex64":
        x = (x + 1j * rng.standard_normal((a, b, c))).astype(dt)
    before = sum(ops.launches.values())
    got = ops.transpose01(torch.from_numpy(x))
    assert got.is_contiguous() and sum(ops.launches.values()) == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtranspose01(jnp.asarray(x))))
    np.testing.assert_array_equal(got.numpy(), x.swapaxes(0, 1))


def test_transpose01_rejects_other_ranks():
    with pytest.raises(ValueError):
        ops.transpose01(torch.zeros(2, 3))

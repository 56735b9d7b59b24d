"""The port's codecs (repro_torch.core.quant) against the reference's
(repro.core.quant) on the same numpy-seeded inputs.

Contract: bf16 payloads bitwise; int8 scales within 1 ULP (the reference's
XLA may compile the /127 as a reciprocal multiply) and payloads within one
quantum (a 1-ULP scale moves an exact half-way value by one step); the
guard counters equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq


def _data(shape, seed, specials=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[..., 0] *= 1e3  # blocks of very different magnitude
    if specials:
        x.flat[3], x.flat[7], x.flat[11] = np.nan, np.inf, -np.inf
    return x


@pytest.mark.parametrize("spec", [None, "complex64", "c64", "none", "bf16", "bfloat16",
                                  "int8", "BF16"])
def test_canonical_comm_dtype_and_wire_ratio(spec):
    assert tq.canonical_comm_dtype(spec) == jq.canonical_comm_dtype(spec)
    assert tq.wire_ratio(spec) == jq.wire_ratio(spec)


def test_unknown_comm_dtype_raises():
    with pytest.raises(ValueError):
        tq.canonical_comm_dtype("fp8")


def test_bf16_bitwise():
    x = _data((7, 33, 5), 0) * np.float32(3.7)
    got = tq.encode_bf16(torch.from_numpy(x)).view(torch.int16).numpy().view(np.uint16)
    want = np.asarray(jq.encode_bf16(jnp.asarray(x))).view(np.uint16)
    np.testing.assert_array_equal(got, want)
    back = tq.decode_bf16(tq.encode_bf16(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq.decode_bf16(jq.encode_bf16(jnp.asarray(x)))))


@pytest.mark.parametrize("shape,block_axis", [
    ((6, 8, 10), 0),
    ((6, 8, 10), -1),
    ((2, 6, 4, 3, 5), (1, 3)),
    ((2, 3, 4, 5), (0, 1, 2, 3)),
])
@pytest.mark.parametrize("specials", [False, True])
def test_int8_matches_reference(shape, block_axis, specials):
    x = _data(shape, len(shape), specials)
    q, s, st = tq.quantize_int8(torch.from_numpy(x), block_axis=block_axis, with_stats=True)
    jqq, js, jst = jq.quantize_int8(jnp.asarray(x), block_axis=block_axis, with_stats=True)
    js = np.asarray(js)
    assert s.shape == js.shape and s.dtype == torch.float32
    np.testing.assert_array_max_ulp(s.numpy(), js, maxulp=1)
    assert q.dtype == torch.int8
    assert np.max(np.abs(q.numpy().astype(np.int32) - np.asarray(jqq).astype(np.int32))) <= 1
    for k in ("nonfinite", "saturated"):
        assert float(st[k]) == float(jst[k])
    deq = tq.dequantize_int8(q, s).numpy()
    want = np.asarray(jq.dequantize_int8(jqq, jnp.asarray(js)))
    np.testing.assert_allclose(deq, want, rtol=0, atol=1.0 * float(js.max()) * 1.000001)


def test_int8_scale_div_and_all_zero_blocks():
    x = np.zeros((4, 6), np.float32)
    x[1] = _data((6,), 3)
    q, s = tq.quantize_int8(torch.from_numpy(x), block_axis=0, scale_div=4.0)
    jqq, js = jq.quantize_int8(jnp.asarray(x), block_axis=0, scale_div=4.0)
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    assert float(s[0, 0]) == pytest.approx(1e-12 / 127 / 4)


def test_planes_roundtrip():
    rng = np.random.default_rng(5)
    y = (rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))).astype(np.complex64)
    p = tq.complex_to_planes(torch.from_numpy(y))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jq.complex_to_planes(jnp.asarray(y))))
    np.testing.assert_array_equal(tq.planes_to_complex(p).numpy(), y)

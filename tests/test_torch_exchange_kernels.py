"""The plain versions of the port's exchange kernels
(repro_torch.kernels.exchange) against the reference's Pallas kernels
(repro.kernels.exchange, interpret mode on the CPU), over the
parametrisation of tests/test_exchange_kernels.py.

Tolerance: bf16 payloads and decodes bitwise; int8 scales within 1 ULP,
payloads within one quantum and decodes within 1.25 quanta (max |x| / 127),
as in tests/test_exchange_kernels.py.  Guard counts (non-finite, saturated)
equal the reference kernel's exactly: they are integers far below 2^24.  On a CPU tensor the wrappers
(``ops``) take the plain version and launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import exchange as jx
from repro_torch.kernels.exchange import ops as tx


def _rand(shape, iscomplex, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if iscomplex:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


def _quantum(y):
    return float(np.max(np.abs(np.stack([np.real(y), np.imag(y)])))) / 127.0


def _payload(t):
    """A payload as numpy in a form both frameworks share."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jpayload(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _check_payload(got, want, codec):
    got, want = _payload(got), _jpayload(want)
    assert got.shape == want.shape
    if codec == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.max(np.abs(got.astype(np.int32) - want.astype(np.int32))) <= 1


def _check_block(got, want, codec, y):
    want = np.asarray(want)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    if codec == "bf16":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1.25 * _quantum(y), rtol=0)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("iscomplex", [True, False])
@pytest.mark.parametrize("shape,axis,m,nbatch", [
    ((6, 8, 10), 1, 4, 0),
    ((8, 6, 10), 0, 2, 0),
    ((3, 6, 8, 10), 2, 4, 1),
])
def test_encode_decode_match_reference(codec, iscomplex, shape, axis, m, nbatch):
    y = _rand(shape, iscomplex, seed=axis + m)
    before = sum(tx.launches.values())
    q, s, st = tx.encode_payload(torch.from_numpy(y), axis=axis, m=m, nbatch=nbatch, codec=codec)
    jqq, js, _ = jx.encode_payload(jnp.asarray(y), axis=axis, m=m, nbatch=nbatch, codec=codec)
    _check_payload(q, jqq, codec)
    assert st is None
    if codec == "int8":
        assert s.shape == (int(np.prod(shape[:nbatch])), m)
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    else:
        assert s is None and js is None
    out = tx.decode_payload(q, axis=axis, m=m, nbatch=nbatch, scale=s, codec=codec,
                            iscomplex=iscomplex)
    want = jx.decode_payload(jqq, axis=axis, m=m, nbatch=nbatch, scale=js, codec=codec,
                             iscomplex=iscomplex)
    _check_block(out, want, codec, y)
    assert sum(tx.launches.values()) == before  # a CPU tensor launches no kernel


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("iscomplex", [True, False])
@pytest.mark.parametrize("shape,v,w,m,nbatch", [
    ((8, 6, 10), 0, 2, 4, 0),     # scatter axis after the chunk source
    ((6, 10, 8), 2, 0, 2, 0),     # w < v: the other scatter order
    ((3, 8, 6, 10), 0, 1, 4, 1),  # stacked fields
])
def test_pack_unpack_match_reference(codec, iscomplex, shape, v, w, m, nbatch):
    y = _rand(shape, iscomplex, seed=v * 10 + w)
    bv = v + nbatch
    q, s, _ = tx.pack_chunks(torch.from_numpy(y), axis=bv, m=m, nbatch=nbatch, codec=codec)
    jqq, js, _ = jx.pack_chunks(jnp.asarray(y), axis=bv, m=m, nbatch=nbatch, codec=codec)
    _check_payload(q, jqq, codec)
    if codec == "int8":
        assert s.shape == (m, int(np.prod(shape[:nbatch])))
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    out = tx.unpack_chunks(q, v=v, w=w, m=m, nbatch=nbatch, scale=s, codec=codec,
                           iscomplex=iscomplex)
    want = jx.unpack_chunks(jqq, v=v, w=w, m=m, nbatch=nbatch, scale=js, codec=codec,
                            iscomplex=iscomplex)
    _check_block(out, want, codec, y)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("scale_div", [None, 64.0])
@pytest.mark.parametrize("wrapper", ["encode_payload", "pack_chunks"])
def test_guard_counts_match_reference(codec, scale_div, wrapper):
    """K1's guard mode: per-(field, chunk) counts summed, with non-finite
    inputs and with the saturation fault's scale divisor."""
    y = _rand((3, 8, 6, 10), True, seed=5)
    y.reshape(-1)[[0, 77, 400]] = [np.nan, np.inf, -np.inf + 1j]
    kw = dict(axis=1, m=4, nbatch=1, codec=codec, guard=True, scale_div=scale_div)
    q, s, st = getattr(tx, wrapper)(torch.from_numpy(y), **kw)
    jq, js, jst = getattr(jx, wrapper)(jnp.asarray(y), **kw)
    # as floats: a NaN's bf16 bit pattern differs between the frameworks
    got, want = q.float().numpy(), np.asarray(jq).astype(np.float32)
    if codec == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.max(np.abs(got - want)) <= 1
    for key in ("nonfinite", "saturated"):
        assert st[key].dtype == torch.float32
        assert float(st[key]) == float(jst[key]), key
    assert float(st["nonfinite"]) == 3
    if codec == "int8":
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
        assert float(st["saturated"]) > (100 if scale_div else 0)


def test_indivisible_chunk_axis_raises():
    with pytest.raises(ValueError):
        tx.pack_chunks(torch.zeros(6, 5), axis=1, m=2, codec="bf16")

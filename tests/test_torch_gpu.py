"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is false
(decided inside the test, never at import).  On a machine with a card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Tolerances: bf16 payloads and decodes are bitwise; int8 scales are equal and
payloads within one quantum; the four-step DFT is f32 FMA arithmetic in
another order than the plain matmuls, held to 1e-5 of the output's max.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.exchange import ops as xops, ref as xref
from repro_torch.kernels.fft import ops as fops, ref as fref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(shape, iscomplex, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if iscomplex:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("n", [1, 7, 42, 63, 64, 256, 257, 512, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_matches_plain(cuda, n, inverse):
    x = _rand((33, n), True, n, cuda)
    got = fops.fft_matmul(x, inverse=inverse)
    n1, n2 = fops.plan_factors(n)
    xc = x.conj() if inverse else x
    want = fref.fourstep_ref(xc, n1, n2)
    want = want.conj() / n if inverse else want
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fourstep_axes_and_rfft(cuda, axis):
    x = _rand((6, 10, 9), False, axis, cuda)
    got = fops.rfft_matmul(x, axis=axis)
    want = torch.fft.rfft(x.double(), dim=axis)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    back = fops.irfft_matmul(got, n=x.shape[axis], axis=axis)
    assert (back - x).abs().max().item() <= 1e-5 * x.abs().max().item()


def _assert_codec(got, want, codec, quantum):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    if codec == "bf16":
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1.25 * quantum


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("iscomplex", [True, False])
@pytest.mark.parametrize("shape,v,w,m,nbatch", [
    ((8, 6, 10), 0, 2, 4, 0),
    ((6, 10, 8), 2, 0, 2, 0),
    ((3, 8, 6, 10), 0, 1, 4, 1),
    ((4, 8, 5), 1, 0, 1, 0),
])
def test_exchange_kernels_match_plain(cuda, codec, iscomplex, shape, v, w, m, nbatch):
    y = _rand(shape, iscomplex, v * 10 + w, cuda)
    bv = v + nbatch
    quantum = torch.view_as_real(y).abs().max().item() / 127.0 if iscomplex else \
        y.abs().max().item() / 127.0

    q, s = xops.pack_chunks(y, axis=bv, m=m, nbatch=nbatch, codec=codec)
    qr, sr = xref.pack_chunks_ref(y, axis=bv, m=m, nbatch=nbatch, codec=codec)
    _assert_codec(q.float(), qr.float(), codec, 1.0)
    if codec == "int8":
        assert torch.equal(s, sr)
    out = xops.unpack_chunks(qr, v=v, w=w, m=m, nbatch=nbatch, scale=sr, codec=codec,
                             iscomplex=iscomplex)
    want = xref.unpack_chunks_ref(qr, v=v, w=w, m=m, nbatch=nbatch, scale=sr, codec=codec,
                                  iscomplex=iscomplex)
    _assert_codec(out, want, "bf16", quantum)  # same payload: decode is exact

    q, s = xops.encode_payload(y, axis=bv, m=m, nbatch=nbatch, codec=codec)
    qr, sr = xref.encode_payload_ref(y, axis=bv, m=m, nbatch=nbatch, codec=codec)
    _assert_codec(q.float(), qr.float(), codec, 1.0)
    if codec == "int8":
        assert torch.equal(s, sr)
    out = xops.decode_payload(qr, axis=bv, m=m, nbatch=nbatch, scale=sr, codec=codec,
                              iscomplex=iscomplex)
    want = xref.decode_payload_ref(qr, axis=bv, m=m, nbatch=nbatch, scale=sr, codec=codec,
                                   iscomplex=iscomplex)
    _assert_codec(out, want, "bf16", quantum)

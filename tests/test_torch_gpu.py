"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is false
(decided inside the test, never at import).  On a machine with a card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Tolerances: bf16 payloads and decodes are bitwise; int8 scales are equal and
payloads within one quantum; a decode of one payload is bitwise in both
codecs and both designs; the four-step DFT is f32 FMA (general
design) or 3xTF32 tensor-core arithmetic (n1, n2 multiples of 8, at most
64) in another order than the plain matmuls, held to 1e-5 of the output's
max.
The encode's guard mode (counts and ``scale_div``) is held to the plain
version exactly: same payload and scale bits, same counts.  The transpose
moves values, so it is bitwise.  The flash attention (K6) is held to
2e-4 in fp32 (``tests/test_flash.py``'s own limit) and in bf16 to
2^-7 |plain| + 2^-8 max|v|: one bf16 ulp of the output plus twice the
bound of the kernel's rounding of p to bf16, which the plain version does
not round; bf16 runs the tensor-core design, fp32 the FMA design, and
the bf16 kernel is also held to the CPU emulation of its tiles.  The
traditional engine's transposed-out exchange with ``impl="cuda"`` on a
1-rank NCCL group launches the pack and unpack kernels and matches the
plain codec's path (bf16 bitwise, int8 within one quantum, equal stats);
so does its int8 exchange of stacked fields, each field within one of its
own quanta.  Batched plans: the DNS plan's stacked and per-field forwards
are bitwise equal (lossless), 3 stacked 512^3 fields through int8 stay
within the plan's 3e-2 bound each with one field at 1e3, and every K1/K3
launch of a stacked 512^3 forward is ``vec``.  The example twins at the
examples' sizes on a 1-rank NCCL group hold the examples' checks (a K4 DNS
run's energies within 1e-5 of cuFFT's, a bf16 wire's within its rounding
bound), and every example plan audits clean.
"""

import math
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels.exchange import kernel as xkernel, ops as xops, ref as xref
from repro_torch.kernels.fft import ops as fops, ref as fref
from repro_torch.kernels.flash import ops as flops, ref as flref
from repro_torch.kernels.transpose import ops as tops, ref as tref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A (1, 1) mesh on a 1-rank NCCL group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from repro_torch.core.meshutil import make_mesh

    init = tmp_path_factory.mktemp("nccl") / "pg"
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("p0", "p1"))
    finally:
        dist.destroy_process_group()


def _rand(shape, iscomplex, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if iscomplex:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(x).to(device)


def _fourstep_plain(x, inverse=False):
    n = x.shape[-1]
    n1, n2 = fops.plan_factors(n)
    xc = x.conj() if inverse else x
    want = fref.fourstep_ref(xc.to(torch.complex64), n1, n2)
    return want.conj() / n if inverse else want


def _assert_k4(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("n", [1, 7, 42, 63, 64, 256, 257, 512, 1024, 2048, 4096,
                               97, 202, 251, 1000, 8192])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_matches_plain(cuda, n, inverse):
    x = _rand((33, n), True, n, cuda)
    _assert_k4(fops.fft_matmul(x, inverse=inverse), _fourstep_plain(x, inverse))


@pytest.mark.parametrize("n", [512, 4096])
def test_fourstep_rfft_first_bins(cuda, n):
    """Real input and nout = n // 2 + 1 < n on the tensor-core design."""
    x = _rand((33, n), False, n + 1, cuda)
    _assert_k4(fops.rfft_matmul(x), _fourstep_plain(x)[:, : n // 2 + 1])


@pytest.mark.parametrize("batch", [1, 13, 2646, 5000])
@pytest.mark.parametrize("n", [512, 1024, 63, 64])
def test_fourstep_ragged_batch(cuda, n, batch):
    """A batch that is no multiple of the rows a group takes (8 at 512, 4
    at 1024; the general design's 8 rows a block at 2646 rows, 16 at 5000):
    the last group's missing rows write nothing."""
    x = _rand((batch, n), True, n + batch, cuda)
    _assert_k4(fops.fft_matmul(x), _fourstep_plain(x))
    _assert_k4(fops.fft_matmul(x, inverse=True), _fourstep_plain(x, True))


@pytest.mark.parametrize("n", [512, 4096, 257, 64])
def test_fourstep_propagates_nonfinite(cuda, n):
    """A NaN or Inf in a row leaves that row non-finite and the others as
    they were (a guarded plan relies on it): NaN bit patterns with a high
    mantissa must not round to a finite TF32 value."""
    x = _rand((9, n), True, n + 2, cuda)
    want = fops.fft_matmul(x)
    bad = torch.view_as_real(x).view(torch.int32)
    bad[2, 5, 0] = 0x7FFFFFFF                # NaN, all mantissa bits set
    bad[4, 0, 1] = 0x7F800000                # +Inf
    bad[6, n - 1, 0] = -4096                 # 0xFFFFF000: a NaN that + 0x1000 wraps to +0
    got = fops.fft_matmul(x)
    torch.cuda.synchronize()
    finite = torch.isfinite(torch.view_as_real(got)).all(dim=-1).all(dim=-1)
    assert not finite[2] and not finite[4] and not finite[6]
    ok = [0, 1, 3, 5, 7, 8]
    assert torch.equal(got[ok], want[ok])


@pytest.mark.parametrize("n,design", [(512, "tc"), (4096, "tc"), (257, "general"),
                                      (1000, "general"), (64, "general"), (8192, "general")])
def test_fourstep_design_by_length(cuda, n, design):
    x = _rand((4, n), True, n, cuda)
    before = Counter(fops.design_launches)
    fops.fft_matmul(x)
    fops.rfft_matmul(x.real.contiguous())
    torch.cuda.synchronize()
    assert fops.design_launches - before == Counter({f"{design}:fft": 1, f"{design}:rfft": 1})


def test_fourstep_nonfinite_stays_in_its_row(cuda):
    """The general design at the quickstart's 2646 rows of n = 64 takes 8
    rows a block: a NaN and an Inf in two rows of the first block leave
    the block's other rows bitwise as they were."""
    x = _rand((2646, 64), True, 5, cuda)
    want = fops.fft_matmul(x)
    bad = torch.view_as_real(x).view(torch.int32)
    bad[2, 9, 1] = 0x7FC00000                # NaN
    bad[5, 63, 0] = -8388608                 # 0xFF800000: -Inf
    got = fops.fft_matmul(x)
    torch.cuda.synchronize()
    finite = torch.isfinite(torch.view_as_real(got)).all(dim=-1).all(dim=-1)
    assert not finite[2] and not finite[5]
    ok = torch.ones(2646, dtype=torch.bool, device=cuda)
    ok[2] = ok[5] = False
    assert torch.equal(got[ok], want[ok])


def test_fourstep_general_split_matches_c(cuda):
    """The C side's split of every length a general block holds is
    ``ref.general_split``'s."""
    from repro_torch.kernels.fft import kernel as fkernel

    for n in range(1, 9686):
        assert fkernel.general_split(n) == fref.general_split(n), n


@pytest.mark.parametrize("n", [42, 63, 64, 97, 256, 1000])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_general_matches_its_emulation(cuda, n, inverse):
    """The general design against ``ref.fourstep_general_ref``, the CPU
    emulation of its split, roots and FMA order, within 1e-6 of max |y|:
    a root may round the other way in its last bit (numpy's exp against
    the card's sincospi) and the emulation's FMA rounds twice."""
    x = _rand((21, n), True, n + 3, cuda)
    got = fops.fft_matmul(x, inverse=inverse)
    want = fref.fourstep_general_ref(x.cpu(), inverse).to(cuda)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fourstep_axes_and_rfft(cuda, axis):
    x = _rand((6, 10, 9), False, axis, cuda)
    got = fops.rfft_matmul(x, axis=axis)
    want = torch.fft.rfft(x.double(), dim=axis)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    back = fops.irfft_matmul(got, n=x.shape[axis], axis=axis)
    assert (back - x).abs().max().item() <= 1e-5 * x.abs().max().item()


# K1's tiles and designs: a scale block of 7 tiles (the last ragged) and one
# of 3 tiles with runs 720 floats apart that cross tile edges, both "vec";
# odd S and S * P below one vector, both "scalar"
K1_SHAPES = [((40, 33, 20), 1, 0, 1, 0), ((24, 40, 36), 1, 0, 4, 0),
             ((6, 5, 7), 1, 0, 1, 0), ((16, 3, 1), 2, 0, 1, 0)]


def _k1_last_tile(y, m, v, nbatch):
    """Put the block's max |x| in the last tile of the last scale block
    where a scale block spans several tiles; returns the design the wrapper
    should pick (``xref.tile_design`` on a fresh, aligned block)."""
    P = 2 if y.is_complex() else 1
    F, O, M, S = xops._chunk_view(y.shape, v + nbatch, m, nbatch)
    if O * S * P > xref.TILE:
        flat = y.view(-1)
        flat[-2] = 50.0
    return xref.tile_design(F, O, M, S, P, 1, 0, 0)


def _k1_designs(fn, counter=None):
    """``(fn(), designs)``: the encode designs that one call of ``fn`` ran
    (the decode's with ``counter=xops.decode_design_launches``)."""
    counter = xops.design_launches if counter is None else counter
    before = Counter(counter)
    out = fn()
    return out, {d.split(":")[0] for d in counter - before}


def _k3_designs(fn):
    return _k1_designs(fn, xops.decode_design_launches)


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
] + K1_SHAPES)
def test_exchange_kernels_match_plain(cuda, codec, iscomplex, shape, v, w, m, nbatch):
    y = _rand(shape, iscomplex, v * 10 + w, cuda)
    design = _k1_last_tile(y, m, v, nbatch)
    bv = v + nbatch
    quantum = torch.view_as_real(y).abs().max().item() / 127.0 if iscomplex else \
        y.abs().max().item() / 127.0

    (q, s, _), ran = _k1_designs(
        lambda: xops.pack_chunks(y, axis=bv, m=m, nbatch=nbatch, codec=codec))
    assert ran == {design}
    qr, sr, _ = xref.pack_chunks_ref(y, axis=bv, m=m, nbatch=nbatch, codec=codec)
    _assert_codec(q.float(), qr.float(), codec, 1.0)
    if codec == "int8":
        assert torch.equal(s, sr)
    out, ran = _k3_designs(lambda: xops.unpack_chunks(qr, v=v, w=w, m=m, nbatch=nbatch,
                                                      scale=sr, codec=codec, iscomplex=iscomplex))
    P = 2 if iscomplex else 1
    assert ran == {xref.tile_design(*xops._chunk_view(out.shape, w + nbatch, m, nbatch), P, 1, 0,
                                    0)}
    want = xref.unpack_chunks_ref(qr, v=v, w=w, m=m, nbatch=nbatch, scale=sr, codec=codec,
                                  iscomplex=iscomplex)
    _assert_codec(out, want, "bf16", quantum)  # same payload: decode is exact

    (q, s, _), ran = _k1_designs(
        lambda: xops.encode_payload(y, axis=bv, m=m, nbatch=nbatch, codec=codec))
    assert ran == {design}
    qr, sr, _ = xref.encode_payload_ref(y, axis=bv, m=m, nbatch=nbatch, codec=codec)
    _assert_codec(q.float(), qr.float(), codec, 1.0)
    if codec == "int8":
        assert torch.equal(s, sr)
    out, ran = _k3_designs(lambda: xops.decode_payload(qr, axis=bv, m=m, nbatch=nbatch, scale=sr,
                                                       codec=codec, iscomplex=iscomplex))
    assert ran == {design}
    want = xref.decode_payload_ref(qr, axis=bv, m=m, nbatch=nbatch, scale=sr, codec=codec,
                                   iscomplex=iscomplex)
    _assert_codec(out, want, "bf16", quantum)


@pytest.mark.parametrize("scale_div", [None, 64.0])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("iscomplex", [True, False])
@pytest.mark.parametrize("shape,v,w,m,nbatch", [
    ((8, 6, 10), 0, 2, 4, 0),
    ((6, 10, 8), 2, 0, 2, 0),
    ((3, 8, 6, 10), 0, 1, 4, 1),
    ((4, 8, 5), 1, 0, 1, 0),
] + K1_SHAPES)
def test_exchange_guard_mode_matches_plain(cuda, codec, iscomplex, shape, v, w, m, nbatch,
                                           scale_div):
    y = _rand(shape, iscomplex, v * 10 + w + 1, cuda)
    design = _k1_last_tile(y, m, v, nbatch)
    flat = y.view(-1)
    flat[3] = float("nan")
    flat[-1] = float("inf")
    if flat.numel() > 2 * xref.TILE:  # a NaN in the last tile too, not an Inf
        flat[3], flat[-3] = 0.5, float("nan")
    bv = v + nbatch
    kw = dict(axis=bv, m=m, nbatch=nbatch, codec=codec, scale_div=scale_div)
    for wrapper, plain in ((xops.pack_chunks, xref.pack_chunks_ref),
                           (xops.encode_payload, xref.encode_payload_ref)):
        (q, s, st), ran = _k1_designs(lambda wrapper=wrapper: wrapper(y, guard=True, **kw))
        assert ran == {design}
        q0, s0, st0 = wrapper(y, guard=False, **kw)
        qr, sr, str_ = plain(y, guard=True, **kw)
        torch.cuda.synchronize()
        # guard mode writes the unguarded payload, bit for bit
        bits = (lambda t: t.view(torch.int16)) if codec == "bf16" else (lambda t: t)
        assert st0 is None and torch.equal(bits(q), bits(q0))
        if codec == "int8":
            assert torch.equal(q, qr) and torch.equal(s, sr) and torch.equal(s, s0)
        else:  # a NaN's bf16 bits may differ between the two: compare values
            assert torch.equal(q.float().nan_to_num(), qr.float().nan_to_num())
        for key in ("nonfinite", "saturated"):
            assert st[key].dtype == torch.float32
            assert st[key].item() == str_[key].item(), (wrapper.__name__, key)
        assert st["nonfinite"].item() == 2


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32])
def test_exchange_encode_unaligned_block_runs_scalar(cuda, codec, dtype):
    """A contiguous block at a storage offset off 16-byte alignment: the
    wrapper picks the scalar design, whose payload is the plain version's."""
    shape = (8, 6, 16)
    y0 = _rand(shape, dtype == torch.complex64, 11, cuda)
    base = torch.empty(y0.numel() + 1, dtype=dtype, device=cuda)
    y = base[1:].view(shape)
    y.copy_(y0)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    for wrapper, plain in ((xops.pack_chunks, xref.pack_chunks_ref),
                           (xops.encode_payload, xref.encode_payload_ref)):
        (q, s, _), ran = _k1_designs(lambda wrapper=wrapper: wrapper(y, axis=1, m=2, codec=codec))
        qr, sr, _ = plain(y0, axis=1, m=2, codec=codec)
        assert ran == {"scalar"}
        _assert_codec(q.float(), qr.float(), codec, 1.0)
        if codec == "int8":
            assert torch.equal(s, sr)


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32])
def test_exchange_decode_unaligned_block_runs_scalar(cuda, codec, dtype, layout):
    """A decode into a block at a storage offset off 16-byte alignment runs
    the scalar design, and its block is the plain version's, bit for bit."""
    shape, axis, m = (8, 6, 16), 1, 2
    y = _rand(shape, dtype == torch.complex64, 13, cuda)
    if layout == 0:
        q, s, _ = xref.encode_payload_ref(y, axis=axis, m=m, codec=codec)
        want = xref.decode_payload_ref(q, axis=axis, m=m, scale=s, codec=codec,
                                       iscomplex=y.is_complex())
    else:
        q, s, _ = xref.pack_chunks_ref(y, axis=2, m=m, codec=codec)
        want = xref.unpack_chunks_ref(q, v=2, w=axis, m=m, scale=s, codec=codec,
                                      iscomplex=y.is_complex())
    base = torch.empty(want.numel() + 1, dtype=dtype, device=cuda)
    out = base[1:].view(want.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    got, design = xkernel.decode(q.contiguous(), s, out, *xops._chunk_view(want.shape, axis, m, 0),
                                 codec=codec, layout=layout)
    torch.cuda.synchronize()
    assert design == "scalar" and got is out
    assert torch.equal(torch.view_as_real(got) if got.is_complex() else got,
                       torch.view_as_real(want) if want.is_complex() else want)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_exchange_decode_refuses_vec_off_its_rule(cuda, codec, monkeypatch):
    """``design=vec`` where S % 4 != 0: ``exchange_decode`` returns an error
    and the wrapper raises it (no fallback to another design)."""
    y = _rand((6, 5, 7), True, 17, cuda)
    q, s, _ = xref.encode_payload_ref(y, axis=1, m=1, codec=codec)
    F, O, M, S = xops._chunk_view(y.shape, 1, 1, 0)
    assert S % 4 != 0
    monkeypatch.setattr(xkernel, "tile_design", lambda *a: "vec")
    with pytest.raises(RuntimeError, match=r"exchange_decode \(vec design\) failed"):
        xkernel.decode(q.contiguous(), s, torch.empty_like(y), F, O, M, S, codec=codec,
                       layout=xkernel.IN_PLACE)


def _k5_design(fn):
    """``(fn(), design)``: the one K5 design that ``fn``'s launch ran."""
    before = Counter(tops.design_launches)
    out = fn()
    ran = {k.split(":")[1] for k in (Counter(tops.design_launches) - before)}
    assert len(ran) == 1, ran
    return out, ran.pop()


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("shape", [(1, 1, 1), (24, 24, 8), (7, 13, 3), (64, 48, 40),
                                   (512, 33, 1), (5, 7, 1025), (3, 2, 5000), (64, 4, 128),
                                   (8, 8, 512), (128, 64, 1), (9, 9, 16), (9, 9, 14),
                                   (70, 33, 35), (2, 3, 300000)])
def test_transpose01_matches_plain(cuda, dtype, shape):
    """Both designs, each where ``ref.transpose_design`` puts it, bitwise."""
    x = _rand(shape, dtype == torch.complex64, sum(shape), cuda)
    got, design = _k5_design(lambda: tops.transpose01(x))
    torch.cuda.synchronize()
    assert got.shape == (shape[1], shape[0], shape[2]) and got.dtype == dtype
    assert design == tref.transpose_design(*shape, x.element_size(), x.data_ptr() % 16,
                                           got.data_ptr() % 16)
    assert torch.equal(got, x.transpose(0, 1).contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("shape", [(512, 64, 32), (16, 16, 512)])
def test_transpose01_unaligned_runs_tile(cuda, dtype, shape):
    """x at an odd storage offset (off 16-byte alignment): the tile design,
    bitwise, on shapes whose aligned x runs rows."""
    x0 = _rand(shape, dtype == torch.complex64, 3, cuda)
    base = torch.empty(x0.numel() + 1, dtype=dtype, device=cuda)
    x = base[1:].view(shape)
    x.copy_(x0)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert tref.transpose_design(*shape, x.element_size(), 0, 0) == "rows"
    got, design = _k5_design(lambda: tops.transpose01(x))
    torch.cuda.synchronize()
    assert design == "tile" and torch.equal(got, x0.transpose(0, 1).contiguous())


def test_transpose01_refuses_rows_off_its_rule(cuda, monkeypatch):
    """``design=rows`` on 64-byte rows: ``transpose01`` returns an error
    and the wrapper raises it (no fallback to the other design)."""
    from repro_torch.kernels.transpose import kernel as tkernel

    x = _rand((24, 24, 8), True, 5, cuda)
    monkeypatch.setattr(tkernel, "transpose_design", lambda *a: "rows")
    with pytest.raises(RuntimeError, match=r"transpose01 \(rows design\) failed"):
        tkernel.transpose01(x)


def test_transpose01_c_rule_and_plan_match_ref(cuda):
    """The C side's rule and launch are ``ref.transpose_design``'s and
    ``ref.transpose_plan``'s over a grid that crosses every boundary."""
    from repro_torch.kernels.transpose import kernel as tkernel

    for A, B in ((1, 1), (9, 9), (512, 33), (2 ** 14, 2 ** 14 - 1), (2 ** 14, 2 ** 14)):
        for C in (1, 2, 3, 5, 14, 16, 17, 18, 28, 32, 33, 35, 36, 40, 128, 512, 1025, 5000,
                  2 ** 20, 2 ** 32 - 2, 2 ** 32):
            for elem in (4, 8):
                for xm, ym in ((0, 0), (8, 0), (4, 0), (0, 8)):
                    want = tref.transpose_design(A, B, C, elem, xm, ym)
                    assert tkernel.c_design(A, B, C, elem, xm, ym) == want, (A, B, C, elem, xm)
                for design in {"tile", tref.transpose_design(A, B, C, elem, 0, 0)}:
                    assert tkernel.c_plan(A, B, C, elem, design) == \
                        tref.transpose_plan(A, B, C, elem, design), (A, B, C, elem, design)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("v,w,group", [(2, 1, "p1"), (0, 2, "p0")])
def test_traditional_transposed_out_takes_the_kernels(mesh1, codec, v, w, group):
    from repro_torch.core.redistribute import exchange_shard

    y = _rand((8, 6, 10), True, 11 * v + w, "cuda")
    kw = dict(mesh=mesh1, method="traditional", transposed_out=True, comm_dtype=codec,
              guard=True)
    before = Counter(xops.launches)
    got, st = exchange_shard(y, v, w, group, impl="cuda", **kw)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in xops.launches.items() if n != before[k]}
    assert launched == {f"pack_chunks:{codec}:guard": xops.ENCODE_KERNELS[codec],
                        f"unpack_chunks:{codec}": 1}
    want, st_want = exchange_shard(y, v, w, group, impl="torch", **kw)
    assert got.shape == (1, *y.shape)  # chunk-major: (M, ...) with M = 1
    quantum = torch.view_as_real(y).abs().max().item() / 127.0
    _assert_codec(got, want, codec, quantum)
    for key in ("nonfinite", "saturated"):
        assert st[key].item() == st_want[key].item()


@pytest.mark.parametrize("tout", [False, True])
def test_traditional_int8_stacked_fields_take_the_kernels(mesh1, tout):
    """The traditional engine's int8 exchange of 3 stacked fields (field 1
    at 1e3), plain and transposed out, through K1 and K3: one scale per
    (chunk, field), each field within one of its quanta of the plain codec."""
    from repro_torch.core.redistribute import exchange_shard

    y = _rand((3, 8, 6, 12), True, 21, "cuda")
    y[1] *= 1e3
    kw = dict(mesh=mesh1, method="traditional", transposed_out=tout, comm_dtype="int8",
              nbatch=1)
    before = Counter(xops.launches)
    got = exchange_shard(y, 2, 1, "p1", impl="cuda", **kw)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in xops.launches.items() if n != before[k]}
    assert launched == {"pack_chunks:int8": 2, "unpack_chunks:int8": 1}
    want = exchange_shard(y, 2, 1, "p1", impl="torch", **kw)
    assert got.shape == want.shape == ((1, 3, 8, 6, 12) if tout else (3, 8, 6, 12))
    for f in range(3):
        quantum = torch.view_as_real(y[f]).abs().max().item() / 127.0
        _assert_codec(got.select(int(tout), f), want.select(int(tout), f), "int8", quantum)


def _dns_plan(mesh, fusion, comm="complex64"):
    """examples/navier_stokes.py's plan at 384^3 with 256 retained modes."""
    from repro_torch.core.fftcore import TransformSpec
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig

    return ParallelFFT(mesh, (384, 384, 384), ("p0", "p1"),
                       config=PlanConfig(impl="matmul", exchange_impl="cuda", comm_dtype=comm,
                                         batch_fusion=fusion),
                       transforms=(TransformSpec.pruned(256), TransformSpec.pruned(256),
                                   TransformSpec.r2c(n_keep=129)))


def test_dns_plan_stacked_equals_per_field(mesh1):
    """Lossless: the 3-field stacked and per-field forwards of the DNS plan
    are bitwise equal, and equal to the single-field forwards."""
    u = torch.randn((3, 384, 384, 384), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    stacked = _dns_plan(mesh1, "stacked")
    a = stacked.forward_many_padded(3)(u)
    b = _dns_plan(mesh1, "per-field").forward_many_padded(3)(u)
    assert a.shape == (3, 256, 256, 129)
    assert torch.equal(a, b)
    assert torch.equal(a[2], stacked.forward_padded(u[2]))


@pytest.mark.parametrize("method", ["pipelined", "traditional"])
def test_impl_torch_lossless_contracts_at_384(mesh1, method):
    """Under ``impl="torch"`` (cuFFT) at n = 384, where cuFFT along a strided
    axis rounds by the other axes' extents: the lossless engine equals the
    fused one bitwise (4 slices when pipelined), and a 2-field batch equals
    the per-field loop bitwise under every batch_fusion."""
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig

    shape = (384, 384, 384)
    x = torch.randn((2, *shape), dtype=torch.complex64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    fused = ParallelFFT(mesh1, shape, ("p0", "p1"), config=PlanConfig(impl="torch"))
    plan = ParallelFFT(mesh1, shape, ("p0", "p1"),
                       config=PlanConfig(impl="torch", method=method, chunks=4))
    y = fused.forward_padded(x[0])
    assert torch.equal(plan.forward_padded(x[0]), y)
    assert torch.equal(plan.backward_padded(y), fused.backward_padded(y))
    loop = torch.stack([plan.forward_padded(f) for f in x])
    for fusion in ("stacked", "pipelined-across-fields", "per-field"):
        p = ParallelFFT(mesh1, shape, ("p0", "p1"),
                        config=PlanConfig(impl="torch", method=method, chunks=4,
                                          batch_fusion=fusion))
        assert torch.equal(p.forward_many_padded(2)(x), loop), fusion


def test_trig_matmul_rows_independent_of_row_count_on_the_card(cuda):
    """cuBLAS rounds a row of a plain matmul by the row count; the DCT/DST
    matmul's fixed blocks of rows give each row the same bits."""
    b = fops.TRIG_ROWS
    x = torch.randn(2 * b + 700, 384, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    whole = fops.dct_matmul(x, axis=-1)
    for lo, hi in ((0, 1), (3, 700), (1000, 5000), (b - 5, b + 9), (b + 1, 2 * b + 700),
                   (2 * b + 699, 2 * b + 700)):
        assert torch.equal(fops.dct_matmul(x[lo:hi], axis=-1), whole[lo:hi]), (lo, hi)


def _stacked_512(scale_1=1e3):
    x = torch.randn((3, 512, 512, 512), dtype=torch.complex64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    x[1] *= scale_1
    return x


def test_int8_stacked_forward_keeps_per_field_scales(mesh1):
    """3 stacked 512^3 fields, field 1 at 1e3, through an int8 wire: each
    field within the int8 plan bound (3e-2 relative L2, chip_smoke's
    TOL_FWD) of torch.fft.fftn and of its own single-field forward."""
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig

    x = _stacked_512()
    plan = ParallelFFT(mesh1, (512, 512, 512), ("p0", "p1"),
                       config=PlanConfig(impl="matmul", exchange_impl="cuda", comm_dtype="int8"))
    y = plan.forward_many_padded(3)(x)
    for f in range(3):
        for want in (torch.fft.fftn(x[f]), plan.forward_padded(x[f])):
            rel = (torch.linalg.vector_norm(y[f] - want) / torch.linalg.vector_norm(want)).item()
            assert rel <= 3e-2, (f, rel)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_stacked_512_codec_launches_are_vec(mesh1, codec):
    """Every K1 and K3 launch of a 3-field stacked 512^3 forward runs the
    vec design (S % 4 == 0, fresh aligned storage)."""
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig

    x = _stacked_512(1.0)
    plan = ParallelFFT(mesh1, (512, 512, 512), ("p0", "p1"),
                       config=PlanConfig(impl="matmul", exchange_impl="cuda", comm_dtype=codec))
    enc, dec = Counter(xops.design_launches), Counter(xops.decode_design_launches)
    plan.forward_many_padded(3)(x)
    torch.cuda.synchronize()
    enc = {k: n - enc[k] for k, n in xops.design_launches.items() if n != enc[k]}
    dec = {k: n - dec[k] for k, n in xops.decode_design_launches.items() if n != dec[k]}
    assert enc == {f"vec:{codec}": 2 * xops.ENCODE_KERNELS[codec]}
    assert dec == {f"vec:{codec}": 2}


def _flash_limit(want, v):
    """K6's limit: 2e-4 in fp32, 2^-7 |want| + 2^-8 max|v| in bf16."""
    if want.dtype == torch.float32:
        return 2e-4 + 2e-4 * want.abs()
    return 2.0 ** -7 * want.float().abs() + 2.0 ** -8 * v.float().abs().max()


@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128, 160, 192])
@pytest.mark.parametrize("S", [50, 64, 257])
@pytest.mark.parametrize("G", [1, 2, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_matches_plain(cuda, dtype, causal, G, S, dh):
    """q and k of head dim ``dh``, v of the value head dim the kernel pairs
    with it (``dh`` but for MLA's (192, 128))."""
    from repro_torch.kernels.flash import kernel

    dv = dict(kernel.PAIRS)[dh]
    gen = torch.Generator(device="cuda").manual_seed(S * dh + G)
    q = torch.randn((2, S, 2 * G, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, S, 2, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, S, 2, dv), generator=gen, device=cuda).to(dtype)
    before, designs = sum(flops.launches.values()), Counter(flops.design_launches)
    got = flops.flash_attention(q, k, v, causal=causal)
    want = flref.attention_gqa_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert sum(flops.launches.values()) == before + 1
    tag = "tc:bfloat16" if dtype == torch.bfloat16 else "fma:float32"
    assert flops.design_launches - designs == Counter({tag: 1})
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs()
    assert bool((err <= _flash_limit(want, v)).all()), err.max().item()


@pytest.mark.parametrize("S,Hkv,G,dh,causal", [
    (50, 2, 1, 16, True), (130, 1, 16, 128, True), (77, 1, 2, 160, True),
    (192, 2, 2, 32, False), (257, 1, 16, 64, True),
    (130, 4, 1, 192, True), (77, 1, 2, 192, False), (130, 4, 1, 80, True),
])
def test_flash_bf16_matches_tile_emulation(cuda, S, Hkv, G, dh, causal):
    """The tensor-core design against the CPU emulation of its order of work
    (``ref.attention_tiles_ref``), at the bf16 limit; v of the value head
    dim the kernel pairs with ``dh``."""
    from repro_torch.kernels.flash import kernel

    rng = np.random.default_rng(S * dh + G)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, h, d)).astype(np.float32))
               .to(torch.bfloat16) for h, d in ((Hkv * G, dh), (Hkv, dh),
                                                (Hkv, dict(kernel.PAIRS)[dh])))
    got = flops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=causal).cpu()
    want = flref.attention_tiles_ref(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs()
    assert bool((err <= _flash_limit(want, v)).all()), err.max().item()


def test_flash_refuses_unsupported_head_dims(cuda):
    x = torch.zeros((1, 8, 2, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flops.flash_attention(x, x, x)


@pytest.mark.parametrize("B,S,Hq,Hkv,dh", [(4, 4096, 56, 8, 128), (4, 2048, 16, 16, 64)],
                         ids=["llava", "seamless"])
def test_flash_at_the_vlm_and_audio_serving_shapes(cuda, B, S, Hq, Hkv, dh):
    """K6 at LLaVA-NeXT-34B's prefill (2048 frontend and 2048 prompt
    positions, 56 q heads on 8 kv heads: a group of 7, the first that is not
    a power of two) and at SeamlessM4T's decoder prefill (16 / 16 heads of
    64), bf16, causal, on the tensor-core design, against the plain version
    a batch row at a time (LLaVA's whole batch would take 15 GB of fp32
    scores)."""
    gen = torch.Generator(device="cuda").manual_seed(S + Hq)
    q, k, v = (torch.randn((B, S, h, dh), generator=gen, device=cuda).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    designs = Counter(flops.design_launches)
    got = flops.flash_attention(q, k, v, causal=True)
    assert flops.design_launches - designs == Counter({"tc:bfloat16": 1})
    for b in range(B):
        want = flref.attention_gqa_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True)
        err = (got[b:b + 1].float() - want.float()).abs()
        assert bool((err <= _flash_limit(want, v)).all()), (b, err.max().item())


@pytest.mark.parametrize("arch", ["llava_next_34b", "seamless_m4t_medium"])
def test_vlm_and_audio_lms_match_the_cpu_run(cuda, arch):
    """LLaVA-NeXT's and SeamlessM4T's smoke LMs in fp32 on the card (K6's
    FMA design once a layer in the prefill: the VLM's over F + S positions,
    the audio decoder's self-attention) against the same weights on the
    CPU, where K6 takes its plain version: the prefill's logits and every
    cache leaf, 3 decode steps' logits and the cache after them, within
    1e-4 (the LM files' fp32 limit); never K6 in decode."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve_lm
    from repro_torch.models.lm import LM, OPTIMIZED

    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    cpu = LM(cfg, q_block=16, perf=OPTIMIZED, device="cpu", seed=0)
    card = LM(cfg, q_block=16, perf=OPTIMIZED, device=cuda, seed=0)
    card.load_state_dict(cpu.state_dict(), strict=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 43)))
    frontend = serve_lm.make_frontend(cfg, 2, 40, "cpu", 1)
    off = cfg.n_frontend_tokens if cfg.family == "vlm" else 0

    def leaves(cache):
        cache = cache.get("blocks", cache)
        return [cache[k].clone() for k in sorted(cache)]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs, k6 = [], []
        for lm in (cpu, card):
            before = sum(flops.launches.values())
            cache, lg = lm.prefill({"tokens": toks[:, :40].to(lm.device),
                                    "frontend": frontend.to(lm.device)}, max_len=off + 43)
            k6.append(sum(flops.launches.values()) - before)
            got = [lg[:, 0], *leaves(cache)]
            for t in range(3):
                cache, lg = lm.decode_step(cache, toks[:, 40 + t].to(lm.device), off + 40 + t)
                got.append(lg)
            k6.append(sum(flops.launches.values()) - before)
            outs.append([g.cpu() for g in (*got, *leaves(cache))])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert k6 == [0, 0, cfg.n_layers, cfg.n_layers]
    for i, (want, got) in enumerate(zip(*outs)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=f"output {i}")


def test_lm_prefill_runs_k6_once_per_layer(cuda):
    """The optimized prefill launches K6 once per layer and decode never,
    and its logits match the same prefill with the plain attention."""
    from repro_torch import configs
    from repro_torch.models.lm import LM, OPTIMIZED

    cfg = configs.smoke("glm4_9b")
    lm = LM(cfg, q_block=16, perf=OPTIMIZED, device=cuda, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    before, designs = sum(flops.launches.values()), Counter(flops.design_launches)
    cache, lg = lm.prefill({"tokens": toks}, max_len=41)
    assert sum(flops.launches.values()) == before + cfg.n_layers
    lm.decode_step(cache, lg[:, 0].argmax(-1), 40)
    assert sum(flops.launches.values()) == before + cfg.n_layers
    assert flops.design_launches - designs == Counter({"tc:bfloat16": cfg.n_layers})
    lm._serving_causal = lambda q, k, v: flref.attention_gqa_ref(q, k, v, causal=True)
    _, lg_plain = lm.prefill({"tokens": toks}, max_len=41)
    rel = ((lg - lg_plain).norm() / lg_plain.norm()).item()
    assert rel < 6e-2, rel


def test_moe_lm_prefill_runs_k6_once_per_layer_and_repeats_bitwise(cuda):
    """Phi-3.5-MoE's smoke config on the card: K6 once per layer in the
    prefill and never in decode; at a capacity that drops, two prefills are
    bitwise equal and the dropped count is read from the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.lm import LM, OPTIMIZED

    cfg = configs.smoke("phi35_moe_42b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    lm = LM(cfg, q_block=16, perf=OPTIMIZED, device=cuda, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    before = sum(flops.launches.values())
    moe.assignments.clear()
    cache, lg = lm.prefill({"tokens": toks}, max_len=41)
    assert sum(flops.launches.values()) == before + cfg.n_layers
    dropped = int(moe.assignments["dropped"])
    assert 0 < dropped < moe.assignments["routed"]
    lm.decode_step(cache, lg[:, 0].argmax(-1), 40)
    assert sum(flops.launches.values()) == before + cfg.n_layers
    _, lg2 = lm.prefill({"tokens": toks}, max_len=41)
    assert torch.equal(lg, lg2) and int(moe.assignments["dropped"]) == 2 * dropped


@pytest.mark.parametrize("arch", ["glm4_9b", "phi35_moe_42b"])
def test_world_one_sharded_lm_is_the_meshless_lm_bitwise(mesh1, arch):
    """At one rank on NCCL (``make_host_mesh(1)``) the sharded LM holds the
    mesh-less LM's very tensors, and its prefill (K6 once a layer), 4 greedy
    decode steps and cache are the mesh-less LM's bit for bit, with the
    collectives ``collectives_per_call`` counts.  Phi drops assignments
    (capacity factor 0.5) through the expert-parallel dispatch."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding
    from repro_torch.models.lm import LM, OPTIMIZED

    cfg = configs.smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    lm = LM(cfg, q_block=16, perf=OPTIMIZED, device="cuda", seed=0)
    par = lm.sharded(make_host_mesh(1))
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(lm.parameters(), par.parameters()))
    toks = torch.randint(0, cfg.vocab, (2, 40), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    runs = []
    for m in (lm, par):
        sharding.collectives.clear()
        before = sum(flops.launches.values())
        cache, lg = m.prefill({"tokens": toks}, max_len=44)
        assert sum(flops.launches.values()) == before + cfg.n_layers
        counts = [Counter(sharding.collectives)]
        logits, tok = [lg], lg[:, -1].argmax(-1)
        ids = [tok]
        for t in range(4):
            sharding.collectives.clear()
            cache, lg = m.decode_step(cache, tok, 40 + t)
            counts.append(Counter(sharding.collectives))
            tok = lg.argmax(-1)
            logits.append(lg)
            ids.append(tok)
        runs.append((logits, ids, cache, counts))
    (la, ia, ca, counts), (lb, ib, cb, par_counts) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(ia, ib))
    assert all(torch.equal(ca[g][k], cb[g][k]) for g in ca for k in ca[g])
    assert counts == [Counter()] * 5
    assert par_counts == [par.collectives_per_call(2, 40)] + [par.collectives_per_call(2)] * 4


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_2p7b"])
def test_world_one_sharded_ssm_and_hybrid_lm_is_the_meshless_lm_bitwise(mesh1, arch):
    """At one rank on NCCL the sharded Falcon-Mamba and Zamba2 smoke LMs
    hold the mesh-less LM's very tensors, and their prefill (K6 never for
    the SSM, once a group for the hybrid's shared block, all on the
    tensor-core design), 4 greedy decode steps (no K6) and every cache leaf
    are the mesh-less LM's bit for bit, with the collectives
    ``collectives_per_call`` counts."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding
    from repro_torch.models.lm import LM, OPTIMIZED

    cfg = configs.smoke(arch)
    k6 = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    lm = LM(cfg, q_block=16, perf=OPTIMIZED, device="cuda", seed=0)
    par = lm.sharded(make_host_mesh(1))
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(lm.parameters(), par.parameters()))
    toks = torch.randint(0, cfg.vocab, (2, 40), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    designs = Counter(flops.design_launches)
    runs = []
    for m in (lm, par):
        sharding.collectives.clear()
        before = sum(flops.launches.values())
        cache, lg = m.prefill({"tokens": toks}, max_len=44)
        assert sum(flops.launches.values()) == before + k6
        counts = [Counter(sharding.collectives)]
        logits, tok = [lg], lg[:, -1].argmax(-1)
        ids = [tok]
        for t in range(4):
            sharding.collectives.clear()
            cache, lg = m.decode_step(cache, tok, 40 + t)
            counts.append(Counter(sharding.collectives))
            tok = lg.argmax(-1)
            logits.append(lg)
            ids.append(tok)
        assert sum(flops.launches.values()) == before + k6
        leaves = {k: v for k, v in cache.items() if torch.is_tensor(v)}
        leaves.update({f"states.{k}": v for k, v in cache.get("states", {}).items()})
        runs.append((logits, ids, leaves, counts))
    assert flops.design_launches - designs == Counter({"tc:bfloat16": 2 * k6} if k6 else {})
    (la, ia, ca, counts), (lb, ib, cb, par_counts) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(ia, ib))
    assert set(ca) == set(cb) and all(torch.equal(ca[k], cb[k]) for k in ca)
    assert counts == [Counter()] * 5
    assert par_counts == [par.collectives_per_call(2, 40)] + [par.collectives_per_call(2)] * 4


def test_mla_lm_prefill_runs_k6_once_per_layer_and_repeats_bitwise(cuda):
    """DeepSeek-V2-Lite's smoke config with its own MLA head dims (q and k
    128 + 64, v 128: K6 at (192, 128)) on the card: K6 once per layer in the
    prefill and never in decode, all on the tensor-core design; two
    prefills bitwise equal (logits and latent cache); the prefill within
    6e-2 of the same prefill with the plain attention; the absorbed and the
    expanded decode step within 6e-2 of each other."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.config import MLAConfig
    from repro_torch.models.lm import LM, OPTIMIZED

    cfg = configs.smoke("deepseek_v2_lite_16b")
    cfg = dataclasses.replace(cfg, mla=MLAConfig(kv_lora_rank=64, qk_nope_dim=128,
                                                 qk_rope_dim=64, v_head_dim=128))
    lm = LM(cfg, q_block=16, perf=OPTIMIZED, device=cuda, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    before, designs = sum(flops.launches.values()), Counter(flops.design_launches)
    cache, lg = lm.prefill({"tokens": toks}, max_len=41)
    assert sum(flops.launches.values()) == before + cfg.n_layers
    twin = {g: {k: v.clone() for k, v in c.items()} for g, c in cache.items()}
    _, lg_abs = lm.decode_step(cache, lg[:, 0].argmax(-1), 40)
    _, lg_exp = lm.decode_step(twin, lg[:, 0].argmax(-1), 40, absorbed=False)
    assert sum(flops.launches.values()) == before + cfg.n_layers
    assert flops.design_launches - designs == Counter({"tc:bfloat16": cfg.n_layers})
    rel = ((lg_abs - lg_exp).norm() / lg_exp.norm()).item()
    assert rel < 6e-2, rel
    c1, lg1 = lm.prefill({"tokens": toks}, max_len=41)
    c2, lg2 = lm.prefill({"tokens": toks}, max_len=41)
    assert torch.equal(lg1, lg2) and all(torch.equal(c1[g][k], c2[g][k])
                                         for g in c1 for k in ("ckv", "krope"))
    lm._serving_causal = lambda q, k, v: flref.attention_gqa_ref(q, k, v, causal=True)
    _, lg_plain = lm.prefill({"tokens": toks}, max_len=41)
    rel = ((lg1 - lg_plain).norm() / lg_plain.norm()).item()
    assert rel < 6e-2, rel


def test_ssm_lm_matches_the_cpu_run(cuda):
    """Falcon-Mamba's smoke LM in fp32 on the card (the chunked selective
    scan, a padded last chunk included) against the same weights on the CPU:
    the prefill's logits and ``ssm`` and ``conv`` states, 3 decode steps'
    logits and the state after them, within 1e-4 (the scan's limit in
    tests/test_ssm.py); no K6 launch."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.lm import LM, OPTIMIZED

    cfg = dataclasses.replace(configs.smoke("falcon_mamba_7b"), dtype="float32")
    cpu = LM(cfg, perf=OPTIMIZED, device="cpu", seed=0)
    card = LM(cfg, perf=OPTIMIZED, device=cuda, seed=0)
    card.load_state_dict(cpu.state_dict(), strict=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 43)))
    before, tf32 = sum(flops.launches.values()), torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for lm in (cpu, card):
            cache, lg = lm.prefill({"tokens": toks[:, :40].to(lm.device)})
            got = [lg[:, 0], cache["ssm"].clone(), cache["conv"].clone()]
            for t in range(3):
                cache, lg = lm.decode_step(cache, toks[:, 40 + t].to(lm.device), 40 + t)
                got.append(lg)
            outs.append([g.cpu() for g in (*got, cache["ssm"])])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert sum(flops.launches.values()) == before
    for name, want, got in zip(("prefill", "ssm", "conv", "decode0", "decode1", "decode2",
                                "ssm after decode"), *outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=name)


def test_hybrid_lm_matches_the_cpu_run(cuda):
    """Zamba2's smoke LM in fp32 on the card (K6's FMA design once a group
    in the prefill, the SSD scan with a padded last chunk) against the same
    weights on the CPU, where K6 takes its plain version: the prefill's
    logits and every cache leaf, 3 decode steps' logits and the cache after
    them, within 1e-4 (the SSD scan's limit in tests/test_ssm.py); K6 once
    a group per prefill, never in decode."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.lm import LM, OPTIMIZED

    cfg = dataclasses.replace(configs.smoke("zamba2_2p7b"), dtype="float32")
    groups = cfg.n_layers // cfg.attn_every
    cpu = LM(cfg, q_block=16, perf=OPTIMIZED, device="cpu", seed=0)
    card = LM(cfg, q_block=16, perf=OPTIMIZED, device=cuda, seed=0)
    card.load_state_dict(cpu.state_dict(), strict=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 43)))

    def leaves(cache):
        return [cache["k"].clone(), cache["v"].clone(), cache["states"]["ssm"].clone(),
                cache["states"]["conv"].clone()]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs, k6 = [], []
        for lm in (cpu, card):
            before = sum(flops.launches.values())
            cache, lg = lm.prefill({"tokens": toks[:, :40].to(lm.device)}, max_len=43)
            k6.append(sum(flops.launches.values()) - before)
            got = [lg[:, 0], *leaves(cache)]
            for t in range(3):
                cache, lg = lm.decode_step(cache, toks[:, 40 + t].to(lm.device), 40 + t)
                got.append(lg)
            k6.append(sum(flops.launches.values()) - before)
            outs.append([g.cpu() for g in (*got, *leaves(cache))])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert k6 == [0, 0, groups, groups]
    names = ("prefill", "k", "v", "ssm", "conv", "decode0", "decode1", "decode2",
             "k after decode", "v after decode", "ssm after decode", "conv after decode")
    for name, want, got in zip(names, *outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("budget", ["bf16", "int8"])
def test_auto_plan_equals_explicit_under_its_schedule(mesh1, tmp_path, budget):
    """An auto plan tunes on the card with the exchange kernels swept
    (``exchange_impl="cuda"``, a lossy budget); its forward and backward are
    bitwise equal to the explicit plan run under the tuned schedule, and a
    second plan on the same cache replays that schedule without timing."""
    from repro_torch.core import tuner
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig

    shape = (42, 63, 64)
    cfg = PlanConfig(method="auto", impl="matmul", exchange_impl="cuda", comm_dtype=budget,
                     tuner_cache=str(tmp_path / "t.json"))
    plan = ParallelFFT(mesh1, shape, ("p0", "p1"), config=cfg)
    explicit = ParallelFFT(mesh1, shape, ("p0", "p1"),
                           config=PlanConfig(impl="matmul", exchange_impl="cuda"))
    sched = plan.schedule
    assert len(sched) == 2 and all(e in tuner.candidates_for(budget, "cuda") for e in sched)
    x = _rand(plan.input_pencil.local_shape, True, 11, "cuda")
    y = plan.forward_padded(x)
    assert torch.equal(y, explicit._execute(x, "forward", sched, guard=False))
    assert torch.equal(plan.backward_padded(y), explicit._execute(y, "backward", sched,
                                                                  guard=False))
    tuner._MEMO.clear()
    real, tuner.tune_plan = tuner.tune_plan, None  # a replay must not sweep
    try:
        again = ParallelFFT(mesh1, shape, ("p0", "p1"), config=cfg)
        assert again.schedule == sched
    finally:
        tuner.tune_plan = real


# -- the example twins and the plan audit on the card -------------------------

_TWIN_CONFIGS = {
    "example": {"method": "fused"},
    "slice": {"method": "fused", "impl": "matmul", "exchange_impl": "cuda"},
    "slice_bf16": {"method": "fused", "impl": "matmul", "exchange_impl": "cuda",
                   "comm_dtype": "bf16"},
}


@pytest.mark.parametrize("config", list(_TWIN_CONFIGS))
def test_navier_stokes_twin_on_the_card(mesh1, config):
    """The Taylor-Green twin at the example's size (32 modes, 48^3) on a
    1-rank NCCL group: the example's checks, and a K4 run's energies within
    1e-5 relative of cuFFT's at every step (a bf16 wire within its rounding
    bound, chip_smoke.TOL_DNS_BF16's form = 9.06e-3 at this dt, and its
    decrements E_k - E_0 within chip_smoke.TOL_DNS_BF16_DECAY's 0.111, which
    a frozen step exceeds)."""
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.examples import navier_stokes as ns

    cfg = PlanConfig(**_TWIN_CONFIGS[config])
    lossless = cfg.comm_dtype == "complex64"
    out = ns.run(mesh1, config=cfg, guard_demo=lossless)
    checks = dict(out["checks"])
    if not lossless:
        checks.pop("bitwise_batched")
    assert all(checks.values()), checks
    ref = ns.run(mesh1, config=PlanConfig(**_TWIN_CONFIGS["example"]), guard_demo=False)
    tol = 1e-5 if lossless else 2 * 2 * 2.0 ** -9 + 8 * 5e-3 * 2 * 2 * 4 * 2.0 ** -9
    for a, b in zip(out["energies"], ref["energies"]):
        assert abs(a - b) <= tol * b
    if not lossless:
        e, r = out["energies"], ref["energies"]
        decay_tol = 4 * 2.0 ** -8 + 6 * 2.0 ** -8 * math.sqrt(3 / 8) / (3 * ns.NU)
        for a, b in zip(e[1:], r[1:]):
            assert abs((a - e[0]) - (b - r[0])) <= decay_tol * abs(b - r[0])


@pytest.mark.parametrize("config", ["example", "slice"])
def test_quickstart_and_poisson_twins_on_the_card(mesh1, config):
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.examples import poisson, quickstart

    cfg = PlanConfig(**_TWIN_CONFIGS[config])
    assert quickstart.run(mesh1, cfg)["ok"]
    out = poisson.run(mesh1, cfg)
    assert out["ok"] and out["err"] < 1e-5


def test_plan_audit_of_the_example_plans_on_the_card(mesh1):
    """Every example plan audits clean on the card, the exchange kernels
    opaque to dispatch (PLAN009 counts their wrappers' calls)."""
    from repro_torch.analysis import planlint

    for label, (plan, nfields) in planlint.example_plans(mesh1).items():
        rep = planlint.audit_plan(plan, nfields=nfields, label=label)
        assert rep.ok, (label, [v.to_dict() for v in rep.violations])

"""The codec kernels' order of work on the CPU (no kernel here): K1's
encode and K2/K3's decode.

Both directions (``csrc/exchange.cu``: ``enc_amax_kernel`` and
``enc_kernel``; ``decode_kernel``) run one block per (scale block, tile of
8192 floats) and move 4 complex or 4 reals a step (the ``"vec"`` design) or
one float (``"scalar"``), with offsets from one map, the kernels' own
formulas; the decode reads the encode's map backwards.  ``ref.tile_map``,
``ref.encode_tiles_ref`` and ``ref.decode_tiles_ref`` emulate that map
with index tensors.  Here: (a) the encode's emulation reads every block
float once and writes every payload element once, and the decode's reads
every payload element once and writes every block float once; (b) the
encode's payload, scales and guard counts equal the plain versions'
(``encode_payload_ref`` / ``pack_chunks_ref``) exactly: bf16 and int8
payloads bit for bit, int8 scales equal, counts equal (the same arithmetic
in another order of work), and the decode's block equals
``decode_payload_ref`` / ``unpack_chunks_ref`` bit for bit (the kernel's
bf16 widening is a 16-bit shift, its int8 decode one multiply, as the
plain codec's); (c) both match the reference's Pallas kernels in interpret
mode (encode: bf16 bitwise, int8 payloads within one quantum and scales
within 1 ULP, as ``tests/test_torch_exchange_kernels.py`` holds XLA's
division; decode: bf16 bitwise, int8 within 1 ULP); (d) ``ref.tile_design``
gives ``"vec"`` on every view of the port's paths, encode and decode, and
``"scalar"`` off its conditions; (e) the tile and thread constants and the
one map are the kernels'.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.exchange import kernel, ops, ref

CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "exchange.cu"

# (name, block shape, axis, m, nbatch, complex); path views cut in O only
VIEWS = [
    ("odd_S", (6, 5, 7), 1, 1, 0, True),                   # S = 35: scalar
    ("short_runs", (16, 3, 1), 2, 1, 0, True),             # S * P = 2 < one vector
    ("real_short_runs", (16, 3, 2), 2, 1, 0, False),       # P = 1, S = 2
    ("F3_M2", (3, 8, 6, 12), 2, 2, 1, True),               # F > 1, M > 1: runs apart
    ("F3_M2_odd", (3, 10, 6, 7), 2, 2, 1, True),           # the same, scalar
    ("real_M4", (8, 12, 16), 1, 4, 0, False),              # P = 1, M > 1
    ("ragged", (40, 33, 20), 1, 1, 0, True),               # 7 tiles, the last short
    ("M4_runs_cross_tiles", (2, 24, 40, 36), 2, 4, 1, True),  # runs of 720 over 3 tiles
    ("path_512_axis2", (2, 4, 512), 2, 1, 0, True),        # 512^3, v = 2, O cut
    ("path_512_axis1", (1, 512, 512), 1, 1, 0, True),      # 512^3, v = 1, O cut
    ("path_pipelined_slice", (4, 16, 1, 128), 2, 1, 0, True),  # (512, 512, 1, 128), O cut
    ("path_quickstart_axis2", (42, 63, 64), 2, 1, 0, True),
    ("path_quickstart_axis1", (42, 63, 64), 1, 1, 0, True),
]
# the port's exchanges at full size (every plan on one card has M = 1)
PATH_VIEWS = [((512, 512, 512), 2), ((512, 512, 512), 1), ((512, 512, 1, 128), 2),
              ((512, 512, 1, 128), 1), ((42, 63, 64), 2), ((42, 63, 64), 1)]


def _block(shape, iscomplex, seed, *, faults=False, max_last=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if iscomplex:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    flat = x.reshape(-1)
    if max_last:  # the largest |x| in the last tile of the last scale block
        flat[-1] = 40.0
    if faults:
        flat[[1, flat.size // 2]] = [np.nan, np.inf]
    return torch.from_numpy(x)


def _view(y, axis, m, nbatch):
    P = 2 if y.is_complex() else 1
    return (*ops._chunk_view(y.shape, axis, m, nbatch), P)


def _floats(y):
    return (torch.view_as_real(y) if y.is_complex() else y).reshape(-1)


def _bits(q):
    return q.view(torch.int16) if q.dtype == torch.bfloat16 else q


def _design(view, design):
    return ref.tile_design(*view, 1, 0, 0) if design == "rule" else design


@pytest.mark.parametrize("design", ["rule", "scalar"])
@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("name,shape,axis,m,nbatch,iscomplex", VIEWS, ids=[v[0] for v in VIEWS])
def test_tile_order_matches_plain(name, shape, axis, m, nbatch, iscomplex, codec, layout,
                                  design):
    y = _block(shape, iscomplex, len(name), faults=True, max_last=True)
    view = _view(y, axis, m, nbatch)
    plain = ref.pack_chunks_ref if layout == 1 else ref.encode_payload_ref
    sd = 64.0 if codec == "int8" and design == "scalar" else None
    q, s, c, reads, writes = ref.encode_tiles_ref(
        _floats(y), *view, codec=codec, layout=layout, design=_design(view, design),
        guard=True, scale_div=sd)
    assert torch.all(reads == 1) and torch.all(writes == 1)
    qr, sr, str_ = plain(y, axis=axis, m=m, nbatch=nbatch, codec=codec, guard=True,
                         scale_div=sd)
    assert torch.equal(_bits(q), _bits(qr.reshape(-1)))
    if codec == "int8":
        assert torch.equal(s, sr)
    assert float(c[..., 0].sum()) == float(str_["nonfinite"]) == 2
    assert float(c[..., 1].sum()) == float(str_["saturated"])


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("name,shape,axis,m,nbatch,iscomplex",
                         [v for v in VIEWS if v[0] in ("odd_S", "F3_M2", "real_M4", "ragged")],
                         ids=["odd_S", "F3_M2", "real_M4", "ragged"])
def test_tile_order_matches_reference_kernel(name, shape, axis, m, nbatch, iscomplex, codec):
    import jax.numpy as jnp

    from repro.kernels import exchange as jx

    y = _block(shape, iscomplex, len(name) + 1)
    view = _view(y, axis, m, nbatch)
    for layout, jfn in ((0, jx.encode_payload), (1, jx.pack_chunks)):
        q, s, _, _, _ = ref.encode_tiles_ref(_floats(y), *view, codec=codec, layout=layout,
                                             design=_design(view, "rule"))
        jq, js, _ = jfn(jnp.asarray(y.numpy()), axis=axis, m=m, nbatch=nbatch, codec=codec,
                        interpret=True)
        jq = np.asarray(jq).reshape(-1)
        if codec == "bf16":
            np.testing.assert_array_equal(q.view(torch.int16).numpy().view(np.uint16),
                                          jq.view(np.uint16))
        else:
            assert np.max(np.abs(q.numpy().astype(np.int32) - jq.astype(np.int32))) <= 1
            np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)


def _payload(n, codec, seed):
    """A flat received payload: bf16 of normal values with a NaN and both
    infinities, or int8 over the whole of [-127, 127]."""
    rng = np.random.default_rng(seed)
    if codec == "int8":
        return torch.from_numpy(rng.integers(-127, 128, n).astype(np.int8))
    q = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    q[[1, n // 2, n - 1]] = torch.tensor([float("nan"), float("inf"), -float("inf")],
                                         dtype=torch.bfloat16)
    return q


def _scales(F, M, layout, seed):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.uniform(1e-3, 2.0, F * M).astype(np.float32))
    return s.view(M, F) if layout == 1 else s.view(F, M)


def _decode_plain(plain, q, sc, shape, axis, m, nbatch, iscomplex, codec, layout):
    """The plain decode of flat payload ``q`` into the block ``shape``, whose
    ``axis`` holds the ``m`` chunks (the in-place payload's chunked axis, or
    the chunk-major payload's scatter axis w, with v another axis)."""
    P = 2 if iscomplex else 1
    if layout == 0:
        return plain[0](q.reshape(P, *shape), axis=axis, m=m, nbatch=nbatch, scale=sc,
                        codec=codec, iscomplex=iscomplex)
    s = list(shape)
    s[axis] //= m
    w = axis - nbatch
    return plain[1](q.reshape(m, P, *s), v=0 if w else 1, w=w, m=m, nbatch=nbatch, scale=sc,
                    codec=codec, iscomplex=iscomplex)


@pytest.mark.parametrize("design", ["rule", "scalar"])
@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("name,shape,axis,m,nbatch,iscomplex", VIEWS, ids=[v[0] for v in VIEWS])
def test_decode_tile_order_matches_plain(name, shape, axis, m, nbatch, iscomplex, codec, layout,
                                         design):
    P = 2 if iscomplex else 1
    view = (*ops._chunk_view(shape, axis, m, nbatch), P)
    F, O, M, S, _ = view
    q = _payload(F * O * M * S * P, codec, len(name))
    sc = _scales(F, M, layout, len(name)) if codec == "int8" else None
    y, reads, writes = ref.decode_tiles_ref(q, sc, *view, codec=codec, layout=layout,
                                            design=_design(view, design))
    assert torch.all(reads == 1) and torch.all(writes == 1)
    want = _decode_plain((ref.decode_payload_ref, ref.unpack_chunks_ref), q, sc, shape, axis, m,
                         nbatch, iscomplex, codec, layout)
    assert torch.equal(y.view(torch.int32), _floats(want).view(torch.int32))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("name,shape,axis,m,nbatch,iscomplex",
                         [v for v in VIEWS if v[0] in ("odd_S", "F3_M2", "real_M4", "ragged")],
                         ids=["odd_S", "F3_M2", "real_M4", "ragged"])
def test_decode_tile_order_matches_reference_kernel(name, shape, axis, m, nbatch, iscomplex,
                                                    codec):
    import jax.numpy as jnp

    from repro.kernels import exchange as jx

    P = 2 if iscomplex else 1
    view = (*ops._chunk_view(shape, axis, m, nbatch), P)
    F, O, M, S, _ = view
    q = _payload(F * O * M * S * P, codec, len(name) + 1)
    for layout in (0, 1):
        sc = _scales(F, M, layout, layout) if codec == "int8" else None
        y, _, _ = ref.decode_tiles_ref(q, sc, *view, codec=codec, layout=layout,
                                       design=_design(view, "rule"))
        jq = jnp.asarray(q.view(torch.int16).numpy().view(jnp.bfloat16) if codec == "bf16"
                         else q.numpy())
        jsc = None if sc is None else jnp.asarray(sc.numpy())
        want = _decode_plain(
            (lambda *a, **k: jx.decode_payload(*a, interpret=True, **k),
             lambda *a, **k: jx.unpack_chunks(*a, interpret=True, **k)),
            jq, jsc, shape, axis, m, nbatch, iscomplex, codec, layout)
        want = np.asarray(want)
        want = np.stack([want.real, want.imag], -1) if iscomplex else want
        want = want.astype(np.float32).reshape(-1)
        if codec == "bf16":
            np.testing.assert_array_equal(y.numpy().view(np.uint32), want.view(np.uint32))
        else:
            np.testing.assert_array_max_ulp(y.numpy(), want, maxulp=1)


def test_design_rule():
    for shape, axis in PATH_VIEWS:
        view = (*ops._chunk_view(shape, axis, 1, 0), 2)
        for layout in (0, 1):
            assert ref.tile_design(*view, layout, 1 << 21, 1 << 22) == "vec", (shape, axis)
    # the decodes of the path exchanges: the same view cut at the scatter
    # axis w, any axis of the path shapes
    for shape in {shape for shape, _ in PATH_VIEWS}:
        for w in range(len(shape)):
            view = (*ops._chunk_view(shape, w, 1, 0), 2)
            for layout in (0, 1):
                assert ref.tile_design(*view, layout, 1 << 21, 1 << 22) == "vec", (shape, w)
    view = (1, 8, 1, 512, 2)
    assert ref.tile_design(*view, 1, 8, 0) == "scalar"   # block 8-byte aligned only
    assert ref.tile_design(*view, 1, 16, 4) == "scalar"  # payload 4-byte aligned only
    for S in (1, 2, 35, 510):
        assert ref.tile_design(1, 8, 1, S, 2, 1, 0, 0) == "scalar"


def test_the_map_reads_in_vectors():
    """A vec step reads 4 P consecutive, aligned floats of one run."""
    F, O, M, S, P = 2, 24, 4, 360, 2
    _, src, _ = ref.tile_map(F, O, M, S, P, 1, "vec")
    v = src.view(-1, 4 * P)
    assert torch.all(v[:, 0] % (4 * P) == 0)
    assert torch.all(v - v[:, :1] == torch.arange(4 * P))
    assert torch.all(v[:, 0] // (S * P) == v[:, -1] // (S * P))


def test_constants_are_the_kernels():
    src = CU.read_text()
    assert re.search(rf"constexpr int kThreads = {ref.THREADS};", src)
    assert re.search(rf"constexpr int kTile = {ref.TILE};", src)
    assert re.search(rf"constexpr int kVecDesign = {kernel._DESIGNS['vec']};", src)
    # one map: every kernel places its tile with tile_of and its vectors
    # with locate, and the decode keeps no index map of its own
    for name in ("enc_amax_kernel", "enc_kernel", "decode_kernel"):
        body = src[src.index(f"    {name}("):]
        body = body[:body.index("\n}\n")]
        assert "tile_of<P, kContig>(" in body and "locate<P, kContig>(" in body, name
    for gone in ("wire_index", "run_of", "struct View", "make_view"):
        assert gone not in src, gone

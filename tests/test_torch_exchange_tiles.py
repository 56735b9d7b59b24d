"""K1's order of work on the CPU (no kernel here).

The encode (``csrc/exchange.cu``, ``enc_amax_kernel`` and ``enc_kernel``)
runs one block per (scale block, tile of 8192 floats) and moves 4 complex
or 4 reals a step (the ``"vec"`` design) or one float (``"scalar"``), with
offsets from the kernel's own formulas.  ``ref.encode_tile_map`` and
``ref.encode_tiles_ref`` emulate that map with index tensors.  Here: (a)
the emulation reads every block float once and writes every payload
element once; (b) its payload, scales and guard counts equal the plain
versions' (``encode_payload_ref`` / ``pack_chunks_ref``) exactly: bf16 and
int8 payloads bit for bit, int8 scales equal, counts equal (the same
arithmetic in another order of work); (c) it matches the reference's
``encode_pallas_call`` in interpret mode (bf16 bitwise; int8 payloads within
one quantum and scales within 1 ULP, as ``tests/test_torch_exchange_kernels.py``
holds XLA's division); (d) ``ref.encode_design`` gives ``"vec"`` on every
view of the port's paths and ``"scalar"`` off its conditions; (e) the
tile and thread constants are the kernel's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.exchange import ops, ref

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
    return ref.encode_design(*view, 1, 0, 0) if design == "rule" else design


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


def test_design_rule():
    for shape, axis in PATH_VIEWS:
        view = (*ops._chunk_view(shape, axis, 1, 0), 2)
        for layout in (0, 1):
            assert ref.encode_design(*view, layout, 1 << 21, 1 << 22) == "vec", (shape, axis)
    view = (1, 8, 1, 512, 2)
    assert ref.encode_design(*view, 1, 8, 0) == "scalar"   # block 8-byte aligned only
    assert ref.encode_design(*view, 1, 16, 4) == "scalar"  # payload 4-byte aligned only
    for S in (1, 2, 35, 510):
        assert ref.encode_design(1, 8, 1, S, 2, 1, 0, 0) == "scalar"


def test_the_map_reads_in_vectors():
    """A vec step reads 4 P consecutive, aligned floats of one run."""
    F, O, M, S, P = 2, 24, 4, 360, 2
    _, src, _ = ref.encode_tile_map(F, O, M, S, P, 1, "vec")
    v = src.view(-1, 4 * P)
    assert torch.all(v[:, 0] % (4 * P) == 0)
    assert torch.all(v - v[:, :1] == torch.arange(4 * P))
    assert torch.all(v[:, 0] // (S * P) == v[:, -1] // (S * P))


def test_constants_are_the_kernels():
    src = CU.read_text()
    assert re.search(rf"constexpr int kThreads = {ref.THREADS};", src)
    assert re.search(rf"constexpr int kEncTile = {ref.TILE};", src)

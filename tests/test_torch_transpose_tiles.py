"""The local transpose's order of work on the CPU (no kernel here): K5's
two designs in ``csrc/transpose.cu``.

``rows`` moves the rows of x straight to y in 16-byte vectors, walking y in
order, 4 vectors a thread; ``tile`` moves a TA x TB x TC tile
through padded shared memory.  ``ref.transpose_design`` is the rule between
them, ``ref.transpose_plan`` the launch, and ``ref.transpose_rows_ref`` /
``ref.transpose_tile_ref`` emulate each design's map from (block, thread,
slot) to elements with the kernel's formulas and multiply-shift divisions.
Here: (a) the rule at every one of its boundaries; (b) the multiply-shift
division is exact where the kernel uses it; (c) each plan's tile fits a
thread's registers and the shared memory, and its padded stride keeps the
write phase free of bank conflicts; the rows design's warps access whole
runs; (d) each emulation writes every element
of y once and is bitwise equal to ``numpy.swapaxes`` and to the reference's
``transpose01`` (Pallas, interpret mode); (e) the constants are the
source's.  The C side's rule and plan are held to these on the card
(``tests/test_torch_gpu.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.transpose.ops import transpose01 as jtranspose01
from repro_torch.kernels.transpose import ref

CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "transpose.cu"

# the sweep's shapes, the 1 GiB shapes scaled down ((262144, 4, 128) ->
# (64, 4, 128), (16384, 8192, 1) -> (128, 64, 1), 512^3 -> (8, 8, 512)),
# ragged edges, and C over {1, 2, 3, 5, 35, 40, 128, 1025}
SHAPES = [(24, 24, 8), (7, 13, 3), (64, 48, 40), (512, 33, 1), (64, 4, 128), (128, 64, 1),
          (8, 8, 512), (70, 33, 1), (9, 130, 2), (17, 9, 5), (3, 11, 35), (5, 7, 1025),
          (2, 3, 5000), (1, 1, 1), (40, 1, 128)]
CASES = [(s, dt, d) for s in SHAPES for dt in ("float32", "complex64")
         for d in ("rows", "tile")
         if d == "tile" or ref.transpose_design(*s, 4 if dt == "float32" else 8, 0, 0) == "rows"]


def _x(shape, dt, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if dt == "complex64":
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


@pytest.mark.parametrize("A,B,C,elem,xm,ym,want", [
    (512, 512, 512, 8, 0, 0, "rows"),          # 4 KB rows
    (262144, 4, 128, 8, 0, 0, "rows"),         # the traditional pack of 512^3
    (16384, 8192, 1, 8, 0, 0, "tile"),         # 2-D transpose, 8-byte rows
    (64, 48, 40, 8, 0, 0, "rows"),             # 320 bytes
    (64, 48, 40, 4, 0, 0, "rows"),             # 160 bytes
    (24, 24, 8, 8, 0, 0, "tile"),              # 64 bytes: below the least row
    (9, 9, 16, 8, 0, 0, "rows"),               # 128 bytes: the least row
    (9, 9, 32, 4, 0, 0, "rows"),
    (9, 9, 14, 8, 0, 0, "tile"),               # 112 bytes: a multiple of 16 below 128
    (9, 9, 28, 4, 0, 0, "tile"),
    (9, 9, 33, 4, 0, 0, "tile"),               # 132 bytes: off a multiple of 16
    (9, 9, 1025, 4, 0, 0, "tile"),
    (9, 9, 34, 4, 0, 0, "tile"),               # 136 bytes: a multiple of 8 only
    (9, 9, 36, 4, 0, 0, "rows"),               # 144 bytes
    (9, 9, 17, 8, 0, 0, "tile"),               # 136 bytes of complex64
    (9, 9, 18, 8, 0, 0, "rows"),
    (512, 512, 512, 8, 8, 0, "tile"),          # x at an odd complex64 offset
    (512, 512, 512, 8, 4, 0, "tile"),
    (512, 512, 512, 8, 0, 8, "tile"),          # y unaligned
    (2 ** 14, 2 ** 14 - 1, 16, 8, 0, 0, "rows"),  # 2^31 - 2^17 vectors of x: fits
    (2 ** 14, 2 ** 14, 16, 8, 0, 0, "tile"),   # 2^31 vectors: the vector index overflows
    (1, 1, 2 ** 32 - 2, 8, 0, 0, "rows"),      # 2^31 - 1 vectors in one row
    (1, 1, 2 ** 32, 8, 0, 0, "tile"),
])
def test_design_rule_boundaries(A, B, C, elem, xm, ym, want):
    assert ref.transpose_design(A, B, C, elem, xm, ym) == want


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 33, 35, 64, 1025, 4096, 2 ** 16 + 1, 2 ** 30 - 1,
                               2 ** 30, 2 ** 30 + 1, 2 ** 31 - 1])
def test_fast_div_is_exact(d):
    m, s = ref.fast_div(d)
    assert 0 < m < 2 ** 32 and 31 <= s <= 62
    rng = np.random.default_rng(d)
    ns = {0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, 2 ** 31 - 1, 2 ** 31 - 2,
          (2 ** 31 - 1) // d * d, (2 ** 31 - 1) // d * d - 1}
    ns |= set(int(n) for n in rng.integers(0, 2 ** 31, 2000))
    for n in ns:
        if 0 <= n < 2 ** 31:
            assert (n * m) >> s == n // d, (n, d)


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 31, 35, 40, 128, 1025, 2048, 4096, 5000])
def test_tile_plan_fits_and_is_bank_conflict_free(C, elem):
    grid, ta, tb, tc, stride, smem = ref.transpose_plan(100, 37, C, elem, "tile")
    cap = ref.THREADS * ref.TILE_THREAD_BYTES // elem
    assert ta & (ta - 1) == 0 and tb & (tb - 1) == 0 and ta in (tb, 2 * tb)
    assert tc == min(C, cap) and ta * tb * tc <= cap < 4 * ta * tb * tc
    assert grid == -(-100 // ta) * -(-37 // tb) * -(-C // tc)
    assert stride % ref.BANKS == tc % ref.BANKS and 0 <= stride - tb * tc < ref.BANKS
    assert smem == ta * stride * elem <= 48 * 1024
    # the write phase: a warp's lanes o = (ib, ia, c), c fastest, read
    # smem[ia * stride + ib * tc + c]; each 4-byte bank holds elem / 4 words
    # of a warp's request (the least for 32 lanes of elem bytes)
    words = elem // 4
    for w0 in range(0, ta * tb * tc - 31, 32 * 7):
        o = np.arange(w0, w0 + 32)
        c, p = o % tc, o // tc
        ia, ib = p % ta, p // ta
        if len(set(ib)) > 1:
            continue  # a warp across two rows of y
        idx = ia * stride + ib * tc + c
        addr = (idx[:, None] * words + np.arange(words)).ravel()
        per_bank = np.bincount(addr % ref.BANKS, minlength=ref.BANKS)
        assert per_bank.max() == words, (C, elem, w0)


@pytest.mark.parametrize("A,B,C,elem", [(300, 7, 16, 8), (300, 7, 32, 4), (64, 48, 40, 8),
                                         (512, 512, 512, 8), (262144, 4, 128, 8),
                                         (2, 3, 5000, 4)])
def test_rows_plan(A, B, C, elem):
    blocks, vecs, *rest = ref.transpose_plan(A, B, C, elem, "rows")
    per_block = ref.THREADS * ref.ROW_VECS
    assert vecs * 16 == C * elem and rest == [0, 0, 0, 0]
    assert (blocks - 1) * per_block < A * B * vecs <= blocks * per_block


@pytest.mark.parametrize("shape,dt,design", CASES)
def test_emulation_writes_each_element_once_and_matches(shape, dt, design):
    x = _x(shape, dt, sum(shape))
    emulate = ref.transpose_rows_ref if design == "rows" else ref.transpose_tile_ref
    y, writes = emulate(torch.from_numpy(x))
    assert bool((writes == 1).all())
    assert y.shape == (shape[1], shape[0], shape[2]) and y.dtype == torch.from_numpy(x).dtype
    want = x.swapaxes(0, 1)
    np.testing.assert_array_equal(y.numpy(), want)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jtranspose01(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(64, 48, 40), (300, 7, 16), (3, 5, 2000)])
def test_rows_warp_accesses_are_whole(shape):
    """Each warp's store is 512 contiguous bytes of y, and its load falls
    in at most ceil(32 / vecs) + 1 contiguous runs of x, each a whole row
    but the first and the last."""
    A, B, C = shape
    vecs = C * 8 // 16
    total = A * B * vecs
    o = np.arange(0, total - total % 32).reshape(-1, 32)  # a warp's 32 vectors of y, one k
    r, i = o // vecs, o % vecs
    b, a = r // A, r % A
    src = (a * B + b) * vecs + i
    assert (np.diff(o, axis=1) == 1).all()
    for row_src, row_i in zip(src, i):
        starts = np.flatnonzero(np.diff(row_src) != 1) + 1
        runs = np.split(row_i, starts)
        assert len(runs) <= -(-32 // vecs) + 1
        assert all(len(run) == vecs for run in runs[1:-1])


def test_constants_are_the_kernels():
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);", src).group(1))

    assert const("kThreads") == ref.THREADS
    assert const("kRowVecs") == ref.ROW_VECS
    assert const("kRowsMinBytes") == ref.ROWS_MIN_BYTES
    assert const("kTileThreadBytes") == ref.TILE_THREAD_BYTES
    assert const("kBanks") == ref.BANKS

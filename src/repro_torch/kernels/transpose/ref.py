"""Plain torch version of the local-transpose kernel (the reference's
``repro/kernels/transpose/ref.py``); also the library call it is timed
against.

Beside it, the kernel's rule and order of work (``csrc/transpose.cu``), so
that the CPU tests can hold them: ``transpose_design`` picks ``"rows"`` or
``"tile"`` as the C side's ``design_of`` does, ``transpose_plan`` is the
launch that ``plan_of`` makes, and ``transpose_rows_ref`` /
``transpose_tile_ref`` emulate each design's map from (block, thread, slot)
to elements, with the kernel's own index formulas and multiply-shift
divisions.
"""

from __future__ import annotations

import torch

THREADS = 256            # threads a block
ROW_VECS = 4             # rows: 16-byte vectors a thread loads before its first store
ROWS_MIN_BYTES = 128     # rows: the least row length in bytes
TILE_THREAD_BYTES = 32   # tile: bytes a thread holds in registers
BANKS = 32


def transpose01_ref(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(0, 1).contiguous()


def transpose_design(A: int, B: int, C: int, elem_bytes: int, x_ptr_mod16: int,
                     y_ptr_mod16: int) -> str:
    """The kernel's design for an ``(A, B, C)`` x of ``elem_bytes``-byte
    elements whose x and y addresses are ``x_ptr_mod16`` and ``y_ptr_mod16``
    mod 16: ``"rows"`` where a row's ``C * elem_bytes`` bytes are a multiple
    of 16 and at least ``ROWS_MIN_BYTES``, both addresses are 16-byte aligned
    and x has fewer than 2^31 16-byte vectors; ``"tile"`` else.
    ``transpose01`` refuses ``"rows"`` off this rule."""
    L = C * elem_bytes
    rows = (L % 16 == 0 and L >= ROWS_MIN_BYTES and x_ptr_mod16 == 0 and y_ptr_mod16 == 0
            and A * B * (L // 16) < 2 ** 31)
    return "rows" if rows else "tile"


def fast_div(d: int) -> tuple[int, int]:
    """``(m, s)`` with ``n // d == (n * m) >> s`` for ``0 <= n < 2**31``
    (``FastDiv`` in the source: s = 31 + ceil(log2 d), m = ceil(2^s / d))."""
    s = 31 + (d - 1).bit_length()
    return -(-(1 << s) // d), s


def _div(n, d):
    m, s = fast_div(d)
    return (n * m) >> s


def transpose_plan(A: int, B: int, C: int, elem_bytes: int, design: str) -> tuple:
    """The launch of ``design``: ``(blocks, p0, p1, p2, p3, shared bytes)``
    with rows' ``(vecs, 0, 0, 0)`` (a row's 16-byte vectors) or tile's
    ``(TA, TB, TC, stride)``."""
    if design == "rows":
        vecs = C * elem_bytes // 16
        return -(-A * B * vecs // (THREADS * ROW_VECS)), vecs, 0, 0, 0, 0
    cap = THREADS * (TILE_THREAD_BYTES // elem_bytes)
    tc = min(C, cap)
    t = 1
    while 4 * t * t * tc <= cap:
        t *= 2
    ta, tb = (2 * t if 2 * t * t * tc <= cap else t), t
    stride = tb * tc + (tc - tb * tc) % BANKS
    grid = -(-A // ta) * -(-B // tb) * -(-C // tc)
    return grid, ta, tb, tc, stride, ta * stride * elem_bytes


def _elements(x: torch.Tensor) -> torch.Tensor:
    return (torch.view_as_real(x) if x.is_complex() else x).contiguous()


def transpose_rows_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows design on the CPU: ``(y, writes)``, y built by moving the
    16-byte vector of x that each (block, thread, k) loads to the vector of
    y it stores, and ``writes`` the count of writes of each vector of y."""
    A, B, C = x.shape
    blocks, vecs = transpose_plan(A, B, C, x.element_size(), "rows")[:2]
    total = A * B * vecs
    xv = _elements(x).reshape(-1).view(torch.uint8).view(-1, 16)
    o = (torch.arange(blocks).view(-1, 1, 1) * (THREADS * ROW_VECS)
         + torch.arange(ROW_VECS).view(1, -1, 1) * THREADS + torch.arange(THREADS).view(1, 1, -1))
    r = _div(o, vecs)
    i = o - r * vecs
    b = _div(r, A)
    a = r - b * A
    live = o < total
    src, dst = ((a * B + b) * vecs + i)[live], o[live]
    yv = torch.zeros((total, 16), dtype=torch.uint8)
    yv[dst] = xv[src]
    y = yv.view(-1).view(torch.float32)
    y = torch.view_as_complex(y.view(B, A, C, 2)) if x.is_complex() else y.view(B, A, C)
    return y, torch.bincount(dst, minlength=total)


def transpose_tile_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tile design on the CPU: ``(y, writes)``.  Each block's shared
    memory holds the flat x index that each read slot stores at its index;
    each write slot takes the entry at its own index to its element of y.
    Fails if a write slot reads an entry no read slot stored, or two read
    slots of a block store at one index; ``writes`` counts the writes of
    each element of y."""
    A, B, C = x.shape
    gx, ta, tb, tc, stride, _ = transpose_plan(A, B, C, x.element_size(), "tile")
    slots = TILE_THREAD_BYTES // x.element_size()
    nc, nb = -(-C // tc), -(-B // tb)
    blk = torch.arange(gx).view(-1, 1)
    kab = _div(blk, nc)
    kc = blk - kab * nc
    ka = _div(kab, nb)
    kb = kab - ka * nb
    a0, b0, c0 = ka * ta, kb * tb, kc * tc
    ta_e, tb_e, tc_e = (torch.clamp(n - o, max=t) for n, o, t in ((A, a0, ta), (B, b0, tb),
                                                                     (C, c0, tc)))
    i = (torch.arange(THREADS).view(-1, 1) + torch.arange(slots).view(1, -1) * THREADS).view(1, -1)
    corner_x = (a0 * B + b0) * C + c0
    corner_y = (b0 * A + a0) * C + c0
    # read: slot i in row ia = i / (TB * TC) of the tile at j, at ia * skip_in + i of x's corner
    ia = _div(i, tb * tc)
    j = i - ia * tb * tc
    live = (ia < ta_e) & (j < tb_e * tc_e)
    at = (blk * ta * stride + ia * stride + j)[live]
    smem = torch.full((gx * ta * stride,), -1, dtype=torch.int64)
    if torch.bincount(at).max() > 1:
        raise AssertionError("two read slots of a block store at one shared-memory index")
    smem[at] = (corner_x + ia * (B * C - tb * tc) + i)[live]
    # write: slot o in row ib = o / (TA * TC) at k = ia * TC + c, to ib * skip_out + o of y's
    ib = _div(i, ta * tc)
    k = i - ib * ta * tc
    ia = _div(k, tc)
    c = k - ia * tc
    live = (ib < tb_e) & (k < ta_e * tc_e)
    got = smem[(blk * ta * stride + ia * stride + ib * tc + c)[live]]
    if bool((got < 0).any()):
        raise AssertionError("a write slot reads a shared-memory entry no read slot stored")
    dst = (corner_y + ib * (A * C - ta * tc) + i)[live]
    take = torch.zeros(B * A * C, dtype=torch.int64)
    take[dst] = got
    y = x.reshape(-1)[take].view(B, A, C)
    return y, torch.bincount(dst, minlength=B * A * C)

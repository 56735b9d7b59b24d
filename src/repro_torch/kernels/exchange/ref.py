"""Plain torch versions of the exchange kernels.

Each function mirrors one entry point of :mod:`.ops` (and of the
reference's ``repro/kernels/exchange/ref.py``): same arguments, same payload
layouts, same per-(field, chunk) scale blocking, built from the
:mod:`repro_torch.core.quant` codec plus explicit ``movedim`` realignment.
Payloads are re/im planes: ``(P, *shape)`` in place, ``(M, P, *s)``
chunk-major.  The encodes return ``(payload, scale, stats)``: with
``guard=True`` the bf16 stats are :func:`repro_torch.robustness.health.payload_stats`
of the planes and the int8 stats come from ``quantize_int8(with_stats=True)``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import quant
from repro_torch.robustness import health


def _prod(xs) -> int:
    return int(math.prod(xs))


def _to_planes(y: torch.Tensor) -> torch.Tensor:
    if y.is_complex():
        return quant.complex_to_planes(y)
    return y.to(torch.float32)[None]


def _from_planes(p: torch.Tensor, iscomplex: bool) -> torch.Tensor:
    if iscomplex:
        return quant.planes_to_complex(p)
    return p[0]


def _view6(shape, axis: int, m: int, nbatch: int):
    P, s = shape[0], shape[1:]
    if s[axis] % m != 0:
        raise ValueError(f"axis extent {s[axis]} not divisible by group size {m}")
    return (P, _prod(s[:nbatch]), _prod(s[nbatch:axis]), m, s[axis] // m,
            _prod(s[axis + 1:]))


def encode_payload_ref(y, *, axis, m, nbatch=0, codec, guard=False, scale_div=None):
    """In-place payload ``(P, *y.shape)``, the ``(F, M)`` int8 scales and the
    guard stats (``None`` unless ``guard``)."""
    planes = _to_planes(y)
    P, F, A, M, B, R = view = _view6(planes.shape, axis, m, nbatch)
    x6 = planes.reshape(view)
    if codec == "bf16":
        stats = health.payload_stats(x6) if guard else None
        return quant.encode_bf16(x6).reshape(planes.shape), None, stats
    q, sc, *stats = quant.quantize_int8(x6, block_axis=(1, 3), scale_div=scale_div,
                                        with_stats=guard)
    return q.reshape(planes.shape), sc.reshape(F, M), stats[0] if guard else None


def decode_payload_ref(p, *, axis, m, nbatch=0, scale, codec, iscomplex):
    P, F, A, M, WB, R = view = _view6(p.shape, axis, m, nbatch)
    x6 = p.reshape(view)
    if codec == "int8":
        out = quant.dequantize_int8(x6, scale.reshape(1, F, 1, M, 1, 1))
    else:
        out = quant.decode_bf16(x6)
    return _from_planes(out.reshape(p.shape), iscomplex)


def pack_chunks_ref(y, *, axis, m, nbatch=0, codec, guard=False, scale_div=None):
    """Chunk-major payload ``(M, P, *s)`` (``s[axis]`` the chunk extent), the
    ``(M, F)`` int8 scales and the guard stats."""
    planes = _to_planes(y)
    P, F, A, M, B, R = view = _view6(planes.shape, axis, m, nbatch)
    q, scale, stats = encode_payload_ref(y, axis=axis, m=m, nbatch=nbatch, codec=codec,
                                         guard=guard, scale_div=scale_div)
    packed = torch.movedim(q.reshape(view), 3, 0)
    s = list(planes.shape[1:])
    s[axis] = B
    if scale is not None:
        scale = scale.T.contiguous()  # (F, M) -> (M, F)
    # contiguous, as the kernel writes it: the buffer all_to_all_single sends
    return packed.reshape((M, P, *s)).contiguous(), scale, stats


def unpack_chunks_ref(p, *, v, w, m, nbatch=0, scale, codec, iscomplex):
    """Scatter received chunk ``j`` of ``(M, P, *s)`` into w-slot ``j`` while
    decoding; ``v``/``w`` are field-relative axes of ``s``."""
    M, P = p.shape[0], p.shape[1]
    s = p.shape[2:]
    if M != m:
        raise ValueError(f"payload carries {M} chunks, group has {m}")
    bv, bw = v + nbatch, w + nbatch
    F = _prod(s[:nbatch])
    if bw < bv:
        in_view = (M, P, F, _prod(s[nbatch:bw]), s[bw],
                   _prod(s[bw + 1:bv]), s[bv], _prod(s[bv + 1:]))
        m_out = 3
    else:
        in_view = (M, P, F, _prod(s[nbatch:bv]), s[bv],
                   _prod(s[bv + 1:bw]), s[bw], _prod(s[bw + 1:]))
        m_out = 5
    x8 = p.reshape(in_view)
    if codec == "int8":
        out = quant.dequantize_int8(x8, scale.reshape(M, 1, F, 1, 1, 1, 1, 1))
    else:
        out = quant.decode_bf16(x8)
    out = torch.movedim(out, 0, m_out)
    final = list(s)
    final[bw] = M * s[bw]
    return _from_planes(out.reshape((P, *final)), iscomplex)


# ---------------------------------------------------------------------------
# the kernels' order of work (csrc/exchange.cu: enc_amax_kernel, enc_kernel
# and decode_kernel share one tile map)
# ---------------------------------------------------------------------------

#: the codec kernels' threads per block and floats per tile (kThreads, kTile)
THREADS, TILE = 256, 8192


def tile_design(F, O, M, S, P, layout, block_ptr: int, payload_ptr: int) -> str:  # noqa: ARG001
    """The codec kernels' design, encode and decode alike, for the ``(F, O,
    M, S, P)`` view in ``layout`` with the block at address ``block_ptr``
    and the payload at ``payload_ptr``: ``"vec"`` (4 complex or 4 reals a
    step, 16-byte block accesses) where ``S % 4 == 0`` (no vector straddles
    a run; every run and wire-plane start is aligned), the block is 16-byte
    and the payload 8-byte aligned, else ``"scalar"``.  ``exchange_encode``
    and ``exchange_decode`` refuse ``"vec"`` where this fails."""
    return "vec" if S % 4 == 0 and block_ptr % 16 == 0 and payload_ptr % 8 == 0 else "scalar"


def tile_map(F, O, M, S, P, layout, design):
    """Which block float and which payload element each step of the codec
    kernels pairs, in their order of work (scale block, tile, step, thread,
    float of the vector), computed with the kernels' own offset formulas
    (``tile_of``, ``locate``).  The encode reads the block float and writes
    the payload element; the decode reads the element and writes the float.
    Returns ``(fm, src, dst)``: the scale block ``f * M + m``, the block-side
    float index and the flat payload index, one entry per float moved."""
    V = 4 * P if design == "vec" else 1
    L, n = S * P, O * S * P
    tiles = -(-n // TILE)
    steps = TILE // (THREADS * V)
    fm = torch.arange(F * M).view(-1, 1, 1, 1, 1)
    t = torch.arange(tiles).view(1, -1, 1, 1, 1)
    u = torch.arange(steps).view(1, 1, -1, 1, 1)
    thr = torch.arange(THREADS).view(1, 1, 1, -1, 1)
    k = torch.arange(V).view(1, 1, 1, 1, -1)
    i = (u * THREADS + thr) * V  # the vector's first float in the tile
    f, m = fm // M, fm % M
    e0 = t * TILE
    bbase = (f * O * M + m) * L
    wbase = (m * P * F + f) * O * S if layout == 1 else (f * O * M + m) * S
    pstride = F * O * S if layout == 1 else F * O * M * S
    if M == 1 or O == 1:  # contiguous: a shift
        xt, wt = bbase + e0, wbase + e0 // P
        xo, wo, p0 = i, i // P, i % P
    else:  # one 32-bit division per vector
        bstride, wstride = M * L, (S if layout == 1 else M * S)
        o0 = e0 // L
        j0 = e0 - o0 * L
        xt, wt = bbase + o0 * bstride, wbase + o0 * wstride
        e = j0 + i
        d = e // L
        j = e - d * L
        xo, wo, p0 = d * bstride + j, d * wstride + j // P, j % P
    if V == 1:
        src, dst = xt + xo + 0 * k, wt + p0 * pstride + wo + 0 * k
    else:  # plane p holds floats p, P + p, 2P + p, 3P + p of the vector
        src, dst = xt + xo + k, wt + (k % P) * pstride + wo + k // P
    live = (i < torch.clamp(n - e0, max=TILE)).expand(src.shape)
    fm = fm.expand(src.shape)
    return fm[live], src[live], dst[live]


def encode_tiles_ref(x: torch.Tensor, F, O, M, S, P, *, codec, layout, design,
                     guard=False, scale_div=None):
    """The encode as the kernel orders it (:func:`tile_map`): the
    flat float block ``x`` (``F * O * M * S * P`` floats) in, ``(payload,
    scales, counts, reads, writes)`` out, with the payload flat in
    ``layout``, the int8 scales and the guard counts laid out as the
    kernel's (``(F, M)`` in place, ``(M, F)`` chunk-major, counts with a
    trailing ``(nonfinite, saturated)`` pair), and how many times the map
    read each block float and wrote each payload element."""
    fm, src, dst = tile_map(F, O, M, S, P, layout, design)
    N = F * O * M * S * P
    reads = torch.bincount(src, minlength=N)
    writes = torch.bincount(dst, minlength=N)
    a = x.reshape(-1)[src]
    finite = torch.isfinite(a)
    nonfinite = torch.zeros(F * M, dtype=torch.float32).index_add_(0, fm, (~finite).float())
    saturated = torch.zeros(F * M, dtype=torch.float32)
    scales = None
    if codec == "bf16":
        q = torch.empty(N, dtype=torch.bfloat16)
        q[dst] = quant.encode_bf16(a)
    else:
        xf = torch.where(finite, a, torch.zeros((), dtype=a.dtype))
        amax = torch.zeros(F * M, dtype=torch.float32).scatter_reduce_(0, fm, xf.abs(), "amax")
        scale = torch.clamp_min(amax, quant._EPS) / torch.full_like(amax, 127.0)
        if scale_div is not None:
            scale = scale / torch.full_like(scale, scale_div)
        r = torch.clamp(torch.round(xf / scale[fm]), -127, 127)
        q = torch.empty(N, dtype=torch.int8)
        q[dst] = r.to(torch.int8)
        saturated.index_add_(0, fm, (r.abs() == 127).float())
        scales = scale
    counts = torch.stack([nonfinite, saturated], -1) if guard else None
    if layout == 1:  # (F, M) -> (M, F)
        if scales is not None:
            scales = scales.view(F, M).T.contiguous()
        if counts is not None:
            counts = counts.view(F, M, 2).transpose(0, 1).contiguous()
    else:
        if scales is not None:
            scales = scales.view(F, M)
        if counts is not None:
            counts = counts.view(F, M, 2)
    return q, scales, counts, reads, writes


def decode_tiles_ref(payload: torch.Tensor, scales, F, O, M, S, P, *, codec, layout, design):
    """The decode as the kernel orders it (:func:`tile_map`, the encode's
    map read backwards): the flat payload (bf16 or int8, ``layout``) and for
    int8 its scales (``(F, M)`` in place, ``(M, F)`` chunk-major) in,
    ``(block, reads, writes)`` out: the flat float block and how many times
    the map read each payload element and wrote each block float.  bf16
    widens as the kernel does, the bits shifted up 16; int8 is one multiply
    by the scale of the element's ``(f, m)``.  (The kernel's P = 2 vec
    design hands each 16-byte piece of a warp step's 32 vectors to another
    lane of the warp to store; which float each element lands in is the
    map's.)"""
    fm, src, dst = tile_map(F, O, M, S, P, layout, design)
    N = F * O * M * S * P
    q = payload.reshape(-1)[dst]
    if codec == "bf16":
        a = (q.view(torch.int16).to(torch.int32) << 16).view(torch.float32)
    else:
        f, m = fm // M, fm % M
        sidx = m * F + f if layout == 1 else f * M + m
        a = q.to(torch.float32) * scales.reshape(-1)[sidx]
    block = torch.empty(N, dtype=torch.float32)
    block[src] = a
    return block, torch.bincount(dst, minlength=N), torch.bincount(src, minlength=N)

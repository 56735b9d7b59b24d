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
    return packed.reshape((M, P, *s)), scale, stats


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

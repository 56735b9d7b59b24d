"""Wrappers of the exchange codec kernels (the port of
``repro/kernels/exchange/ops.py``), with the reference's arguments and
payload layouts:

:func:`encode_payload` / :func:`decode_payload` — payload in place,
    ``(P, *shape)`` re/im planes, ``(F, M)`` int8 scales.
:func:`pack_chunks` / :func:`unpack_chunks` — chunk-major payload
    ``(M, P, *s)`` with ``(M, F)`` scales: what ``all_to_all_single``
    splits on dim 0, and what the port's fused exchange ships.  The unpack
    scatters received chunk ``j`` into slot ``j`` of the concat axis.

A tensor on the CPU takes the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel (:mod:`.kernel`).  ``launches`` counts kernel launches
per wrapper and codec: an int8 encode is two (max-abs, then quantize).
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from repro_torch.kernels.exchange import ref

#: kernel launches per "<wrapper>:<codec>"
launches: Counter = Counter()
#: kernels one encode launches per codec: int8 runs a max-abs pass, then the quantize pass
ENCODE_KERNELS = {"bf16": 1, "int8": 2}


def _prod(xs) -> int:
    return int(math.prod(xs))


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no exchange kernel for device {t.device}")
    return t.device.type


def _chunk_view(s, axis: int, m: int, nbatch: int):
    """(F, O, M, S) of a block shape ``s`` chunked ``m`` ways along ``axis``."""
    if s[axis] % m != 0:
        raise ValueError(f"axis extent {s[axis]} not divisible by group size {m}")
    return _prod(s[:nbatch]), _prod(s[nbatch:axis]), m, s[axis] // m * _prod(s[axis + 1:])


def _planes(y: torch.Tensor) -> int:
    return 2 if y.is_complex() else 1


def _block_dtype(iscomplex: bool):
    return torch.complex64 if iscomplex else torch.float32


def encode_payload(y: torch.Tensor, *, axis: int, m: int, nbatch: int = 0, codec: str):
    """Encode block ``y`` in place: ``(payload (P, *y.shape), scales (F, M) | None)``."""
    if _device_kind(y) == "cpu":
        return ref.encode_payload_ref(y, axis=axis, m=m, nbatch=nbatch, codec=codec)
    from repro_torch.kernels.exchange import kernel

    y = y.contiguous()
    q, scales = kernel.encode(y, *_chunk_view(y.shape, axis, m, nbatch), codec=codec,
                              layout=kernel.IN_PLACE)
    launches[f"encode_payload:{codec}"] += ENCODE_KERNELS[codec]
    return q.reshape(_planes(y), *y.shape), scales


def decode_payload(p: torch.Tensor, *, axis: int, m: int, nbatch: int = 0, scale,
                   codec: str, iscomplex: bool) -> torch.Tensor:
    """Decode an in-place payload ``(P, *shape)`` whose ``axis`` holds ``m``
    sender chunks back into the block."""
    if _device_kind(p) == "cpu":
        return ref.decode_payload_ref(p, axis=axis, m=m, nbatch=nbatch, scale=scale,
                                      codec=codec, iscomplex=iscomplex)
    from repro_torch.kernels.exchange import kernel

    s = tuple(p.shape[1:])
    out = torch.empty(s, dtype=_block_dtype(iscomplex), device=p.device)
    kernel.decode(p.contiguous(), scale, out, *_chunk_view(s, axis, m, nbatch),
                  codec=codec, layout=kernel.IN_PLACE)
    launches[f"decode_payload:{codec}"] += 1
    return out


def pack_chunks(y: torch.Tensor, *, axis: int, m: int, nbatch: int = 0, codec: str):
    """Encode block ``y`` into the chunk-major payload ``(M, P, *s)``
    (``s[axis]`` the chunk extent) and ``(M, F)`` int8 scales."""
    if _device_kind(y) == "cpu":
        return ref.pack_chunks_ref(y, axis=axis, m=m, nbatch=nbatch, codec=codec)
    from repro_torch.kernels.exchange import kernel

    y = y.contiguous()
    q, scales = kernel.encode(y, *_chunk_view(y.shape, axis, m, nbatch), codec=codec,
                              layout=kernel.CHUNK_MAJOR)
    launches[f"pack_chunks:{codec}"] += ENCODE_KERNELS[codec]
    s = list(y.shape)
    s[axis] //= m
    return q.reshape(m, _planes(y), *s), scales


def unpack_chunks(p: torch.Tensor, *, v: int, w: int, m: int, nbatch: int = 0, scale,
                  codec: str, iscomplex: bool) -> torch.Tensor:
    """Decode the received chunk-major payload ``(M, P, *s)``, scattering
    chunk ``j`` into slot ``j`` of axis ``w`` (field-relative ``v``/``w``)."""
    if _device_kind(p) == "cpu":
        return ref.unpack_chunks_ref(p, v=v, w=w, m=m, nbatch=nbatch, scale=scale,
                                     codec=codec, iscomplex=iscomplex)
    from repro_torch.kernels.exchange import kernel

    if p.shape[0] != m:
        raise ValueError(f"payload carries {p.shape[0]} chunks, group has {m}")
    s = list(p.shape[2:])
    bw = w + nbatch
    F, O, S = _prod(s[:nbatch]), _prod(s[nbatch:bw]), _prod(s[bw:])
    final = list(s)
    final[bw] *= m
    out = torch.empty(final, dtype=_block_dtype(iscomplex), device=p.device)
    kernel.decode(p.contiguous(), scale, out, F, O, m, S, codec=codec,
                  layout=kernel.CHUNK_MAJOR)
    launches[f"unpack_chunks:{codec}"] += 1
    return out

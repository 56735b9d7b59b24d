"""Wrappers of the exchange codec kernels (the port of
``repro/kernels/exchange/ops.py``), with the reference's arguments and
payload layouts:

:func:`encode_payload` / :func:`decode_payload` — payload in place,
    ``(P, *shape)`` re/im planes, ``(F, M)`` int8 scales.
:func:`pack_chunks` / :func:`unpack_chunks` — chunk-major payload
    ``(M, P, *s)`` with ``(M, F)`` scales: what ``all_to_all_single``
    splits on dim 0, and what the port's fused exchange ships.  The unpack
    scatters received chunk ``j`` into slot ``j`` of the concat axis.

The encodes return ``(payload, scale, stats)`` as the reference's do:
``stats`` is ``None``, or with ``guard=True`` the ``{"nonfinite",
"saturated"}`` f32 counts summed over the per-(field, chunk) blocks.
``scale_div`` divides the int8 scales (the saturation fault).

A tensor on the CPU takes the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel (:mod:`.kernel`).  ``launches`` counts kernel launches
per wrapper and codec (``"<wrapper>:<codec>"``, with ``":guard"`` appended
for a guarded encode): an int8 encode is two (max-abs, then quantize).
``design_launches`` counts the encode's launches again by the design that
ran (``"<design>:<codec>"``: ``"vec"``, 16-byte block accesses, or
``"scalar"``, one float a step; :func:`.ref.tile_design` is the rule), and
``decode_design_launches`` the decode's the same way.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from repro_torch.core.quant import canonical_comm_dtype
from repro_torch.kernels.exchange import ref

#: kernel launches per "<wrapper>:<codec>"
launches: Counter = Counter()
#: the encode's launches per design and codec ("vec:bf16", "scalar:int8", ...)
design_launches: Counter = Counter()
#: the decode's launches per design and codec, keyed as ``design_launches``
decode_design_launches: Counter = Counter()
#: kernels one encode launches per codec: int8 runs a max-abs pass, then the quantize pass
ENCODE_KERNELS = {"bf16": 1, "int8": 2}


def cuda_applicable(method: str, comm_dtype) -> bool:  # noqa: ARG001
    """Whether ``impl="cuda"`` changes anything for a stage of ``method``
    shipping ``comm_dtype``: true for a lossy payload only (the codec gives
    the kernels their work).  A lossless stage runs the same plain pack and
    scatter under either impl, so the tuner sweeps no lossless ``"cuda"``
    candidate.  ``method`` is taken as the reference's ``pallas_applicable``
    takes it."""
    return canonical_comm_dtype(comm_dtype) != "complex64"


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


def _stats_dict(counts: torch.Tensor | None) -> dict | None:
    """Per-(field, chunk) ``(..., 2)`` counts -> the summed stats dict."""
    if counts is None:
        return None
    return {"nonfinite": counts[..., 0].sum(), "saturated": counts[..., 1].sum()}


def _encode(y, axis, m, nbatch, codec, guard, scale_div, layout, wrapper):
    from repro_torch.kernels.exchange import kernel

    y = y.contiguous()
    q, scales, counts, design = kernel.encode(
        y, *_chunk_view(y.shape, axis, m, nbatch), codec=codec, layout=layout, guard=guard,
        scale_div=1.0 if scale_div is None else scale_div)
    launches[f"{wrapper}:{codec}{':guard' if guard else ''}"] += ENCODE_KERNELS[codec]
    design_launches[f"{design}:{codec}"] += ENCODE_KERNELS[codec]
    return y, q, scales, _stats_dict(counts)


def encode_payload(y: torch.Tensor, *, axis: int, m: int, nbatch: int = 0, codec: str,
                   guard: bool = False, scale_div=None):
    """Encode block ``y`` in place: ``(payload (P, *y.shape), scales (F, M) | None,
    stats | None)``."""
    if _device_kind(y) == "cpu":
        return ref.encode_payload_ref(y, axis=axis, m=m, nbatch=nbatch, codec=codec,
                                      guard=guard, scale_div=scale_div)
    from repro_torch.kernels.exchange import kernel

    y, q, scales, stats = _encode(y, axis, m, nbatch, codec, guard, scale_div,
                                  kernel.IN_PLACE, "encode_payload")
    return q.reshape(_planes(y), *y.shape), scales, stats


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
    _, design = kernel.decode(p.contiguous(), scale, out, *_chunk_view(s, axis, m, nbatch),
                              codec=codec, layout=kernel.IN_PLACE)
    launches[f"decode_payload:{codec}"] += 1
    decode_design_launches[f"{design}:{codec}"] += 1
    return out


def pack_chunks(y: torch.Tensor, *, axis: int, m: int, nbatch: int = 0, codec: str,
                guard: bool = False, scale_div=None):
    """Encode block ``y`` into the chunk-major payload ``(M, P, *s)``
    (``s[axis]`` the chunk extent): ``(payload, (M, F) int8 scales | None,
    stats | None)``."""
    if _device_kind(y) == "cpu":
        return ref.pack_chunks_ref(y, axis=axis, m=m, nbatch=nbatch, codec=codec,
                                   guard=guard, scale_div=scale_div)
    from repro_torch.kernels.exchange import kernel

    y, q, scales, stats = _encode(y, axis, m, nbatch, codec, guard, scale_div,
                                  kernel.CHUNK_MAJOR, "pack_chunks")
    s = list(y.shape)
    s[axis] //= m
    return q.reshape(m, _planes(y), *s), scales, stats


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
    _, design = kernel.decode(p.contiguous(), scale, out, F, O, m, S, codec=codec,
                              layout=kernel.CHUNK_MAJOR)
    launches[f"unpack_chunks:{codec}"] += 1
    decode_design_launches[f"{design}:{codec}"] += 1
    return out

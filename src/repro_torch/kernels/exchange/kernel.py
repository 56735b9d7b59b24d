"""ctypes binding of the exchange codec kernels (``csrc/exchange.cu``).

Both entry points take the block as its ``(F, O, M, S, P)`` float view and
the payload in one of two layouts (``IN_PLACE``: ``(P, F, O, M, S)``;
``CHUNK_MAJOR``: ``(M, P, F, O, S)``).  The library is built and loaded at
the first launch, never at import.  ``encode`` and ``decode`` pick their
design with :func:`.ref.tile_design` (``"vec"`` or ``"scalar"``), pass it
to the kernel as its ``design`` argument (the C side refuses ``"vec"`` where
the rule fails) and return it; with ``guard=True`` ``encode`` also returns
the per-(field, chunk) ``(nonfinite, saturated)`` counts, laid out like the
scales with a trailing pair.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.exchange.ref import tile_design

IN_PLACE, CHUNK_MAJOR = 0, 1
_CODECS = {"bf16": 0, "int8": 1}
_DESIGNS = {"scalar": 0, "vec": 1}
_WIRE = {"bf16": torch.bfloat16, "int8": torch.int8}

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
_f = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.library("exchange")
    lib.exchange_encode.argtypes = [_c, _c, _c, _c, _c, _i, _i, _ll, _ll, _ll, _ll, _i, _f, _i,
                                    _c]
    lib.exchange_encode.restype = _i
    lib.exchange_decode.argtypes = [_c, _c, _c, _i, _i, _ll, _ll, _ll, _ll, _i, _i, _c]
    lib.exchange_decode.restype = _i
    return lib


def _floats(block: torch.Tensor) -> torch.Tensor:
    """The block's interleaved f32 storage (complex64 or float32)."""
    if not block.is_cuda or not block.is_contiguous():
        raise ValueError("the exchange kernels need a contiguous CUDA block")
    if block.dtype == torch.complex64:
        return torch.view_as_real(block)
    if block.dtype == torch.float32:
        return block
    raise ValueError(f"the exchange kernels take complex64 or float32 blocks, got {block.dtype}")


def encode(block: torch.Tensor, F: int, O: int, M: int, S: int, *, codec: str, layout: int,
           guard: bool = False, scale_div: float = 1.0):
    """Encode ``block`` (viewed ``(F, O, M, S)``) into a new payload of
    ``layout``; returns ``(payload, scales, counts)`` with the payload flat in
    its layout, for int8 the ``(F, M)`` or ``(M, F)`` f32 scales (each divided
    by ``scale_div``), with ``guard`` the f32 counts of the same layout with a
    trailing ``(nonfinite, saturated)`` pair, and the design that ran."""
    x = _floats(block)
    P = 2 if block.is_complex() else 1
    if x.numel() != F * O * M * S * P:
        raise ValueError(f"block of {x.numel()} floats is not a ({F}, {O}, {M}, {S}, {P}) view")
    dev = block.device
    q = torch.empty(x.numel(), dtype=_WIRE[codec], device=dev)
    blocks = (M, F) if layout == CHUNK_MAJOR else (F, M)
    scales = amax = counts = None
    if codec == "int8":
        scales = torch.empty(blocks, dtype=torch.float32, device=dev)
        amax = torch.zeros(F * M, dtype=torch.int32, device=dev)
    if guard:
        counts = torch.zeros((*blocks, 2), dtype=torch.int64, device=dev)
    design = tile_design(F, O, M, S, P, layout, x.data_ptr(), q.data_ptr())
    rc = _lib().exchange_encode(
        x.data_ptr(), q.data_ptr(), 0 if scales is None else scales.data_ptr(),
        0 if amax is None else amax.data_ptr(), 0 if counts is None else counts.data_ptr(),
        _CODECS[codec], layout, F, O, M, S, P, float(scale_div), _DESIGNS[design],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exchange_encode ({design} design) failed with CUDA error {rc}")
    return q, scales, None if counts is None else counts.to(torch.float32), design


def decode(payload: torch.Tensor, scales: torch.Tensor | None, out: torch.Tensor,
           F: int, O: int, M: int, S: int, *, codec: str, layout: int):
    """Decode ``payload`` (``layout``) into the preallocated block ``out``
    (viewed ``(F, O, M, S)``), chunk ``m`` of field ``f`` with its sender's
    scale for int8.  Returns ``(out, design)``."""
    y = _floats(out)
    P = 2 if out.is_complex() else 1
    if payload.dtype != _WIRE[codec] or not payload.is_cuda or not payload.is_contiguous():
        raise ValueError(f"{codec} payload must be a contiguous CUDA {_WIRE[codec]} tensor")
    if payload.numel() != y.numel() or y.numel() != F * O * M * S * P:
        raise ValueError("payload, block and view sizes differ")
    if codec == "int8":
        if scales is None or scales.numel() != F * M or not scales.is_contiguous():
            raise ValueError("int8 decode needs F * M contiguous scales")
        scales = scales.to(torch.float32)
    design = tile_design(F, O, M, S, P, layout, y.data_ptr(), payload.data_ptr())
    rc = _lib().exchange_decode(
        payload.data_ptr(), 0 if scales is None else scales.data_ptr(), y.data_ptr(),
        _CODECS[codec], layout, F, O, M, S, P, _DESIGNS[design],
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exchange_decode ({design} design) failed with CUDA error {rc}")
    return out, design

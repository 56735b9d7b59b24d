"""ctypes binding of the local-transpose kernel (``csrc/transpose.cu``).

``transpose01`` picks the design with :func:`.ref.transpose_design`
(``"rows"`` or ``"tile"``) and passes it to the C entry, which refuses
``"rows"`` off that rule.  The library is built and loaded at the first
launch, never at import."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.transpose.ref import transpose_design

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int

#: element bytes per dtype: complex64 moves as one 8-byte re/im pair
_ELEM_BYTES = {torch.float32: 4, torch.complex64: 8}
_DESIGNS = {"tile": 0, "rows": 1}


def _lib() -> ctypes.CDLL:
    lib = _build.library("transpose")
    lib.transpose01.argtypes = [_c, _c, _ll, _ll, _ll, _i, _i, _c]
    lib.transpose01.restype = _i
    lib.transpose01_design.argtypes = [_ll, _ll, _ll, _i, _ll, _ll]
    lib.transpose01_design.restype = _i
    lib.transpose01_plan.argtypes = [_ll, _ll, _ll, _i, _i, ctypes.POINTER(_ll)]
    lib.transpose01_plan.restype = None
    return lib


def design_of(x: torch.Tensor, y: torch.Tensor) -> str:
    """The design that ``transpose01`` runs for ``x`` into ``y``."""
    a, b, c = x.shape
    return transpose_design(a, b, c, _ELEM_BYTES[x.dtype], x.data_ptr() % 16,
                            y.data_ptr() % 16)


def transpose01(x: torch.Tensor) -> torch.Tensor:
    """``(A, B, C) -> (B, A, C)`` of a contiguous CUDA float32 or complex64
    tensor, into a new tensor."""
    if not x.is_cuda or not x.is_contiguous() or x.dim() != 3:
        raise ValueError("transpose01 needs a contiguous 3-D CUDA tensor")
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(f"transpose01 takes float32 or complex64, got {x.dtype}")
    a, b, c = x.shape
    y = torch.empty((b, a, c), dtype=x.dtype, device=x.device)
    design = design_of(x, y)
    rc = _lib().transpose01(x.data_ptr(), y.data_ptr(), a, b, c, _ELEM_BYTES[x.dtype],
                            _DESIGNS[design], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"transpose01 ({design} design) failed with CUDA error {rc}")
    return y


def c_design(A: int, B: int, C: int, elem_bytes: int, x_ptr_mod16: int,
             y_ptr_mod16: int) -> str:
    """The C side's rule (the twin of ``ref.transpose_design``)."""
    d = _lib().transpose01_design(A, B, C, elem_bytes, x_ptr_mod16, y_ptr_mod16)
    return {v: k for k, v in _DESIGNS.items()}[d]


def c_plan(A: int, B: int, C: int, elem_bytes: int, design: str) -> tuple:
    """The C side's launch of ``design`` (the twin of ``ref.transpose_plan``)."""
    out = (_ll * 6)()
    _lib().transpose01_plan(A, B, C, elem_bytes, _DESIGNS[design], out)
    return tuple(out)

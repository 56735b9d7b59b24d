"""ctypes binding of the local-transpose kernel (``csrc/transpose.cu``).
The library is built and loaded at the first launch, never at import."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int

#: element bytes per dtype: complex64 moves as one 8-byte re/im pair
_ELEM_BYTES = {torch.float32: 4, torch.complex64: 8}


def _lib() -> ctypes.CDLL:
    lib = _build.library("transpose")
    lib.transpose01.argtypes = [_c, _c, _ll, _ll, _ll, _i, _c]
    lib.transpose01.restype = _i
    return lib


def transpose01(x: torch.Tensor) -> torch.Tensor:
    """``(A, B, C) -> (B, A, C)`` of a contiguous CUDA float32 or complex64
    tensor, into a new tensor."""
    if not x.is_cuda or not x.is_contiguous() or x.dim() != 3:
        raise ValueError("transpose01 needs a contiguous 3-D CUDA tensor")
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(f"transpose01 takes float32 or complex64, got {x.dtype}")
    a, b, c = x.shape
    y = torch.empty((b, a, c), dtype=x.dtype, device=x.device)
    rc = _lib().transpose01(x.data_ptr(), y.data_ptr(), a, b, c, _ELEM_BYTES[x.dtype],
                            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"transpose01 failed with CUDA error {rc}")
    return y

"""ctypes binding of the four-step DFT kernel (``csrc/fourstep.cu``).

The library is built (``repro_torch._build``) and loaded at the first
launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.library("fourstep")
    lib.fourstep_dft.argtypes = [_c, _c, _ll, _i, _i, _i, _i, _i, _i, _c, _c]
    lib.fourstep_dft.restype = _i
    lib.fourstep_general_split.argtypes = [_i, ctypes.POINTER(_i), ctypes.POINTER(_i)]
    lib.fourstep_general_split.restype = None
    return lib


def general_split(n: int) -> tuple[int, int]:
    """The general design's split of ``n`` as the C side computes it (the
    twin of ``ref.general_split``)."""
    n1, n2 = _i(), _i()
    _lib().fourstep_general_split(n, ctypes.byref(n1), ctypes.byref(n2))
    return n1.value, n2.value


def fourstep(x: torch.Tensor, n1: int, n2: int, *, inverse: bool = False,
             nout: int | None = None, mats: torch.Tensor | None = None) -> torch.Tensor:
    """DFT of every row of a contiguous CUDA ``(batch, n)`` tensor, complex64
    (or float32: real input) -> ``(batch, nout)`` complex64, the first
    ``nout`` bins (all ``n`` by default), ``n = n1 * n2``.  ``mats`` is
    ``ops.tc_matrices(n1, n2, inverse)`` for the lengths of the tensor-core
    design and None for the others; the kernel refuses a mismatch."""
    if not x.is_cuda or not x.is_contiguous() or x.dim() != 2:
        raise ValueError("fourstep needs a contiguous 2-D CUDA tensor")
    if x.dtype not in (torch.complex64, torch.float32):
        raise ValueError(f"fourstep takes complex64 or float32, got {x.dtype}")
    batch, n = x.shape
    if n1 * n2 != n:
        raise ValueError(f"length {n} != {n1} * {n2}")
    if mats is not None and (not mats.is_cuda or mats.dtype != torch.float32
                             or not mats.is_contiguous()):
        raise ValueError("fourstep's tables must be a contiguous float32 CUDA tensor")
    nout = n if nout is None else nout
    y = torch.empty((batch, nout), dtype=torch.complex64, device=x.device)
    rc = _lib().fourstep_dft(x.data_ptr(), y.data_ptr(), batch, n, n1, n2, int(inverse),
                             int(x.dtype == torch.float32), nout,
                             None if mats is None else mats.data_ptr(),
                             torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fourstep_dft failed with CUDA error {rc} at length {n} "
                           f"(= {n1} * {n2}, batch {batch})")
    return y

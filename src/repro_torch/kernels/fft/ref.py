"""Plain versions of the four-step DFT kernel, and its transform tables.

``dft_matrix`` / ``twiddle_matrix`` / ``dct_matrix`` / ``dst_matrix`` are
numpy copies of the reference's tables (``repro/kernels/fft/ref.py``), equal
to them bit for bit.  ``fourstep_ref`` is the four-step algorithm in plain
torch (the kernel's arithmetic without its tiling) and ``fft_ref`` the
``torch.fft`` ground truth.
"""

from __future__ import annotations

import numpy as np
import torch


def fft_ref(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Reference 1-D (i)FFT along the last axis."""
    return torch.fft.ifft(x, dim=-1) if inverse else torch.fft.fft(x, dim=-1)


def dft_matrix(n: int, dtype=np.complex64) -> np.ndarray:
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n).astype(dtype)


def twiddle_matrix(n1: int, n2: int, dtype=np.complex64) -> np.ndarray:
    """T[k1, n2] = exp(-2πi k1 n2 / (n1 n2))."""
    k1 = np.arange(n1)
    n2i = np.arange(n2)
    return np.exp(-2j * np.pi * np.outer(k1, n2i) / (n1 * n2)).astype(dtype)


def dct_matrix(n: int, trig_type: int = 2, dtype=np.float32) -> np.ndarray:
    """Unnormalized (scipy-convention) DCT-II/III matrix: y = M @ x."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    if trig_type == 2:
        m = 2.0 * np.cos(np.pi * k * (2 * j + 1) / (2 * n))
    elif trig_type == 3:
        m = 2.0 * np.cos(np.pi * j * (2 * k + 1) / (2 * n))
        m[:, 0] = 1.0
    else:
        raise ValueError(f"dct type must be 2 or 3, got {trig_type}")
    return m.astype(dtype)


def dst_matrix(n: int, trig_type: int = 2, dtype=np.float32) -> np.ndarray:
    """Unnormalized (scipy-convention) DST-II/III matrix: y = M @ x."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    if trig_type == 2:
        m = 2.0 * np.sin(np.pi * (k + 1) * (2 * j + 1) / (2 * n))
    elif trig_type == 3:
        m = 2.0 * np.sin(np.pi * (j + 1) * (2 * k + 1) / (2 * n))
        m[:, n - 1] = (-1.0) ** k[:, 0]
    else:
        raise ValueError(f"dst type must be 2 or 3, got {trig_type}")
    return m.astype(dtype)


def fourstep_ref(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Four-step DFT along the last axis (length n1*n2) of a complex64
    tensor: input row-major (n1, n2), output k = k1 + n1*k2."""
    *batch, n = x.shape
    if n != n1 * n2:
        raise ValueError(f"length {n} != {n1} * {n2}")
    dev = x.device
    a = x.reshape(*batch, n1, n2)
    f1 = torch.from_numpy(dft_matrix(n1)).to(dev)
    f2 = torch.from_numpy(dft_matrix(n2)).to(dev)
    tw = torch.from_numpy(twiddle_matrix(n1, n2)).to(dev)
    a1 = torch.matmul(f1, a)             # DFT over n1: (..., k1, n2)
    a2 = a1 * tw                         # twiddle
    a3 = torch.matmul(a2, f2)            # DFT over n2: (..., k1, k2)
    return a3.transpose(-1, -2).reshape(*batch, n)  # (k2, k1) row-major

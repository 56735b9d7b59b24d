"""Plain versions of the four-step DFT kernel, and its transform tables.

``dft_matrix`` / ``twiddle_matrix`` / ``dct_matrix`` / ``dst_matrix`` are
numpy copies of the reference's tables (``repro/kernels/fft/ref.py``), equal
to them bit for bit.  ``fourstep_ref`` is the four-step algorithm in plain
torch (the kernel's arithmetic without its tiling) and ``fft_ref`` the
``torch.fft`` ground truth.

``tc_tables`` builds the tensor-core design's tables (the DFT matrices in
real block form, split into TF32 ``big + small``, and the twiddles) and
``fourstep_tf32_ref`` emulates that design's 3xTF32 arithmetic; the tests
use it to show the split is needed and enough.  ``general_split`` is the
general design's split of a length and ``fourstep_general_ref`` emulates
that design's order of work (its tables and its fp32 FMA chains).
"""

from __future__ import annotations

import math

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


def tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` for finite values: the low 13
    bits become 0."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(a: np.ndarray) -> np.ndarray:
    """float32 truncated to TF32 (the low 13 bits cleared): how the kernel
    takes the big part of a data value; NaN and Inf stay non-finite."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(big, small)``: TF32 values with ``big + small`` = float32 ``a``
    to within 2^-22 of ``|a|`` (``a - big`` is exact in float32)."""
    a = np.asarray(a, dtype=np.float32)
    big = tf32_round(a)
    return big, tf32_round(a - big)


def _roots(k: np.ndarray, n: int, inverse: bool) -> np.ndarray:
    """exp(-+2 pi i k / n) in float64, with k reduced mod n first."""
    return np.exp((2j if inverse else -2j) * np.pi * (k % n) / n)


def dft_block(n: int, inverse: bool = False) -> np.ndarray:
    """The DFT-n matrix F in real block form ``[[Fr, -Fi], [Fi, Fr]]``,
    float32 from float64: rows are (Re k, Im k), columns (Re j, Im j)."""
    k = np.arange(n)
    f = _roots(np.outer(k, k), n, inverse)
    return np.block([[f.real, -f.imag], [f.imag, f.real]]).astype(np.float32)


def tc_tables(n1: int, n2: int, inverse: bool = False) -> dict[str, np.ndarray]:
    """The tensor-core four-step's tables: F1 (2 n1 x 2 n1) and F2
    (2 n2 x 2 n2) in block form, each split into TF32 ``*_big`` and
    ``*_small``, and the twiddles T[k1, i2] (n1 x n2, complex64); the
    roots are conjugated for the inverse."""
    f1b, f1s = split_tf32(dft_block(n1, inverse))
    f2b, f2s = split_tf32(dft_block(n2, inverse))
    tw = _roots(np.outer(np.arange(n1), np.arange(n2)), n1 * n2, inverse).astype(np.complex64)
    return {"f1_big": f1b, "f1_small": f1s, "f2_big": f2b, "f2_small": f2s, "tw": tw}


def _mm_tf32(big: torch.Tensor, small: torch.Tensor, x: torch.Tensor,
             split: bool) -> torch.Tensor:
    """``F @ x`` as the kernel forms it: x split as it is read (big its
    TF32 truncation, small the rounding of the rest),
    ``big.small + small.big + big.big`` (or only ``big.big``), fp32 sums.
    A TF32 product is exact in fp32, so fp32 matmuls of the parts emulate
    the tensor cores."""
    xb = torch.from_numpy(tf32_trunc(x.numpy()))
    if not split:
        return big @ xb
    xs = torch.from_numpy(tf32_round((x - xb).numpy()))
    return big @ xs + small @ xb + big @ xb


def fourstep_tf32_ref(x: torch.Tensor, n1: int, n2: int, *, inverse: bool = False,
                      split: bool = True) -> torch.Tensor:
    """The tensor-core four-step on the CPU: a complex64 ``(batch, n1 n2)``
    tensor -> its DFT (inverse: conjugate roots and 1/n), every contraction
    in 3xTF32 (``split=False``: 1xTF32).  Tests only."""
    t = {k: torch.from_numpy(v) for k, v in tc_tables(n1, n2, inverse).items()}
    batch = x.shape[0]
    a = x.reshape(batch, n1, n2)
    c = _mm_tf32(t["f1_big"], t["f1_small"], torch.cat([a.real, a.imag], dim=-2), split)
    c = torch.complex(c[:, :n1], c[:, n1:]) * t["tw"]           # (batch, k1, i2)
    ct = c.transpose(-1, -2)                                     # (batch, i2, k1)
    y = _mm_tf32(t["f2_big"], t["f2_small"],
                 torch.cat([ct.real, ct.imag], dim=-2).contiguous(), split)
    y = torch.complex(y[:, :n2], y[:, n2:]).reshape(batch, n1 * n2)  # k = k1 + n1 k2
    return y / (n1 * n2) if inverse else y


def general_split(n: int) -> tuple[int, int]:
    """The general design's ``(n1, n2)``, ``n = n1 * n2`` (``general_split``
    in ``csrc/fourstep.cu``): ``n2`` the largest divisor of ``n`` at most
    sqrt(n), so ``n1 >= n2``; a prime gives ``(n, 1)``.  For ``n > 256`` it
    is ``ops.plan_factors``' split; below, that one gives ``(n, 1)``."""
    d = math.isqrt(n)
    while n % d:
        d -= 1
    return n // d, d


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``fmaf(a, b, c)`` on float32 arrays: the exact product plus ``c``,
    rounded to float32 (through float64, so a double rounding may move the
    last bit, rarely)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _cmac(acc: tuple, a: tuple, f: tuple) -> tuple:
    """The kernel's ``cmac``: ``acc + a * f`` as four FMAs in its order."""
    re = _fma(-a[1], f[1], _fma(a[0], f[0], acc[0]))
    im = _fma(a[1], f[0], _fma(a[0], f[1], acc[1]))
    return re, im


def _f32_roots(p: np.ndarray, q: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    w = _roots(p, q, inverse).astype(np.complex64)
    return w.real.copy(), w.imag.copy()


def fourstep_general_ref(x: torch.Tensor, inverse: bool = False,
                         nout: int | None = None) -> torch.Tensor:
    """The general design on the CPU: a ``(batch, n)`` complex64 (or
    float32: real input) tensor -> the first ``nout`` bins of its DFT
    (inverse: conjugate roots and 1/n), complex64.  Its split
    (:func:`general_split`), its float32 roots of the DFT-n1, DFT-n2 and
    twiddle tables, and its FMA chains: each bin summed over the terms in
    ascending order, the twiddle a product into zero, the inverse one
    multiply by float32 1/n.  Tests only."""
    n = x.shape[-1]
    n1, n2 = general_split(n)
    xc = x.to(torch.complex64).numpy().reshape(-1, n1, n2)
    a = (xc.real.copy(), xc.imag.copy())                  # (batch, i1, i2)
    zero = np.zeros((xc.shape[0], n1, n2), np.float32)
    k1, i2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    f1 = _f32_roots(np.outer(np.arange(n1), np.arange(n1)) % n1, n1, inverse)  # [k1, i1]
    acc = (zero, zero)                                    # (batch, k1, i2)
    for i in range(n1):
        acc = _cmac(acc, (a[0][:, None, i, :], a[1][:, None, i, :]),
                    (f1[0][:, i, None], f1[1][:, i, None]))
    tw = _f32_roots(k1 * i2, n, inverse)                  # [k1, i2]
    c = _cmac((zero, zero), acc, tw)
    f2 = _f32_roots(np.outer(np.arange(n2), np.arange(n2)) % n2, n2, inverse)  # [k2, i2]
    acc = (zero, zero)                                    # (batch, k1, k2)
    for i in range(n2):
        acc = _cmac(acc, (c[0][:, :, i, None], c[1][:, :, i, None]),
                    (f2[0][None, :, i], f2[1][None, :, i]))
    re, im = acc
    if inverse:
        s = np.float32(1.0) / np.float32(n)
        re, im = re * s, im * s
    y = (re + 1j * im).astype(np.complex64).transpose(0, 2, 1).reshape(x.shape)  # k1 + n1 k2
    return torch.from_numpy(np.ascontiguousarray(y[..., : n if nout is None else nout]))

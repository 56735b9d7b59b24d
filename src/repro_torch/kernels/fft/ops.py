"""Wrappers of the four-step DFT kernel (the port of
``repro/kernels/fft/ops.py``).

``fft_matmul(x, axis, inverse)`` — complex-to-complex, any axis.
``rfft_matmul(x, axis)``         — real input, Hermitian-reduced output.
``irfft_matmul(x, n, axis)``     — inverse of the above.
``dct_matmul`` / ``dst_matmul``  — a DCT/DST axis as ``torch.matmul`` with
                                   the transform matrix, in fixed blocks of
                                   rows (the reference leaves these to XLA,
                                   outside any kernel).

A tensor on the CPU takes the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel (:mod:`.kernel`).  ``launches`` counts kernel launches
per mode, ``design_launches`` the same launches by design and mode
(``"tc:fft"``, ``"general:rfft"``, ...): ``tc`` is 3xTF32 on the tensor
cores, for the lengths :func:`tensor_core_design` accepts, with the tables
of :func:`tc_matrices`; ``general`` every other length.  A
transform along an axis that is not last is a ``movedim().contiguous()``
copy in and out of the kernel.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from repro_torch.kernels.fft import ref

_SINGLE_MATMUL_MAX = 256  # below this, one (N, N) DFT beats two steps

#: kernel launches per mode ("fft", "ifft", "rfft")
launches: Counter = Counter()
#: the same launches per design and mode ("tc:fft", "general:ifft", ...)
design_launches: Counter = Counter()

_tc_cache: dict = {}


def plan_factors(n: int) -> tuple[int, int]:
    """Pick (n1, n2), n = n1*n2, n1 >= n2, n1 minimal such — or (n, 1)."""
    if n <= _SINGLE_MATMUL_MAX:
        return n, 1
    best = (n, 1)
    for n2 in range(int(math.isqrt(n)), 0, -1):
        if n % n2 == 0:
            best = (n // n2, n2)
            break
    return best


def tensor_core_design(n1: int, n2: int) -> bool:
    """Whether ``csrc/fourstep.cu`` runs the 3xTF32 tensor-core design for
    ``(n1, n2)``: both factors multiples of 8 (whole ``m16n8k8`` tiles) and
    ``n1 <= 64`` (the row tiles fit in shared memory; :func:`plan_factors`
    gives ``n2 <= n1``).  The kernel applies the same rule."""
    return n2 > 1 and n1 % 8 == 0 and n2 % 8 == 0 and n1 <= 64 and n2 <= 64


def tc_matrices(n1: int, n2: int, inverse: bool, device) -> torch.Tensor:
    """The tensor-core design's tables in one float32 buffer on ``device``,
    built once per ``(n1, n2, inverse, device)`` in float64 on the host
    (:func:`.ref.tc_tables`): F1 big, F1 small (2 n1 x 2 n1 each), F2 big,
    F2 small (2 n2 x 2 n2), then the twiddles (n1 x n2, re/im
    interleaved)."""
    key = (n1, n2, bool(inverse), torch.device(device))
    if key not in _tc_cache:
        t = ref.tc_tables(n1, n2, inverse)
        flat = np.concatenate([t["f1_big"].ravel(), t["f1_small"].ravel(), t["f2_big"].ravel(),
                               t["f2_small"].ravel(), t["tw"].view(np.float32).ravel()])
        _tc_cache[key] = torch.from_numpy(flat).to(device)
    return _tc_cache[key]


def _rows(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x`` with ``axis`` moved last, contiguous, as ``(batch, n)``."""
    xl = torch.movedim(x, axis, -1).contiguous()
    return xl.reshape(-1, xl.shape[-1])


def _unrows(y: torch.Tensor, x_shape, axis: int, nout: int) -> torch.Tensor:
    shape = list(x_shape)
    shape.pop(axis)
    return torch.movedim(y.reshape(*shape, nout), -1, axis)


def _run(rows: torch.Tensor, *, inverse: bool, nout: int, mode: str) -> torch.Tensor:
    """One batched DFT of ``(batch, n)`` rows: the kernel on CUDA, the plain
    four-step on the CPU."""
    n = rows.shape[-1]
    n1, n2 = plan_factors(n)
    if rows.is_cuda:
        from repro_torch.kernels.fft import kernel

        tc = tensor_core_design(n1, n2)
        mats = tc_matrices(n1, n2, inverse, rows.device) if tc else None
        y = kernel.fourstep(rows, n1, n2, inverse=inverse, nout=nout, mats=mats)
        launches[mode] += 1
        design_launches[f"{'tc' if tc else 'general'}:{mode}"] += 1
        return y
    if rows.device.type != "cpu":
        raise ValueError(f"no four-step DFT for device {rows.device}")
    xc = rows.to(torch.complex64)
    if inverse:
        return (ref.fourstep_ref(xc.conj(), n1, n2).conj() / n)[:, :nout]
    return ref.fourstep_ref(xc, n1, n2)[:, :nout]


def fft_matmul(x: torch.Tensor, *, axis: int = -1, inverse: bool = False) -> torch.Tensor:
    """Complex 1-D DFT along ``axis`` through the four-step kernel."""
    x = x.to(torch.complex64)
    axis = axis % x.dim()
    n = x.shape[axis]
    y = _run(_rows(x, axis), inverse=inverse, nout=n, mode="ifft" if inverse else "fft")
    return _unrows(y, x.shape, axis, n)


def rfft_matmul(x: torch.Tensor, *, axis: int = -1) -> torch.Tensor:
    """Real-input DFT; returns the n//2+1 non-redundant bins."""
    x = x.to(torch.float32)
    axis = axis % x.dim()
    nout = x.shape[axis] // 2 + 1
    y = _run(_rows(x, axis), inverse=False, nout=nout, mode="rfft")
    return _unrows(y, x.shape, axis, nout)


def irfft_matmul(x: torch.Tensor, *, n: int, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`rfft_matmul`: Hermitian-extend, full inverse DFT,
    real part."""
    x = x.to(torch.complex64)
    axis = axis % x.dim()
    xl = torch.movedim(x, axis, -1)
    tail = torch.flip(torch.conj(xl[..., 1: n - n // 2]), dims=(-1,))
    full = torch.cat([xl, tail], dim=-1)
    y = fft_matmul(full, axis=-1, inverse=True)
    return torch.movedim(y.real, -1, axis)


def dct_matmul(x: torch.Tensor, *, axis: int = -1, trig_type: int = 2) -> torch.Tensor:
    """Unnormalized DCT-II/III along ``axis`` as one f32 matmul; complex
    blocks transform re/im independently."""
    return _trig_matmul(x, axis, ref.dct_matrix(x.shape[axis % x.dim()], trig_type))


def dst_matmul(x: torch.Tensor, *, axis: int = -1, trig_type: int = 2) -> torch.Tensor:
    """Unnormalized DST-II/III along ``axis`` (see :func:`dct_matmul`)."""
    return _trig_matmul(x, axis, ref.dst_matrix(x.shape[axis % x.dim()], trig_type))


#: rows of one DCT/DST matmul call: every call has this shape (the last block
#: zero-padded), since a GEMM's rounding of a row can depend on how many
#: rows share the call (a lone row takes another code path, and the BLAS
#: picks its blocking by the row count)
TRIG_ROWS = 16384


def _trig_rows(rows: torch.Tensor, mt: torch.Tensor) -> torch.Tensor:
    """``rows @ mt`` in calls of :data:`TRIG_ROWS` rows each, so each row's
    result is the same whatever the other rows are; each full block is
    written in place, only the last one is padded."""
    r = rows.shape[0]
    out = rows.new_empty(r, mt.shape[1])
    full = r - r % TRIG_ROWS
    for i in range(0, full, TRIG_ROWS):
        torch.matmul(rows[i:i + TRIG_ROWS], mt, out=out[i:i + TRIG_ROWS])
    if full < r:
        tail = rows.new_zeros(TRIG_ROWS, rows.shape[1])
        tail[:r - full] = rows[full:]
        out[full:] = torch.matmul(tail, mt)[:r - full]
    return out


def _trig_matmul(x, axis, mat):
    # full f32, as the reference's Precision.HIGHEST: a TF32 product keeps
    # ~3 decimal digits, so refuse to run under allow_tf32
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dct/dst matmul needs torch.backends.cuda.matmul.allow_tf32 = False")
    m = torch.from_numpy(mat).to(x.device)
    axis = axis % x.dim()

    def apply(real_block):
        rows = _rows(real_block.to(torch.float32), axis)
        return _unrows(_trig_rows(rows, m.T), real_block.shape, axis, m.shape[0])

    if x.is_complex():
        return torch.complex(apply(x.real), apply(x.imag))
    return apply(x).to(x.dtype)

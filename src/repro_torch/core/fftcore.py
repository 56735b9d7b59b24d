"""Local (serial) transforms of one plan stage — the port of
``repro/core/fftcore.py``.

A per-axis :class:`TransformSpec` says which 1-D transform each axis gets
(c2c, r2c, DCT-II/III, DST-II/III, optionally pruned to ``n_keep`` modes)
and :func:`local_transform` runs one stage of it in either direction, with
the reference's conventions: forward unnormalized, backward 1/n, DCT/DST in
scipy's unnormalized convention with the backward their exact inverse.

Local FFT implementations:

``impl="torch"``  — ``torch.fft``, the counterpart of the reference's
                    ``jnp.fft``.
``impl="matmul"`` — the four-step DFT kernel (:mod:`repro_torch.kernels.fft`);
                    DCT/DST axes run as one transform-matrix ``torch.matmul``.

Each row's result must not depend on the other axes' extents: a stacked
block of fields and a pipelined slice transform the same rows as one
field's block, and the lossless contracts (batched = the per-field loop,
pipelined = fused) are bitwise.  ``torch.fft`` hands a transform along an
axis whose other axes collapse to one stride (the leading axis of a
contiguous block) to the FFT library as a strided transform, and copies any
other axis to a contiguous last axis first; the two round differently
(pocketfft at lengths with the factors 4 * 3, cuFFT along axis 0 of a 384^3
block), and a stacked block or a pipelined slice of that axis takes the
copy.  So ``impl="torch"`` moves every axis but a contiguous last one last
and makes it contiguous first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

FORWARD = -1
BACKWARD = +1

_KINDS = ("c2c", "r2c", "dct", "dst")


@dataclass(frozen=True)
class TransformSpec:
    """One axis's 1-D transform.

    ``kind``      — "c2c" | "r2c" | "dct" | "dst".
    ``trig_type`` — 2 or 3 (dct/dst only; the forward type).
    ``n_keep``    — retained spectral modes (c2c/r2c only); ``None`` keeps
                    the full spectrum.
    """

    kind: str = "c2c"
    trig_type: int = 2
    n_keep: int | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown transform kind {self.kind!r}")
        if self.kind in ("dct", "dst") and self.trig_type not in (2, 3):
            raise ValueError(f"{self.kind} type must be 2 or 3, got {self.trig_type}")
        if self.n_keep is not None:
            if self.kind in ("dct", "dst"):
                raise ValueError("n_keep (pruning) applies to c2c/r2c axes only")
            if self.n_keep < 1:
                raise ValueError(f"n_keep must be >= 1, got {self.n_keep}")

    @staticmethod
    def c2c(n_keep: int | None = None) -> "TransformSpec":
        return TransformSpec("c2c", n_keep=n_keep)

    @staticmethod
    def r2c(n_keep: int | None = None) -> "TransformSpec":
        return TransformSpec("r2c", n_keep=n_keep)

    @staticmethod
    def dct(trig_type: int = 2) -> "TransformSpec":
        return TransformSpec("dct", trig_type=trig_type)

    @staticmethod
    def dst(trig_type: int = 2) -> "TransformSpec":
        return TransformSpec("dst", trig_type=trig_type)

    @staticmethod
    def pruned(n_keep: int) -> "TransformSpec":
        """Truncated complex spectrum (centered keep)."""
        return TransformSpec("c2c", n_keep=n_keep)

    @property
    def real_to_real(self) -> bool:
        """Transform maps real -> real (complex blocks: re/im separately)."""
        return self.kind in ("dct", "dst")

    def spectral_extent(self, n: int) -> int:
        """Logical length of the forward output for an ``n``-point axis."""
        base = n // 2 + 1 if self.kind == "r2c" else n
        if self.n_keep is not None:
            if self.n_keep > base:
                raise ValueError(f"n_keep={self.n_keep} exceeds spectrum length {base} (n={n})")
            return self.n_keep
        return base

    def tag(self) -> str:
        if self.kind in ("dct", "dst"):
            return f"{self.kind}{self.trig_type}"
        return self.kind if self.n_keep is None else f"{self.kind}[{self.n_keep}]"


def as_spec(s) -> TransformSpec:
    """A TransformSpec from a TransformSpec or a tag string ("c2c", "r2c",
    "dct2", "dct3", "dst2", "dst3")."""
    if isinstance(s, TransformSpec):
        return s
    if isinstance(s, str):
        if s in ("c2c", "r2c"):
            return TransformSpec(s)
        if s in ("dct2", "dct3", "dst2", "dst3"):
            return TransformSpec(s[:3], trig_type=int(s[3]))
        raise ValueError(f"unknown transform tag {s!r}")
    raise TypeError(f"cannot interpret {s!r} as a TransformSpec")


def dealias_grid(n_keep: int) -> int:
    """Grid size of the 3/2-rule dealiased axis keeping ``n_keep`` modes."""
    return (3 * n_keep) // 2


def local_transform(x: torch.Tensor, axis: int, sign: int, spec: TransformSpec, *, n: int,
                    impl: str = "torch", nbatch: int = 0) -> torch.Tensor:
    """One stage of the plan along the locally complete ``axis``
    (field-relative; ``nbatch`` leading axes are stacked fields).  Forward:
    logical length ``n`` -> ``spec.spectral_extent(n)``; backward the exact
    reverse, pruning's keep/zero-scatter folded in."""
    axis = axis + nbatch
    if spec.kind == "c2c":
        if sign == FORWARD:
            y = _fft(x, axis, FORWARD, impl)
            if spec.n_keep is not None:
                y = _keep_centered(y, axis, spec.n_keep)
            return y
        if spec.n_keep is not None:
            x = _scatter_centered(x, axis, n, spec.n_keep)
        return _fft(x, axis, BACKWARD, impl)

    if spec.kind == "r2c":
        nbins = n // 2 + 1
        if sign == FORWARD:
            y = _rfft(x, axis, impl)
            if spec.n_keep is not None:
                y = torch.narrow(y, axis, 0, spec.n_keep)
            return y
        if spec.n_keep is not None and spec.n_keep < nbins:
            x = _zero_extend(x, axis, nbins)
        return _irfft(x, axis, n, impl)

    inverse = sign == BACKWARD
    trig_type = spec.trig_type if not inverse else {2: 3, 3: 2}[spec.trig_type]
    fn = _dct_complex_safe if spec.kind == "dct" else _dst_complex_safe
    return fn(x, axis, trig_type, impl, scale=(1.0 / (2 * n)) if inverse else 1.0)


def _check_impl(impl):
    if impl not in ("torch", "matmul"):
        raise ValueError(f"unknown fft impl {impl!r}")


def _along(x, axis, fn):
    """``fn(x, axis)`` as ``fn`` of ``axis`` moved last and made contiguous,
    moved back."""
    axis = axis % x.dim()
    if axis == x.dim() - 1 and x.is_contiguous():
        return fn(x, axis)
    return torch.movedim(fn(torch.movedim(x, axis, -1).contiguous(), -1), -1, axis)


def _fft(x, axis, sign, impl):
    _check_impl(impl)
    if impl == "torch":
        op = torch.fft.fft if sign == FORWARD else torch.fft.ifft
        return _along(x, axis, lambda t, a: op(t, dim=a))
    from repro_torch.kernels.fft import ops as fft_ops

    return fft_ops.fft_matmul(x, axis=axis, inverse=(sign == BACKWARD))


def _rfft(x, axis, impl):
    _check_impl(impl)
    if impl == "torch":
        return _along(x, axis, lambda t, a: torch.fft.rfft(t, dim=a))
    from repro_torch.kernels.fft import ops as fft_ops

    return fft_ops.rfft_matmul(x, axis=axis)


def _irfft(x, axis, n, impl):
    _check_impl(impl)
    if impl == "torch":
        return _along(x, axis, lambda t, a: torch.fft.irfft(t, n=n, dim=a))
    from repro_torch.kernels.fft import ops as fft_ops

    return fft_ops.irfft_matmul(x, n=n, axis=axis)


def pad_axis(x: torch.Tensor, axis: int, n: int, *, contiguous: bool = False) -> torch.Tensor:
    """``x`` zero-padded at the end of ``axis`` to length ``n``;
    ``contiguous=True`` returns a contiguous block, in one copy at most."""
    if x.shape[axis] == n:
        return x.contiguous() if contiguous else x
    if not contiguous:
        # F.pad lists the last axis first
        return torch.nn.functional.pad(x, [0, 0] * (x.dim() - 1 - axis) + [0, n - x.shape[axis]])
    shape = list(x.shape)
    shape[axis] = n
    out = x.new_zeros(shape)
    out.narrow(axis, 0, x.shape[axis]).copy_(x)
    return out


def _zero_extend(y, axis, n):
    """``y`` zero-padded at the end of ``axis`` to length ``n``."""
    shape = list(y.shape)
    shape[axis] = n - y.shape[axis]
    return torch.cat([y, y.new_zeros(shape)], dim=axis)


def _keep_centered(y, axis, k):
    """Keep the ``k`` lowest-|frequency| modes of an fft-ordered axis: the
    first ceil(k/2) and the last floor(k/2)."""
    n = y.shape[axis]
    if k == n:
        return y
    head = (k + 1) // 2
    tail = k - head
    lo = torch.narrow(y, axis, 0, head)
    if tail == 0:
        return lo
    return torch.cat([lo, torch.narrow(y, axis, n - tail, tail)], dim=axis)


def _scatter_centered(y, axis, n, k):
    """Inverse of :func:`_keep_centered`: zero-pad the retained modes back
    into an ``n``-long fft-ordered axis."""
    if k == n:
        return y
    head = (k + 1) // 2
    tail = k - head
    lo = torch.narrow(y, axis, 0, head)
    mid_shape = list(y.shape)
    mid_shape[axis] = n - k
    mid = y.new_zeros(mid_shape)
    if tail == 0:
        return torch.cat([lo, mid], dim=axis)
    return torch.cat([lo, mid, torch.narrow(y, axis, head, tail)], dim=axis)


# -- DCT / DST via the FFT-based even/odd extension (Makhoul) ---------------


def _dct_complex_safe(x, axis, trig_type, impl, scale=1.0):
    if x.is_complex():
        return torch.complex(_dct_real(x.real, axis, trig_type, impl),
                             _dct_real(x.imag, axis, trig_type, impl)) * scale
    y = _dct_real(x, axis, trig_type, impl)
    return y * scale if scale != 1.0 else y


def _dst_complex_safe(x, axis, trig_type, impl, scale=1.0):
    """DST-II(x) = reverse(DCT-II((-1)^j x)), DST-III(x) = (-1)^k
    DCT-III(reverse(x)); the matmul impl applies the sine matrix directly."""
    if impl == "matmul":
        from repro_torch.kernels.fft import ops as fft_ops

        y = fft_ops.dst_matmul(x, axis=axis, trig_type=trig_type)
        return y * scale if scale != 1.0 else y
    n = x.shape[axis]
    sgn = _alternating(n, x.dim(), axis, x.device)
    if trig_type == 2:
        y = _dct_complex_safe(x * sgn, axis, 2, impl, scale=scale)
        return torch.flip(y, dims=(axis,))
    y = _dct_complex_safe(torch.flip(x, dims=(axis,)), axis, 3, impl, scale=scale)
    return y * sgn


def _alternating(n, ndim, axis, device):
    s = torch.ones(n, dtype=torch.float32, device=device)
    s[1::2] = -1.0
    return s.reshape([n if i == axis % ndim else 1 for i in range(ndim)])


def _dct_real(x, axis, trig_type, impl):
    """Unnormalized (scipy-convention) DCT-II or DCT-III of a real block."""
    _check_impl(impl)
    if impl == "matmul":
        from repro_torch.kernels.fft import ops as fft_ops

        return fft_ops.dct_matmul(x, axis=axis, trig_type=trig_type)
    n = x.shape[axis]
    xl = torch.movedim(x, axis, -1).contiguous()  # the FFT below runs along its last axis
    k = torch.arange(n, device=x.device, dtype=torch.float32)
    if trig_type == 2:
        # permute to v = [x0, x2, ..., x5, x3, x1], one length-n FFT
        v = torch.cat([xl[..., ::2], torch.flip(xl[..., 1::2], dims=(-1,))], dim=-1)
        vf = torch.fft.fft(v, dim=-1)
        y = (2 * torch.exp(-1j * (math.pi * k / (2 * n))) * vf).real
    else:
        # DCT-III = 2n x the inverse of DCT-II
        xr = torch.cat([torch.zeros_like(xl[..., :1]), torch.flip(xl[..., 1:], dims=(-1,))],
                       dim=-1)
        vf = 0.5 * torch.exp(1j * (math.pi * k / (2 * n))) * (xl - 1j * xr)
        v = torch.fft.ifft(vf, dim=-1).real * (2 * n)
        h = (n + 1) // 2
        y = torch.empty_like(xl)
        y[..., ::2] = v[..., :h]
        y[..., 1::2] = torch.flip(v[..., h:], dims=(-1,))
    return torch.movedim(y.to(x.dtype), -1, axis)

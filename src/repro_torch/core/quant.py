"""Quantization codecs of the exchange payloads (``comm_dtype``), in torch.

A copy of the reference codecs (``repro/core/quant.py``) with the same
arithmetic, so that payloads agree bit for bit where the reference's do:

``complex64`` — lossless passthrough (callers skip encode/decode).
``bf16``      — round-to-nearest-even cast of the f32 re/im planes.
``int8``      — one f32 scale per block (max |x| over the finite elements of
    the other axes, floored at ``_EPS``, /127), payload
    ``round(x / scale)`` clipped to [-127, 127].  The division is kept as a
    division (never a reciprocal multiply) and ``torch.round`` rounds half
    to even like ``jnp.round``.

Complex arrays are quantized as stacked (re, im) f32 planes sharing one
scale per block.
"""

from __future__ import annotations

import torch

#: accepted comm_dtype policy names, lossless first
COMM_DTYPES = ("complex64", "bf16", "int8")

_ALIASES = {
    None: "complex64",
    "complex64": "complex64",
    "c64": "complex64",
    "none": "complex64",
    "bf16": "bf16",
    "bfloat16": "bf16",
    "int8": "int8",
}

#: scale floor: keeps all-zero blocks (padding) from dividing by zero
_EPS = 1e-12


def canonical_comm_dtype(comm_dtype) -> str:
    """Normalize a comm_dtype spec (None / alias) to one of
    :data:`COMM_DTYPES`; raises ``ValueError`` for anything else."""
    key = comm_dtype if comm_dtype is None else str(comm_dtype).lower()
    try:
        return _ALIASES[key]
    except KeyError:
        raise ValueError(
            f"unknown comm_dtype {comm_dtype!r}; expected one of {COMM_DTYPES}"
        ) from None


def wire_ratio(comm_dtype) -> int:
    """Payload compression factor vs the uncompressed dtype."""
    return {"complex64": 1, "bf16": 2, "int8": 4}[canonical_comm_dtype(comm_dtype)]


def quantize_int8(x: torch.Tensor, *, block_axis: int | tuple[int, ...] = 0,
                  scale_div=None, with_stats: bool = False):
    """Symmetric per-block int8 quantization of an f32 tensor.

    One scale per index combination of the ``block_axis`` axes: max |x| over
    the finite elements of every other axis.  Returns ``(q, scale)`` with
    ``scale`` in keepdims layout; ``with_stats=True`` adds the
    ``{"nonfinite", "saturated"}`` f32 counts.  Non-finite elements quantize
    to 0.  ``scale_div`` divides the scale (forces saturation)."""
    axes = (block_axis,) if isinstance(block_axis, int) else tuple(block_axis)
    axes = tuple(a % x.ndim for a in axes)
    red = tuple(i for i in range(x.ndim) if i not in axes)
    finite = torch.isfinite(x)
    xf = torch.where(finite, x, torch.zeros((), dtype=x.dtype, device=x.device))
    amax = xf.abs().amax(dim=red, keepdim=True) if red else xf.abs()
    # divide by a tensor: torch turns division by a Python scalar into a
    # multiply by its reciprocal on CUDA, which can move the scale by 1 ULP
    scale = torch.clamp_min(amax, _EPS) / torch.full_like(amax, 127.0)
    if scale_div is not None:
        scale = scale / torch.full_like(scale, scale_div)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    scale = scale.to(torch.float32)
    if not with_stats:
        return q, scale
    stats = {
        "nonfinite": (~finite).sum(dtype=torch.float32),
        "saturated": ((q == 127) | (q == -127)).sum(dtype=torch.float32),
    }
    return q, scale, stats


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (up to the quantization error)."""
    return q.to(torch.float32) * scale


def encode_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 (round-to-nearest-even; no scale)."""
    return x.to(torch.bfloat16)


def decode_bf16(p: torch.Tensor) -> torch.Tensor:
    return p.to(torch.float32)


def complex_to_planes(y: torch.Tensor) -> torch.Tensor:
    """complex64 tensor -> stacked ``(2, *y.shape)`` f32 (re, im) planes."""
    return torch.stack([y.real, y.imag]).to(torch.float32)


def planes_to_complex(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`complex_to_planes`."""
    return torch.complex(p[0].to(torch.float32), p[1].to(torch.float32))

"""Wrapper of the local-transpose kernel (the port of
``repro/kernels/transpose/ops.py``): ``transpose01(x)`` swaps the two
leading axes of a rank-3 float32 or complex64 tensor.

A tensor on the CPU takes the plain version (:mod:`.ref`); a CUDA tensor
launches the kernel (:mod:`.kernel`).  ``launches`` counts kernel launches,
``design_launches`` the same launches by design (``"rows"`` or ``"tile"``,
:func:`.ref.transpose_design`).  No plan path calls it, in either package:
the traditional engines pack with ``movedim`` as the reference's does with
``jnp.moveaxis``.
"""

from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels.transpose import ref

#: kernel launches per "transpose01:<dtype>"
launches: Counter = Counter()
#: the same launches per "transpose01:<design>:<dtype>"
design_launches: Counter = Counter()


def transpose01(x: torch.Tensor) -> torch.Tensor:
    """``(A, B, C) -> (B, A, C)``."""
    if x.dim() != 3:
        raise ValueError(f"transpose01 takes a rank-3 tensor, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.transpose01_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no transpose kernel for device {x.device}")
    from repro_torch.kernels.transpose import kernel

    xc = x.contiguous()
    y = kernel.transpose01(xc)
    if y.numel():
        dtype = str(x.dtype).removeprefix("torch.")
        launches[f"transpose01:{dtype}"] += 1
        design_launches[f"transpose01:{kernel.design_of(xc, y)}:{dtype}"] += 1
    return y

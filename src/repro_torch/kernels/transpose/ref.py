"""Plain torch version of the local-transpose kernel (the reference's
``repro/kernels/transpose/ref.py``); also the library call it is timed
against."""

from __future__ import annotations

import torch


def transpose01_ref(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(0, 1).contiguous()

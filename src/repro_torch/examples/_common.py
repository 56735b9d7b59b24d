"""What the examples share: the ``(p0, p1)`` mesh their CLIs (and the plan
audit's) run on, and the global indices of a rank's block."""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.core.meshutil import balanced_dims, default_group, make_mesh


@contextlib.contextmanager
def process_group(device: str = "cuda"):
    """The ``balanced_dims(world)`` mesh over ``("p0", "p1")`` on the default
    group (:func:`~repro_torch.core.meshutil.default_group`) for the span of
    the block.  ``device="cuda"`` raises without a card."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    with default_group(device):
        yield make_mesh(balanced_dims(dist.get_world_size()), ("p0", "p1"), device=device)


def block_indices(pencil, rank: int, axis: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(index, valid)`` along ``axis`` of global ``rank``'s block of
    ``pencil``: the global index of each local slot (int64) and whether it
    lies inside the logical extent (padded slots do not)."""
    sl = pencil.block_slices(rank)[axis]
    idx = torch.arange(sl.start, sl.stop, device=device)
    return idx, idx < pencil.logical[axis]


def fftfreq(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``np.fft.fftfreq(n, 1 / n)`` at the integer indices ``idx`` (float32)."""
    return torch.where(idx < (n + 1) // 2, idx, idx - n).to(torch.float32)

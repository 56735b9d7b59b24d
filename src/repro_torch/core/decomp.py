"""Balanced block-contiguous decompositions (paper Alg. 1 / Listing 1).

The paper uses the PETSc formula to split an index set of length ``N`` into
``M`` contiguous blocks whose lengths differ by at most one.  MPI's
ALLTOALLW handles such ragged blocks natively; XLA SPMD requires *equal*
shards, so we carry the paper's formula for bookkeeping (tests, oracles,
host-side planning) and add an explicit *padding policy* for the SPMD path:
an axis of logical length ``N`` distributed over ``M`` devices is stored with
physical length ``pad_to_multiple(N, M)`` and the pad region is masked out at
FFT boundaries (see core/pfft.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def decompose(N: int, M: int, p: int) -> tuple[int, int]:
    """Balanced block-contiguous decomposition (paper Alg. 1).

    Returns ``(n, s)``: the number of elements and start offset of part ``p``
    when ``N`` elements are split into ``M`` contiguous balanced parts.
    """
    if N < 0:
        raise ValueError(f"N must be >= 0, got {N}")
    if M <= 0:
        raise ValueError(f"M must be > 0, got {M}")
    if not (0 <= p < M):
        raise ValueError(f"p must be in [0, {M}), got {p}")
    q, r = divmod(N, M)
    n = q + (1 if r > p else 0)
    s = q * p + min(r, p)
    return n, s


def local_lengths(N: int, M: int) -> list[int]:
    """All part lengths ``n_p`` for ``p = 0..M-1``."""
    return [decompose(N, M, p)[0] for p in range(M)]


def start_indices(N: int, M: int) -> list[int]:
    """All start offsets ``s_p`` for ``p = 0..M-1``."""
    return [decompose(N, M, p)[1] for p in range(M)]


def pad_to_multiple(N: int, M: int) -> int:
    """Smallest multiple of ``M`` that is >= ``N`` (SPMD equal-shard policy)."""
    if M <= 0:
        raise ValueError(f"M must be > 0, got {M}")
    return M * math.ceil(N / M) if N > 0 else 0


@dataclass(frozen=True)
class AxisDecomp:
    """One array axis distributed over one mesh-axis group.

    ``logical``  — true (paper) extent of the axis.
    ``parts``    — number of shards (= mesh axis size), 1 if not distributed.
    ``padded``   — stored global extent (equal-shard policy).
    """

    logical: int
    parts: int

    @property
    def padded(self) -> int:
        return pad_to_multiple(self.logical, self.parts)

    @property
    def shard(self) -> int:
        """Per-device (physical) extent."""
        return self.padded // self.parts

    @property
    def pad(self) -> int:
        return self.padded - self.logical

    def owner_slices(self) -> list[slice]:
        """Physical slice of the *global padded* axis owned by each part."""
        return [slice(p * self.shard, (p + 1) * self.shard) for p in range(self.parts)]

    def balanced_slices(self) -> list[slice]:
        """Paper's (ragged) balanced slices of the *logical* axis — oracle only."""
        out = []
        for p in range(self.parts):
            n, s = decompose(self.logical, self.parts, p)
            out.append(slice(s, s + n))
        return out

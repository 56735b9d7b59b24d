"""Deterministic, shard-aware synthetic data (the port of
``repro/data/pipeline.py``).

Every batch is a pure function of ``(seed, step)``, drawn with the
reference's counter-based RNG (``data/prng.py``: JAX's threefry in numpy),
so that the port reads the very tokens the reference reads and a restarted
job replays its stream from the checkpointed step with no loader state.
``host_local_batch`` is a rank's contiguous rows of the batch; the
reference's ``make_batch_specs`` has no counterpart, since each rank of
the port takes its own rows.

The marginal is ``floor(u ** 3 * V)`` of float32 uniforms.  XLA's CPU
backend evaluates ``u ** 3.0`` with the C library's ``powf``, which is not
correctly rounded; here ``u ** 3`` is rounded from float64, and the rare
element whose token could move by one ulp of ``u ** 3`` (``floor`` of a
neighbour differs) is recomputed with the C library's ``powf``, so the
tokens are the reference's on a host whose libm is glibc's.

``spectral_field`` is the reference's smooth periodic field from the same
keys: its phases are the reference's bits, its amplitudes its normals to
about 2e-5 (``prng.normal``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data import prng


@functools.lru_cache(maxsize=1)
def _libm_powf():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib.powf


def power_law_base(u: np.ndarray, vocab: int) -> np.ndarray:
    """``floor(powf(u, 3) * V) % V`` in float32 and int32, as the reference."""
    V = np.float32(vocab)
    cube = (u.astype(np.float64) ** 3).astype(np.float32)
    tok = np.floor(cube * V)
    # the C library's powf is within an ulp of the exact cube: where a
    # neighbour of ``cube`` gives another token, ask it
    near = np.zeros(u.shape, bool)
    for d in (-2, -1, 1, 2):
        nb = cube.view(np.int32) + np.int32(d)
        near |= np.floor(nb.view(np.float32) * V) != tok
    if near.any():
        powf = _libm_powf()
        idx = np.nonzero(near)
        cube[idx] = [powf(float(x), 3.0) for x in u[idx]]
        tok = np.floor(cube * V)
    return tok.astype(np.int32) % np.int32(vocab)


@dataclass(frozen=True)
class SyntheticLMData:
    """Zipf-ish token stream with a learnable bigram structure: tokens from a
    power-law marginal, each next one offset by a function of the previous,
    so that a model can learn below the unigram entropy."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: (F, D): each row also carries ``frontend`` (F, D) float32 standard
    #: normals, the VLM's frontend embeddings or the audio family's frames
    #: (the reference's data has none; its frontends are stubs)
    frontend: tuple[int, int] | None = None

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        """``tokens`` and ``targets`` (B, S) int64, ``mask`` (B, S) float32,
        on the CPU: the reference's values; with ``frontend`` also its
        normals (B, F, D), drawn by numpy from (seed, step)."""
        B, S, V = self.global_batch, self.seq_len, self.vocab
        key = prng.fold_in(prng.prng_key(self.seed), step)
        base = power_law_base(prng.uniform(key, (B, S + 1), minval=1e-6), V).astype(np.int64)
        toks = np.empty((B, S), np.int64)
        prev = base[:, 0]
        for t in range(S):  # x_{t+1} = (base_{t+1} + 7 x_t) % V
            prev = (base[:, t + 1] + 7 * prev) % V
            toks[:, t] = prev
        inp = np.concatenate([base[:, :1], toks[:, :-1]], axis=1)
        out = {"tokens": torch.from_numpy(inp), "targets": torch.from_numpy(toks),
               "mask": torch.ones((B, S), dtype=torch.float32)}
        if self.frontend is not None:
            rng = np.random.default_rng((self.seed, step))
            out["frontend"] = torch.from_numpy(
                rng.standard_normal((B, *self.frontend), dtype=np.float32))
        return out

    def host_local_batch(self, step: int, *, process_index: int = 0,
                         process_count: int = 1) -> dict[str, torch.Tensor]:
        """Rank ``process_index``'s contiguous rows of ``batch(step)`` out of
        ``process_count`` (the data-parallel split)."""
        full = self.batch(step)
        per = self.global_batch // process_count
        return {k: v[process_index * per:(process_index + 1) * per] for k, v in full.items()}


def spectral_field(key, shape, *, modes: int = 8, dtype=torch.float32) -> torch.Tensor:
    """Smooth periodic field of ``shape``: ``modes`` random Fourier modes an
    axis, from the reference's ``key`` (``prng.prng_key(seed)`` or a key it
    derived), on the CPU."""
    d = len(shape)
    ks = prng.split(key, 3)
    amp = torch.from_numpy(prng.normal(ks[0], (modes,) * d))
    phase = torch.from_numpy(prng.uniform(ks[1], (modes,) * d)) * np.float32(2 * np.pi)
    spec = torch.zeros(shape, dtype=torch.complex64)
    spec[(slice(0, modes),) * d] = amp * torch.exp(1j * phase)
    field = torch.fft.ifftn(spec).real * float(np.prod(shape)) ** 0.5
    return field.to(dtype)

"""Shared neural-net layers: norms, RoPE, MLPs, weight init (the port of
``repro/models/layers.py``).

Functions over parameter mappings (``nn.ParameterDict`` or plain dicts of
tensors).  Weight init draws a truncated normal with fan-in scaling from an
explicit ``torch.Generator``.  The compute dtype is the weights' (bf16 on the
serving path); norms run in fp32 and cast back, as in the reference.
``chunked_xent`` is the training loss: the token cross-entropy over chunks
of the sequence, each chunk's logits recomputed in the backward.  On a
mesh (``shard``) it is vocabulary-parallel: each rank holds its columns of
the head, and the max, the sum of exponentials and the gold logit are
reduced in fp32 over "model"; ``vocab_lookup`` is the embedding's side, a
lookup in the rank's rows that the caller reduces.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.bfloat16,
               scale: float | None = None) -> torch.Tensor:
    """(d_in, d_out) weights: a normal truncated to [-3, 3], times ``scale``
    (default 1/sqrt(d_in)), drawn in fp32 on ``gen``'s device and cast."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * std).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, Dh); positions: (..., T) integers.  Rotates the
    interleaved pairs (x[..., 0::2], x[..., 1::2]), not the two halves."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                     # (Dh/2,)
    ang = positions[..., None].float() * freqs                  # (..., T, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, ff: int, kind: str,
             dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    if kind in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d, ff, dtype), "w_up": dense_init(gen, d, ff, dtype),
                "w_down": dense_init(gen, ff, d, dtype)}
    return {"w_up": dense_init(gen, d, ff, dtype), "w_down": dense_init(gen, ff, d, dtype)}


def mlp_apply(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The activation acts on the product in the weights' dtype; jax's
    ``gelu`` is the tanh form."""
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    elif kind == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    elif kind == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    else:
        raise ValueError(kind)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Loss: chunked softmax cross-entropy (never materializes (B, T, V) at once)
# ---------------------------------------------------------------------------


def _xent_chunk(h: torch.Tensor, w_out: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor):
    """(sum of the masked token losses, sum of the mask) of one chunk."""
    logits = (h @ w_out).float()                           # (B, Tc, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def _xent_chunk_parallel(h: torch.Tensor, w_out: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, shard, v0: int):
    """``_xent_chunk`` with ``w_out`` this rank's vocabulary columns [v0, v0
    + V_r): the logsumexp of the rank's logits, then the max of every
    rank's (no gradient, as the reference's max), the sum of each rank's
    exp(lse_r - max) and the gold logit (0 on the ranks that do not hold the
    target) summed over "model".  At one rank the value and its gradient are
    ``_xent_chunk``'s bit for bit (exp(0) = 1, log 1 = 0)."""
    logits = (h @ w_out).float()                           # (B, Tc, V_r)
    lse = torch.logsumexp(logits, dim=-1)
    m = shard.reduce(lse.detach().clone(), op=dist.ReduceOp.MAX)
    local = targets - v0
    n = logits.shape[-1]
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = torch.where((local >= 0) & (local < n), gold, 0.0)
    sums = shard.sum(torch.stack([torch.exp(lse - m), gold]))
    logz = torch.log(sums[0]) + m
    return ((logz - sums[1]) * mask).sum(), mask.sum()


def chunked_xent(h: torch.Tensor, w_out: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor, n_chunks: int, denom: torch.Tensor | None = None, *,
                 shard=None, v0: int = 0) -> torch.Tensor:
    """Mean token cross-entropy of h (B, T, D) through ``w_out`` (D, V),
    summed over ``n_chunks`` chunks of T in order (the reference's scan),
    each under a non-reentrant ``torch.utils.checkpoint``: the backward
    recomputes a chunk's logits, so that one (B, T / n_chunks, V) tile is
    live at a time.  The sum is divided by max(``denom``, 1), by default the
    mask's sum (a data-parallel rank passes the whole batch's).  With a
    ``shard`` (``models.sharding.Shard``) ``w_out`` is this rank's
    vocabulary columns from ``v0`` on (every column, padding too, enters the
    logsumexp, as in the reference) and h is whole on every model rank: two
    fp32 all_reduces a chunk, each again in the chunk's recomputation."""
    b, t, d = h.shape
    assert t % n_chunks == 0, (t, n_chunks)
    tc = t // n_chunks
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * tc, (c + 1) * tc)
        if shard is None:
            s, n = checkpoint(_xent_chunk, h[:, sl], w_out, targets[:, sl], mask[:, sl],
                              use_reentrant=False)
        else:
            s, n = checkpoint(_xent_chunk_parallel, h[:, sl], w_out, targets[:, sl],
                              mask[:, sl], shard, v0, use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return tot / torch.clamp(cnt if denom is None else denom, min=1.0)


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor, v0: int) -> torch.Tensor:
    """The embeddings of ``tokens`` in ``table``, this rank's vocabulary
    rows from ``v0`` on, zero where another rank holds the row: the partial
    sums of a vocabulary-parallel embedding (exact once summed: one rank
    adds its row to zeros)."""
    n = table.shape[0]
    local = tokens - v0
    e = F.embedding(local.clamp(0, n - 1), table)
    return torch.where(((local >= 0) & (local < n))[..., None], e, torch.zeros((), dtype=e.dtype,
                                                                             device=e.device))

"""Attention for the dense family (the port of ``repro/models/attention.py``,
GQA part): projections with RoPE, the blockwise prefill of the baseline
flags, the exact causal prefill through the flash kernel (K6), and
single-token decode over a cache.

Layouts are the reference's: q (B, S, Hq, dh), k/v (B, S, Hkv, dh).  MLA and
Ulysses sequence parallelism are not ported yet.

Mixed precision: the reference's ``bf16_compute`` contracts bf16 operands
with fp32 accumulation and an fp32 result.  torch has no such product, so
both forms here contract fp32 copies of the operands; a product of two bf16
values is exact in fp32, so the result is the reference's up to summation
order.  The switch keeps its other effect: p is rounded to v's dtype before
the p . v product.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init

_NEG_INF = -1e30


def _dots(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """fp32 contraction of two operands (see the module docstring)."""
    return torch.einsum(eq, a.float(), b.float())


# ---------------------------------------------------------------------------
# Blockwise attention (prefill under the baseline flags)
# ---------------------------------------------------------------------------


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        q_block: int = 512, bf16_compute: bool = False) -> torch.Tensor:
    """Attention over q blocks, each against the whole (masked) key range.
    Returns (B, Sq, Hq, dv) in v's dtype.  The reference's ``q_offset`` and
    ``kv_len`` serve callers not ported yet (Ulysses, cross attention)."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv, dv = v.shape[1], v.shape[2], v.shape[3]
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    qb = min(q_block, Sq)
    scale = 1.0 / math.sqrt(dh)
    kv_pos = torch.arange(Skv, device=q.device)
    outs = []
    for i in range(-(-Sq // qb)):
        qi = q[:, i * qb:(i + 1) * qb]
        n = qi.shape[1]  # the last block may be short: the reference pads it
        qi = qi.reshape(B, n, Hkv, G, dh)
        s = _dots((qi * scale).to(qi.dtype), k, "bqhgd,bkhd->bhgqk")
        if causal:
            q_pos = i * qb + torch.arange(n, device=q.device)
            s = torch.where(q_pos[:, None] >= kv_pos[None, :], s, _NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        if bf16_compute:
            p = p.to(v.dtype)
        o = _dots(p, v, "bhgqk,bkhd->bqhgd")
        outs.append(o.reshape(B, n, Hq, dv).to(v.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: int, *, bf16_compute: bool = False,
                     layout: str = "bskd") -> torch.Tensor:
    """Single-token attention over a cache of which the first ``cur_len``
    positions are valid.  q (B, 1, Hq, dh); the cache is (B, S, Hkv, dh)
    (``"bskd"``) or head-major (B, Hkv, S, dh) (``"bhsd"``)."""
    B, _, Hq, dh = q.shape
    hmajor = layout == "bhsd"
    Hkv = k_cache.shape[1] if hmajor else k_cache.shape[2]
    S_cache = k_cache.shape[2] if hmajor else k_cache.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(dh)
    qq = (q.reshape(B, 1, Hkv, G, dh) * scale).to(q.dtype)
    k_eq = "bqhgd,bhkd->bhgqk" if hmajor else "bqhgd,bkhd->bhgqk"
    v_eq = "bhgqk,bhkd->bqhgd" if hmajor else "bhgqk,bkhd->bqhgd"
    s = _dots(qq, k_cache, k_eq)
    mask = torch.arange(S_cache, device=q.device) < cur_len
    s = torch.where(mask, s, _NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    if bf16_compute:
        p = p.to(v_cache.dtype)
    o = _dots(p, v_cache, v_eq)
    return o.reshape(B, 1, Hq, -1).to(v_cache.dtype)


def triangular_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                q_block: int = 512, bf16_compute: bool = True) -> torch.Tensor:
    """Exact causal attention for the serving prefill: the flash kernel (K6),
    which visits only the tiles on and below the diagonal.

    The reference computes this function with an XLA scan over the
    triangular tile list, pre-scaling q in its dtype; K6 scales the fp32
    scores instead (one rounding apart) and always rounds p to v's dtype,
    which on the serving path is what ``bf16_compute`` asks for.
    """
    del bf16_compute  # K6 keeps its operands in the input dtype
    return flash_ops.flash_attention(q, k, v, causal=True, block_q=q_block, block_k=q_block)


# ---------------------------------------------------------------------------
# GQA projections
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int, head_dim: int, *,
             qkv_bias: bool, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    p = {"wq": dense_init(gen, d, n_heads * head_dim, dtype),
         "wk": dense_init(gen, d, n_kv * head_dim, dtype),
         "wv": dense_init(gen, d, n_kv * head_dim, dtype),
         "wo": dense_init(gen, n_heads * head_dim, d, dtype)}
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype, device=gen.device)
    return p


def gqa_qkv(p, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
            positions: torch.Tensor, rope_theta: float):
    """Project + RoPE.  x: (B, S, D) -> q (B,S,Hq,dh), k/v (B,S,Hkv,dh)."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    # RoPE is elementwise per (position, head): rotating in (B, S, H, dh)
    # with the positions broadcast over heads leaves q and k contiguous
    q = apply_rope(q, positions[:, :, None], rope_theta)
    k = apply_rope(k, positions[:, :, None], rope_theta)
    return q, k, v

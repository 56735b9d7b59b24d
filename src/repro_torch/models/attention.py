"""Attention (the port of ``repro/models/attention.py``): GQA projections
with RoPE, the blockwise prefill of the baseline flags, the exact causal
prefill through the flash kernel (K6), single-token decode over a cache,
and DeepSeek-V2's multi-head latent attention (MLA): its latents, queries,
the expansion of the latents to per-head K and V, and the weight-absorbed
decode over the latent cache.

Layouts are the reference's: q (B, S, Hq, dh), k/v (B, S, Hkv, dh); MLA's q
and k (B, S, H, dn + dr), v (B, S, H, dv), its cache c_kv (B, S, r) and
k_rope (B, S, dr).  The decode can run over a cache whose positions are
split over the model group (``decode_attention``'s and
``mla_decode_absorbed``'s ``shard``).  The training forward of every family
runs ``blockwise_attention`` with each q block rematerialized: GQA, MLA's
expanded K and V (the reference's ``mla_attention_train``), the audio
encoder's non-causal attention and its decoder's causal cross-attention;
on a mesh under ``sp_mode="ulysses"`` the dense family's through
``ulysses_attention``, the paper's exchange applied to attention.

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
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm

_NEG_INF = -1e30


def _dots(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """fp32 contraction of two operands (see the module docstring)."""
    return torch.einsum(eq, a.float(), b.float())


# ---------------------------------------------------------------------------
# Blockwise attention (prefill under the baseline flags)
# ---------------------------------------------------------------------------


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        q_block: int = 512, bf16_compute: bool = False,
                        remat: bool = False) -> torch.Tensor:
    """Attention over q blocks, each against the whole (masked) key range.
    Returns (B, Sq, Hq, dv) in v's dtype.  Sq and Skv may differ (the
    encoder–decoder's cross-attention, non-causal); the reference's
    The reference's ``q_offset`` and ``kv_len`` have no caller here.
    The softmax's max takes no gradient (the reference's ``stop_gradient``).
    ``remat`` (the training forward) recomputes each block in the backward
    (a non-reentrant ``torch.utils.checkpoint`` a block, the reference's
    ``jax.checkpoint``-ed scan body), so that one block's scores are live
    at a time."""
    Sq = q.shape[1]
    qb = min(q_block, Sq)
    outs = []
    for i in range(-(-Sq // qb)):
        qi = q[:, i * qb:(i + 1) * qb]  # the last block may be short: the reference pads it
        if remat:
            outs.append(checkpoint(_attention_block, qi, k, v, i * qb, causal, bf16_compute,
                                   use_reentrant=False))
        else:
            outs.append(_attention_block(qi, k, v, i * qb, causal, bf16_compute))
    return torch.cat(outs, dim=1)


def _attention_block(qi: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int,
                     causal: bool, bf16_compute: bool) -> torch.Tensor:
    """One q block (B, n, Hq, dh) at positions q0 .. q0 + n - 1 against the
    whole key range."""
    B, n, Hq, dh = qi.shape
    Skv, Hkv, dv = v.shape[1], v.shape[2], v.shape[3]
    assert Hq % Hkv == 0, (Hq, Hkv)
    qi = qi.reshape(B, n, Hkv, Hq // Hkv, dh)
    s = _dots((qi * (1.0 / math.sqrt(dh))).to(qi.dtype), k, "bqhgd,bkhd->bhgqk")
    if causal:
        q_pos = q0 + torch.arange(n, device=qi.device)
        kv_pos = torch.arange(Skv, device=qi.device)
        s = torch.where(q_pos[:, None] >= kv_pos[None, :], s, _NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    if bf16_compute:
        p = p.to(v.dtype)
    o = _dots(p, v, "bhgqk,bkhd->bqhgd")
    return o.reshape(B, n, Hq, dv).to(v.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: int, *, bf16_compute: bool = False,
                     layout: str = "bskd", shard=None, pos0: int = 0) -> torch.Tensor:
    """Single-token attention over a cache of which the first ``cur_len``
    positions are valid.  q (B, 1, Hq, dh); the cache is (B, S, Hkv, dh)
    (``"bskd"``) or head-major (B, Hkv, S, dh) (``"bhsd"``).

    With a ``shard`` (``models.sharding.Shard``) the cache is this rank's
    block of positions, from global position ``pos0`` on, and q holds the
    rank's q heads; the reference's schedule, which GSPMD lowers to
    all-reduces over the sharded position axis, runs as written: q's heads
    ``all_gather``-ed, the local scores' max ``all_reduce``-d (MAX), the
    sum of exp(s - m) ``all_reduce``-d, p normalised before the local p . v,
    and o ``all_reduce``-d.  Every rank returns all Hq heads.  Without one
    (or at one rank) these are the same ops on the same values."""
    if shard is not None:
        q = shard.gather(q, dim=2)
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
    pos = torch.arange(S_cache, device=q.device)
    if pos0:
        pos = pos + pos0
    s = torch.where(pos < cur_len, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    if shard is not None:
        m = shard.reduce(m, op=dist.ReduceOp.MAX)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if shard is not None:
        l = shard.reduce(l)
    p = p / l
    if bf16_compute:
        p = p.to(v_cache.dtype)
    o = _dots(p, v_cache, v_eq)
    if shard is not None:
        o = shard.reduce(o)
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
# Ulysses sequence parallelism (the paper's exchange applied to attention)
# ---------------------------------------------------------------------------


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shard, *,
                      causal: bool, q_block: int = 512) -> torch.Tensor:
    """Causal (or not) attention of a sequence split over the model group of
    ``shard``: q (B, S / tp, Hq, dh), k, v (B, S / tp, Hkv, dh) this rank's
    block of positions, in rank order; returns its block of the output
    (B, S / tp, Hq, dh).  The reference's ``ulysses_attention``:

    * the kv heads are repeated up to tp where tp does not divide Hkv
      (``repeat_interleave`` by ceil(tp / Hkv): q head h still reads its
      own kv head), and Hq must divide by tp;
    * one ``all_to_all`` takes the sequence-split block to a head-split one,
      (B, S, Hq / tp, dh): the rank's q heads and the kv heads they read,
      every position, the blocks concatenated in sequence order;
    * ``blockwise_attention`` over the whole sequence, each q block
      rematerialized, with fp32 contractions whatever the LM's
      ``bf16_attention`` says (the reference calls it without
      ``bf16_compute`` here);
    * the reverse ``all_to_all`` back to the sequence block.

    The exchange is ``Shard.swap`` (``all_to_all_single`` on the model
    group, its own adjoint), not ``core/redistribute.exchange_shard``:
    q, k and v travel in one buffer, (tp, B, S / tp, Hq / tp + 2 Hkv' / tp,
    dh) with chunk r the heads that rank r takes, so that one collective
    carries all three; ``exchange_shard``'s (v, w) contract moves one
    array split on one axis and gathered on another, which would take three
    exchanges and its own pack and unpack around each.  The buffer is the
    same global redistribution that the FFT plans run: split heads,
    concatenate sequence."""
    tp = shard.tp
    B, s, Hq, dh = q.shape
    if Hq % tp:
        raise ValueError(f"ulysses needs the {Hq} q heads to split over {tp} ranks")
    if k.shape[2] % tp:
        rep = -(-tp // k.shape[2])
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    Hkv = k.shape[2]
    if Hkv % tp or Hq % Hkv or v.shape[3] != dh:
        raise ValueError(f"ulysses: {Hq} q heads and {Hkv} kv heads of {dh} and {v.shape[3]} "
                         f"do not split into whole GQA groups over {tp} ranks")
    n, m = Hq // tp, Hkv // tp
    buf = torch.cat([q.reshape(B, s, tp, n, dh), k.reshape(B, s, tp, m, dh),
                     v.reshape(B, s, tp, m, dh)], dim=3).permute(2, 0, 1, 3, 4)
    got = shard.swap(buf.contiguous())              # chunk j: rank j's positions
    got = got.permute(1, 0, 2, 3, 4).reshape(B, tp * s, n + 2 * m, dh)
    # contiguous, as the projections' own: the products then take the
    # mesh-less attention's paths (at one rank its result bit for bit)
    ql, kl, vl = (t.contiguous() for t in got.split([n, m, m], dim=2))
    o = blockwise_attention(ql, kl, vl, causal=causal, q_block=q_block, remat=True)
    back = shard.swap(o.reshape(B, tp, s, n, dh).transpose(0, 1).contiguous())
    return back.permute(1, 2, 0, 3, 4).reshape(B, s, Hq, dh)


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


def gqa_q(p, x: torch.Tensor, *, n_heads: int, head_dim: int, positions: torch.Tensor,
          rope_theta: float) -> torch.Tensor:
    """Queries of x (B, S, D): (B, S, Hq, dh), RoPE at ``positions``."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    # RoPE is elementwise per (position, head): rotating in (B, S, H, dh)
    # with the positions broadcast over heads leaves q and k contiguous
    return apply_rope(q.reshape(B, S, n_heads, head_dim), positions[:, :, None], rope_theta)


def gqa_kv(p, x: torch.Tensor, *, n_kv: int, head_dim: int, positions: torch.Tensor,
           rope_theta: float):
    """Keys (RoPE at ``positions``) and values of x (B, S, D): (B, S, Hkv, dh)
    each.  Cross-attention takes them from the encoder's output alone."""
    B, S, _ = x.shape
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = apply_rope(k.reshape(B, S, n_kv, head_dim), positions[:, :, None], rope_theta)
    return k, v.reshape(B, S, n_kv, head_dim)


def gqa_qkv(p, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
            positions: torch.Tensor, rope_theta: float):
    """Project + RoPE.  x: (B, S, D) -> q (B,S,Hq,dh), k/v (B,S,Hkv,dh)."""
    q = gqa_q(p, x, n_heads=n_heads, head_dim=head_dim, positions=positions,
              rope_theta=rope_theta)
    return (q, *gqa_kv(p, x, n_kv=n_kv, head_dim=head_dim, positions=positions,
                       rope_theta=rope_theta))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, d: int, n_heads: int, mla,
             dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    dn, dr, r, dv = mla.qk_nope_dim, mla.qk_rope_dim, mla.kv_lora_rank, mla.v_head_dim
    return {"wq": dense_init(gen, d, n_heads * (dn + dr), dtype),
            "w_dkv": dense_init(gen, d, r + dr, dtype),
            "kv_norm": torch.ones((r,), dtype=torch.float32, device=gen.device),
            "w_uk": dense_init(gen, r, n_heads * dn, dtype),
            "w_uv": dense_init(gen, r, n_heads * dv, dtype),
            "wo": dense_init(gen, n_heads * dv, d, dtype)}


def mla_latents(p, x: torch.Tensor, *, mla, positions: torch.Tensor, rope_theta: float):
    """x (B, S, D) -> (c_kv (B, S, r), k_rope (B, S, 1, dr)): the compressed
    KV that MLA caches; RoPE on the rope part only."""
    dr, r = mla.qk_rope_dim, mla.kv_lora_rank
    a = x @ p["w_dkv"]  # (B, S, r + dr)
    c_kv = rmsnorm(a[..., :r], p["kv_norm"], 1e-6)  # the reference's eps
    k_rope = a[..., r:].reshape(*x.shape[:2], 1, dr)
    return c_kv, apply_rope(k_rope, positions[:, :, None], rope_theta)


def mla_queries(p, x: torch.Tensor, *, n_heads: int, mla, positions: torch.Tensor,
                rope_theta: float):
    """x (B, S, D) -> (q_nope (B, S, H, dn), q_rope (B, S, H, dr))."""
    dn, dr = mla.qk_nope_dim, mla.qk_rope_dim
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions[:, :, None], rope_theta)


def mla_expand_kv(p, c_kv: torch.Tensor, k_rope: torch.Tensor, *, n_heads: int, mla):
    """Latents to per-head K (nope || rope, k_rope one head broadcast over
    the heads) (B, S, H, dn + dr) and V (B, S, H, dv)."""
    dn, dv = mla.qk_nope_dim, mla.v_head_dim
    B, S, _ = c_kv.shape
    k_nope = (c_kv.to(p["w_uk"].dtype) @ p["w_uk"]).reshape(B, S, n_heads, dn)
    v = (c_kv.to(p["w_uv"].dtype) @ p["w_uv"]).reshape(B, S, n_heads, dv)
    k = torch.cat([k_nope, k_rope.expand(B, S, n_heads, k_rope.shape[-1])], -1)
    return k, v


def mla_decode_absorbed(p, x: torch.Tensor, cache_ckv: torch.Tensor,
                        cache_krope: torch.Tensor, cur_len: int, *, n_heads: int, mla,
                        positions: torch.Tensor, rope_theta: float,
                        bf16_compute: bool = False, shard=None, pos0: int = 0,
                        h0: int = 0) -> torch.Tensor:
    """Weight-absorbed MLA decode of x (B, 1, D) over the first ``cur_len``
    positions of the latent cache (c_kv (B, M, r), k_rope (B, M, dr)):
    scores q_nope W_uk^T c_kv + q_rope k_rope, output (P c_kv) W_uv, then
    ``wo``; K and V are never expanded for the cache.  Under
    ``bf16_compute`` the absorbed query and p are rounded to x's dtype; the
    last product is fp32.  p is exp(s - max) over its sum, normalised before
    the p . c_kv product, as ``decode_attention``'s.

    With a ``shard`` (``models.sharding.Shard``) the latent cache is this
    rank's block of positions from global position ``pos0`` on, and ``p``
    holds the rank's ``n_heads`` heads from head ``h0`` (its columns of
    ``wq``, ``w_uk`` and ``w_uv``, its rows of ``wo``): the heads' absorbed
    queries and rope queries are ``all_gather``-ed (one gather of their
    concatenation), the max and the sum of the scores ``all_reduce``-d, and
    the latent output o_lat ``all_reduce``-d, of which the rank takes its
    heads through its ``w_uv`` and ``wo``; the caller sums ``wo``'s
    partials.  At one rank these are the same ops on the same values."""
    dn, dr, r, dv = mla.qk_nope_dim, mla.qk_rope_dim, mla.kv_lora_rank, mla.v_head_dim
    B = x.shape[0]
    q_nope, q_rope = mla_queries(p, x, n_heads=n_heads, mla=mla, positions=positions,
                                 rope_theta=rope_theta)
    q_lat = _dots(q_nope, p["w_uk"].reshape(r, n_heads, dn), "bqhd,rhd->bqhr")
    if bf16_compute:
        q_lat = q_lat.to(x.dtype)
    # one buffer of both queries, gathered whole on a mesh (and split alike
    # without one, so that one rank computes the mesh-less values bit for bit)
    q = torch.cat([q_lat, q_rope.to(q_lat.dtype)], -1)
    if shard is not None:
        q = shard.gather(q, dim=2)
    q_lat, q_rope = q[..., :r], q[..., r:]
    s = _dots(q_lat, cache_ckv, "bqhr,bkr->bhqk") + _dots(q_rope, cache_krope, "bqhd,bkd->bhqk")
    s = s * (1.0 / math.sqrt(dn + dr))
    pos = torch.arange(cache_ckv.shape[1], device=x.device)
    if pos0:
        pos = pos + pos0
    s = torch.where(pos < cur_len, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    if shard is not None:
        m = shard.reduce(m, op=dist.ReduceOp.MAX)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    if shard is not None:
        l = shard.reduce(l)
    p_attn = e / l
    if bf16_compute:
        p_attn = p_attn.to(x.dtype)
    o_lat = _dots(p_attn, cache_ckv, "bhqk,bkr->bqhr").contiguous()
    if shard is not None:
        o_lat = shard.reduce(o_lat)[:, :, h0:h0 + n_heads]
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, p["w_uv"].reshape(r, n_heads, dv).float())
    return o.reshape(B, 1, n_heads * dv).to(x.dtype) @ p["wo"]

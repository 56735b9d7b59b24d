"""Plain torch version of the flash-attention kernel (the reference's
``repro/kernels/flash/ref.py``): fp32 math over the whole score matrix;
and :func:`attention_tiles_ref`, the tensor-core design's order of work."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool) -> torch.Tensor:
    """q (BH, Sq, dqk), k (BH, Skv, dqk), v (BH, Skv, dv) -> (BH, Sq, dv),
    fp32 math, scores scaled by 1/sqrt(dqk)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask[None], s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(v.dtype)


def attention_gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool) -> torch.Tensor:
    """:func:`attention_ref` on (B, Sq, Hq, dqk) / (B, Skv, Hkv, dqk) /
    (B, Skv, Hkv, dv) GQA tensors: the q heads of one kv head folded onto it and k, v repeated for
    them, as the reference's wrapper folds them for its kernel."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Sq, Hkv, G, dh).permute(0, 2, 3, 1, 4).reshape(B * Hq, Sq, dh)
    kf = k.transpose(1, 2).reshape(B * Hkv, Skv, dh).repeat_interleave(G, dim=0)
    vf = v.transpose(1, 2).reshape(B * Hkv, Skv, -1).repeat_interleave(G, dim=0)
    o = attention_ref(qf, kf, vf, causal=causal)
    return o.reshape(B, Hkv, G, Sq, -1).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, -1)


def attention_tiles_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        block_k: int = 64) -> torch.Tensor:
    """The order of work of ``csrc/flash.cu``'s tensor-core design, in plain
    torch on (B, Sq, Hq, dqk) / (B, Skv, Hkv, dqk) / (B, Skv, Hkv, dv) GQA
    tensors: ``block_k``-key tiles; fp32 scores of the operands (exact
    products of bf16 values) times 1/sqrt(dqk) rounded once to fp32; the
    top-left causal mask at -1e30; the online softmax per tile (m, l,
    alpha); p rounded to v's dtype before p . v, summed in fp32; out = acc /
    max(l, 1e-30) in v's dtype.  Keys past Skv take no part, as the kernel's
    masked, zero-filled rows."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, dh)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    qpos = torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, G, Sq), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, vf.shape[-1]), device=q.device)
    for k0 in range(0, Skv, block_k):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, k0:k0 + block_k]) * scale
        if causal:
            kpos = torch.arange(k0, min(k0 + block_k, Skv), device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vf[:, k0:k0 + block_k])
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, -1).to(v.dtype)

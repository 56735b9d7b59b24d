"""Plain torch version of the flash-attention kernel (the reference's
``repro/kernels/flash/ref.py``): fp32 math over the whole score matrix."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool) -> torch.Tensor:
    """q (BH, Sq, dh), k/v (BH, Skv, dh) -> (BH, Sq, dh), fp32 math."""
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
    """:func:`attention_ref` on (B, Sq, Hq, dh) / (B, Skv, Hkv, dh) GQA
    tensors: the q heads of one kv head folded onto it and k, v repeated for
    them, as the reference's wrapper folds them for its kernel."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Sq, Hkv, G, dh).permute(0, 2, 3, 1, 4).reshape(B * Hq, Sq, dh)
    kf = k.transpose(1, 2).reshape(B * Hkv, Skv, dh).repeat_interleave(G, dim=0)
    vf = v.transpose(1, 2).reshape(B * Hkv, Skv, -1).repeat_interleave(G, dim=0)
    o = attention_ref(qf, kf, vf, causal=causal)
    return o.reshape(B, Hkv, G, Sq, -1).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, -1)

"""Mixture-of-Experts on one card (the port of ``repro/models/moe.py``).

The reference's token->expert redistribution is the paper's v->w exchange:
a (experts, capacity, d) buffer split over the expert-parallel group by one
fused all-to-all each way.  On one card the group has one rank and the
all-to-all is the identity, so it is left out; the buffer, its order and
its drops are the reference's.  Three paths:

``moe_apply_capacity`` — the capacity dispatch (the reference's
                         ``moe_apply_a2a`` at ep = 1; the serving prefill):
                         each expert runs on its (capacity, d) slice of the
                         buffer, assignments past capacity are dropped.
``moe_apply_local``    — every expert on every token, masked by the gate
                         matrix (the decode path): nothing is dropped.
``moe_apply_dense``    — the reference's meshless form, the same function
                         on one card.

Routing: fp32 router, softmax -> top-k -> renormalise, load-balance aux loss
and router z-loss, as in the reference.  The expert products are
``torch.matmul`` (the reference's ``jnp.einsum`` runs outside any Pallas
kernel).  ``assignments`` counts the dispatch's routed and dropped
assignments.
"""

from __future__ import annotations

import math
from collections import Counter

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp_apply, mlp_init

#: assignments of the capacity dispatch, summed over calls: "routed" (N * k a
#: call, an int) and "dropped" (past capacity, a 0-d int64 tensor on the
#: dispatch's device, so that counting never makes the host wait; ``int()``
#: reads it)
assignments: Counter = Counter()


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def moe_init(gen: torch.Generator, d: int, cfg, mlp_kind: str,
             dtype=torch.bfloat16) -> dict:
    """cfg: ``models.config.MoEConfig``.  The router is fp32 whatever
    ``dtype``; each expert stack (E, d_in, d_out) is one tensor, drawn one
    expert's matrix at a time, so that init holds one fp32 matrix beside the
    weights and never a second copy of a stack."""
    E, ff = cfg.n_experts, cfg.d_ff_expert

    def stack(d_in, d_out):
        w = torch.empty((E, d_in, d_out), dtype=dtype, device=gen.device)
        for e in range(E):
            w[e] = dense_init(gen, d_in, d_out, dtype)
        return w

    p = {"router": dense_init(gen, d, E, torch.float32)}
    if mlp_kind in ("swiglu", "geglu"):
        p["w_gate"] = stack(d, ff)
    p["w_up"] = stack(d, ff)
    p["w_down"] = stack(ff, d)
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, d, cfg.n_shared * ff, mlp_kind, dtype)
    return p


def _expert_ffn(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: (E, C, D), or (N, D) given to every expert, through the expert
    stacks (E, D, F) -> (E, C or N, D).  The activation acts on the products
    in the weights' dtype, as ``mlp_apply``; the gated forms work in place,
    so that a large buffer holds two (E, C, F) products at a time, not four."""
    if kind in ("swiglu", "geglu"):
        h = x @ p["w_gate"]
        h = F.silu(h, inplace=True) if kind == "swiglu" else F.gelu(h, approximate="tanh")
        h.mul_(x @ p["w_up"])
    elif kind == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: (N, D) -> gates (N, k) fp32, expert ids (N, k) int64, aux, z-loss.

    Softmax over the experts in fp32, the top k, renormalised.  The top k
    are taken by a stable descending sort, so that of equal probabilities
    the lower expert id comes first, as ``lax.top_k`` orders them
    (``torch.topk`` promises no order among ties)."""
    logits = x.float() @ router_w.float()                 # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :top_k], idx[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch/GShard): E * sum_e f_e * P_e
    E = router_w.shape[-1]
    f = F.one_hot(idx, E).float().mean(dim=(0, 1)) * top_k
    aux = E * torch.sum(f * probs.mean(0))
    zloss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gates, idx, aux, zloss


def _with_shared(p, x: torch.Tensor, y: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    return y + mlp_apply(p["shared"], x, mlp_kind) if "shared" in p else y


# ---------------------------------------------------------------------------
# The capacity dispatch (the reference's _dispatch_shard on one rank)
# ---------------------------------------------------------------------------


def moe_apply_capacity(p, x: torch.Tensor, *, cfg, mlp_kind: str):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux, z-loss).

    The flat assignments (token n's k choices at n * k ... n * k + k - 1) are
    sorted stably by expert; an assignment's position within its expert is
    its rank there in flat token order, and those at positions >= capacity
    ``max(1, ceil(N * k * capacity_factor / E))`` are dropped.  Each expert
    runs on its whole (capacity, D) slice of the buffer, zeros included.  A
    token's kept outputs are weighted by their gates and summed in fp32 in
    the order of its choices: the reference adds them into zeros in sorted
    order, which is the same sum at k = 2 and a fixed order here for any k
    (no atomics).  Every shape is known to the host: nothing waits on the
    device."""
    B, S, D = x.shape
    N, E, k = B * S, cfg.n_experts, cfg.top_k
    xt = x.reshape(N, D)
    gates, idx, aux, zloss = route(p["router"], xt, k)
    cap = max(1, math.ceil(N * k * cfg.capacity_factor / E))

    flat_e = idx.reshape(-1)                                  # (N k,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    pos = torch.arange(N * k, device=x.device) - first[sorted_e]
    keep = pos < cap
    # a kept assignment's row of the (E cap, D) buffer; a dropped one's the
    # extra row E cap, which the buffer's slice leaves out
    slot = torch.where(keep, sorted_e * cap + pos, E * cap)
    buf = xt.new_zeros((E * cap + 1, D))
    buf[slot] = xt[order // k]
    out = _expert_ffn(p, buf[:E * cap].view(E, cap, D), mlp_kind)

    # back in flat order: assignment j's row of the outputs, zeros if dropped
    flat_slot = torch.empty_like(slot)
    flat_slot[order] = slot
    out = torch.cat([out.reshape(E * cap, D), out.new_zeros((1, D))])
    flat_slot = flat_slot.view(N, k)
    y = out[flat_slot[:, 0]].float() * gates[:, :1]
    for i in range(1, k):
        y = y + out[flat_slot[:, i]].float() * gates[:, i:i + 1]
    assignments["routed"] += N * k
    assignments["dropped"] += (~keep).sum()
    y = y.to(x.dtype).reshape(B, S, D)
    return _with_shared(p, x, y, mlp_kind), aux, zloss


# ---------------------------------------------------------------------------
# Every expert on every token (decode; the reference's meshless form)
# ---------------------------------------------------------------------------


def moe_apply_local(p, x: torch.Tensor, *, cfg, mlp_kind: str):
    """x: (B, S, D), S small -> (y, aux, z-loss).  Every expert runs on
    every token; the gate matrix (N, E), zero off a token's top k, weights
    and sums the outputs in fp32.  The reference's ``_local_shard`` at
    ep = 1: its psum over the expert-parallel axis is the identity."""
    B, S, D = x.shape
    N = B * S
    xt = x.reshape(N, D)
    gates, idx, aux, zloss = route(p["router"], xt, cfg.top_k)
    g_full = torch.zeros((N, cfg.n_experts), dtype=torch.float32, device=x.device)
    g_full.scatter_(1, idx, gates)
    yout = _expert_ffn(p, xt, mlp_kind)                        # (E, N, D)
    y = torch.einsum("ne,end->nd", g_full, yout.float())
    y = y.to(x.dtype).reshape(B, S, D)
    return _with_shared(p, x, y, mlp_kind), aux, zloss


#: the reference's meshless path (every expert resident, gate-masked): on
#: one card the same function as the decode path
moe_apply_dense = moe_apply_local

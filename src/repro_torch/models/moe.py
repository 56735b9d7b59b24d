"""Mixture-of-Experts (the port of ``repro/models/moe.py``).

The token->expert redistribution is the paper's v->w exchange: each
expert-parallel rank fills an expert-major (experts, capacity, d) buffer
whose dim 0 one fused ``all_to_all_single`` splits over the group and
concatenates back, once each way, with no packing pass.  Four paths:

``moe_apply_a2a``      — the expert-parallel dispatch (the serving prefill
                         on a mesh, where S divides over the model group):
                         a rank routes its S / tp positions of its rows,
                         sends its buffer, runs its E / tp experts on what
                         it receives, sends the outputs back, and gathers
                         y along S.  Assignments past the capacity of the
                         rank's own N are dropped, as in the reference.
``moe_apply_capacity`` — the same dispatch on one rank without a mesh (the
                         reference's ``moe_apply_a2a`` at ep = 1): the
                         all-to-all is the identity and is left out.
``moe_apply_local``    — each rank's experts on every one of its tokens,
                         masked by the gate matrix, summed over the model
                         group (the decode path): nothing is dropped.
``moe_apply_dense``    — the reference's meshless form, the same function
                         as ``moe_apply_local`` without a mesh.

At one rank ``moe_apply_a2a`` is ``moe_apply_capacity`` bit for bit, and
``moe_apply_local`` with a mesh is itself without one.  Routing: fp32
router, softmax -> top-k -> renormalise, load-balance aux loss and router
z-loss, as in the reference; on a mesh they are the rank's own (the
reference's mean over the group is left out: serving reads neither).  The
expert products are ``torch.matmul`` (the reference's ``jnp.einsum`` runs
outside any Pallas kernel).  ``assignments`` counts each rank's routed and
dropped assignments.

Training (``LM.loss``) runs ``moe_apply_capacity``, or ``moe_apply_dense``
in local mode, with gradients through the router's gates, aux and z-loss,
the dispatch and the combine.  The backward is deterministic on a card: the
dispatch's gathers its k copies of a token's gradient back in a fixed order
(``_Fill``), and the combine's gathers read distinct rows but the dropped
one, whose gradient is discarded.
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
             dtype=torch.bfloat16, keep=None) -> dict:
    """cfg: ``models.config.MoEConfig``.  The router is fp32 whatever
    ``dtype``; each expert stack (E, d_in, d_out) is one tensor, drawn one
    expert's matrix at a time, so that init holds one fp32 matrix beside the
    weights and never a second copy of a stack.  ``keep(name, tensor)``, if
    given, takes each leaf as soon as it is drawn (``"w_up"``,
    ``"shared.w_down"``, ...) and returns what the layer holds (a rank's
    slice), so that at most one whole stack is held at a time."""
    E, ff = cfg.n_experts, cfg.d_ff_expert
    keep = keep or (lambda name, t: t)

    def stack(d_in, d_out):
        w = torch.empty((E, d_in, d_out), dtype=dtype, device=gen.device)
        for e in range(E):
            w[e] = dense_init(gen, d_in, d_out, dtype)
        return w

    p = {"router": keep("router", dense_init(gen, d, E, torch.float32))}
    if mlp_kind in ("swiglu", "geglu"):
        p["w_gate"] = keep("w_gate", stack(d, ff))
    p["w_up"] = keep("w_up", stack(d, ff))
    p["w_down"] = keep("w_down", stack(ff, d))
    if cfg.n_shared:
        shared = mlp_init(gen, d, cfg.n_shared * ff, mlp_kind, dtype)
        p["shared"] = {k: keep("shared." + k, t) for k, t in shared.items()}
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


def _with_shared(p, x: torch.Tensor, y: torch.Tensor, mlp_kind: str, shard=None) -> torch.Tensor:
    """y plus the shared experts' MLP of x, where the layer has one (split
    column/row over the model group on a mesh, and summed over it)."""
    if "shared" not in p:
        return y
    s = mlp_apply(p["shared"], x, mlp_kind)
    return y + (s if shard is None else shard.reduce(s))


# ---------------------------------------------------------------------------
# The capacity dispatch (the reference's _dispatch_shard)
# ---------------------------------------------------------------------------


class _Fill(torch.autograd.Function):
    """The dispatch buffer (E cap + 1, D): ``buf[slot] = xt[src]``, zeros in
    the slots no assignment fills (the last row takes the dropped ones).
    Its backward sums a token's k gradients by gathers, in the order of its
    choices (``flat_slot`` (N, k): the row of each, E cap if dropped, whose
    gradient is zero), in fp32: a segment sum with no atomics, where the
    backward of ``xt[src]`` would scatter-add the k copies (atomics on CUDA,
    in no fixed order)."""

    @staticmethod
    def forward(ctx, xt, rows: int, slot, src, flat_slot):
        ctx.save_for_backward(flat_slot)
        buf = xt.new_zeros((rows, xt.shape[1]))
        buf[slot] = xt[src]
        return buf

    @staticmethod
    def backward(ctx, g):
        (flat_slot,) = ctx.saved_tensors
        gx = g[flat_slot[:, 0]].float()
        for i in range(1, flat_slot.shape[1]):
            gx += g[flat_slot[:, i]].float()
        return gx.to(g.dtype), None, None, None, None


def _dispatch(p, xt: torch.Tensor, *, cfg, mlp_kind: str, shard=None):
    """xt: (N, D), one rank's tokens -> (y (N, D) in xt's dtype, aux, z-loss).

    The flat assignments (token n's k choices at n * k ... n * k + k - 1) are
    sorted stably by expert; an assignment's position within its expert is
    its rank there in flat token order, and those at positions >= capacity
    ``max(1, ceil(N * k * capacity_factor / E))`` are dropped.  The kept
    ones fill an expert-major (E cap, D) buffer (a dropped one goes to an
    extra row the buffer's slice leaves out).  On a mesh that slice is the
    send buffer of one ``all_to_all_single``: dim 0 is expert-major, so
    chunk r, experts [r E_loc, (r + 1) E_loc), reaches rank r with no pack
    pass; the received (tp, E_loc, cap, D) is reordered to (E_loc, tp cap,
    D) (the reference's transpose), run through the rank's experts, ordered
    back and returned by a second ``all_to_all_single``.  Each expert runs
    on its whole (capacity, D) slices, zeros included.  A token's kept
    outputs are weighted by their gates and summed in fp32 in the order of
    its choices: the reference adds them into zeros in sorted order, which
    is the same sum at k = 2 and a fixed order here for any k (no atomics).
    Every shape is known to the host: nothing waits on the device."""
    N, D = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    gates, idx, aux, zloss = route(p["router"], xt, k)
    cap = max(1, math.ceil(N * k * cfg.capacity_factor / E))

    flat_e = idx.reshape(-1)                                  # (N k,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=xt.device))
    pos = torch.arange(N * k, device=xt.device) - first[sorted_e]
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos, E * cap)
    # back in flat order: assignment j's row of the buffer, E cap if dropped
    flat_slot = torch.empty_like(slot)
    flat_slot[order] = slot
    flat_slot = flat_slot.view(N, k)
    send = _Fill.apply(xt, E * cap + 1, slot, order // k, flat_slot)[:E * cap]
    if shard is None:
        out = _expert_ffn(p, send.view(E, cap, D), mlp_kind)
    else:
        ep = shard.tp
        E_loc = E // ep
        recv = shard.exchange(send)
        recv = recv.view(ep, E_loc, cap, D).transpose(0, 1).reshape(E_loc, ep * cap, D)
        out = _expert_ffn(p, recv, mlp_kind)
        out = out.view(E_loc, ep, cap, D).transpose(0, 1).reshape(E * cap, D)
        out = shard.exchange(out.contiguous())

    # assignment j's row of the outputs, zeros if dropped
    out = torch.cat([out.reshape(E * cap, D), out.new_zeros((1, D))])
    y = out[flat_slot[:, 0]].float() * gates[:, :1]
    for i in range(1, k):
        y = y + out[flat_slot[:, i]].float() * gates[:, i:i + 1]
    assignments["routed"] += N * k
    dropped = assignments["dropped"]  # 0, or a tensor of an earlier call (maybe another device)
    assignments["dropped"] = (~keep).sum() + (dropped.to(keep.device) if torch.is_tensor(dropped)
                                              else dropped)
    return y.to(xt.dtype), aux, zloss


def moe_apply_capacity(p, x: torch.Tensor, *, cfg, mlp_kind: str):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux, z-loss): the capacity
    dispatch (``_dispatch``) of every token on one rank."""
    B, S, D = x.shape
    y, aux, zloss = _dispatch(p, x.reshape(B * S, D), cfg=cfg, mlp_kind=mlp_kind)
    return _with_shared(p, x, y.reshape(B, S, D), mlp_kind), aux, zloss


def moe_apply_a2a(p, x: torch.Tensor, shard, *, cfg, mlp_kind: str):
    """x: (B, S, D), the rank's rows, whole over the model group, S
    divisible by it -> (y (B, S, D), aux, z-loss).  The rank dispatches its
    contiguous S / tp positions (``_dispatch`` with the two all-to-alls,
    capacity from its own N = B S / tp), then one ``all_gather`` along S
    makes y whole on every rank again (the reference's out spec is
    position-sharded, and its next layer's constraint gathers it).  The
    expert stacks are the rank's E / tp experts."""
    B, S, D = x.shape
    if S % shard.tp:
        raise ValueError(f"the expert-parallel dispatch needs S ({S}) divisible by {shard.tp}")
    n = S // shard.tp
    xs = x[:, shard.rank * n:(shard.rank + 1) * n]
    y, aux, zloss = _dispatch(p, xs.reshape(B * n, D), cfg=cfg, mlp_kind=mlp_kind, shard=shard)
    y = shard.gather(y.view(B, n, D), dim=1)
    return _with_shared(p, x, y, mlp_kind, shard), aux, zloss


# ---------------------------------------------------------------------------
# Every expert on every token (decode; the reference's meshless form)
# ---------------------------------------------------------------------------


def moe_apply_local(p, x: torch.Tensor, *, cfg, mlp_kind: str, shard=None):
    """x: (B, S, D), S small -> (y, aux, z-loss).  Each of the rank's experts
    runs on every token; the gate matrix (N, E), zero off a token's top k,
    restricted to the rank's experts, weights and sums the outputs in fp32,
    and on a mesh one fp32 ``all_reduce`` sums them over the model group (the
    reference's ``_local_shard`` and its psum)."""
    B, S, D = x.shape
    N = B * S
    xt = x.reshape(N, D)
    gates, idx, aux, zloss = route(p["router"], xt, cfg.top_k)
    g = torch.zeros((N, cfg.n_experts), dtype=torch.float32, device=x.device)
    g.scatter_(1, idx, gates)
    yout = _expert_ffn(p, xt, mlp_kind)                        # (E_loc, N, D)
    if shard is not None:
        n = cfg.n_experts // shard.tp
        g = g[:, shard.rank * n:(shard.rank + 1) * n]
    y = torch.einsum("ne,end->nd", g, yout.float())
    if shard is not None:
        y = shard.reduce(y)
    y = y.to(x.dtype).reshape(B, S, D)
    return _with_shared(p, x, y, mlp_kind, shard), aux, zloss


#: the reference's meshless path (every expert on every token, gate-masked,
#: nothing dropped), which its compressed-gradient Trainer trains through
#: (``LM.local()``): on one card the same function as the decode path
moe_apply_dense = moe_apply_local

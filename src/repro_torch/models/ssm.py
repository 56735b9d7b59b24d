"""The state-space layers Mamba1 (the selective scan) and Mamba2 (the SSD
scan): the port of ``repro/models/ssm.py``.

Functions over parameter mappings (``nn.ParameterDict`` or plain dicts of
tensors), as in ``layers.py``.  The depthwise causal conv sums its K taps in
fp32 in the order k = 0 ... K-1, adds the bias and casts back; its decode
step contracts a (B, K, C) window in fp32.

``selective_scan`` is chunked as the reference is: T padded to a multiple of
the chunk (dt padded with 0, so a padded step has dA = 1 and dBx = 0 and the
final state is the state at T), then a sequential loop over chunks carrying
h (B, Di, N) in fp32.  Inside a chunk, dA = exp(dt A) and dBx = dt B x over
(B, Lc, Di, N), then the recurrence h_l = dA_l h_{l-1} + dBx_l, which the
reference runs as ``lax.associative_scan`` (plain JAX, no Pallas kernel):
here a sequential loop over the chunk's positions, one in-place
``addcmul_`` on a (B, Di, N) slice each, which never divides (the products
of dA underflow fp32 over a chunk, as they should) and holds nothing beyond
the chunk's two (B, Lc, Di, N) tensors.  Then y = sum_n h C.  It is plain
PyTorch, the reference's plain JAX; a fused scan kernel is later work
(ROADMAP.md §2).  With gradients enabled (the training forward) each chunk
runs the same operations out of place, rematerialized in the backward
(``_scan_chunk``): bit for bit the same values.

``mamba1_apply`` keeps the reference's dtype boundaries: ``in_proj``,
``x_proj``, ``dt_proj`` and ``out_proj`` in the weights' dtype; the softplus
of ``(dt @ dt_proj).float() + dt_bias`` in fp32 (``F.softplus``, whose
threshold of 20 agrees with jax's ``logaddexp(x, 0)`` to fp32 rounding);
``y + D x`` and the ``silu(z)`` gate in fp32, cast before ``out_proj``.

``ssd_scan`` (Mamba2) is chunked the same way, with T padded by zeros in
x, dt, B and C (a padded step, dt = 0, neither decays nor adds) and s
(B, H, P, N) carried in fp32.  A chunk is dense contractions, as in the
reference: the log decays ``cum = cumsum(dt a)``, the lower triangle of
``(C_i . B_j) exp(cum_i - cum_j)`` against ``x dt``, the inter-chunk term
``C_i . (exp(cum_i) s)`` and the state update ``exp(cum_last) s + sum_j
exp(cum_last - cum_j) B_j (x dt)_j``.  ``exp(cum_i - cum_j)`` can overflow
to inf above the diagonal (j > i): the exponent is set to -inf there before
the exp, and ``torch.where`` drops those entries as the reference's ``where``
does (a product with a 0/1 mask would make inf . 0 = NaN).  The values are
the reference's; its gradient is not where it overflows, since it
exponentiates first and masks after, and the backward of the dropped inf is
0 . inf = NaN; here it is finite.  Each of the reference's three-operand einsums is one factor applied
first and then a two-operand product: torch contracts an einsum left to
right, which for the state update would build a (B, Lc, N, H, P)
intermediate (671 MB a chunk at Zamba2's widths).  ``mamba2_apply`` splits
``in_proj``'s output as z, x, B, C, dt, runs the causal conv over (x, B, C),
and ends in the gated norm ``rmsnorm((y silu(z)).to(u.dtype), norm_w)``.

Both apply functions take ``shard`` (a ``models/sharding.py`` ``Shard``,
None without a mesh) and then run on the rank's slices of the weights
(whole channels of Mamba1, whole heads of Mamba2; the rules are
``sharding.py``'s): Mamba1's ``x @ x_proj`` is a sum over every rank's
channels, reduced in fp32 before dt, B and C are split; Mamba2's gated
norm takes the mean square over the whole di, the rank's mean scaled by
1 / tp and reduced in fp32 (the scale is exactly 1.0 at tp = 1, so that one
rank computes ``rmsnorm`` bit for bit).  Both return ``out_proj``'s partial
sums, which the caller reduces.  The scans are per channel or head and run
on the rank's alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import dense_init


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C); w: (K, C) depthwise taps; left-padded causal conv.
    The newest input meets the last tap."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    wf = w.float()
    out = xp[:, 0:T].float() * wf[0]
    for k in range(1, K):
        out += xp[:, k:k + T].float() * wf[k]
    return (out + b.float()).to(x.dtype)


def conv_tail(x: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 raw inputs of (B, T, C), zero-padded on the left when
    T < K-1: the decode conv state."""
    T = x.shape[1]
    if T >= K - 1:
        return x[:, T - (K - 1):]
    return F.pad(x, (0, 0, K - 1 - T, 0))


def causal_conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor):
    """Decode: state (B, K-1, C) holds the last K-1 inputs; x_t (B, C).
    Returns (the next state, the output (B, C))."""
    window = torch.cat([state, x_t[:, None]], dim=1)           # (B, K, C)
    y = (window.float() * w.float()).sum(1)
    return window[:, 1:], (y + b.float()).to(x_t.dtype)


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def mamba1_init(gen: torch.Generator, d: int, cfg, dtype=torch.bfloat16) -> dict:
    """The reference's leaves, shapes and dtypes, drawn on ``gen``:
    ``dt_bias``, ``A_log`` and ``D`` fp32; A = 1 ... N tiled over d_inner
    (S4D-real); dt log-uniform on [1e-3, 1e-1], ``dt_bias`` its inverse
    softplus."""
    di = cfg.expand * d
    dtr = cfg.dt_rank or -(-d // 16)
    N = cfg.d_state
    dev = gen.device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)[None].repeat(di, 1)
    u = torch.rand((di,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    conv_w = torch.randn((cfg.d_conv, di), generator=gen, device=dev) / math.sqrt(cfg.d_conv)
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, di, dtr + 2 * N, dtype),
        "dt_proj": dense_init(gen, dtr, di, dtype, scale=dtr**-0.5),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _scan_chunk(h, x_c, dt_c, A, B_c, C_c):
    """The training form of one chunk: the serving form's operations out of
    place (one ``addcmul`` a position, each h a tensor of its own), so that
    autograd can take it back; the same values bit for bit.  Returns (the
    last h, y_c (B, Lc, Di) fp32)."""
    dt_f = dt_c.float()
    dA = torch.exp(dt_f[..., None] * A.float())
    dBx = (dt_f * x_c.float())[..., None] * B_c[:, :, None, :].float()
    hs = []
    for l in range(dA.shape[1]):
        h = torch.addcmul(dBx[:, l], dA[:, l], h)
        hs.append(h)
    return h, torch.matmul(torch.stack(hs, 1), C_c[..., None].float())[..., 0]


def selective_scan(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """Diagonal selective scan, chunked.

    x, dt: (B, T, Di); A: (Di, N); Bm, Cm: (B, T, N).
    Returns y (B, T, Di) fp32 and the final state (B, Di, N) fp32.  Where
    a gradient is wanted (grad mode on and an input that requires one) it
    takes the training form (``_scan_chunk``, each chunk rematerialized in
    the backward, as the reference's checkpointed chunk body): the serving
    form's in-place ``addcmul_`` on views of one buffer share that buffer's
    version counter, which autograd refuses.
    """
    B, T, Di = x.shape
    Lc = min(chunk, T)
    pad = -T % Lc
    if pad:
        x, dt, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (x, dt, Bm, Cm))
    Af = A.float()
    h = (torch.zeros((B, Di, A.shape[-1]), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, A, Bm, Cm, h0)):
        ys = []
        for c0 in range(0, T + pad, Lc):
            c = slice(c0, c0 + Lc)
            h, y_c = checkpoint(_scan_chunk, h, x[:, c], dt[:, c], Af, Bm[:, c], Cm[:, c],
                                use_reentrant=False)
            ys.append(y_c)
        return torch.cat(ys, 1)[:, :T], h
    y = torch.empty((B, T + pad, Di), dtype=torch.float32, device=x.device)
    for c0 in range(0, T + pad, Lc):
        c = slice(c0, c0 + Lc)
        dt_c = dt[:, c].float()
        dA = (dt_c[..., None] * Af).exp_()                       # (B, Lc, Di, N)
        hs = (dt_c * x[:, c].float())[..., None] * Bm[:, c, None, :].float()  # dBx
        for a_l, hs_l in zip(dA.unbind(1), hs.unbind(1)):
            h = hs_l.addcmul_(a_l, h)                             # h_l = dA_l h + dBx_l
        y[:, c] = torch.matmul(hs, Cm[:, c, :, None].float())[..., 0]
        h = h.clone()  # the carry alone, not a view that holds the chunk
        del dA, hs
    return y[:, :T], h


def mamba1_apply(p, u: torch.Tensor, *, cfg, state: dict | None = None, shard=None):
    """u: (B, T, D).  ``state=None`` for the prefill; returns (y, new state).

    ``state`` is {"conv": (B, K-1, Di) in u's dtype, "ssm": (B, Di, N) fp32}
    for the one-token decode form (T = 1); with ``shard`` Di is the rank's
    channels and y its partial sums.
    """
    N = cfg.d_state
    dtr = p["dt_proj"].shape[0]
    x, z = (u @ p["in_proj"]).chunk(2, dim=-1)

    if state is None:
        conv_state = conv_tail(x, cfg.d_conv)
        x = causal_conv(x, p["conv_w"], p["conv_b"])
    else:
        conv_state, x1 = causal_conv_step(state["conv"], x[:, 0], p["conv_w"], p["conv_b"])
        x = x1[:, None]
    x = F.silu(x)

    xp = x @ p["x_proj"]
    if shard is not None:  # a sum over every rank's channels
        xp = shard.reduce(xp)
    dt, Bm, Cm = xp.split([dtr, N, N], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if state is None:
        y, h = selective_scan(x, dt, A, Bm, Cm, chunk=cfg.chunk)
    else:
        dA = torch.exp(dt[:, 0, :, None] * A)
        dBx = dt[:, 0, :, None] * Bm.float()[:, 0, None, :] * x.float()[:, 0, :, None]
        h = dA * state["ssm"] + dBx
        y = torch.einsum("bin,bn->bi", h, Cm.float()[:, 0])[:, None]

    y = y + p["D"] * x.float()
    y = (y * F.silu(z.float())).to(u.dtype)
    return y @ p["out_proj"], {"ssm": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_init(gen: torch.Generator, d: int, cfg, dtype=torch.bfloat16) -> dict:
    """The reference's leaves, shapes and dtypes, drawn on ``gen``:
    ``in_proj`` (d, 2 di + 2N + nh), a conv over di + 2N channels,
    ``dt_bias`` the inverse softplus of a dt log-uniform on [1e-3, 1e-1],
    ``A_log`` zeros, ``D`` ones and ``norm_w`` ones, all four fp32."""
    di = cfg.expand * d
    nh = di // cfg.headdim
    N = cfg.d_state
    conv_dim = di + 2 * N
    dev = gen.device
    u = torch.rand((nh,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    conv_w = torch.randn((cfg.d_conv, conv_dim), generator=gen, device=dev) / math.sqrt(cfg.d_conv)
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * N + nh, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def ssd_scan(xh, dt, a_log, Bm, Cm, *, chunk: int, s0=None):
    """SSD chunked recurrence (Mamba2), h_t = exp(dt_t a) h_{t-1} + dt_t
    x_t (x) B_t, y_t = h_t . C_t.

    xh: (B, T, H, P); dt: (B, T, H) (after the softplus); a_log: (H,), the
    negative ``-exp(A_log)``; Bm, Cm: (B, T, N) (one group).  Returns y
    (B, T, H, P) fp32 and the final state (B, H, P, N) fp32.
    """
    B, T, H, Pd = xh.shape
    N = Bm.shape[-1]
    Lc = min(chunk, T)
    pad = -T % Lc
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (dt, Bm, Cm))
    a_log = a_log.float()
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=xh.device).tril()
    s = (torch.zeros((B, H, Pd, N), dtype=torch.float32, device=xh.device)
         if s0 is None else s0.float())
    y = torch.empty((B, T + pad, H, Pd), dtype=torch.float32, device=xh.device)
    for c0 in range(0, T + pad, Lc):
        c = slice(c0, c0 + Lc)
        x_c, dt_c, B_c, C_c = (a[:, c].float() for a in (xh, dt, Bm, Cm))
        cum = torch.cumsum(dt_c * a_log, dim=1)                   # (B, Lc, H) log decays
        xb = x_c * dt_c[..., None]                                # (B, Lc, H, P)
        # intra-chunk: att[i, j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i
        cum_h = cum.transpose(1, 2)                               # (B, H, Lc)
        decay = torch.exp(torch.where(tri, cum_h[..., :, None] - cum_h[..., None, :],
                                      -math.inf))
        att = (C_c @ B_c.transpose(1, 2))[:, None] * decay        # 0 where j > i
        yc = (att @ xb.transpose(1, 2)).transpose(1, 2)           # (B, Lc, H, P)
        # inter-chunk: y_i += exp(cum_i) C_i . s
        cs = (C_c @ s.reshape(B, H * Pd, N).transpose(1, 2)).view(B, Lc, H, Pd)
        y[:, c] = yc + cs * torch.exp(cum)[..., None]
        # state: s' = exp(cum_last) s + sum_j B_j (x) (exp(cum_last - cum_j) xb_j)
        xw = xb * torch.exp(cum[:, -1:] - cum)[..., None]
        s = (s * torch.exp(cum[:, -1])[:, :, None, None]
             + (xw.reshape(B, Lc, H * Pd).transpose(1, 2) @ B_c).view(B, H, Pd, N))
    return y[:, :T], s


def gated_rmsnorm(y: torch.Tensor, w: torch.Tensor, eps: float, shard=None) -> torch.Tensor:
    """``rmsnorm(y, w, eps)`` over the last dim; with ``shard``, ``y`` and
    ``w`` are the rank's part of it and the mean square is the whole dim's:
    the rank's mean times 1 / tp, summed in fp32 over the model group."""
    yf = y.float()
    ms = (yf * yf).mean(-1, keepdim=True)
    if shard is not None:
        ms = shard.reduce(ms * (1.0 / shard.tp))
    return (yf * torch.rsqrt(ms + eps) * w.float()).to(y.dtype)


def mamba2_apply(p, u: torch.Tensor, *, cfg, state: dict | None = None, shard=None):
    """u: (B, T, D).  ``state=None`` for the prefill; returns (y, new state).

    ``state`` is {"ssm": (B, H, P, N) fp32, "conv": (B, K-1, di + 2N) in u's
    dtype} for the one-token decode form (T = 1); with ``shard`` di and H
    are the rank's (``norm_w``'s length gives them), B and C whole, and y
    its partial sums.
    """
    di = p["norm_w"].shape[0]
    N = cfg.d_state
    Pd = cfg.headdim
    H = di // Pd
    B, T, _ = u.shape
    z, x, Bm, Cm, dt = (u @ p["in_proj"]).split([di, di, N, N, H], dim=-1)

    xbc = torch.cat([x, Bm, Cm], dim=-1)
    if state is None:
        conv_state = conv_tail(xbc, cfg.d_conv)
        xbc = causal_conv(xbc, p["conv_w"], p["conv_b"])
    else:
        conv_state, xbc1 = causal_conv_step(state["conv"], xbc[:, 0], p["conv_w"], p["conv_b"])
        xbc = xbc1[:, None]
    x, Bm, Cm = F.silu(xbc).split([di, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B, T, H)
    a_log = -torch.exp(p["A_log"])                              # (H,)
    xh = x.reshape(B, T, H, Pd)

    if state is None:
        y, s = ssd_scan(xh, dt, a_log, Bm, Cm, chunk=cfg.chunk)
    else:
        a = torch.exp(dt[:, 0] * a_log)                         # (B, H)
        xb = xh[:, 0].float() * dt[:, 0, :, None]               # (B, H, P)
        s = state["ssm"] * a[..., None, None] + xb[..., None] * Bm[:, 0, None, None].float()
        y = (s @ Cm[:, 0, None, :, None].float())[:, None, ..., 0]     # (B, 1, H, P)

    y = (y + p["D"][:, None] * xh.float()).reshape(B, T, di)
    y = gated_rmsnorm((y * F.silu(z.float())).to(u.dtype), p["norm_w"], 1e-5, shard)
    return y @ p["out_proj"], {"ssm": s, "conv": conv_state}

"""The state-space layer Mamba1, the selective scan (the port of the Mamba1
half of ``repro/models/ssm.py``).

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
(ROADMAP.md §2).

``mamba1_apply`` keeps the reference's dtype boundaries: ``in_proj``,
``x_proj``, ``dt_proj`` and ``out_proj`` in the weights' dtype; the softplus
of ``(dt @ dt_proj).float() + dt_bias`` in fp32 (``F.softplus``, whose
threshold of 20 agrees with jax's ``logaddexp(x, 0)`` to fp32 rounding);
``y + D x`` and the ``silu(z)`` gate in fp32, cast before ``out_proj``.
Mamba2 (``ssd_scan``) is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def selective_scan(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """Diagonal selective scan, chunked.

    x, dt: (B, T, Di); A: (Di, N); Bm, Cm: (B, T, N).
    Returns y (B, T, Di) fp32 and the final state (B, Di, N) fp32.
    """
    B, T, Di = x.shape
    Lc = min(chunk, T)
    pad = -T % Lc
    if pad:
        x, dt, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (x, dt, Bm, Cm))
    Af = A.float()
    h = (torch.zeros((B, Di, A.shape[-1]), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
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


def mamba1_apply(p, u: torch.Tensor, *, cfg, state: dict | None = None):
    """u: (B, T, D).  ``state=None`` for the prefill; returns (y, new state).

    ``state`` is {"conv": (B, K-1, Di) in u's dtype, "ssm": (B, Di, N) fp32}
    for the one-token decode form (T = 1).
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

    dt, Bm, Cm = (x @ p["x_proj"]).split([dtr, N, N], dim=-1)
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

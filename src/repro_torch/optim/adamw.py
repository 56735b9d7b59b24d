"""AdamW with a cosine schedule and global-norm clipping (the port of
``repro/optim/adamw.py``).

The parameters and the state are dicts of tensors keyed by the parameters'
names.  Moments are fp32 whatever the parameter dtype; weight decay acts
on matrices only (``ndim >= 2``, or the rule ``decays`` gives); each leaf is updated in fp32 and cast
back, with no fp32 master copy, as in the reference.  ``update`` writes
the parameters, the moments and the gradients (clipped) in place, one leaf
at a time, with two fp32 temporaries of the leaf's size, and runs the
reference's fp32 operations in the reference's order, each rounded once:

  g ← (g·scale) cast to g's dtype;  mu ← b1·mu + (1 − b1)·g;
  nu ← b2·nu + (1 − b2)·g²;  δ ← (mu / c1) / (√(nu / c2) + eps)
  (+ wd·p for matrices);  p ← (p − lr·δ) cast to p's dtype

with c1 = 1 − b1^t, c2 = 1 − b2^t, t the new step.  The divisors are
tensors on the leaf's device, since CUDA turns a division by a host scalar
into a product by its reciprocal; the square root is correctly rounded, as
XLA's (``_sqrt_``).  ``lr`` and the bias corrections are float32 on the
host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch


class OptState(NamedTuple):
    step: torch.Tensor           # int32 scalar, on the CPU
    mu: dict                     # first moment, fp32, keyed as the parameters
    nu: dict                     # second moment, fp32


def _sqrt_(t: torch.Tensor) -> torch.Tensor:
    """In-place correctly rounded fp32 square root: CUDA's ``sqrt`` is; the
    CPU's vectorized one is not (an ulp off in ~1 % of values), so there it
    goes through float64, whose rounding to fp32 is the correct one."""
    if t.device.type == "cuda":
        return t.sqrt_()
    return t.copy_(t.double().sqrt_())


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """lr(step): linear warm-up to ``base_lr`` over ``warmup`` steps, then a
    cosine to ``min_frac * base_lr`` at ``total``; float32 on the host."""

    def lr(step) -> torch.Tensor:
        step = _f32(step)
        warm = _f32(base_lr) * step / _f32(max(warmup, 1))
        prog = torch.clamp((step - _f32(warmup)) / _f32(max(total - warmup, 1)), 0.0, 1.0)
        cos = _f32(base_lr) * (_f32(min_frac) + _f32(1 - min_frac) * _f32(0.5)
                               * (_f32(1) + torch.cos(_f32(math.pi) * prog)))
        return torch.where(step < _f32(warmup), warm, cos)
    return lr


def global_norm(grads: dict, split: Callable[[str], bool] | None = None,
                reduce: Callable[[torch.Tensor], torch.Tensor] | None = None) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's fp32 sum of
    squares.  On a mesh, ``split(name)`` tells the leaves of which a rank
    holds a slice: their sums of squares are ``reduce``d (summed over
    "model", one collective of them all) before the sum, and the whole
    leaves, which every rank holds alike, count once.  At one rank that is
    the mesh-less sum bit for bit."""
    sq = {k: g.float().square().sum() for k, g in grads.items()}
    names = [k for k in sq if split(k)] if split is not None else []
    if names:
        sq.update(zip(names, reduce(torch.stack([sq[k] for k in names])).unbind()))
    gsq = None
    for s in sq.values():
        gsq = s if gsq is None else gsq + s
    return torch.sqrt(gsq)


def clip_by_global_norm(grads: dict, max_norm: float, split=None, reduce=None):
    """Scales ``grads`` in place by min(1, max_norm / max(norm, 1e-9)), each
    in fp32 and cast back; returns (grads, fp32 norm).  ``split`` and
    ``reduce``: ``global_norm``'s, on a mesh."""
    gnorm = global_norm(grads, split, reduce)
    scale = torch.clamp(_f32(max_norm).to(gnorm.device) / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return grads, gnorm


@dataclass(frozen=True)
class AdamW:
    lr: Any                      # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    # decays(name, p): whether leaf ``name`` takes weight decay; default: a
    # matrix (``ndim >= 2``).  The trainer passes the reference's rule on
    # its stacked tree (``convert.decays_in_reference``).
    decays: Callable[[str, torch.Tensor], bool] | None = None
    # on a mesh: split(name), whether a rank holds a slice of the leaf, and
    # reduce(t), the sum over "model" of the slices' squared norm
    # (``global_norm``)
    split: Callable[[str], bool] | None = None
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None

    def init(self, params: dict) -> OptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        mu={k: zeros(p) for k, p in params.items()},
                        nu={k: zeros(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: dict, state: OptState, params: dict):
        """Returns (params, state, {"grad_norm", "lr"}), each written in place
        but the step; ``grads`` is clipped in place."""
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm, self.split, self.reduce)
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else _f32(self.lr)
        t = step.to(torch.float32)
        c1 = _f32(1) - torch.pow(_f32(self.b1), t)
        c2 = _f32(1) - torch.pow(_f32(self.b2), t)
        b1, b2 = _f32(self.b1), _f32(self.b2)
        a1, a2 = _f32(1 - self.b1), _f32(1 - self.b2)
        on = {}
        for k, p in params.items():
            dev = p.device
            if dev not in on:
                on[dev] = [x.to(dev) for x in (b1, b2, a1, a2, c1, c2, _f32(self.eps),
                                                _f32(self.weight_decay), lr)]
            b1_, b2_, a1_, a2_, c1_, c2_, eps_, wd_, lr_ = on[dev]
            mu, nu = state.mu[k], state.nu[k]
            g = grads[k].to(torch.float32, copy=True)  # temporary 1 (the grads stay)
            tmp = torch.mul(g, a1_)               # temporary 2
            mu.mul_(b1_).add_(tmp)
            torch.mul(g, g, out=tmp)
            tmp.mul_(a2_)
            nu.mul_(b2_).add_(tmp)
            torch.div(mu, c1_, out=tmp)           # mhat
            torch.div(nu, c2_, out=g)             # nhat
            _sqrt_(g).add_(eps_)
            tmp.div_(g)                           # delta
            if (self.decays(k, p) if self.decays is not None else p.ndim >= 2):
                g.copy_(p)
                g.mul_(wd_)
                tmp.add_(g)
            tmp.mul_(lr_)
            g.copy_(p)
            g.sub_(tmp)
            p.copy_(g)
            del g, tmp
        return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}

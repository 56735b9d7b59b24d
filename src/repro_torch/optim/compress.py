"""Int8 gradient compression with error feedback for the data-parallel
reduction (the port of ``repro/optim/compress.py``).

Over the ``"data"`` group of G ranks, a gradient dict is flattened to one
fp32 vector (padded to a multiple of G) and reduced as

    quantize the (G, n/G) chunks to int8, one scale a chunk
    -> ``all_to_all_single`` the int8 chunks and their scales (each rank
       owns 1/G of the vector) -> dequantize and sum -> requantize the
       reduced chunk -> ``all_gather`` the int8 chunks and scales -> dequantize

about one byte an element each way where an fp32 all-reduce moves four.
The quantizer is the port's shared codec (``core/quant.py``, the exchange
wires'), as the reference uses its shared ``quant``.  ``ErrorFeedback``
carries what this rank's channel dropped into the next step; its residual
is taken against ``reduce_local_roundtrip``, the rank's own contribution
after the wire's quantization, not against the reduced sum.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.quant import dequantize_int8 as _dequant, quantize_int8


def _quant(x: torch.Tensor):
    """Symmetric per-chunk int8 (chunks along axis 0); returns (q, scale)."""
    return quantize_int8(x, block_axis=0)


def _group(mesh, axis_name: str):
    return mesh.get_group(axis_name), mesh.size(mesh.mesh_dim_names.index(axis_name))


def _reduce_shard(flat: torch.Tensor, group, G: int) -> torch.Tensor:
    """int8 reduce-scatter + all-gather of one flat fp32 vector whose length
    divides by G."""
    n = flat.shape[0]
    q, s = _quant(flat.reshape(G, n // G))               # (G, n/G) int8 + (G, 1)
    q_in, s_in = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_in, q.contiguous(), group=group)
    dist.all_to_all_single(s_in, s.contiguous(), group=group)
    part = _dequant(q_in, s_in).sum(0)                   # my reduced chunk
    q2, s2 = _quant(part[None])
    qs = [torch.empty_like(q2[0]) for _ in range(G)]
    ss = [torch.empty_like(s2[0]) for _ in range(G)]
    dist.all_gather(qs, q2[0].contiguous(), group=group)
    dist.all_gather(ss, s2[0].contiguous(), group=group)
    return _dequant(torch.stack(qs), torch.stack(ss)).reshape(n)


def _flatten_padded(grads: dict, G: int) -> torch.Tensor:
    """One fp32 vector of every leaf in order, zero-padded to a multiple of G
    (the layout the collective and its local estimate share)."""
    vec = torch.cat([g.reshape(-1).float() for g in grads.values()])
    pad = -vec.numel() % G
    return torch.nn.functional.pad(vec, (0, pad)) if pad else vec


def _unflatten(out: torch.Tensor, grads: dict) -> dict:
    res, off = {}, 0
    for k, g in grads.items():
        res[k] = out[off:off + g.numel()].reshape(g.shape).to(g.dtype)
        off += g.numel()
    return res


def compressed_psum(grads: dict, mesh, axis_name: str = "data") -> dict:
    """The sum over ``axis_name`` of each rank's ``grads``, through int8
    payloads; every rank returns it."""
    group, G = _group(mesh, axis_name)
    return _unflatten(_reduce_shard(_flatten_padded(grads, G), group, G), grads)


def reduce_local_roundtrip(grads: dict, mesh, axis_name: str = "data") -> dict:
    """This rank's contribution to ``compressed_psum`` after the wire's
    quantization (the same flatten, padding and per-chunk scales, no
    collective): what error feedback takes its residual against."""
    G = mesh.size(mesh.mesh_dim_names.index(axis_name))
    vec = _flatten_padded(grads, G)
    q, s = _quant(vec.reshape(G, -1))
    return _unflatten(_dequant(q, s).reshape(-1), grads)


class ErrorFeedback:
    """Error-feedback state: e ← (g + e) − Q(g + e) around a lossy
    ``compress_fn``; the state is a dict of fp32 tensors like the grads."""

    @staticmethod
    def init(grads_like: dict) -> dict:
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grads_like.items()}

    @staticmethod
    def apply(grads: dict, err: dict, compress_fn, local_fn=None):
        """Returns (compressed estimate, new err).  Where ``compress_fn``
        also reduces over ranks, ``local_fn`` gives the rank's own lossy
        estimate to take the residual against."""
        corrected = {k: g.float() + err[k] for k, g in grads.items()}
        sent = compress_fn(corrected)
        local = sent if local_fn is None else local_fn(corrected)
        return sent, {k: c - local[k].float() for k, c in corrected.items()}


def quantize_roundtrip(grads: dict) -> dict:
    """The lossy channel alone (per-tensor int8)."""
    out = {}
    for k, g in grads.items():
        q, s = _quant(g.reshape(1, -1))
        out[k] = _dequant(q, s).reshape(g.shape).to(g.dtype)
    return out

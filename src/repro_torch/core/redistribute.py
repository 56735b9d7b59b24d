"""The v->w exchange of a distributed array (paper Sec. 3.3.2, Alg. 2/3) on
``torch.distributed`` — the port of ``repro/core/redistribute.py``, fused
engine.

The reference's fused engine is one ``lax.all_to_all(split_axis=v,
concat_axis=w)``: the collective itself does the strided gather and
scatter.  ``all_to_all_single`` only splits and concatenates dim 0, so here
the send buffer is built chunk-major and the received chunks are scattered
into the concat axis:

``complex64`` (lossless) — a plain ``movedim(...).contiguous()`` into
    chunk-major order, the collective, and a plain scatter into ``w``.  This
    brings back the local realignment pass the paper removes; a lossless
    mode of the exchange kernels is to remove it (ROADMAP).
``bf16`` / ``int8`` — the encode writes the narrow payload straight into
    chunk-major order (``pack_chunks``), the collective ships it (int8 adds
    a second, ``(M, F)``-scale all-to-all, chunk-major like the payload), and
    the decode scatters chunk ``j`` into w-slot ``j`` while widening
    (``unpack_chunks``): no pass beyond the codec's own.  With
    ``impl="cuda"`` these are the exchange kernels (their plain versions for
    a CPU block); ``impl="torch"`` runs the plain versions everywhere.

The traditional and pipelined engines, ``guard=`` and the fault taps are not
ported yet (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.meshutil import axis_size
from repro_torch.core.pencil import Group, group_name
from repro_torch.core.quant import canonical_comm_dtype
from repro_torch.kernels.exchange import ops as xops, ref as xref


def _exchange_dim0(t: torch.Tensor, pg) -> torch.Tensor:
    """``all_to_all_single`` of ``t``'s equal dim-0 chunks over ``pg``."""
    t = t.contiguous()
    out = torch.empty_like(t)
    if t.is_complex():
        dist.all_to_all_single(torch.view_as_real(out), torch.view_as_real(t), group=pg)
    else:
        dist.all_to_all_single(out, t, group=pg)
    return out


def _all_to_all_comm(y: torch.Tensor, pg, m: int, *, split_axis: int, concat_axis: int,
                     comm_dtype=None, nbatch: int = 0, impl: str = "torch") -> torch.Tensor:
    """The tiled all-to-all of ``y`` over ``pg`` (``m`` ranks): ``split_axis``
    is cut into ``m`` chunks, chunk ``j`` goes to group rank ``j``, and the
    chunk received from rank ``j`` lands in slot ``j`` of ``concat_axis``;
    the payload travels as ``comm_dtype``."""
    d = canonical_comm_dtype(comm_dtype)
    if y.shape[split_axis] % m != 0:
        raise ValueError(f"split axis extent {y.shape[split_axis]} not divisible by group size {m}")
    if d == "complex64":
        shape = list(y.shape)
        shape[split_axis: split_axis + 1] = [m, shape[split_axis] // m]
        recv = _exchange_dim0(torch.movedim(y.reshape(shape), split_axis, 0), pg)
        out = torch.movedim(recv, 0, concat_axis)
        shape = list(out.shape)
        shape[concat_axis: concat_axis + 2] = [shape[concat_axis] * shape[concat_axis + 1]]
        return out.reshape(shape)
    if impl == "cuda":
        pack, unpack = xops.pack_chunks, xops.unpack_chunks
    elif impl == "torch":
        pack, unpack = xref.pack_chunks_ref, xref.unpack_chunks_ref
    else:
        raise ValueError(f"unknown exchange impl {impl!r}")
    payload, scale = pack(y, axis=split_axis, m=m, nbatch=nbatch, codec=d)
    recv = _exchange_dim0(payload, pg)
    scale_recv = None if scale is None else _exchange_dim0(scale, pg)
    return unpack(recv, v=split_axis - nbatch, w=concat_axis - nbatch, m=m, nbatch=nbatch,
                  scale=scale_recv, codec=d, iscomplex=y.is_complex())


def exchange_shard(block: torch.Tensor, v: int, w: int, group: Group, *, mesh: DeviceMesh,
                   method: str = "fused", comm_dtype=None, nbatch: int = 0,
                   impl: str = "torch") -> torch.Tensor:
    """This rank's v->w exchange over the mesh dimension ``group``.

    Input block: axis ``v`` full, axis ``w`` this rank's shard.  Output
    block: axis ``v`` this rank's shard, axis ``w`` full.  ``nbatch``
    leading axes are stacked fields (``v``/``w`` field-relative)."""
    if v == w:
        raise ValueError("exchange requires v != w (paper Alg. 3)")
    if method != "fused":
        raise NotImplementedError(
            f"method={method!r}: the port runs the fused engine only (ROADMAP: "
            "traditional and pipelined engines)")
    name = group_name(group)
    return _all_to_all_comm(block, mesh.get_group(name), axis_size(mesh, name),
                            split_axis=v + nbatch, concat_axis=w + nbatch,
                            comm_dtype=comm_dtype, nbatch=nbatch, impl=impl)

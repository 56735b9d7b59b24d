"""The v->w exchange of a distributed array (paper Sec. 3.3.2, Alg. 2/3) on
``torch.distributed`` — the port of ``repro/core/redistribute.py``.

``all_to_all_single`` only splits and concatenates dim 0, so every engine
ships a chunk-major send buffer and scatters the received chunks into the
concat axis:

``method="fused"`` — the reference's one ``lax.all_to_all(split_axis=v,
    concat_axis=w)``.  ``complex64`` (lossless): a plain
    ``movedim(...).contiguous()`` into chunk-major order, the collective, and
    a plain scatter into ``w`` (the local realignment the paper removes; a
    lossless mode of the exchange kernels is to remove it, ROADMAP).
    ``bf16``/``int8``: the encode writes the narrow payload straight into
    chunk-major order (``pack_chunks``), the collective ships it (int8 adds a
    second, ``(M, F)``-scale all-to-all) and the decode scatters chunk ``j``
    into w-slot ``j`` while widening (``unpack_chunks``).  With
    ``impl="cuda"`` these are the exchange kernels (their plain versions for
    a CPU block); ``impl="torch"`` runs the plain versions everywhere.
``method="traditional"`` — paper Eqs. 15-17 as the reference writes them:
    with ``impl="cuda"`` and a lossy wire, the same pack kernel ->
    collective -> unpack kernel as above (with ``transposed_out=True`` the
    unpack scatters into a new leading chunk axis); otherwise a reshape,
    the materialized ``movedim(...).contiguous()`` pack, the dim-0 exchange
    (with the plain codec) and a second copy to scatter back, or none with
    ``transposed_out=True`` (chunk-major output, FFTW's "transposed out").
``method="pipelined"`` — the fused exchange cut into slices of the
    post-exchange v shard, each one ``all_to_all_single(async_op=True)``:
    every slice is issued first, then waited for and decoded in order, so a
    caller's work on slice ``i`` (the next FFT stage, see
    :func:`repro_torch.core.pfft._exchange_then_fft`) is issued before the
    wait of slice ``i + 1``.  Lossless slices join to the fused output
    bitwise; lossy slices quantize independently.

Stacked fields (``nbatch`` leading axes, ``v``/``w`` field-relative): every
engine ships all fields in its one collective (per slice when pipelined),
and int8 keeps one scale per (field, chunk), ``(M, F)`` chunk-major on the
wire, so a field never shares a max-abs with another.  The traditional
engine's materialized pack puts the chunk axis in front of the fields; its
int8 codec then views the packed block with the fields first, so its scales
are per (chunk, field) as the reference's.  Transposed out, the output is
``(m, fields..., ...)``: the chunk axis leads and the fields follow it.
:func:`exchange_shard_start` splits the fused exchange into an issue and a
``finish()`` (asynchronous for ``batch_fusion="pipelined-across-fields"``);
:func:`exchange_shard` issues its fused exchanges through it.

``guard=True`` makes every engine return ``(out, stats)``: the
``{"nonfinite", "saturated"}`` counts of its lossy payload (from the codec
kernel's guard mode, or :func:`~repro_torch.robustness.health.payload_stats`
and ``quantize_int8(with_stats=True)`` under ``impl="torch"``), zeros for a
lossless stage.  The fault taps (:mod:`repro_torch.robustness.faults`) act
on every received buffer and on the int8 scale; unarmed they return their
input.  Element 0 of each received chunk-major buffer is the output block's
element 0, the element the reference's taps corrupt.

A group may be a tuple of mesh dimensions (:mod:`repro_torch.core.meshutil`):
chunk ``k`` goes to the rank of composed index ``k``.  ``new_group`` orders
a group by global rank, so a tuple out of mesh order gathers each wire
buffer's chunks into that order before the collective and back after it
(:func:`_exchange_dim0`, on every engine and wire alike, int8's scales
too); a tuple in mesh order needs neither.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.decomp import local_lengths
from repro_torch.core.hardware import HBM_BW, ICI_BW, ICI_LATENCY_S  # noqa: F401 (re-exported)
from repro_torch.core.meshutil import Subgroup, in_mesh_order, subgroup
from repro_torch.core.pencil import Group, Pencil, group_names, group_size
from repro_torch.core.quant import canonical_comm_dtype, wire_ratio
from repro_torch.kernels.exchange import ops as xops, ref as xref
from repro_torch.robustness import faults, health

#: chunk counts the tuner sweeps for the pipelined method
PIPELINE_CHUNK_CANDIDATES = (2, 4, 8)


def _exchange_dim0(t: torch.Tensor, grp: Subgroup, *, async_op: bool = False):
    """Start ``all_to_all_single`` of ``t``'s ``m`` dim-0 chunks over the
    group ``grp``, chunk ``k`` to the rank of composed index ``k``; returns
    ``receive()``, which waits and gives the received chunks with chunk
    ``j`` from composed index ``j``.  A group out of mesh order
    (``grp.send``) gathers the chunks into its rank order before the send,
    in place of the ``.contiguous()`` pack, and back after the receive."""
    t = t.contiguous() if grp.send is None else t.index_select(0, grp.send)
    out = torch.empty_like(t)
    if t.is_complex():
        work = dist.all_to_all_single(torch.view_as_real(out), torch.view_as_real(t),
                                      group=grp.pg, async_op=async_op)
    else:
        work = dist.all_to_all_single(out, t, group=grp.pg, async_op=async_op)

    def receive():
        if work is not None:
            work.wait()
        return out if grp.recv is None else out.index_select(0, grp.recv)

    return receive


def _start_comm(y: torch.Tensor, grp: Subgroup, *, split_axis: int, concat_axis: int,
                comm_dtype=None, nbatch: int = 0, impl: str = "torch", guard: bool = False,
                async_op: bool = False):
    """Issue the tiled all-to-all of ``y`` over the group ``grp`` (``m``
    ranks): ``split_axis`` is cut into ``m`` chunks, chunk ``j`` goes to the
    rank of composed index ``j``, and the chunk received from index ``j``
    lands in slot ``j`` of ``concat_axis``; the payload travels as
    ``comm_dtype``.  Returns ``(finish, stats)``: ``finish()`` waits for the
    collectives, applies the wire taps and decodes; ``stats`` is None unless
    ``guard``."""
    m = grp.size
    d = canonical_comm_dtype(comm_dtype)
    if y.shape[split_axis] % m != 0:
        raise ValueError(f"split axis extent {y.shape[split_axis]} not divisible by group size {m}")
    if d == "complex64":
        shape = list(y.shape)
        shape[split_axis: split_axis + 1] = [m, shape[split_axis] // m]
        receive = _exchange_dim0(torch.movedim(y.reshape(shape), split_axis, 0), grp,
                                 async_op=async_op)

        def finish():
            out = torch.movedim(faults.tap_wire(receive(), "payload"), 0, concat_axis)
            oshape = list(out.shape)
            oshape[concat_axis: concat_axis + 2] = [oshape[concat_axis] * oshape[concat_axis + 1]]
            return out.reshape(oshape)

        return finish, health.zero_stats(y.device) if guard else None
    if impl == "cuda":
        pack, unpack = xops.pack_chunks, xops.unpack_chunks
    elif impl == "torch":
        pack, unpack = xref.pack_chunks_ref, xref.unpack_chunks_ref
    else:
        raise ValueError(f"unknown exchange impl {impl!r}")
    sd = faults.scale_div() if d == "int8" else None
    payload, scale, stats = pack(y, axis=split_axis, m=m, nbatch=nbatch, codec=d, guard=guard,
                                 scale_div=sd)
    receive = _exchange_dim0(payload, grp, async_op=async_op)
    receive_scale = None if scale is None else _exchange_dim0(scale, grp, async_op=async_op)

    def finish():
        recv = receive()
        s = None if receive_scale is None else faults.tap_wire(receive_scale(), "scale")
        return unpack(faults.tap_wire(recv, "payload"), v=split_axis - nbatch,
                      w=concat_axis - nbatch, m=m, nbatch=nbatch, scale=s, codec=d,
                      iscomplex=y.is_complex())

    return finish, stats


def _group(mesh: DeviceMesh, group: Group) -> Subgroup:
    return subgroup(mesh, group_names(group))


def exchange_shard(block: torch.Tensor, v: int, w: int, group: Group, *, mesh: DeviceMesh,
                   method: str = "fused", chunks: int = 1, transposed_out: bool = False,
                   comm_dtype=None, nbatch: int = 0, guard: bool = False,
                   impl: str = "torch"):
    """This rank's v->w exchange over ``group``: a mesh dimension, or a
    tuple of them (a composed group, indexed row-major in its own order).

    Input block: axis ``v`` full, axis ``w`` this rank's shard.  Output
    block: axis ``v`` this rank's shard, axis ``w`` full.  ``nbatch``
    leading axes are stacked fields (``v``/``w`` field-relative).
    ``chunks`` applies to ``method="pipelined"``, ``transposed_out`` to
    ``method="traditional"``.  ``guard=True`` returns ``(out, stats)``."""
    if v == w:
        raise ValueError("exchange requires v != w (paper Alg. 3)")
    bv, bw = v + nbatch, w + nbatch
    if method == "pipelined":
        r = exchange_shard_sliced(block, v, w, group, mesh=mesh, chunks=chunks,
                                  comm_dtype=comm_dtype, nbatch=nbatch, guard=guard, impl=impl)
        pieces, stats = r if guard else (r, None)
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=bv)
        return (out, stats) if guard else out
    if method not in ("fused", "traditional"):
        raise ValueError(f"unknown method {method!r}")
    grp = _group(mesh, group)
    m = grp.size
    d = canonical_comm_dtype(comm_dtype)
    if method == "fused" or (impl == "cuda" and d != "complex64"):
        # traditional with the kernels: one kernel packs chunk-major and
        # encodes, the unpack kernel scatters and decodes, as the fused
        # engine's (Eqs. 15-17 cost no extra pass).
        if method == "traditional" and transposed_out:
            # the scatter goes into a new axis of extent 1 just behind the
            # fields, so received chunk j lands at index j of it; that chunk
            # axis then moves in front of the fields (a view when nbatch > 0)
            finish, stats = _start_comm(block.unsqueeze(nbatch), grp, split_axis=bv + 1,
                                        concat_axis=nbatch, comm_dtype=d, nbatch=nbatch,
                                        impl=impl, guard=guard)
            out = torch.movedim(finish(), nbatch, 0)
        else:
            finish, stats = exchange_shard_start(block, v, w, group, mesh=mesh, comm_dtype=d,
                                                 nbatch=nbatch, guard=guard, impl=impl)
            out = finish()
        return (out, stats) if guard else out
    nv = block.shape[bv]
    if nv % m != 0:
        raise ValueError(f"axis v={v} extent {nv} not divisible by group size {m}")
    # Eq. 15: v -> (m, nv/m), a view; Eq. 16: the chunk axis to the front,
    # the materialized local transpose; then the dim-0 exchange
    shape = list(block.shape)
    shape[bv: bv + 1] = [m, nv // m]
    y = torch.movedim(block.reshape(shape), bv, 0).contiguous()
    if nbatch and d == "int8":
        # one int8 scale per (chunk, field), as the reference blocks them:
        # the codec sees (fields, 1, m, ...) and cuts the m axis into m
        # chunks of 1, which land in the extent-1 axis
        z = torch.movedim(y, 0, nbatch).unsqueeze(nbatch)
        finish, stats = _start_comm(z, grp, split_axis=nbatch + 1, concat_axis=nbatch,
                                    comm_dtype=d, nbatch=nbatch, impl=impl, guard=guard)
        y = torch.movedim(finish().squeeze(nbatch + 1), nbatch, 0)
    else:
        finish, stats = _start_comm(y, grp, split_axis=0, concat_axis=0, comm_dtype=d,
                                    impl=impl, guard=guard)
        y = finish()
    if not transposed_out:
        # Eq. 17: chunk q carries peer q's w shard; insert the chunk axis
        # before w and merge (m, w_shard) -> w_full: the second copy
        z = torch.movedim(y, 0, bw)
        shape = list(z.shape)
        shape[bw: bw + 2] = [shape[bw] * shape[bw + 1]]
        y = z.reshape(shape)
    return (y, stats) if guard else y


def exchange_shard_start(block: torch.Tensor, v: int, w: int, group: Group, *,
                         mesh: DeviceMesh, method: str = "fused", chunks: int = 1,
                         comm_dtype=None, nbatch: int = 0, guard: bool = False,
                         impl: str = "torch", async_op: bool = False):
    """Start this rank's v->w exchange; returns ``(finish, stats)``,
    ``finish()`` giving the exchanged block and ``stats`` None unless
    ``guard``.

    With ``method="fused"`` the encode runs and the collective (with int8's
    scale collective) is issued here, asynchronously with ``async_op=True``;
    ``finish()`` waits for it and decodes, so work launched in between (the
    previous field's FFT under ``batch_fusion="pipelined-across-fields"``)
    is queued ahead of the wait.  The traditional and pipelined engines run
    to completion here, as :func:`exchange_shard` (the reference's per-field
    exchange), and ``finish()`` returns their result."""
    if v == w:
        raise ValueError("exchange requires v != w (paper Alg. 3)")
    if method != "fused":
        res = exchange_shard(block, v, w, group, mesh=mesh, method=method, chunks=chunks,
                             comm_dtype=comm_dtype, nbatch=nbatch, guard=guard, impl=impl)
        out, stats = res if guard else (res, None)
        return (lambda: out), stats
    return _start_comm(block, _group(mesh, group), split_axis=v + nbatch,
                       concat_axis=w + nbatch, comm_dtype=comm_dtype, nbatch=nbatch, impl=impl,
                       guard=guard, async_op=async_op)


def exchange_shard_sliced(block: torch.Tensor, v: int, w: int, group: Group, *,
                          mesh: DeviceMesh, chunks: int, comm_dtype=None, nbatch: int = 0,
                          guard: bool = False, impl: str = "torch", then=None):
    """The fused v->w exchange as independent per-slice all-to-alls (the
    pipelined engine).  The v axis is viewed as ``(m, b)``, ``b`` the
    post-exchange shard, and sliced along ``b`` into
    ``local_lengths(b, min(chunks, b))`` pieces; rank ``r``'s slice ``i`` is
    a contiguous v-subrange of the fused output.

    Every slice's collective is issued (``async_op=True``) before the first
    wait; then each slice is waited for, decoded, and passed to ``then``
    (default: identity) before the next wait.  Returns the list of
    ``then(piece)``, with the stats summed over the slices when ``guard``."""
    grp = _group(mesh, group)
    m = grp.size
    bv, bw = v + nbatch, w + nbatch
    nv = block.shape[bv]
    if nv % m != 0:
        raise ValueError(f"axis v={v} extent {nv} not divisible by group size {m}")
    b = nv // m
    sizes = [n for n in local_lengths(b, max(1, min(chunks, b))) if n > 0]
    shape = list(block.shape)
    shape[bv: bv + 1] = [m, b]
    y = block.reshape(shape)
    w_eff = bw if bw < bv else bw + 1  # the concat axis shifts right if it follows v
    started, off = [], 0
    stats = health.zero_stats(block.device) if guard else None
    for n in sizes:
        piece = torch.narrow(y, bv + 1, off, n)
        off += n
        finish, s = _start_comm(piece, grp, split_axis=bv, concat_axis=w_eff,
                                comm_dtype=comm_dtype, nbatch=nbatch, impl=impl, guard=guard,
                                async_op=True)
        if guard:
            stats = health.add_stats(stats, s)
        started.append((finish, n))
    out = []
    for finish, n in started:
        p = finish()
        # the m-factor axis now has extent 1: merge (1, n) -> (n,)
        pshape = list(p.shape)
        pshape[bv: bv + 2] = [n]
        p = p.reshape(pshape)
        out.append(p if then is None else then(p))
    return (out, stats) if guard else out


# ---------------------------------------------------------------------------
# counts and the time model of the plan's exchanges (pure arithmetic; the
# reference's values, but the local copies of exchange_local_copy_elems)
# ---------------------------------------------------------------------------


def exchange_cost_bytes(src: Pencil, v: int, w: int) -> int:  # noqa: ARG001
    """Elements each rank sends in the exchange (itemsize excluded): the
    local block minus the chunk it keeps.  The same for every engine."""
    m = group_size(src.mesh, src.placement[w])
    return math.prod(src.local_shape) * (m - 1) // m


def exchange_wire_bytes(src: Pencil, v: int, w: int, *, itemsize: int = 8, comm_dtype=None,
                        nfields: int = 1, slices: int = 1) -> int:
    """Bytes each rank puts on the wire: the exchanged elements of
    ``nfields`` stacked fields at the payload's width (bf16 itemsize / 2,
    int8 itemsize / 4), and for int8 one f32 scale per (field, destination)
    for each of the ``slices`` collectives of a pipelined engine."""
    d = canonical_comm_dtype(comm_dtype)
    total = exchange_cost_bytes(src, v, w) * nfields * itemsize // wire_ratio(d)
    if d == "int8":
        m = group_size(src.mesh, src.placement[w])
        total += 4 * (m - 1) * nfields * max(1, slices)
    return total


def pipeline_slices(src: Pencil, v: int, w: int, *, chunks: int) -> int:
    """Collectives the pipelined engine issues for this exchange: the
    nonempty pieces of the post-exchange shard ``b = n_v / m`` that
    :func:`exchange_shard_sliced` cuts."""
    return len(_slice_lengths(src, v, w, chunks))


def exchange_collective_launches(src: Pencil, v: int, w: int, *, method: str = "fused",
                                 chunks: int = 1, nfields: int = 1,
                                 batch_fusion: str = "stacked") -> int:  # noqa: ARG001
    """Payload collectives this exchange issues for ``nfields`` fields (the
    int8 scale collective is not counted, as in the reference): ``chunks``
    for a chunked pipelined engine, else one; ``"stacked"`` (or one field)
    issues that once, ``"per-field"`` and ``"pipelined-across-fields"`` once
    per field."""
    per_exchange = chunks if method == "pipelined" and chunks > 1 else 1
    n = max(1, nfields)
    if n == 1 or batch_fusion == "stacked":
        return per_exchange
    if batch_fusion in ("per-field", "pipelined-across-fields"):
        return n * per_exchange
    raise ValueError(f"unknown batch_fusion {batch_fusion!r}")


def _lead(shape, axis: int, nbatch: int) -> bool:
    """Whether anything but extent 1 precedes ``axis`` of a block of
    ``shape`` (stacked fields always do): moving the axis to the front, or
    merging into it, is then a copy."""
    return nbatch > 0 or math.prod(shape[:axis]) > 1


def _slice_lengths(src: Pencil, v: int, w: int, chunks: int) -> list[int]:
    """The pipelined engine's nonempty slices of the post-exchange shard."""
    b = src.local_shape[v] // group_size(src.mesh, src.placement[w])
    return [n for n in local_lengths(b, max(1, min(chunks, b))) if n > 0]


def _engine_copies(src: Pencil, v: int, w: int, *, method: str, chunks: int,
                   transposed_out: bool, nbatch: int, comm_dtype, impl: str):
    """``(copies, concats, scale_gathers)`` of one exchange of a contiguous
    block as the port makes them: ``copies`` and ``concats`` lists of the
    elements each copy or concatenate materializes, counted at the local
    block's width (a lossy payload's copy is ``local / wire_ratio`` of
    them), and the number of ``index_select`` gathers of int8's ``(M, F)``
    scales beside them.  A stacked block (``nbatch``) holds more than one
    field."""
    d = canonical_comm_dtype(comm_dtype)
    m = group_size(src.mesh, src.placement[w])
    local = math.prod(src.local_shape)
    ordered = in_mesh_order(src.mesh, group_names(src.placement[w]))
    dst = src.exchanged(v, w)

    def wire(n_elems):
        """The gathers of a group out of mesh order around one collective of
        ``n_elems`` block elements: send and receive, payload and scales."""
        if ordered or m == 1:
            return [], 0
        size = n_elems if d == "complex64" else n_elems // wire_ratio(d)
        return [size, size], 2 if d == "int8" else 0

    if method not in ("fused", "traditional", "pipelined"):
        raise ValueError(f"unknown method {method!r}")
    # the pack into chunk-major order (``movedim(...).contiguous()``) moves
    # data unless the chunk axis already leads
    pack = m > 1 and _lead(src.local_shape, v, nbatch)
    kernels = impl == "cuda" and d != "complex64"
    if method == "fused" or (method == "traditional" and kernels):
        copies, scales = wire(local)
        if d == "complex64":
            # the send's gather takes the pack's place out of mesh order
            if ordered and pack:
                copies.append(local)
            if m > 1 and _lead(dst.local_shape, w, nbatch):  # the scatter into w
                copies.append(local)
        return copies, [], scales
    if method == "traditional":  # Eq. 16's pack and Eq. 17's unpack
        copies, scales = wire(local)
        if pack:
            copies.append(local)
        if m > 1 and not transposed_out and _lead(dst.local_shape, w, nbatch):
            copies.append(local)
        return copies, [], scales
    sizes = _slice_lengths(src, v, w, chunks)
    b = sum(sizes)
    # one slice of several is a strided view of the block
    sliced = len(sizes) > 1 and (m > 1 or _lead(src.local_shape, v, nbatch))
    copies, scales = [], 0
    for n in sizes:
        piece = local * n // b
        c, s = wire(piece)
        copies += c
        scales += s
        if d == "complex64":
            shape = list(dst.local_shape)
            shape[v] = n
            if ordered and (pack or sliced):
                copies.append(piece)
            if m > 1 and _lead(shape, w, nbatch):
                copies.append(piece)
    return copies, [local] if len(sizes) > 1 else [], scales


def exchange_takes_any_layout(src: Pencil, v: int, w: int, *, method: str = "fused",
                              chunks: int = 1, nbatch: int = 0, comm_dtype=None,
                              impl: str = "torch") -> bool:
    """Whether the exchange reads its block through a copy of all of it (the
    chunk-major pack where the chunk axis does not lead, each slice's pack
    of a pipelined exchange of several, a composed group's gather out of
    mesh order, or a lossy wire's encode), so that a block in any layout
    costs it no copy more than a contiguous one.

    Where it does not, the engine takes the block as it lies and the copies
    of :func:`exchange_engine_ops` hold for a contiguous block only: a
    strided view would be copied by the pack, a realignment outside the
    collective that no contract names.  The executor therefore has the
    transform before such an exchange hand on a contiguous block
    (``repro_torch.core.pfft._fft_padded_axis``), as the reference's
    ``jnp.fft`` moves its axis back before the exchange sees it, and hands
    on the transform's own view everywhere else.  A lossy encode under
    ``impl="cuda"`` counts as reading any layout: K1's wrapper copies a
    strided block first (ROADMAP §3)."""
    d = canonical_comm_dtype(comm_dtype)
    m = group_size(src.mesh, src.placement[w])
    lead = _lead(src.local_shape, v, nbatch)
    if d != "complex64" and (method != "traditional" or impl == "cuda"):
        return True
    if method == "traditional":
        return m > 1 and lead
    if m > 1 and (lead or not in_mesh_order(src.mesh, group_names(src.placement[w]))):
        return True
    return method == "pipelined" and pipeline_slices(src, v, w, chunks=chunks) > 1 and (
        m > 1 or lead)


def exchange_engine_ops(src: Pencil, v: int, w: int, *, method: str = "fused", chunks: int = 1,
                        transposed_out: bool = False, nbatch: int = 0, comm_dtype=None,
                        impl: str = "torch") -> dict[str, int]:
    """Layout copies (``"transposes"``: ``clone``, ``copy_``,
    ``index_select``) and concatenates (``"concats"``) the engine makes
    outside the collective, as the port makes them: the contract
    :mod:`repro_torch.analysis.planlint` holds a run to (PLAN003, PLAN004).
    The block is contiguous, or the exchange reads it through a copy of
    its own (:func:`exchange_takes_any_layout`).

    Where the port equals the reference (``repro.core.redistribute
    .exchange_engine_ops``): a lossy fused exchange makes none (the codec
    packs into chunk-major order and the decode scatters into ``w``);
    traditional makes its pack and unpack copies, except where the moved
    axis already leads; with ``impl="cuda"`` and a lossy wire the codec
    kernels do them; pipelined concatenates its slices when it makes more
    than one.

    Where it differs, every case also priced by
    :func:`exchange_local_copy_elems`:

    * a lossless (complex64) fused or pipelined exchange over ``M > 1``
      ranks packs with ``movedim(...).contiguous()`` into chunk-major order
      and scatters with a ``movedim``/``reshape`` (``all_to_all_single``
      splits dim 0 only): one copy each, except where the moved axis
      already leads (nothing but extent 1 before ``v``, or before ``w``
      after the exchange, and no stacked fields); a pipelined slice of
      several is never contiguous in chunk-major order, so each packs;
    * a composed group out of mesh order gathers the wire buffer's chunks
      into the group's rank order with ``index_select`` before the send and
      back after the receive (two more, int8's scales two more again); on a
      lossless fused or pipelined wire the send's gather is the pack;
    * under ``impl="cuda"`` the codec kernels' pack and scatter are the
      kernels' (their plain versions' on a CPU tensor are the wrappers'):
      the engine makes no copy of its own for them, traditional's
      transposed-out exchange included (the decode scatters into the new
      leading chunk axis; the reference keeps that case's pack copy).

    ``nbatch`` leading axes are stacked fields; ``transposed_out`` applies
    to traditional."""
    copies, concats, scales = _engine_copies(
        src, v, w, method=method, chunks=chunks, transposed_out=transposed_out, nbatch=nbatch,
        comm_dtype=comm_dtype, impl=impl)
    return {"transposes": len(copies) + scales, "concats": len(concats)}


def exchange_local_copy_elems(src: Pencil, v: int, w: int, *, method: str = "fused",
                              comm_dtype=None, impl: str = "torch", chunks: int = 1,
                              nbatch: int = 0) -> int:
    """Elements of local copies the engine pays on top of the wire payload
    and the codec: the elements of the copies and concatenates of
    :func:`exchange_engine_ops`, at the local block's width (a lossy
    payload's gather is ``local / wire_ratio`` of them; int8's ``(M, F)``
    scales, a few floats, are not counted).  ``chunks`` is the pipelined
    engine's and ``nbatch`` says whether the block stacks fields.

    The reference counts traditional's pack and unpack as two passes, the
    pipelined concat as one and fused as none, and none of the engine's
    own under its kernels.  The port's count is the copies its code makes:
    traditional's pack or unpack is free where the moved axis already
    leads, a one-slice pipelined exchange concatenates nothing, a lossless
    fused or pipelined exchange over ``M > 1`` ranks pays the pack and the
    scatter where they move data, and a composed group out of mesh order
    adds its gathers (:func:`exchange_engine_ops` lists the cases)."""
    copies, concats, _ = _engine_copies(
        src, v, w, method=method, chunks=chunks, transposed_out=False, nbatch=nbatch,
        comm_dtype=comm_dtype, impl=impl)
    return sum(copies) + sum(concats)


def exchange_time_model(src: Pencil, v: int, w: int, *, itemsize: int = 8,
                        method: str = "fused", chunks: int = 1, comm_dtype=None,
                        ici_bw: float = ICI_BW, hbm_bw: float = HBM_BW,
                        overlap_compute_s: float = 0.0, nfields: int = 1,
                        batch_fusion: str = "stacked", ici_latency_s: float = ICI_LATENCY_S,
                        impl: str = "torch") -> float:
    """Modeled seconds of one exchange and the 1-D FFT stage after it (whose
    per-field time the caller passes as ``overlap_compute_s``), at this
    card's constants unless given (:mod:`repro_torch.core.hardware`).

    fused/traditional serialize the collective and the FFT; pipelined with
    c slices exposes only the first slice's collective and the last
    slice's FFT:

        T = c·T_lat + T_comm/c + max(T_comm, T_fft)·(c-1)/c + T_fft/c

    A lossy ``comm_dtype`` shrinks T_comm to :func:`exchange_wire_bytes`
    and adds the codec's HBM passes over the local block, one lean pass a
    side with ``impl="cuda"`` (read wide, write narrow and back), and a
    full-width plane stack more a side with the plain codec.  ``nfields``
    fields ship by ``batch_fusion``: ``"stacked"`` one collective for all
    (one latency, N× bytes and FFT), ``"pipelined-across-fields"`` N
    collectives with field i's hidden under field i-1's FFT, ``"per-field"``
    N serialized exchange + FFT pairs.  The reference's formula, with the
    port's local copies (:func:`exchange_local_copy_elems`)."""
    d = canonical_comm_dtype(comm_dtype)
    n = max(1, nfields)
    comm_s = exchange_wire_bytes(src, v, w, itemsize=itemsize, comm_dtype=d) / ici_bw
    stacked = 1 if n > 1 and batch_fusion == "stacked" else 0
    copy_s = (exchange_local_copy_elems(src, v, w, method=method, comm_dtype=d, impl=impl,
                                        chunks=chunks, nbatch=stacked)
              * itemsize / hbm_bw)
    if d != "complex64":
        local = math.prod(src.local_shape)
        per_side = itemsize + itemsize // wire_ratio(d)
        if impl != "cuda":
            per_side += itemsize
        copy_s += 2 * local * per_side / hbm_bw

    def one(comm, fft):
        if method == "pipelined" and chunks > 1:
            c = chunks
            return c * ici_latency_s + comm / c + max(comm, fft) * (c - 1) / c + fft / c
        return ici_latency_s + comm + fft

    if n == 1 or batch_fusion == "stacked":
        return one(comm_s * n, overlap_compute_s * n) + copy_s * n
    if batch_fusion == "per-field":
        return n * (one(comm_s, overlap_compute_s) + copy_s)
    if batch_fusion == "pipelined-across-fields":
        launches = n * (chunks if method == "pipelined" and chunks > 1 else 1)
        fft = overlap_compute_s
        return (launches * ici_latency_s + comm_s + (n - 1) * max(comm_s, fft)
                + fft + n * copy_s)
    raise ValueError(f"unknown batch_fusion {batch_fusion!r}")

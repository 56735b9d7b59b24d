"""planlint — a run-time audit that a plan's executor does what its schedule
says (the port of ``repro/analysis/planlint.py``).

The paper's thesis (Sec. 3.3.2) is that the generalized all-to-all leaves
no local realignment pass outside the collective.  The reference checks
that, and the rest of a plan's schedule contracts, on the lowered jaxpr and
the compiled HLO.  The port has neither: :func:`audit_plan` runs **one
call** of the executor the plan runs (``forward_padded`` /
``backward_padded``, ``*_many_padded(n)`` for ``nfields > 1``, or
``guarded_padded`` when the plan is guarded) on a zero block of this rank,
and watches it through two recorders:

:class:`CollectiveRecorder`  wraps ``torch.distributed.all_to_all_single``:
    the count, the dtype and the off-rank bytes of each call, ``(m - 1) / m``
    of the tensor, as the reference's ``_stage_payload_multiset`` counts
    them.
:class:`OpRecorder`          a ``TorchDispatchMode`` that attributes each
    aten op to the innermost ``repro_torch`` frame under it (module path
    and function).  A kernel wrapper (``kernels/<name>/ops.py``) is opaque,
    as its kernel is on the card: every op beneath it, its plain version's
    on a CPU tensor too, is the wrapper's.

The checks, with the reference's codes:

PLAN001  ``all_to_all_single`` calls == the schedule's expected launches
         (× pipeline slices, × 2 for int8's scale collective, × nfields
         under non-stacked batch fusions).
PLAN002  the multiset of off-rank payload bytes == the
         :func:`~repro_torch.core.redistribute.exchange_wire_bytes` model.
         gloo and NCCL ship the tensor they are given, so there is no
         widened-wire exception as on the reference's CPU backend.
PLAN003  layout copies (``clone``, ``copy_``, ``index_select``) attributed
         to ``core/redistribute.py`` / ``core/pfft.py`` == the engine
         contract of :func:`~repro_torch.core.redistribute.exchange_engine_ops`,
         which counts the port's copies (its docstring lists where they
         differ from the reference's) for the layout the schedule promises:
         a contiguous block, or one the exchange reads through a copy of its
         own.  A strided block whose pack copies it (a realignment outside
         the collective) is a violation, whatever the run's layout.
PLAN004  concatenates (``cat``, ``stack``) attributed there == the contract;
         and the bytes of those copies and concatenates == the local-copy
         model :func:`~repro_torch.core.redistribute.exchange_local_copy_elems`
         summed over the stages, at each stage's width, with the restack
         of a non-stacked batch fusion (the one concatenate a stage the
         reference's op contract names) at the size of the stage's
         transformed output.  This puts the tuner's copy model under audit.
PLAN005  no float64 or complex128 tensor on the transform's data path (no
         op output and no collective of those dtypes).  The one documented
         exception is the guarded executor's stat vector, summed over the
         ranks by one float64 ``all_reduce`` (``ParallelFFT.guarded_padded``).
PLAN006  each narrow wire dtype (bf16, int8) is read from the collective's
         own tensor, so the check holds whether the codec is the plain
         version (CPU) or K1/K3 (the card, opaque to dispatch): the payload
         collectives of each narrow dtype == the launches of the stages that
         claim it, and the converts into and out of it that dispatch sees
         pair up.
PLAN008  ops attributed to ``robustness/`` are present iff ``guard != "off"``.
PLAN009  calls of the exchange-kernel wrappers K1 (``pack_chunks``) and K3
         (``unpack_chunks``) == 2 per lossy ``impl="cuda"`` stage side-pair,
         × slices, × nfields under non-stacked fusions; and when every
         lossy stage claims ``cuda``, no op is attributed to
         ``core/quant.py``.

PLAN007 (the HLO's all-to-all count) and the HLO half of PLAN005 have no
counterpart: there is no compiled HLO, and the run-time count is PLAN001
itself.

The ``schedule=`` override audits the run against a *claimed* schedule
instead of the plan's own: the negative-test hook (a traditional plan
claiming fused must report PLAN003).

CLI (one ``[ok]`` line per plan; exit 1 on any violation)::

    torchrun --nproc-per-node 4 -m repro_torch.analysis.planlint --device cpu
    python -m repro_torch.analysis.planlint            # one rank, NCCL on the card

audits the example plans (quickstart, navier_stokes, poisson, with the
guarded, kernel and batched cases of the reference's ``_example_plans``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from collections import Counter
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.examples import _common

#: modules whose copies and concatenates are the exchange engine's
ENGINE_MODULES = ("core/redistribute.py", "core/pfft.py")

#: module prefix of the guard's ops (PLAN008)
GUARD_MODULE_PREFIX = "robustness/"

#: the exchange kernels' wrappers (PLAN009), in ``kernels/exchange/ops.py``
EXCHANGE_KERNEL_WRAPPERS = ("pack_chunks", "unpack_chunks")

#: the plain wire codec (PLAN009): a plan whose lossy stages all run the
#: kernels must run no op of it
QUANT_MODULE = "core/quant.py"

#: the one float64 tensor PLAN005 allows: the guarded executor's stat vector
GUARD_STATS_FUNCTION = ("core/pfft.py", "ParallelFFT.guarded_padded.<locals>.fn")

_COPY_OPS = frozenset({"clone", "copy_", "index_select"})
_CONCAT_OPS = frozenset({"cat", "stack"})
_CONVERT_OPS = frozenset({"_to_copy", "copy_"})
_NARROW = {torch.bfloat16: "bfloat16", torch.int8: "int8"}
_CLAIMED_NARROW = {"bf16": "bfloat16", "int8": "int8"}
_WIDE = (torch.float64, torch.complex128)
_PKG = "/repro_torch/"


@dataclass
class Violation:
    code: str
    message: str

    def to_dict(self) -> dict:
        return {"code": self.code, "message": self.message}


@dataclass
class AuditReport:
    """Outcome of one :func:`audit_plan` call: ``expected`` the schedule's
    contract (with a per-stage breakdown), ``observed`` what the run did,
    ``collectives`` one record per ``all_to_all_single`` call, and
    ``violations`` every contract the run broke (none: the plan is
    certified)."""

    label: str
    direction: str
    nfields: int
    schedule: list
    expected: dict
    observed: dict
    collectives: list = field(default_factory=list)
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"label": self.label, "direction": self.direction, "nfields": self.nfields,
                "ok": self.ok, "schedule": [list(e) for e in self.schedule],
                "expected": self.expected, "observed": self.observed,
                "collectives": self.collectives,
                "violations": [v.to_dict() for v in self.violations]}

    def summary(self) -> dict:
        return {"ok": self.ok, "violations": sorted({v.code for v in self.violations}),
                "all_to_alls": self.observed.get("all_to_alls"),
                "wire_bytes": self.expected.get("wire_bytes"),
                "engine_copies": self.observed.get("engine_copies"),
                "engine_concats": self.observed.get("engine_concats"),
                "engine_copy_bytes": self.observed.get("engine_copy_bytes"),
                "guard_ops": self.observed.get("guard_ops"),
                "exchange_kernel_calls": self.observed.get("exchange_kernel_calls")}


# ---------------------------------------------------------------------------
# the recorders
# ---------------------------------------------------------------------------


class CollectiveRecorder:
    """While active, records every ``torch.distributed.all_to_all_single``
    call: ``calls`` holds ``{"dtype", "bytes", "group_size",
    "offrank_bytes"}`` of each, the off-rank bytes ``(m - 1) / m`` of the
    sent tensor; ``n`` is their count."""

    def __init__(self):
        self.calls: list[dict] = []

    @property
    def n(self) -> int:
        return len(self.calls)

    def __enter__(self):
        self._real = real = dist.all_to_all_single

        def recorded(output, input, *args, **kwargs):
            group = kwargs.get("group", args[2] if len(args) > 2 else None)
            m = dist.get_world_size(group)
            nbytes = input.numel() * input.element_size()
            self.calls.append({"dtype": str(input.dtype).removeprefix("torch."),
                               "bytes": nbytes, "group_size": m,
                               "offrank_bytes": nbytes * (m - 1) // m})
            return real(output, input, *args, **kwargs)

        dist.all_to_all_single = recorded
        return self

    def __exit__(self, *exc):
        dist.all_to_all_single = self._real


def _attribution() -> tuple[str, str]:
    """``(module, function)`` of the innermost ``repro_torch`` frame on the
    stack (this package's own frames skipped), or of a kernel wrapper
    (``kernels/<name>/ops.py``) anywhere under it; ``("<torch>", "")`` when
    no frame of the port is on the stack."""
    f = sys._getframe(2)
    first = None
    while f is not None:
        fname = f.f_code.co_filename.replace("\\", "/")
        i = fname.rfind(_PKG)
        if i >= 0:
            mod = fname[i + len(_PKG):]
            if not mod.startswith("analysis/"):
                here = (mod, f.f_code.co_qualname)
                if first is None:
                    first = here
                if mod.startswith("kernels/") and mod.endswith("/ops.py"):
                    return here
        f = f.f_back
    return first or ("<torch>", "")


@dataclass(frozen=True)
class OpRecord:
    module: str
    function: str
    op: str
    dtypes: tuple
    nbytes: int
    shape: tuple
    src_dtype: object = None


class OpRecorder(TorchDispatchMode):
    """While active, records every aten op with its attribution
    (:func:`_attribution`), output dtypes, output bytes (``copy_``: its
    destination's) and the dtype it converts from."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = [args[0]] if name == "copy_" else (
            list(out) if isinstance(out, (tuple, list)) else [out])
        tens = [t for t in outs if isinstance(t, torch.Tensor)]
        src = None
        if name == "copy_" and len(args) > 1 and isinstance(args[1], torch.Tensor):
            src = args[1].dtype
        elif args and isinstance(args[0], torch.Tensor):
            src = args[0].dtype
        mod, fn = _attribution()
        self.ops.append(OpRecord(mod, fn, name, tuple(t.dtype for t in tens),
                                 sum(t.numel() * t.element_size() for t in tens),
                                 tuple(tens[0].shape) if tens else (), src))
        return out


class _WrapperCalls:
    """While active, counts calls of the exchange-kernel wrappers."""

    def __enter__(self):
        from repro_torch.kernels.exchange import ops as xops

        self.calls = Counter()
        self._saved = []
        for name in EXCHANGE_KERNEL_WRAPPERS:
            real = getattr(xops, name)

            def counted(*args, _real=real, _name=name, **kwargs):
                self.calls[_name] += 1
                return _real(*args, **kwargs)

            self._saved.append((name, real))
            setattr(xops, name, counted)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.exchange import ops as xops

        for name, real in self._saved:
            setattr(xops, name, real)


def _observed(ops: list[OpRecord], colls: list[dict], kernel_calls: Counter) -> dict:
    copies, concats = Counter(), Counter()
    eng_bytes = 0
    engine_ops = Counter()
    guard_ops = quant_ops = 0
    conv_in = {d: 0 for d in _NARROW.values()}
    conv_out = {d: 0 for d in _NARROW.values()}
    wide = []
    for r in ops:
        if r.module.startswith(GUARD_MODULE_PREFIX):
            guard_ops += 1
        if r.module == QUANT_MODULE:
            quant_ops += 1
        if r.op in _COPY_OPS or r.op in _CONCAT_OPS:
            tgt = copies if r.op in _COPY_OPS else concats
            tgt[r.module] += 1
            if r.module in ENGINE_MODULES:
                eng_bytes += r.nbytes
                engine_ops[f"{r.module}:{r.function}:{r.op}{list(r.shape)}"] += 1
        if r.op in _CONVERT_OPS and r.dtypes:
            out_dt = r.dtypes[0]
            if out_dt in _NARROW and r.src_dtype not in _NARROW:
                conv_in[_NARROW[out_dt]] += 1
            elif r.src_dtype in _NARROW and out_dt not in _NARROW:
                conv_out[_NARROW[r.src_dtype]] += 1
        if any(dt in _WIDE for dt in r.dtypes) and (r.module, r.function) != GUARD_STATS_FUNCTION:
            wide.append(f"{r.op} -> {[str(d) for d in r.dtypes]} at {r.module}:{r.function}")
    wide += [f"all_to_all_single of {c['dtype']}" for c in colls
             if c["dtype"] in ("float64", "complex128")]
    return {
        "all_to_alls": len(colls),
        "payload_bytes": sorted(c["offrank_bytes"] for c in colls),
        "wire_bytes": sum(c["offrank_bytes"] for c in colls),
        "wire_dtypes": dict(Counter(c["dtype"] for c in colls)),
        "engine_copies": sum(n for m, n in copies.items() if m in ENGINE_MODULES),
        "engine_concats": sum(n for m, n in concats.items() if m in ENGINE_MODULES),
        "engine_copy_bytes": eng_bytes,
        "engine_ops": dict(engine_ops),
        "copies_by_module": dict(copies),
        "concats_by_module": dict(concats),
        "guard_ops": guard_ops,
        "quant_ops": quant_ops,
        "exchange_kernel_calls": sum(kernel_calls.values()),
        "narrow_converts_in": conv_in,
        "narrow_converts_out": conv_out,
        "wide_dtype_ops": wide,
    }


# ---------------------------------------------------------------------------
# the expected side (the schedule's contract)
# ---------------------------------------------------------------------------


def _walk(plan, direction: str, schedule):
    """(stages, pencils, dtypes, schedule) in execution order."""
    stages, pencils, _, _ = plan._walk(direction)
    if direction == "forward":
        return stages, pencils, plan.dtype_trace, tuple(schedule)
    return stages, pencils, plan.dtype_trace[::-1], tuple(schedule)[::-1]


def _itemsize(dt) -> int:
    return 8 if dt == torch.complex64 else 4


def _expected_contract(plan, direction: str, schedule, nfields: int) -> dict:
    """Per exchange stage, the launches, payload multiset, wire bytes,
    engine ops and their bytes, and kernel-wrapper calls its claimed entry
    implies; plan-level totals beside."""
    from repro_torch.core.decomp import local_lengths
    from repro_torch.core.pencil import group_size
    from repro_torch.core.pfft import ExchangeStage, FFTStage
    from repro_torch.core.quant import canonical_comm_dtype, wire_ratio
    from repro_torch.core.redistribute import (_engine_copies, exchange_engine_ops,
                                               exchange_local_copy_elems, exchange_wire_bytes,
                                               pipeline_slices)
    from repro_torch.kernels.exchange.ops import cuda_applicable

    stages, pencils, dtypes, sched = _walk(plan, direction, schedule)
    nbatch = 1 if nfields > 1 else 0
    per_stage, ex_i = [], 0
    for i, st in enumerate(stages):
        if not isinstance(st, ExchangeStage):
            continue
        method, chunks, comm, impl, fusion = sched[ex_i]
        comm = canonical_comm_dtype(comm)
        src = pencils[i]
        isz = _itemsize(dtypes[i])
        m = group_size(src.mesh, src.placement[st.w])
        slices = pipeline_slices(src, st.v, st.w, chunks=chunks) if method == "pipelined" else 1
        per_field = nbatch and fusion != "stacked"
        calls, fpc = (nfields, 1) if per_field else (1, nfields)
        nb = 0 if per_field else nbatch
        nxt = stages[i + 1] if i + 1 < len(stages) else None
        then_fft = isinstance(nxt, FFTStage) and nxt.axis == st.w
        # the pipelined engine's slices are concatenated after the next
        # stage's transform (pfft._exchange_then_fft), except across fields,
        # where each field's exchange runs whole before its transform
        transformed = then_fft and not (per_field and fusion == "pipelined-across-fields")
        out_bytes = (math.prod(pencils[i + 2].local_shape) * _itemsize(dtypes[i + 2])
                     if then_fft else math.prod(pencils[i + 1].local_shape) * isz)
        kw = dict(method=method, chunks=chunks, nbatch=nb, comm_dtype=comm, impl=impl)
        ops = exchange_engine_ops(src, st.v, st.w, **kw)
        copy_bytes = exchange_local_copy_elems(src, st.v, st.w, **kw) * isz * fpc
        # int8's (M, F) scales, gathered beside the payload out of mesh
        # order: the model leaves their few floats out
        copy_bytes += _engine_copies(src, st.v, st.w, transposed_out=False, **kw)[2] * m * fpc * 4
        if ops["concats"] and transformed:
            # the model prices the reassembly at the exchanged block; it
            # concatenates the transformed slices
            copy_bytes += fpc * (out_bytes - math.prod(src.local_shape) * isz)
        copy_bytes *= calls
        copies, concats = ops["transposes"] * calls, ops["concats"] * calls
        if per_field:  # the fields' outputs are restacked: one concatenate
            concats += 1
            copy_bytes += nfields * out_bytes
        b = src.local_shape[st.v] // m
        lengths = [n for n in local_lengths(b, max(1, min(chunks, b))) if n > 0] if \
            method == "pipelined" else [b]
        local = math.prod(src.local_shape)
        payloads = []
        for _ in range(calls):
            for n in lengths:
                elems = local * fpc * n // b
                payloads.append(elems * (m - 1) // m * isz // wire_ratio(comm))
                if comm == "int8":
                    payloads.append(4 * (m - 1) * fpc)
        kernel = impl == "cuda" and cuda_applicable(method, comm)
        per_stage.append({
            "stage": ex_i, "v": st.v, "w": st.w, "method": method, "chunks": chunks,
            "comm_dtype": comm, "impl": impl, "batch_fusion": fusion, "itemsize": isz,
            "group_size": m, "slices": slices,
            "launches": slices * (2 if comm == "int8" else 1) * calls,
            "payload_launches": slices * calls,
            "wire_bytes": exchange_wire_bytes(src, st.v, st.w, itemsize=isz, comm_dtype=comm,
                                              nfields=nfields, slices=slices),
            "payload_bytes": sorted(payloads),
            "engine_copies": copies, "engine_concats": concats, "engine_copy_bytes": copy_bytes,
            "exchange_kernel_calls": 2 * slices * calls if kernel else 0,
        })
        ex_i += 1
    total = {k: sum(s[k] for s in per_stage) for k in (
        "launches", "wire_bytes", "engine_copies", "engine_concats", "engine_copy_bytes",
        "exchange_kernel_calls")}
    return {**total, "payload_bytes": sorted(p for s in per_stage for p in s["payload_bytes"]),
            "stages": per_stage}


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------


def _executor(plan, direction: str, nfields: int):
    """``(fn, block)``: the executor the plan runs for ``direction`` and a
    zero block of this rank for it."""
    if direction not in ("forward", "backward"):
        raise ValueError(f"unknown direction {direction!r}")
    _, _, _, pen = plan._walk(direction)
    dtype = plan.input_dtype if direction == "forward" else plan.spectral_dtype
    lead = (nfields,) if nfields > 1 else ()
    block = torch.zeros(lead + pen.local_shape, dtype=dtype, device=plan.device)
    if plan.guard != "off":
        return plan.guarded_padded(direction, nfields=nfields), block
    if nfields > 1:
        return plan._many_padded(nfields, direction), block
    return (plan.forward_padded if direction == "forward" else plan.backward_padded), block


def audit_plan(plan, *, nfields: int = 1, direction: str = "forward", schedule=None,
               label: str = "") -> AuditReport:
    """Audit one call of ``plan``'s executor against its schedule contracts.

    The executor runs the plan's own resolved schedule (tuned first for
    ``method="auto"``); ``schedule=`` only overrides the *claimed* contract
    the run is checked against (the plan's own by default).  Collective:
    every rank of the plan's mesh calls it alike."""
    from repro_torch.core.planconfig import as_schedule
    from repro_torch.core.quant import canonical_comm_dtype

    actual = plan.batched_schedule(nfields)
    claimed = as_schedule(schedule if schedule is not None else actual)
    if len(claimed) != plan.n_exchanges:
        raise ValueError(f"claimed schedule has {len(claimed)} entries for "
                         f"{plan.n_exchanges} exchange stages")
    fn, block = _executor(plan, direction, nfields)
    rec = OpRecorder()
    with CollectiveRecorder() as colls, _WrapperCalls() as kernel_calls, rec:
        fn(block)
    if plan.device.type == "cuda":
        torch.cuda.synchronize(plan.device)
    expected = _expected_contract(plan, direction, claimed, nfields)
    observed = _observed(rec.ops, colls.calls, kernel_calls.calls)
    v: list[Violation] = []
    guard = plan.guard

    if observed["all_to_alls"] != expected["launches"]:
        v.append(Violation("PLAN001", f"{observed['all_to_alls']} all_to_all_single calls != "
                                      f"expected {expected['launches']} launches"))
    if observed["payload_bytes"] != expected["payload_bytes"]:
        v.append(Violation("PLAN002", f"off-rank payload bytes {observed['payload_bytes']} != "
                                      f"exchange_wire_bytes model {expected['payload_bytes']}"))
    engine = observed["engine_ops"]
    if observed["engine_copies"] != expected["engine_copies"]:
        v.append(Violation("PLAN003", f"engine layout copies {observed['engine_copies']} != "
                                      f"contract {expected['engine_copies']} (ops: {engine})"))
    if observed["engine_concats"] != expected["engine_concats"]:
        v.append(Violation("PLAN004", f"engine concatenates {observed['engine_concats']} != "
                                      f"contract {expected['engine_concats']} (ops: {engine})"))
    elif observed["engine_copy_bytes"] != expected["engine_copy_bytes"]:
        v.append(Violation("PLAN004", f"engine copy bytes {observed['engine_copy_bytes']} != "
                                      f"the local-copy model's {expected['engine_copy_bytes']} "
                                      f"(ops: {engine})"))
    if observed["wide_dtype_ops"]:
        v.append(Violation("PLAN005", f"wide-dtype tensors: {observed['wide_dtype_ops'][:4]}"))
    if guard == "off" and observed["guard_ops"]:
        v.append(Violation("PLAN008", f"guard='off' run has {observed['guard_ops']} op(s) "
                                      f"attributed to {GUARD_MODULE_PREFIX}"))
    elif guard != "off" and not observed["guard_ops"]:
        v.append(Violation("PLAN008", f"guard={guard!r} run has no {GUARD_MODULE_PREFIX} op: "
                                      f"the health checks are missing"))
    if observed["exchange_kernel_calls"] != expected["exchange_kernel_calls"]:
        v.append(Violation("PLAN009", f"{observed['exchange_kernel_calls']} exchange-kernel "
                                      f"wrapper calls != the schedule's "
                                      f"{expected['exchange_kernel_calls']}"))
    lossy = [e for e in claimed if canonical_comm_dtype(e.comm_dtype) != "complex64"]
    if lossy and all(e.impl == "cuda" for e in lossy) and observed["quant_ops"]:
        v.append(Violation("PLAN009", f"every lossy stage claims impl='cuda' but "
                                      f"{observed['quant_ops']} op(s) attribute to "
                                      f"{QUANT_MODULE}: codec work outside the kernels"))
    wires = observed["wire_dtypes"]
    for comm, dt in _CLAIMED_NARROW.items():
        want = sum(s["payload_launches"] for s in expected["stages"] if s["comm_dtype"] == comm)
        got = wires.get(dt, 0)
        if got != want:
            v.append(Violation("PLAN006", f"{got} collective(s) carried {dt}, the schedule "
                                          f"claims {want} {comm} payload collective(s)"))
        enc, dec = observed["narrow_converts_in"][dt], observed["narrow_converts_out"][dt]
        if enc != dec:
            v.append(Violation("PLAN006", f"unpaired {dt} encode/decode: {enc} converts into "
                                          f"it, {dec} out of it"))
    return AuditReport(label=label or f"{plan.shape}:{plan.method}", direction=direction,
                       nfields=nfields, schedule=list(claimed), expected=expected,
                       observed=observed, collectives=colls.calls, violations=v)


# ---------------------------------------------------------------------------
# CLI: the example plans
# ---------------------------------------------------------------------------


def example_plans(mesh):
    """The example plans (``repro_torch.examples``' own plan builders at
    the examples' sizes) with the reference's extra cases: label ->
    ``(plan, nfields)``."""
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.examples.navier_stokes import N, dns_plan
    from repro_torch.examples.poisson import poisson_plan
    from repro_torch.examples.quickstart import quickstart_plan

    return {
        "quickstart": (quickstart_plan(mesh), 1),
        "quickstart[guarded]": (quickstart_plan(mesh, PlanConfig(method="fused",
                                                                 guard="degrade")), 1),
        "quickstart[int8-cuda]": (quickstart_plan(mesh, PlanConfig(
            method="fused", comm_dtype="int8", exchange_impl="cuda")), 1),
        "quickstart[bf16-cuda-trad]": (quickstart_plan(mesh, PlanConfig(
            method="traditional", comm_dtype="bf16", exchange_impl="cuda")), 1),
        "navier_stokes": (dns_plan(mesh, N), 1),
        "navier_stokes[batched]": (dns_plan(mesh, N), 3),
        "poisson": (poisson_plan(mesh), 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.planlint",
        description="Audit one run of each example plan against its schedule contracts.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (NCCL, the default) or cpu (gloo)")
    ap.add_argument("--out", default=None, help="JSON report path (rank 0 writes it)")
    ap.add_argument("--only", default=None, help="comma-separated plan labels (default: all)")
    args = ap.parse_args(argv)
    with _common.process_group(args.device) as mesh:
        plans = example_plans(mesh)
        if args.only:
            keep = {s.strip() for s in args.only.split(",")}
            if keep - set(plans):
                print(f"planlint: unknown plan labels {sorted(keep - set(plans))}",
                      file=sys.stderr)
                return 2
            plans = {k: p for k, p in plans.items() if k in keep}
        rank0 = dist.get_rank() == 0
        reports = {}
        for label, (plan, nfields) in plans.items():
            rep = reports[label] = audit_plan(plan, nfields=nfields, label=label)
            if rank0:
                status = "ok" if rep.ok else "FAIL " + ",".join(
                    sorted({x.code for x in rep.violations}))
                print(f"planlint: {label:28s} a2a={rep.observed['all_to_alls']} "
                      f"wire={rep.expected['wire_bytes']}B "
                      f"engine_copies={rep.observed['engine_copies']} [{status}]")
                for x in rep.violations:
                    print(f"  {x.code}: {x.message}", file=sys.stderr)
        ok = all(r.ok for r in reports.values())
        if rank0 and args.out:
            with open(args.out, "w") as fh:
                json.dump({"ok": ok, "world": dist.get_world_size(),
                           "plans": {k: r.to_dict() for k, r in reports.items()}}, fh,
                          indent=1, default=str)
        if rank0:
            print(f"planlint: {len(reports)} plan(s) on {dist.get_world_size()} rank(s); "
                  f"{'all clean' if ok else 'VIOLATIONS FOUND'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

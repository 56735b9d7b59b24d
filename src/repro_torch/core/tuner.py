"""Per-plan exchange-schedule tuner (``ParallelFFT(method="auto")``) — the
port of ``repro/core/tuner.py``.

The candidates of each exchange stage are the reference's, in its order,
with the port's implementation names (``"jnp"`` -> ``"torch"``,
``"pallas"`` -> ``"cuda"``):

* engine: ``fused``, ``traditional``, ``pipelined`` × chunks ∈ {2, 4, 8};
* wire payload: every ``comm_dtype`` no lossier than the plan's budget
  (complex64 only for the lossless default, {complex64, bf16} for
  ``"bf16"``, {complex64, bf16, int8} for ``"int8"``);
* exchange impl: the exchange kernels (``"cuda"``) are swept only under an
  ``exchange_impl="cuda"`` budget and only on lossy payloads
  (:func:`~repro_torch.kernels.exchange.ops.cuda_applicable`);
* batch fusion (``nfields > 1``): ``stacked``, ``pipelined-across-fields``,
  ``per-field``.

:func:`tune_plan` times every candidate on the stage's own shapes (the
exchange and the 1-D FFT it feeds, through the executor the plan runs) and
keeps the fastest; :func:`get_or_tune` caches the winner on disk.  With
model priors armed (``$REPRO_MODEL_PRIORS``, a
:mod:`repro_torch.core.modelfit` report) each stage times only the
``$REPRO_TUNER_PRIOR_TOPK`` (default 6) candidates the model ranks first.

**The ranks agree.**  The reference times each candidate once, in one
program; the port runs :func:`get_or_tune` on every rank, and ranks that
picked different winners would issue mismatched collectives.  So rank 0
of the plan's world alone reads the cache (hit, miss or quarantined) and
broadcasts the parsed schedule or the miss; a candidate refused before its
stage issues any collective (an armed compile-failure fault) on any rank is
refused on every rank; each candidate's seconds are reduced over the world
with ``MAX`` (the slowest rank prices the stage), so every rank holds the
same times and picks the same winner.  Only rank 0
writes the cache.  A process with no process group (a plan over a stand-in
mesh, timings stubbed) has nothing to agree with.  An exception raised
after a stage issued a collective is not caught.

Cache schema 6 (the reference's number, so a reader sees the
correspondence): each entry maps a :func:`plan_key` (mesh, shape, grid,
transforms, FFT impl, backend, device kind, field count, the candidate
set) to ``{"schedule": [[method, chunks, comm_dtype, impl, batch_fusion],
...], "timings": {...}}``.  :func:`quarantine` marks an entry bad after a
guarded run caught its schedule failing; a marked, stale, corrupt or
out-of-candidate-set entry never parses, so the plan retunes and the
entry is rewritten.  The reference's migration of schema-5 entries is not
ported: no port cache ever held one.  Writes are atomic and merge per key
under ``fcntl.flock``.  Cache location: ``$REPRO_TUNER_CACHE`` or
``~/.cache/repro_torch/fft_tuner.json``; an in-process memo avoids re-reading
the file per plan.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from pathlib import Path

try:  # POSIX advisory locks; absent on some platforms (the lock becomes a no-op)
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

import torch
import torch.distributed as dist

from repro_torch.core import modelfit
from repro_torch.core.planconfig import BATCH_FUSIONS, StageEntry, as_schedule
from repro_torch.core.quant import canonical_comm_dtype
from repro_torch.core.redistribute import PIPELINE_CHUNK_CANDIDATES
from repro_torch.kernels.exchange.ops import cuda_applicable
from repro_torch.robustness import faults

#: cache schema version (the reference's)
SCHEMA_VERSION = 6

#: times a guarded execution may quarantine and retune one cache entry
#: before the runner gives up and raises (repro_torch.robustness.runner)
MAX_QUARANTINE_RETUNES = 3

#: (method, chunks) engine candidates timed per exchange stage
ENGINE_CANDIDATES: tuple[tuple[str, int], ...] = (
    ("fused", 1),
    ("traditional", 1),
    *(("pipelined", c) for c in PIPELINE_CHUNK_CANDIDATES),
)

#: payloads allowed under each accuracy budget, lossless first
COMM_DTYPE_LADDER = {
    "complex64": ("complex64",),
    "bf16": ("complex64", "bf16"),
    "int8": ("complex64", "bf16", "int8"),
}

#: with model priors armed, how many top-ranked candidates a stage still
#: times (0 disables pruning)
PRIOR_TOPK_DEFAULT = 6


def candidates_for(comm_dtype=None, exchange_impl: str = "torch") -> tuple[StageEntry, ...]:
    """Every engine × every payload no lossier than ``comm_dtype``; an
    ``exchange_impl="cuda"`` budget adds the exchange kernels for every
    candidate they apply to (lossy payloads)."""
    ladder = COMM_DTYPE_LADDER[canonical_comm_dtype(comm_dtype)]
    out = [StageEntry(m, c, d) for d in ladder for m, c in ENGINE_CANDIDATES]
    if exchange_impl == "cuda":
        out += [StageEntry(m, c, d, "cuda") for d in ladder
                for m, c in ENGINE_CANDIDATES if cuda_applicable(m, d)]
    return tuple(out)


def batched_candidates_for(comm_dtype=None, exchange_impl: str = "torch",
                           ) -> tuple[StageEntry, ...]:
    """Every single-field candidate × every batch fusion mode."""
    return tuple(e._replace(batch_fusion=f) for f in BATCH_FUSIONS
                 for e in candidates_for(comm_dtype, exchange_impl))


def _default_candidates(plan, nfields: int):
    if nfields <= 1:
        return candidates_for(plan.comm_dtype, plan.exchange_impl)
    return batched_candidates_for(plan.comm_dtype, plan.exchange_impl)


def _tag(cand) -> str:
    return "@".join(str(p) for p in cand)


#: the lossless budget's candidates
DEFAULT_CANDIDATES = candidates_for("complex64")

_MEMO: dict[str, tuple[StageEntry, ...]] = {}

#: per-candidate stage times, shared across budgets in one process
_STAGE_MEMO: dict[tuple[str, int, str], float] = {}


def default_cache_path() -> Path:
    env = os.environ.get("REPRO_TUNER_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "fft_tuner.json"


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _key_fields(plan, nfields: int = 1) -> dict:
    """What determines the stage shapes and the hardware the times hold for
    (the candidate-set-independent part of the key)."""
    mesh_sig = tuple(zip(plan.mesh.mesh_dim_names, tuple(plan.mesh.shape)))
    return {"schema": SCHEMA_VERSION, "mesh": mesh_sig, "shape": plan.shape,
            "grid": plan.grid, "transforms": tuple(sp.tag() for sp in plan.transforms),
            "impl": plan.impl, "backend": plan.device.type,
            "device_kind": _device_kind(plan.device), "nfields": nfields}


def plan_key(plan, candidates=None, *, nfields: int = 1) -> str:
    """Cache key: the stage shapes, the candidates swept, the field count
    and the hardware."""
    if candidates is None:
        candidates = _default_candidates(plan, nfields)
    fields = _key_fields(plan, nfields)
    fields["candidates"] = sorted(_tag(c) for c in candidates)
    return json.dumps(fields, sort_keys=True, default=str)


def load_cache(path) -> dict:
    """A schedule cache, or ``{}`` for anything unusable (a missing file,
    unreadable bytes, invalid JSON, a non-object): a stale or corrupt cache
    never raises, it is retuned and rewritten."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


@contextlib.contextmanager
def _file_lock(path):
    """Cross-process advisory lock (``fcntl.flock`` on ``<path>.lock``)
    around a read-merge-write cycle.  A no-op without ``fcntl`` or when the
    lock file cannot be made.  flock is held per open file description, so
    a caller must not nest it for one path (see :func:`quarantine`)."""
    if fcntl is None:
        yield
        return
    try:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(str(path) + ".lock", os.O_RDWR | os.O_CREAT, 0o644)
    except OSError:
        yield
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # closing releases the flock


def save_cache(path, data: dict, *, merge: bool = True, lock: bool = True) -> bool:
    """Write cache entries atomically (a temp file in the same directory,
    then ``os.replace``).  ``merge=True`` re-reads the file and overlays only
    the keys in ``data``, under :func:`_file_lock` unless the caller holds
    it (``lock=False``).  Returns False where the file cannot be written
    (tuning still works, uncached)."""
    try:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with _file_lock(path) if lock else contextlib.nullcontext():
            if merge:
                current = load_cache(path)
                current.update(data)
                data = current
            fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(json.dumps(data, indent=1))
                os.replace(tmp, path)
            except BaseException:
                os.unlink(tmp)
                raise
        return True
    except OSError:
        return False


# -- the ranks' agreement ----------------------------------------------------


def _ranked(plan) -> bool:
    """Whether this process is one rank of a world the plan's mesh must
    agree over."""
    if not dist.is_initialized():
        return False
    if plan.mesh.size() != dist.get_world_size():
        raise ValueError(f"a tuned plan's mesh of {plan.mesh.size()} ranks must cover the "
                         f"world of {dist.get_world_size()}")
    return True


def is_root(plan) -> bool:
    """Whether this process reads and writes the cache: rank 0 of the
    plan's world."""
    return not _ranked(plan) or dist.get_rank() == 0


def broadcast(plan, obj):
    """Rank 0's ``obj`` on every rank."""
    if not _ranked(plan):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0,
                               device=plan.device if plan.device.type == "cuda" else None)
    return box[0]


def _max_over_ranks(plan, value: float) -> float:
    if not _ranked(plan):
        return value
    t = torch.tensor([value], dtype=torch.float64, device=plan.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _barrier(plan):
    if _ranked(plan):
        if plan.device.type == "cuda":
            dist.barrier(device_ids=[plan.device.index])
        else:
            dist.barrier()


# -- resolve, quarantine -----------------------------------------------------


def get_or_tune(plan, *, cache_path=None, candidates=None, nfields: int = 1):
    """The tuned schedule of ``plan`` (a :class:`StageEntry` per exchange
    stage), from the in-process memo, else rank 0's read of the disk cache,
    else a sweep (:func:`tune_plan`) whose winner rank 0 writes.  Every rank
    of the plan's world calls it and gets the same schedule."""
    if candidates is None:
        candidates = _default_candidates(plan, nfields)
    candidates = as_schedule(candidates)
    path = Path(cache_path) if cache_path else default_cache_path()
    key = plan_key(plan, candidates, nfields=nfields)
    memo_key = f"{path}|{key}"
    if memo_key in _MEMO:
        return _MEMO[memo_key]
    disk, rows = {}, None
    if is_root(plan):
        disk = load_cache(path)
        sched = _parse_entry(disk.get(key), plan.n_exchanges, candidates=candidates)
        rows = None if sched is None else [list(e) for e in sched]
    rows = broadcast(plan, rows)
    if rows is not None:
        sched = as_schedule(rows)
    else:
        sched, timings = tune_plan(plan, candidates=candidates, nfields=nfields)
        if is_root(plan):
            entry = {"schedule": [list(s) for s in sched], "timings": timings}
            prev = disk.get(key)
            if isinstance(prev, dict) and prev.get("quarantines"):
                # a retune after a quarantine keeps the count, so an entry
                # that keeps failing exhausts the runner's cap
                entry["quarantines"] = int(prev["quarantines"])
            save_cache(path, {key: entry})
    _MEMO[memo_key] = sched
    return sched


def forget(key: str):
    """Drop this process's memos of ``key``'s schedule and every stage
    time, so the next resolve of the plan re-times."""
    for k in [k for k in _MEMO if k.endswith("|" + key)]:
        del _MEMO[k]
    _STAGE_MEMO.clear()


def quarantine(path, key: str, reason: str) -> int:
    """Mark the cache entry at ``key`` bad (a guarded run caught its
    schedule failing), so that it stops parsing and the next resolve
    retunes; returns the entry's lifetime quarantine count and drops the
    memos (:func:`forget`).  The read-bump-write holds one
    :func:`_file_lock` (the inner save passes ``lock=False``)."""
    with _file_lock(path):
        disk = load_cache(path)
        entry = disk.get(key)
        if not isinstance(entry, dict):
            entry = {}
        entry["bad"] = {"reason": reason}
        entry["quarantines"] = int(entry.get("quarantines", 0)) + 1
        save_cache(path, {key: entry}, lock=False)
    forget(key)
    return entry["quarantines"]


def _parse_entry(entry, n_exchanges: int, candidates=None):
    """One cache entry as a :class:`StageEntry` schedule, or None when it
    is missing, quarantined (``"bad"``), malformed (stage count, types,
    unknown values) or names an entry outside the live ``candidates``."""
    if not isinstance(entry, dict) or entry.get("bad"):
        return None
    try:
        sched = as_schedule(entry["schedule"])
        if len(sched) != n_exchanges:
            return None
        if candidates is not None:
            live = set(as_schedule(candidates))
            if any(e not in live for e in sched):
                return None
        return sched
    except (TypeError, KeyError, IndexError, ValueError):
        return None


# -- the sweep ---------------------------------------------------------------


def _prior_stage_time(plan, si: int, entry: StageEntry, nfields: int, coeffs: dict) -> float:
    """Modeled seconds of one stage candidate at a fit report's
    coefficients, the key prior-guided tuning ranks by: the exchange and the
    1-D FFT it feeds, as :meth:`ParallelFFT.model_time_s` prices a stage."""
    from repro_torch.core.pfft import FFTStage
    from repro_torch.core.redistribute import exchange_time_model

    st = plan.stages[si]
    follow = plan.stages[si + 1] if si + 1 < len(plan.stages) else None
    fft_s = 0.0
    if isinstance(follow, FFTStage) and follow.axis == st.w:
        fft_s = plan._stage_flops_at(si + 1) / plan.mesh.size() / coeffs["peak_flops"]
    return exchange_time_model(
        plan.pencil_trace[si], st.v, st.w, itemsize=plan._stage_itemsize(si),
        method=entry.method, chunks=entry.chunks, comm_dtype=entry.comm_dtype,
        impl=entry.impl, ici_bw=coeffs["ici_bw"], hbm_bw=coeffs["hbm_bw"],
        ici_latency_s=coeffs["ici_latency_s"], overlap_compute_s=fft_s,
        nfields=nfields, batch_fusion=entry.batch_fusion)


def _refusal(entry: StageEntry):
    """The armed compile-failure fault ``entry``'s stage raises before it
    issues any collective, or None."""
    try:
        with faults.stage_context(None, entry.method, entry.comm_dtype):
            faults.check_compile(entry.method, entry.comm_dtype)
    except faults.FaultInjected as e:
        return e
    return None


def tune_plan(plan, *, candidates=None, repeats: int = 3, inner: int = 2, nfields: int = 1):
    """Time every candidate for every exchange stage of ``plan`` (each with
    the 1-D FFT it feeds, batched candidates on the stacked ``(nfields,
    ...)`` block) and return ``(schedule, timings)``, ``timings[stage][tag]``
    in seconds: the slowest rank's, the same on every rank.  A candidate
    refused on any rank before it issues a collective is timed ``inf`` on
    every rank, with its reason under ``"<tag>:error"``.  With priors armed
    only the model's top ``$REPRO_TUNER_PRIOR_TOPK`` are timed; the rest
    keep their modeled seconds under ``"pruned:<tag>"``."""
    from repro_torch.core.pfft import ExchangeStage

    if candidates is None:
        candidates = _default_candidates(plan, nfields)
    candidates = as_schedule(candidates)
    priors = modelfit.active_priors()
    try:
        topk = int(os.environ.get("REPRO_TUNER_PRIOR_TOPK", str(PRIOR_TOPK_DEFAULT)))
    except ValueError:
        topk = PRIOR_TOPK_DEFAULT
    base_key = json.dumps(_key_fields(plan, nfields), sort_keys=True, default=str)
    schedule = []
    timings: dict[str, dict[str, float]] = {}
    for si, st in enumerate(plan.stages):
        if not isinstance(st, ExchangeStage):
            continue
        per, by_tag = {}, {}
        sweep = candidates
        if priors is not None and 0 < topk < len(candidates):
            est = {c: _prior_stage_time(plan, si, c, nfields, priors) for c in candidates}
            ranked = sorted(candidates, key=lambda c: est[c])
            sweep, skipped = ranked[:topk], ranked[topk:]
            for c in skipped:
                per[f"pruned:{_tag(c)}"] = est[c]
        for cand in sweep:
            tag = _tag(cand)
            by_tag[tag] = cand
            memo_key = (base_key, si, tag)
            if memo_key in _STAGE_MEMO:
                per[tag] = _STAGE_MEMO[memo_key]
                continue
            err = _refusal(cand)
            if _max_over_ranks(plan, float(err is not None)):
                per[tag] = float("inf")
                per[f"{tag}:error"] = repr(err)[:200] if err else "refused on another rank"
                continue
            per[tag] = _max_over_ranks(plan, _time_stage(plan, si, *cand, repeats=repeats,
                                                         inner=inner, nfields=nfields))
            _STAGE_MEMO[memo_key] = per[tag]
        best = min((k for k in per if ":" not in k), key=lambda k: per[k])
        schedule.append(by_tag[best])
        timings[f"stage{si}"] = per
    return tuple(schedule), timings


def _time_stage(plan, si: int, method: str, chunks: int, comm_dtype: str,
                impl: str = "torch", batch_fusion: str = "stacked", *,
                repeats: int, inner: int, nfields: int = 1) -> float:
    """Seconds of one exchange stage (and the FFT after it) of this rank
    under one candidate, through the executor the plan runs
    (:func:`repro_torch.core.pfft._run_exchange_stage`) on a zero block of
    the stage's dtype: one warm call, then the best of ``repeats`` runs of
    ``inner`` calls, the ranks meeting at a barrier before each run and the
    card synchronized before the clock is read."""
    from repro_torch.core import fftcore
    from repro_torch.core.pfft import FFTStage, _run_exchange_stage

    st = plan.stages[si]
    before = plan.pencil_trace[si]
    follow = plan.stages[si + 1] if si + 1 < len(plan.stages) else None
    fft_st = follow if isinstance(follow, FFTStage) and follow.axis == st.w else None
    after = plan.pencil_trace[si + 2] if fft_st is not None else None
    nbatch = 1 if nfields > 1 else 0
    entry = StageEntry(method, chunks, comm_dtype, impl, batch_fusion)
    # the stage's own dtype: the exchanges of an all-real (DCT/DST) plan ship float32
    x = torch.zeros((nfields,) * nbatch + before.local_shape, dtype=plan.dtype_trace[si],
                    device=plan.device)

    def run():
        return _run_exchange_stage(x, st, fft_st, plan.pencil_trace[si + 1], after, entry,
                                   impl=plan.impl, sign=fftcore.FORWARD, mesh=plan.mesh,
                                   nbatch=nbatch)[0]

    def sync():
        if plan.device.type == "cuda":
            torch.cuda.synchronize(plan.device)

    run()
    sync()
    best = float("inf")
    for _ in range(repeats):
        _barrier(plan)
        t0 = time.perf_counter()
        for _ in range(inner):
            run()
        sync()
        best = min(best, (time.perf_counter() - t0) / inner)
    return best

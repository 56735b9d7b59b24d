"""Checkpointing: atomic, async, elastic (the port of
``repro/checkpoint/store.py``), in the reference's on-disk format.

Layout: ``<dir>/step_<N:010d>/{manifest.json, <key>.npy ...}``, a leaf's key
the "/"-joined path of its dict keys, sequence indices and named-tuple
fields (``.name``, as JAX prints a ``GetAttrKey``), its file the key with
"/" as "__".  The manifest records each leaf's file, shape, dtype name and
the sha1 of its bytes; bf16 is stored as uint16 and named ``bfloat16``.  So
a checkpoint written by either package loads in the other, bit for bit.

* **atomic** — a save writes ``step_N.tmp`` and renames it only after the
  manifest is fsynced; a torn write is never taken for a checkpoint.
* **async** — ``CheckpointManager.save_async`` copies the tensors to the
  host (into pinned memory: the only part on the caller's path) and writes
  on a thread; a failed write is raised by the next ``wait`` or
  ``save_async``.  A save or a load writes or reads its leaves on up to 8
  threads at once (``np.save``/``np.load`` and sha1 release the
  interpreter's lock).
* **elastic** — a checkpoint holds whole (logical) tensors; ``load_checkpoint
  (..., shardings=...)`` takes a congruent tree of functions, each mapping a
  whole leaf to this rank's slice (``convert.lm_shardings``: the LM's rules
  in ``models/sharding.py``), so a job restarts on another mesh.

Loaded leaves are CPU tensors (bf16 read as ``uint16`` and viewed as
``torch.bfloat16``, so no extension package is needed).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch


#: threads that write or read a checkpoint's leaves at once
_IO_THREADS = min(8, os.cpu_count() or 1)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: tuple = ()) -> dict:
    """{key: leaf} in the tree's order (a dict's keys as given)."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif _is_namedtuple(tree):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {"/".join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,)))
    return out


def _unflatten(tree_like, leaves: dict, prefix: tuple = ()):
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),)) for k, v in tree_like.items()}
    if _is_namedtuple(tree_like):
        return type(tree_like)(*(_unflatten(getattr(tree_like, f), leaves, prefix + ("." + f,))
                                 for f in tree_like._fields))
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, leaves, prefix + (str(i),))
                               for i, v in enumerate(tree_like))
    return leaves["/".join(prefix)]


def _is_bf16(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str | os.PathLike, step: int, tree, *,
                    extra: dict | None = None, keep: int = 3) -> Path:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:010d}"
    tmp = directory / f"step_{step:010d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    def write(item):
        key, leaf = item
        store = to_numpy(leaf)
        fn = key.replace("/", "__") + ".npy"
        np.save(tmp / fn, store)
        return key, {"file": fn, "shape": list(store.shape),
                     "dtype": "bfloat16" if _is_bf16(leaf) else str(store.dtype),
                     "sha1": _sha1(store)}

    manifest = {"step": step, "extra": extra or {},
                "leaves": dict(_map_leaves(write, _flatten(tree).items()))}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(directory, keep)
    return final


def _gc(directory: Path, keep: int):
    steps = sorted(p for p in directory.glob("step_*") if not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def _intact_steps(directory: Path) -> list[int]:
    """Step numbers with a renamed (non-.tmp) dir and a manifest, ascending."""
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                  if not p.name.endswith(".tmp") and (p / "manifest.json").exists())


def latest_step(directory: str | os.PathLike) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = _intact_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str | os.PathLike, step: int) -> dict:
    with open(Path(directory) / f"step_{step:010d}" / "manifest.json") as f:
        return json.load(f)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        return t.view(torch.bfloat16)
    return t


def _load_step(directory: Path, step: int, flat: dict, shard_flat: dict, verify: bool):
    """Restore one specific checkpoint step (raises on any corruption)."""
    ckpt = directory / f"step_{step:010d}"
    with open(ckpt / "manifest.json") as f:
        manifest = json.load(f)

    def read(key):
        meta = manifest["leaves"][key]
        arr = np.load(ckpt / meta["file"])
        if verify and _sha1(arr) != meta["sha1"]:
            raise IOError(f"checksum mismatch for {key} in {ckpt}")
        t = _to_tensor(arr, meta["dtype"])
        return key, shard_flat[key](t) if key in shard_flat else t

    return dict(_map_leaves(read, list(flat))), manifest


def _sha1(a: np.ndarray) -> str:
    """sha1 of an array's bytes in C order (its buffer where it is one)."""
    return hashlib.sha1(a.data if a.flags.c_contiguous else a.tobytes()).hexdigest()


def _map_leaves(fn, items) -> list:
    """``fn`` over ``items`` on a few threads (file I/O and sha1 release the
    interpreter's lock), results in order; the first failure is raised."""
    items = list(items)
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(_IO_THREADS, len(items))) as pool:
        return list(pool.map(fn, items))


def load_checkpoint(directory: str | os.PathLike, tree_like, *, step: int | None = None,
                    shardings=None, verify: bool = True, fallback: bool = True):
    """Restore into the structure of ``tree_like`` (only its keys are read);
    ``shardings``, a congruent tree (or a flat dict by key) of functions,
    maps each whole leaf it names to this rank's slice — the elastic
    restart.  Returns (tree of CPU tensors, manifest).

    With ``step=None`` and ``fallback=True`` a checkpoint that fails to
    restore (checksum, torn or missing leaf, unreadable manifest) is skipped
    with a warning for the next older intact one, and the skipped steps are
    listed in ``manifest["skipped_steps"]``; only when every one fails does
    it raise, with each step's failure.  An explicit ``step=`` (or
    ``fallback=False``) fails fast."""
    directory = Path(directory)
    flat = _flatten(tree_like)
    shard_flat = _flatten(shardings) if shardings is not None else {}

    def load(s):
        leaves, manifest = _load_step(directory, s, flat, shard_flat, verify)
        return _unflatten(tree_like, leaves), manifest

    if step is not None:
        return load(step)
    steps = _intact_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    if not fallback:
        return load(steps[-1])

    skipped: list[dict] = []
    for s in reversed(steps):
        try:
            tree, manifest = load(s)
        except (OSError, ValueError, KeyError, EOFError) as e:
            warnings.warn(f"skipping corrupt checkpoint step {s}: {e!r}", stacklevel=2)
            skipped.append({"step": s, "error": repr(e)[:300]})
            continue
        if skipped:
            manifest = dict(manifest)
            manifest["skipped_steps"] = skipped
        return tree, manifest
    detail = "; ".join(f"step {d['step']}: {d['error']}" for d in skipped)
    raise IOError(f"every checkpoint under {directory} is corrupt — {detail}")


class AsyncCheckpointError(RuntimeError):
    """A background ``save_async`` write failed.  ``step`` names the
    checkpoint whose write died; ``__cause__`` carries the original
    exception.  Raised by the next ``wait()``/``save_async()`` call."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(f"async checkpoint write for step {step} failed: {cause!r}")
        self.step = step


class CheckpointManager:
    """Async checkpointing with at most one outstanding write.

    ``save_async`` waits for the previous write (raising its failure, if
    any, as ``AsyncCheckpointError``) before it copies the new tree to the
    host; the copy is the only part on the caller's path (``snapshot_s``
    holds its seconds), the write runs on a thread (``write_s`` its
    seconds once joined)."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: AsyncCheckpointError | None = None
        self.snapshot_s = self.write_s = None

    def save_async(self, step: int, tree, *, extra: dict | None = None, copied: bool = False):
        """Write ``tree`` as checkpoint ``step`` on a thread.  ``copied``:
        its leaves are host copies that the caller hands over (the Trainer
        of an LM on a mesh gathers them so), written as they are."""
        import time

        self.wait()
        t0 = time.perf_counter()
        flat = _flatten(tree)
        host_tree = tree if copied else _unflatten(tree, {k: _host_copy(v)
                                                          for k, v in flat.items()})
        if any(isinstance(v, torch.Tensor) and v.is_cuda for v in flat.values()):
            torch.cuda.synchronize()  # the copies into pinned memory are asynchronous
        self.snapshot_s = time.perf_counter() - t0

        def work():
            t1 = time.perf_counter()
            try:
                save_checkpoint(self.directory, step, host_tree, extra=extra, keep=self.keep)
            except BaseException as e:  # surfaced on the next wait()/save_async()
                err = AsyncCheckpointError(step, e)
                err.__cause__ = e
                self._error = err
            self.write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the outstanding write, re-raising its failure (if any) as
        ``AsyncCheckpointError``."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self):
        return latest_step(self.directory)

    def __del__(self):
        err = getattr(self, "_error", None)
        if err is not None:  # pragma: no cover - interpreter-shutdown timing
            warnings.warn(f"CheckpointManager dropped without surfacing a failed async "
                          f"write: {err}", RuntimeWarning, stacklevel=1)


def _host_copy(leaf):
    """A leaf's own host copy, so that the caller may go on updating it: a
    device tensor copied into pinned memory without blocking (the caller
    synchronizes), a CPU tensor cloned."""
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        out = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        return out.copy_(leaf.detach(), non_blocking=True)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return np.array(leaf)

"""Fault-tolerant training runtime (the port of ``repro/runtime/trainer.py``).

* **checkpoint/restart** — ``save_async`` every ``ckpt_every`` steps and
  once at the end (``checkpoint/store.py``, the reference's format); on
  start the trainer resumes from the newest intact checkpoint, its own or
  one that the reference's ``Trainer`` wrote (``convert.
  trainer_state_from_reference``).  The data is a pure function of the step
  (``data/pipeline.py``), so the stream replays exactly.
* **preemption** — SIGTERM/SIGINT ask for a final checkpoint at the next
  step boundary, then the run returns.  On a mesh the ranks agree on it
  once a step (one all_reduce, MAX, of the flag over every rank), so that
  all save and leave at the same step: a rank that left alone would leave
  the others waiting in a collective.
* **straggler detection** — a step slower than ``straggler_factor`` times
  the median of the last ``straggler_window`` steps (once 8 are in)
  writes a ``SLOW_STEP`` event to the heartbeat log.
* **overlap** — the next step's rows are drawn on the host and copied
  from pinned memory without blocking while the step runs; checkpoints
  are written on a thread.

Data parallelism: with ``mesh`` (``launch/mesh.make_host_mesh``, ``("data",
"model")``, one process a rank) each rank holds the whole weights and
optimizer state (the reference also shards them over ``"data"``, FSDP),
takes its contiguous rows of each batch, and computes its rows' summed
token loss over the whole batch's mask count (the MoE family's aux and
z terms, its own rows', over the group's size); the gradients are then
summed in fp32 over ``"data"`` (one ``all_reduce`` a leaf, cast back
once), so each rank applies the gradient of the whole batch's mean loss
plus the mean of the ranks' aux and z terms, the gradient the reference
takes (ROADMAP §3).  ``grad_compression="int8"`` takes the reference's
explicit path instead: each rank's gradient of its own rows' mean loss,
the experts of its local-mode LM (``LM.local()``: every expert on every
token, ``moe_apply_dense``), goes through error feedback and
``optim/compress.compressed_psum``, divided by the group's size.  Rank 0
alone writes the checkpoints and the heartbeat.  Weight decay takes the
reference's leaves: those of rank >= 2 in its stacked tree, a layer's norm
weights among them (``convert.decays_in_reference``).  Every family
trains.

Tensor and sequence parallelism: an LM on a ``("data", "model")`` mesh
(``LM(cfg, mesh=, sp_mode=)``, the dense family) trains on the LM's own
mesh.  Each data rank's model ranks take the same rows, and the loss and
metrics are not summed over ``"model"``.  After the backward the leaves
that each model rank holds whole but reaches only through its own heads,
positions or kv heads (``LM.summed_over_model``: ``wk``, ``wv``; the
norms under the sequence-sharded residual) are summed over ``"model"`` in
one fp32 ``all_reduce``, then every gradient over ``"data"`` as above;
the clip's norm sums the split leaves' squares over ``"model"`` and
counts the whole leaves once.  Rank 0 writes whole leaves, so that a
checkpoint restores on any mesh, or without one; a restore cuts them to
the rank's slices (``convert.lm_shardings``).  Its model group sends it
each split leaf's slices (``Shard.gather_to_lead``), one leaf at a time,
and rank 0 copies the whole leaf to pinned host memory before the next:
no card holds more than its state and one whole leaf (two where the
split is not on the leading dim).  The other data ranks hold the same
slices and take no part.  int8 compression of a mesh LM is not ported
(ROADMAP §1).
"""

from __future__ import annotations

import functools
import json
import signal
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.checkpoint.store import read_manifest
from repro_torch.core.meshutil import axis_size
from repro_torch.data import SyntheticLMData
from repro_torch.models import sharding
from repro_torch.models.convert import decays_in_reference, lm_shardings
from repro_torch.models.lm import LM
from repro_torch.optim import AdamW, OptState, cosine_schedule


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "ckpt"
    log_every: int = 10
    lr: float = 3e-4
    warmup: int = 20
    straggler_factor: float = 3.0
    straggler_window: int = 32
    keep_ckpts: int = 3
    # "none" | "int8": the int8 error-feedback reduction over "data"
    grad_compression: str = "none"


class Trainer:
    """Trains ``lm`` on ``data``: a mesh-less LM (its parameters whole on
    this rank), data-parallel over the ``"data"`` ranks of ``mesh``
    (``("data", "model")``, "model" of 1) where one is given; or an LM on a
    mesh, over that mesh (``mesh`` may be omitted)."""

    def __init__(self, lm: LM, data: SyntheticLMData, tc: TrainConfig, *, mesh=None):
        why = lm.loss_not_ported()
        if why:
            raise NotImplementedError(why)
        if tc.grad_compression not in ("none", "int8"):
            raise ValueError(f"grad_compression {tc.grad_compression!r}: 'none' or 'int8'")
        if lm.shard is not None:
            if mesh is not None and mesh is not lm.shard.mesh:
                raise ValueError("an LM on a mesh trains on its own mesh")
            mesh = lm.shard.mesh
            if tc.grad_compression == "int8":
                raise NotImplementedError("int8 gradient compression of an LM on a mesh is not "
                                          "ported yet (ROADMAP §1)")
        self.lm, self.data, self.tc, self.mesh = lm, data, tc, mesh
        self.dp, self.dp_rank, self.group = 1, 0, None
        if mesh is not None:
            if lm.shard is None and axis_size(mesh, "model") > 1:
                raise ValueError("a mesh-less LM trains data-parallel (a mesh of \"model\" 1); "
                                 "for tensor parallelism pass LM(cfg, mesh=mesh)")
            self.dp, self.dp_rank = axis_size(mesh, "data"), mesh.get_local_rank("data")
            self.group = mesh.get_group("data")
        elif tc.grad_compression == "int8":
            raise ValueError("grad_compression='int8' reduces over a mesh's \"data\" ranks; "
                             "pass mesh=")
        if data.global_batch % self.dp:
            raise ValueError(f"global batch {data.global_batch} does not split over "
                             f"{self.dp} data ranks")
        self.lead = dist.get_rank() == 0 if mesh is not None else True
        self.opt = AdamW(lr=cosine_schedule(tc.lr, tc.warmup, tc.steps),
                         decays=functools.partial(decays_in_reference, lm.cfg),
                         **({} if lm.shard is None else
                            {"split": lm.split_over_model, "reduce": lm.shard.reduce}))
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=tc.keep_ckpts)
        self._stop = False
        self.snapshot_s = None  # seconds of the last save on the loop's path
        self._times: deque[float] = deque(maxlen=tc.straggler_window)
        self.heartbeat_path = Path(tc.ckpt_dir) / "heartbeat.log"
        self.params = lm.trainable_params()
        self._err_feedback = tc.grad_compression == "int8"
        # the reference's compressed path trains its per-shard local-mode LM
        self.loss_lm = lm.local() if self._err_feedback else lm

    # -- state ----------------------------------------------------------------

    def init_state(self):
        """(params, a fresh optimizer state, 0): the LM's own parameters, as
        drawn from its seed or loaded into it."""
        return self.params, self.opt.init(self.params), 0

    def restore_or_init(self):
        """The newest intact checkpoint's (params, opt state, step), written
        into this LM's parameters and a state of its leaves, or
        ``init_state()`` where there is none."""
        params, opt_state, _ = self.init_state()
        last = self.ckpt.latest_step()
        if last is None:
            return params, opt_state, 0
        keys = read_manifest(self.tc.ckpt_dir, last)["leaves"]
        lm = self.lm
        cuts = (None if lm.shard is None else
                lm_shardings(lm.cfg, lm.shard.mesh, list(params)))
        if any(k.startswith("params/blocks/") for k in keys):  # the reference's Trainer
            from repro_torch.models.convert import trainer_state_from_reference

            flat, manifest = load_checkpoint(self.tc.ckpt_dir, {k: None for k in keys})
            state = trainer_state_from_reference(lm.cfg, flat)
            if cuts is not None:
                for tree in (state["params"], state["opt"].mu, state["opt"].nu):
                    tree.update({k: cuts[k](t) for k, t in tree.items()})
        else:
            shardings = None if cuts is None else {
                f"{pre}/{k}": fn for k, fn in cuts.items()
                for pre in ("params", "opt/.mu", "opt/.nu")}
            state, manifest = load_checkpoint(self.tc.ckpt_dir,
                                              {"params": params, "opt": opt_state},
                                              shardings=shardings)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(state["params"][k])
            for mine, theirs in ((opt_state.mu, state["opt"].mu), (opt_state.nu, state["opt"].nu)):
                for k, t in mine.items():
                    t.copy_(theirs[k])
        step = state["opt"].step.to(torch.int32).reshape(())
        return params, OptState(step.clone(), opt_state.mu, opt_state.nu), manifest["step"]

    # -- one step ---------------------------------------------------------------

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.dp > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def train_step(self, params: dict, opt_state: OptState, batch: dict, err: dict | None = None):
        """One step on this rank's rows ``batch``: returns (params, opt state,
        metrics), with the new error-feedback state before the metrics under
        int8 compression.  The parameters are updated in place."""
        for p in params.values():
            p.grad = None
        if self._err_feedback:
            from repro_torch.optim.compress import (ErrorFeedback, compressed_psum,
                                                    reduce_local_roundtrip)

            loss, metrics = self.loss_lm.loss(batch)  # this rank's rows' mean
            loss.backward()
            g, err = ErrorFeedback.apply(
                {k: p.grad for k, p in params.items()}, err,
                lambda c: compressed_psum(c, self.mesh), lambda c: reduce_local_roundtrip(c, self.mesh))
            ndp = torch.full((), float(self.dp), device=loss.device)
            grads = {k: t / ndp for k, t in g.items()}
            means = self._all_reduce(torch.stack([loss.detach(), metrics["xent"].detach(),
                                                  metrics["aux"].detach()])) / ndp
            params, opt_state, om = self.opt.update(grads, opt_state, params)
            return params, opt_state, err, {"loss": means[0], "xent": means[1], "aux": means[2],
                                            **om}
        denom = self._all_reduce(batch["mask"].sum().to(self.lm.device))
        loss, metrics = self.lm.loss(batch, denom=denom, n_ranks=self.dp)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        self.lm.sum_partial_grads(grads)  # a mesh LM's whole leaves, over "model"
        sums = torch.stack([loss.detach(), metrics["xent"].detach(),
                            metrics["aux"].detach() / self.dp])
        if self.dp > 1:  # the whole batch's gradient: fp32 sums, cast back once
            for g in grads.values():
                g.copy_(self._all_reduce(g.float()))
            sums = self._all_reduce(sums)
        params, opt_state, om = self.opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": sums[0], "xent": sums[1], "aux": sums[2], **om}

    def stage_batch(self, step: int) -> dict:
        """This rank's rows of batch ``step`` on the LM's device: a
        non-blocking copy from pinned memory on a card."""
        rows = self.data.host_local_batch(step, process_index=self.dp_rank,
                                          process_count=self.dp)
        if self.lm.device.type != "cuda":
            return rows
        return {k: v.pin_memory().to(self.lm.device, non_blocking=True) for k, v in rows.items()}

    # -- loop -------------------------------------------------------------------

    def _heartbeat(self, record: dict):
        if self.lead:
            with open(self.heartbeat_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _save(self, step: int, params, opt_state):
        """Rank 0 writes whole leaves (the module docstring): a mesh LM's
        model group sends it each split leaf's slices, a leaf at a time,
        and it copies each whole leaf to host memory before the next."""
        t0 = time.perf_counter()
        sh = self.lm.shard
        if sh is None or sh.tp == 1:
            if self.lead:
                self.ckpt.save_async(step, {"params": params, "opt": opt_state})
        elif sh.drank == 0:  # the lead's model group
            if self.lead:
                self.ckpt.wait()  # one host copy of the state at a time
            p, mu, nu = ({k: self._host_whole(k, t) for k, t in tree.items()}
                         for tree in (params, opt_state.mu, opt_state.nu))
            if self.lead:
                if self.lm.device.type == "cuda":
                    torch.cuda.synchronize()  # the copies into pinned memory
                step_t = opt_state.step.detach().to("cpu", copy=True)
                self.ckpt.save_async(step, {"params": p, "opt": OptState(step_t, mu, nu)},
                                     copied=True)
        self.snapshot_s = time.perf_counter() - t0

    def _host_whole(self, name: str, t: torch.Tensor):
        """On rank 0, a host copy of the whole leaf ``name`` (a parameter or
        moment) of which ``t`` is this rank's slice, gathered from its model
        group; None on the group's other ranks (they send their slices)."""
        dim = sharding.split_dim(name)
        t = t.detach()
        if dim is not None:
            t = self.lm.shard.gather_to_lead(t, dim)
        elif not self.lead:
            return None
        if t is None:
            return None
        if t.is_cuda:
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
        return t.clone() if dim is None else t

    def _stop_agreed(self) -> bool:
        """Whether any rank has been asked to stop: on a mesh one
        all_reduce (MAX) of the flag over every rank (counted for an LM on
        a mesh, ``LM.collectives_per_step(trainer=True)``)."""
        if self.mesh is None:
            return self._stop
        flag = torch.tensor([float(self._stop)], device=self.lm.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if self.lm.shard is not None:
            sharding.collectives["all_reduce"] += 1
        self._stop = bool(flag.item())
        return self._stop

    def _signal(self, *_):
        self._stop = True

    def run(self, on_metrics=None):
        """Train from the newest checkpoint (or step 0) to ``tc.steps``;
        returns (params, opt state, history of {"step", "loss", "time",
        "grad_norm", "xent"})."""
        tc = self.tc
        Path(tc.ckpt_dir).mkdir(parents=True, exist_ok=True)
        old1 = signal.signal(signal.SIGTERM, self._signal)
        old2 = signal.signal(signal.SIGINT, self._signal)
        params, opt_state, start = self.restore_or_init()
        history = []
        err = None
        if self._err_feedback:
            from repro_torch.optim.compress import ErrorFeedback

            err = ErrorFeedback.init(params)
        try:
            staged = self.stage_batch(start)
            for step in range(start, tc.steps):
                t0 = time.perf_counter()
                batch = staged
                if self._err_feedback:
                    params, opt_state, err, metrics = self.train_step(params, opt_state, batch,
                                                                      err)
                else:
                    params, opt_state, metrics = self.train_step(params, opt_state, batch)
                if step + 1 < tc.steps:  # stage the next batch while the step runs
                    staged = self.stage_batch(step + 1)
                loss = float(metrics["loss"])  # sync point
                dt = time.perf_counter() - t0
                median = float(np.median(self._times)) if self._times else dt
                slow = dt > tc.straggler_factor * median and len(self._times) >= 8
                self._times.append(dt)
                self._heartbeat({"step": step, "t": dt, "loss": loss,
                                 **({"event": "SLOW_STEP"} if slow else {})})
                history.append({"step": step, "loss": loss, "time": dt,
                                "grad_norm": float(metrics["grad_norm"]),
                                "xent": float(metrics["xent"])})
                if on_metrics:
                    on_metrics(history[-1])
                if (step + 1) % tc.ckpt_every == 0:
                    self._save(step + 1, params, opt_state)
                if self._stop_agreed():
                    self.ckpt.wait()
                    self._save(step + 1, params, opt_state)
                    self.ckpt.wait()
                    self._heartbeat({"step": step, "event": "PREEMPTED_CLEAN_EXIT"})
                    break
            else:
                self.ckpt.wait()
                self._save(tc.steps, params, opt_state)
                self.ckpt.wait()
            if self.mesh is not None:  # every rank returns once rank 0's write is in
                dist.barrier()
        finally:
            signal.signal(signal.SIGTERM, old1)
            signal.signal(signal.SIGINT, old2)
        return params, opt_state, history

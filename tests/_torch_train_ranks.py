"""CPU (gloo) ranks running the port's training pieces across two ranks,
for tests/test_torch_compress.py (``compressed_psum``, ``ErrorFeedback``),
tests/test_torch_checkpoint.py (the elastic load) and
tests/test_torch_train.py (the data-parallel ``Trainer``, with and without
int8 compression, and ``launch.train`` under two ranks, data-parallel and
with ``--model-parallel 2 --sp-mode ulysses``), and across the (1, 2), (2,
2) and (1, 4) meshes for tests/test_torch_train_tp.py (``LM.loss`` of the
dense family on a mesh in its four forms, ``ulysses_attention``, the
``Trainer`` of a mesh LM, its resume and checkpoint).

The cases and their numpy-seeded inputs are plain data here, so that the
JAX side (a subprocess with 2 virtual devices) builds the same ones.  This
module imports no torch at top level and no jax at all.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from _torch_ranks import _init, start  # noqa: F401  (start: the tests' launcher)

WORLD = 2

#: per-rank gradient leaves of the compression cases: name -> shape
COMPRESS_SHAPES = {"a": (33, 7), "b": (130,)}
#: error-feedback rounds of the ErrorFeedback case
EF_ROUNDS = 3

#: the data-parallel training runs: smoke GLM-4 in fp32, seq 16, batch 4
TRAIN_ARCH = "glm4_9b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 16, 4, 3
TRAIN_LR, TRAIN_WARMUP = 3e-3, 1
TRAIN_MODES = ("none", "int8")
TRAIN_Q_BLOCK, TRAIN_XENT_CHUNKS = 8, 2


def compress_grads(rank: int, round_: int = 0) -> dict[str, np.ndarray]:
    """Rank ``rank``'s fp32 gradient leaves for round ``round_``."""
    rng = np.random.default_rng(100 + 10 * round_ + rank)
    return {k: (rng.standard_normal(s) * (1 + rank)).astype(np.float32)
            for k, s in COMPRESS_SHAPES.items()}


def run_compress_rank(rank: int, init_file: str, out_dir: str):
    """``compressed_psum`` of round 0 and ``ErrorFeedback.apply`` over
    ``EF_ROUNDS`` rounds on a (2,) "data" mesh; each rank saves its
    results to ``out_dir/compress<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.meshutil import make_mesh
    from repro_torch.optim.compress import (ErrorFeedback, compressed_psum,
                                            reduce_local_roundtrip)

    _init(rank, init_file, WORLD)
    try:
        mesh = make_mesh((WORLD,), ("data",), device="cpu")
        res = {}
        g = {k: torch.from_numpy(v) for k, v in compress_grads(rank).items()}
        for k, v in compressed_psum(g, mesh).items():
            res["psum:" + k] = v.numpy()
        for k, v in reduce_local_roundtrip(g, mesh).items():
            res["local:" + k] = v.numpy()
        err = ErrorFeedback.init(g)
        for r in range(EF_ROUNDS):
            g = {k: torch.from_numpy(v) for k, v in compress_grads(rank, r).items()}
            sent, err = ErrorFeedback.apply(g, err, lambda c: compressed_psum(c, mesh),
                                            lambda c: reduce_local_roundtrip(c, mesh))
            for k in g:
                res[f"ef{r}:sent:{k}"] = sent[k].numpy()
                res[f"ef{r}:err:{k}"] = err[k].numpy()
        np.savez(Path(out_dir) / f"compress{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def run_elastic_rank(rank: int, init_file: str, out_dir: str):
    """Load ``out_dir/ckpt`` (a whole smoke GLM-4 state, written by the test)
    on a (1, 2) mesh with ``convert.lm_shardings``; each rank saves whether
    every leaf equals its slice of ``LM(cfg, mesh=...)``'s own weights."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import lm_shardings
    from repro_torch.models.lm import LM

    _init(rank, init_file, WORLD)
    try:
        mesh = make_host_mesh(WORLD, device="cpu")
        cfg = configs.smoke(TRAIN_ARCH)
        mine = LM(cfg, mesh=mesh, device="cpu", seed=5).state_dict()
        tree, manifest = load_checkpoint(Path(out_dir) / "ckpt", {"params": mine},
                                         shardings={"params": lm_shardings(cfg, mesh, mine)})
        same = {k: bool(torch.equal(tree["params"][k], t)) for k, t in mine.items()}
        shapes = {k: list(tree["params"][k].shape) for k in mine}
        (Path(out_dir) / f"elastic{rank}.json").write_text(json.dumps(
            {"same": same, "shapes": shapes, "step": manifest["step"]}))
    finally:
        dist.destroy_process_group()


#: ``launch.train --model-parallel 2 --sp-mode ulysses``: the reference's
#: CLI takes TP_CLI_STEPS steps with a checkpoint each, the port's resumes
#: the first (``tests/test_torch_train.py``)
TP_CLI_ARGV = ["--arch", TRAIN_ARCH, "--preset", "smoke", "--model-parallel", "2", "--sp-mode",
               "ulysses"]
TP_CLI_STEPS = 3


def run_train_tp_cli(rank: int, out_dir: str):
    """The port's ``launch.train`` with ``TP_CLI_ARGV`` under the two ranks,
    resuming the reference CLI's step-1 checkpoint: waits for the
    reference's run (``out_dir/ref_cli.done``), rank 0 copies its
    directory without the later steps; returns the history."""
    import shutil
    import time

    import torch.distributed as dist

    from repro_torch.launch import train as train_cli

    done, mine = Path(out_dir) / "ref_cli.done", Path(out_dir) / "tp_cli"
    t0 = time.monotonic()
    while not done.exists():
        if time.monotonic() - t0 > 300:
            raise TimeoutError("the reference's CLI run did not finish")
        time.sleep(0.2)
    if rank == 0:
        shutil.copytree(Path(out_dir) / "ref_cli", mine)
        for step in range(2, TP_CLI_STEPS + 1):
            shutil.rmtree(mine / f"step_{step:010d}")
    dist.barrier()
    return train_cli.main([*TP_CLI_ARGV, "--steps", str(TP_CLI_STEPS), "--device", "cpu",
                           "--ckpt-dir", str(mine)])


def run_train_rank(rank: int, init_file: str, out_dir: str):
    """The port's ``Trainer`` on a (2, 1) mesh for each of ``TRAIN_MODES``
    from the weights in ``out_dir/weights.npz`` (the port's state dict of
    the reference's initial weights), then ``launch.train.main`` under the
    two ranks; each rank saves its histories and final weights' checksum to
    ``out_dir/train<rank>.json``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.runtime import TrainConfig, Trainer

    torch.set_num_threads(2)
    _init(rank, init_file, WORLD)
    try:
        mesh = make_host_mesh(1, device="cpu")
        cfg = dataclasses.replace(configs.smoke(TRAIN_ARCH), dtype="float32")
        weights = np.load(Path(out_dir) / "weights.npz")
        data = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
        out = {}
        for mode in TRAIN_MODES:
            lm = LM(cfg, q_block=TRAIN_Q_BLOCK, xent_chunks=TRAIN_XENT_CHUNKS, device="cpu")
            lm.load_state_dict({k: torch.from_numpy(weights[k]) for k in weights.files})
            tc = TrainConfig(steps=TRAIN_STEPS, ckpt_every=100, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                             ckpt_dir=str(Path(out_dir) / f"ckpt-{mode}"),
                             grad_compression=mode)
            params, _, hist = Trainer(lm, data, tc, mesh=mesh).run()
            out[mode] = {"loss": [h["loss"] for h in hist],
                         "grad_norm": [h["grad_norm"] for h in hist],
                         "param_sum": float(sum(p.double().sum() for p in params.values()))}
        hist = train_cli.main(["--arch", TRAIN_ARCH, "--preset", "smoke", "--steps", "2",
                               "--device", "cpu", "--ckpt-dir", str(Path(out_dir) / "cli")])
        out["cli"] = {"loss": [h["loss"] for h in hist]}
        hist = run_train_tp_cli(rank, out_dir)
        out["tp_cli"] = {"step": [h["step"] for h in hist], "loss": [h["loss"] for h in hist],
                         "grad_norm": [h["grad_norm"] for h in hist]}
        (Path(out_dir) / f"train{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


#: the data-parallel MoE runs: smoke Phi-3.5-MoE in fp32, the dense runs' sizes
MOE_ARCH = "phi35_moe_42b"


def run_train_moe_rank(rank: int, init_file: str, out_dir: str):
    """The port's ``Trainer`` for the smoke ``MOE_ARCH`` on a (2, 1) mesh for
    each of ``TRAIN_MODES`` from the weights in ``out_dir/moe_weights.npz``;
    each rank saves its histories (loss, grad norm, and the step's xent and
    aux) to ``out_dir/moe<rank>.json``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.runtime import TrainConfig, Trainer

    torch.set_num_threads(2)
    _init(rank, init_file, WORLD)
    try:
        mesh = make_host_mesh(1, device="cpu")
        cfg = dataclasses.replace(configs.smoke(MOE_ARCH), dtype="float32")
        weights = np.load(Path(out_dir) / "moe_weights.npz")
        data = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
        out = {}
        for mode in TRAIN_MODES:
            lm = LM(cfg, q_block=TRAIN_Q_BLOCK, xent_chunks=TRAIN_XENT_CHUNKS, device="cpu")
            lm.load_state_dict({k: torch.from_numpy(weights[k]) for k in weights.files})
            tc = TrainConfig(steps=TRAIN_STEPS, ckpt_every=100, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                             ckpt_dir=str(Path(out_dir) / f"moe-ckpt-{mode}"),
                             grad_compression=mode)
            tr = Trainer(lm, data, tc, mesh=mesh)
            params, opt, _ = tr.init_state()
            err = None
            if mode == "int8":
                from repro_torch.optim.compress import ErrorFeedback

                err = ErrorFeedback.init(params)
            hist = []
            for step in range(TRAIN_STEPS):
                batch = tr.stage_batch(step)
                if mode == "int8":
                    params, opt, err, m = tr.train_step(params, opt, batch, err)
                else:
                    params, opt, m = tr.train_step(params, opt, batch)
                hist.append({k: float(m[k]) for k in ("loss", "xent", "aux", "grad_norm")
                             if k in m})
            out[mode] = hist
        (Path(out_dir) / f"moe{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


#: tensor- and sequence-parallel training of the dense family
#: (tests/test_torch_train_tp.py): the meshes, archs and forms ((sp_mode,
#: seq_sharded_residual)); smoke configs in fp32 at the training runs' sizes
TP_MESHES = ((1, 2), (2, 2), (1, 4))
#: the meshes of each arch's loss cases: GLM-4 at every mesh, Nemotron-4
#: (its non-gated MLP and layernorms under the same placement rules) at one
TP_ARCH_MESHES = {"glm4_9b": TP_MESHES, "nemotron_4_15b": ((1, 2),)}
TP_ARCHS = tuple(TP_ARCH_MESHES)
TP_FORMS = (("none", False), ("none", True), ("ulysses", False), ("ulysses", True))
#: the batch of the loss cases
TP_BATCH_STEP = 3
#: the case with a vocabulary the mesh does not divide: (mesh, arch, vocab,
#: form); the reference pads it to 252 on (1, 4)
TP_PAD = ((1, 4), "glm4_9b", 250, ("none", False))
#: ulysses_attention against blockwise_attention: by mesh, ((B, S, Hq,
#: Hkv, dh), causal); Hkv 2 at tp 4 repeats each kv head twice
TP_ULYSSES = {(1, 2): (((2, 16, 4, 2, 8), True),),
              (1, 4): (((2, 16, 4, 2, 8), True), ((2, 16, 8, 4, 8), False)),
              (2, 2): ()}
TP_ULYSSES_Q_BLOCK = 4
#: the Trainer (3 steps against the reference's) and the resume, on (2, 2)
TP_TRAIN_FORM = ("ulysses", True)
#: the tp-2 checkpoint a mesh-less Trainer restores, on (1, 2)
TP_CKPT_FORM = ("none", True)
TP_CKPT_STEPS = 2


def wait_for(path, timeout: float = 300):
    """``path`` once it exists (the test writes the weights while the ranks
    and the reference's subprocesses start)."""
    import time

    t0 = time.monotonic()
    while not Path(path).exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.1)
    return path


def tp_loss_cases(mesh_shape) -> list[tuple[str, int | None, tuple[str, bool]]]:
    """(arch, vocab or None for the config's, form) of a mesh's loss cases."""
    cases = [(arch, None, form) for arch in TP_ARCHS if mesh_shape in TP_ARCH_MESHES[arch]
             for form in TP_FORMS]
    if mesh_shape == TP_PAD[0]:
        cases.append(TP_PAD[1:])
    return cases


def tp_key(arch: str, vocab, form) -> str:
    return f"{arch}:{form[0]}:{'seq' if form[1] else 'whole'}" + (f":v{vocab}" if vocab else "")


def tp_wkey(arch: str, vocab) -> str:
    """The weights' prefix of ``arch`` (at ``vocab``) in the weights' npz."""
    return f"{arch}:v{vocab}" if vocab else arch


def tp_config(configs, arch: str, vocab=None):
    """The fp32 smoke config of ``arch`` (either package's ``configs``),
    at ``vocab`` where given."""
    import dataclasses

    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    return dataclasses.replace(cfg, vocab=vocab) if vocab else cfg


def pad_vocab(arrays: dict, padded: int) -> dict:
    """The state dict (numpy) with ``embed``'s rows and ``lm_head``'s
    columns padded to ``padded`` with seeded values, as the reference draws
    its padding (its logsumexp reads those columns)."""
    rng = np.random.default_rng(5)
    out = dict(arrays)
    e, h = arrays["embed"], arrays["lm_head"]
    out["embed"] = np.concatenate(
        [e, rng.standard_normal((padded - e.shape[0], e.shape[1])).astype(e.dtype)])
    out["lm_head"] = np.concatenate(
        [h, (rng.standard_normal((h.shape[0], padded - h.shape[1])) / 8).astype(h.dtype)], 1)
    return out


def tp_weights(weights, prefix: str) -> dict:
    pre = prefix + ":"
    return {k[len(pre):]: weights[k] for k in weights.files
            if k.startswith(pre) and ":" not in k[len(pre):]}


def ulysses_inputs(shape, causal: bool) -> dict[str, np.ndarray]:
    """Seeded q (B, S, Hq, dh), k, v (B, S, Hkv, dh) and the output's
    cotangent of a ``TP_ULYSSES`` case."""
    B, S, Hq, Hkv, dh = shape
    rng = np.random.default_rng(sum(shape) + causal)
    return {"q": rng.standard_normal((B, S, Hq, dh)).astype(np.float32),
            "k": rng.standard_normal((B, S, Hkv, dh)).astype(np.float32),
            "v": rng.standard_normal((B, S, Hkv, dh)).astype(np.float32),
            "do": rng.standard_normal((B, S, Hq, dh)).astype(np.float32)}


def ulysses_tag(shape, causal: bool) -> str:
    return "x".join(map(str, shape)) + (":causal" if causal else ":full")


def tp_leaf_collectives(shard) -> dict:
    """``Shard.gather_leaves`` and ``Shard.gather_to_lead`` on seeded
    leaves, a (6, 4 tp) one split on its columns and a (4 tp, 6) one on its
    rows, the same on every rank: whether the gathered leaves are the whole
    ones, whether each rank's gradient of its slices is the sum over the
    model group of the ranks' cotangents (rank m's scaled by m + 1) on
    them, and what ``gather_to_lead`` returns on this rank."""
    import torch

    tp, m = shard.tp, shard.rank
    rng = np.random.default_rng(11)
    whole = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((6, 4 * tp), (4 * tp, 6))]
    cot = [torch.from_numpy(rng.standard_normal(tuple(w.shape)).astype(np.float32))
           for w in whole]
    dims = (1, 0)
    mine = [w.narrow(d, 4 * m, 4).clone().requires_grad_() for w, d in zip(whole, dims)]
    got = shard.gather_leaves(mine, list(dims))
    sum(((g * c).sum() * (m + 1) for g, c in zip(got, cot))).backward()
    summed = tp * (tp + 1) / 2
    lead = [shard.gather_to_lead(t.detach(), d) for t, d in zip(mine, dims)]
    return {"forward": all(torch.equal(g.detach(), w) for g, w in zip(got, whole)),
            "backward": all(torch.allclose(t.grad, summed * c.narrow(d, 4 * m, 4), rtol=1e-6)
                            for t, c, d in zip(mine, cot, dims)),
            "lead": [None if x is None else bool(torch.equal(x, w))
                     for x, w in zip(lead, whole)], "model_rank": m}


def whole_leaf(lm, name: str, t):
    """The whole leaf ``name`` (a parameter, its gradient or moment) of
    which ``t`` is this rank's slice on ``lm``'s mesh: the model group's
    slices all-gathered along its split dim (every model rank calls it)."""
    from repro_torch.models import sharding

    dim = sharding.split_dim(name)
    t = t.detach()
    return t if dim is None or lm.shard.tp == 1 else lm.shard.gather(t, dim)


def run_train_tp_rank(rank: int, init_file: str, out_dir: str, mesh_shape=(1, 2)):
    """One rank of a ``mesh_shape`` gloo mesh: each ``tp_loss_cases`` loss
    (its data rank's rows over the whole batch's mask count) and its
    gradients from the weights in ``out_dir/../weights.npz``, the partial
    ones summed over "model" (``LM.sum_partial_grads``), the loss and
    gradients summed over "data", each gathered whole; the collectives of
    the loss and its backward beside ``LM.collectives_per_step``; each
    ``TP_ULYSSES`` case (the output and q, k, v's gradients gathered along
    the sequence); on (2, 2) the Trainer's ``TRAIN_STEPS`` steps and a
    4 + 2 resume against 6 steps; on (1, 2) a Trainer's ``TP_CKPT_STEPS``
    steps and their checkpoint, with the whole leaves beside it.  Writes
    ``tp<rank>.npz`` and ``tp<rank>.json`` to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding
    from repro_torch.models.attention import ulysses_attention
    from repro_torch.models.convert import shard_params
    from repro_torch.models.lm import LM, PerfFlags
    from repro_torch.runtime import TrainConfig, Trainer

    torch.set_num_threads(1)  # the meshes' ranks share the host's cores
    _init(rank, init_file, mesh_shape[0] * mesh_shape[1])
    try:
        mesh = make_host_mesh(mesh_shape[1], device="cpu")
        weights = np.load(wait_for(Path(out_dir).parent / "weights.npz"))
        arrays, info = {}, {"cases": {}}

        def model(arch, vocab, form):
            cfg = tp_config(configs, arch, vocab)
            lm = LM(cfg, mesh=mesh, sp_mode=form[0], q_block=TRAIN_Q_BLOCK,
                    xent_chunks=TRAIN_XENT_CHUNKS, perf=PerfFlags(seq_sharded_residual=form[1]),
                    device="cpu")
            full = {k: torch.from_numpy(v) for k, v in tp_weights(weights, tp_wkey(arch, vocab)
                                                                  ).items()}
            lm.load_state_dict(shard_params(cfg, full, mesh))
            return cfg, lm

        def data_of(cfg):
            return SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)

        for arch, vocab, form in tp_loss_cases(mesh_shape):
            key = tp_key(arch, vocab, form)
            cfg, lm = model(arch, vocab, form)
            sh = lm.shard
            whole = data_of(cfg).batch(TP_BATCH_STEP)
            rows = sh.rows(TRAIN_BATCH)
            batch = {k: v if rows is None else v[rows[0]:rows[1]] for k, v in whole.items()}
            params = lm.trainable_params()
            sharding.collectives.clear()
            loss, _ = lm.loss(batch, denom=whole["mask"].sum())
            loss.backward()
            counts = dict(sharding.collectives)
            grads = {k: p.grad for k, p in params.items()}
            lm.sum_partial_grads(grads)
            loss = loss.detach()
            for t in (loss, *grads.values()):
                dist.all_reduce(t, group=sh.dgroup)
            arrays[key + "|loss"] = loss.numpy()
            for k, g in grads.items():
                arrays[f"{key}|g|{k}"] = whole_leaf(lm, k, g).numpy()
            info["cases"][key] = {"counts": counts, "formula": dict(lm.collectives_per_step()),
                                  "summed": [k for k in grads if lm.summed_over_model(k)],
                                  "split": [k for k in grads if lm.split_over_model(k)]}

        shard = sharding.Shard(mesh)
        for shape, causal in TP_ULYSSES[mesh_shape]:
            tag = ulysses_tag(shape, causal)
            s0, s = shard.seq_block(shape[1])
            x = {k: torch.from_numpy(v[:, s0:s0 + s].copy())
                 for k, v in ulysses_inputs(shape, causal).items()}
            q, k, v = (x[n].requires_grad_() for n in "qkv")
            o = ulysses_attention(q, k, v, shard, causal=causal, q_block=TP_ULYSSES_Q_BLOCK)
            (o * x["do"]).sum().backward()
            for name, t in (("o", o.detach()), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
                arrays[f"uly:{tag}|{name}"] = shard.gather(t, 1).numpy()

        info["leaves"] = tp_leaf_collectives(shard)
        cfg, lm = model(TRAIN_ARCH, None, TP_CKPT_FORM)
        stopper = Trainer(lm, data_of(cfg), TrainConfig(
            steps=3, ckpt_every=100, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
            ckpt_dir=str(Path(out_dir) / "stop")))

        def stop_on_the_last_rank(m):
            if m["step"] == 0 and rank == dist.get_world_size() - 1:
                stopper._stop = True

        hist = stopper.run(on_metrics=stop_on_the_last_rank)[2]
        info["stop"] = {"steps": [h["step"] for h in hist],
                        "checkpoint": stopper.ckpt.latest_step()}

        if mesh_shape == (2, 2):
            cfg, _ = model(TRAIN_ARCH, None, TP_TRAIN_FORM)

            def trainer(d, steps):
                return Trainer(model(TRAIN_ARCH, None, TP_TRAIN_FORM)[1], data_of(cfg),
                               TrainConfig(steps=steps, ckpt_every=100, lr=TRAIN_LR,
                                           warmup=TRAIN_WARMUP, ckpt_dir=str(Path(out_dir) / d)))

            hist = trainer("trainer", TRAIN_STEPS).run()[2]
            info["trainer"] = {"loss": [h["loss"] for h in hist],
                               "grad_norm": [h["grad_norm"] for h in hist]}
            first = trainer("resume", 6)

            def stop(m):  # one rank asked to stop: every rank stops after the same step
                if m["step"] == 3 and rank == dist.get_world_size() - 1:
                    first._stop = True

            h1 = first.run(on_metrics=stop)[2]
            p2, o2, h2 = trainer("resume", 6).run()
            p3, o3, h3 = trainer("straight", 6).run()
            info["resume"] = {
                "steps": [[h["step"] for h in h1], [h["step"] for h in h2]],
                "losses": [h["loss"] for h in h1 + h2] == [h["loss"] for h in h3],
                "params": all(torch.equal(p2[k], p3[k]) for k in p3),
                "moments": all(torch.equal(o2.mu[k], o3.mu[k]) and torch.equal(o2.nu[k], o3.nu[k])
                               for k in p3)}

        if mesh_shape == (1, 2):
            cfg, lm = model(TRAIN_ARCH, None, TP_CKPT_FORM)
            params, opt, _ = Trainer(lm, data_of(cfg), TrainConfig(
                steps=TP_CKPT_STEPS, ckpt_every=100, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                ckpt_dir=str(Path(out_dir) / "tp2ckpt"))).run()
            leaves = {f"{pre}|{k}": whole_leaf(lm, k, t).numpy()
                      for pre, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu))
                      for k, t in tree.items()}
            if rank == 0:
                np.savez(Path(out_dir) / "tp2whole.npz", **leaves)

        np.savez(Path(out_dir) / f"tp{rank}.npz", **arrays)
        (Path(out_dir) / f"tp{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()

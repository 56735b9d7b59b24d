"""CPU (gloo) ranks running the port's training pieces across two ranks,
for tests/test_torch_compress.py (``compressed_psum``, ``ErrorFeedback``),
tests/test_torch_checkpoint.py (the elastic load) and
tests/test_torch_train.py (the data-parallel ``Trainer``, with and without
int8 compression, and ``launch.train`` under two ranks).

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

"""LM pretraining — the twin of ``examples/lm_pretrain.py``: a small dense LM
(GLM-4's family at the preset's widths) trained with the port's whole
runtime (AdamW, the seeded data stream, async checkpoints, restart).
``--arch`` trains another family at the preset's widths instead: the
arch's smoke config (its experts, MLA, Mamba layers, frontend or encoder
as ``configs.smoke`` cuts them) with the preset's layers, widths and
vocabulary, and its frontend embeddings or frames in each batch
(``launch.train.data_for``).

Presets:
  10m   ~10M parameters,  seq 256  (the default)
  100m  ~100M parameters, seq 512

Run:  python -m repro_torch.examples.lm_pretrain --steps 50              # on the card
      python -m repro_torch.examples.lm_pretrain --steps 50 --device cpu
      torchrun --nproc-per-node 2 -m repro_torch.examples.lm_pretrain --device cpu
      python -m repro_torch.examples.lm_pretrain --arch zamba2_2p7b --steps 20 --device cpu
Rerun the same command after a kill: it resumes from the last atomic
checkpoint and replays the same data stream.  Under ``torchrun`` the ranks
train data-parallel, each on its rows of the batch.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
from dataclasses import replace

import torch

from repro_torch import configs
from repro_torch.core.meshutil import default_group, mesh_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import data_for, under_ranks
from repro_torch.models.config import param_count
from repro_torch.models.lm import LM
from repro_torch.runtime import TrainConfig, Trainer

PRESETS = {
    "10m": dict(n_layers=8, d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                vocab=4096, head_dim=32, seq=256, batch=4),
    "100m": dict(n_layers=12, d_model=640, n_heads=10, n_kv_heads=5, d_ff=2560,
                 vocab=16384, head_dim=64, seq=512, batch=8),
}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="10m")
    ap.add_argument("--arch", default=None,
                    help="train this arch's family at the preset's widths (default: dense)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lm_pretrain runs on a CUDA card and none is available; "
                           "pass --device cpu to run on the CPU")
    p = dict(PRESETS[args.preset])
    seq, batch = p.pop("seq"), p.pop("batch")
    base = configs.smoke(args.arch) if args.arch else configs.get("glm4_9b")
    cfg = replace(base, name=f"lm-{args.preset}" + (f"-{args.arch}" if args.arch else ""), **p)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_lm_pretrain")
    ranks = under_ranks()
    with default_group(device.type) if ranks else contextlib.nullcontext():
        mesh = make_host_mesh(1, device=device.type) if ranks else None
        lm = LM(cfg, q_block=64, xent_chunks=4,
                device=mesh_device(mesh) if mesh is not None else device)
        data = data_for(cfg, seq, batch)
        trainer = Trainer(lm, data, TrainConfig(steps=args.steps, ckpt_every=50,
                                                ckpt_dir=ckpt_dir, lr=args.lr, warmup=20),
                          mesh=mesh)
        if trainer.lead:
            print(f"model: {param_count(cfg) / 1e6:.1f}M params, seq={seq}, batch={batch}, "
                  f"ranks={trainer.dp}, device={lm.device}")

        def log(m):
            if trainer.lead and (m["step"] % 10 == 0 or m["step"] < 3):
                print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                      f"gnorm {m['grad_norm']:.2f}  {m['time']:.2f}s", flush=True)

        _, _, hist = trainer.run(on_metrics=log)
        if trainer.lead and hist:
            first = sum(h["loss"] for h in hist[:5]) / len(hist[:5])
            last = sum(h["loss"] for h in hist[-5:]) / len(hist[-5:])
            print(f"done: loss {first:.3f} -> {last:.3f} over {len(hist)} steps "
                  f"(ckpts in {ckpt_dir})")
    return hist


if __name__ == "__main__":
    main()

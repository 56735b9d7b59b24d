"""Training CLI (the port of ``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch glm4_9b --preset smoke --steps 20 --device cpu
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch glm4_9b --preset smoke \\
      --steps 20 --device cpu

``--preset smoke`` trains the reduced config of the family, ``--preset
full`` the published one (seq 4096, batch 256 unless given).  The run is
the port's ``Trainer`` (``runtime/trainer.py``): atomic and async
checkpoints in ``--ckpt-dir`` (a resumed run continues from the newest),
SIGTERM-clean preemption, the heartbeat log with its straggler events.  It
runs on the CUDA card unless ``--device cpu`` is given, and raises without
one.  Under ``torchrun`` the ranks train data-parallel (``launch/mesh.
make_host_mesh``, ``"data"`` the world, each rank on ``cuda:LOCAL_RANK``
over NCCL, or gloo with ``--device cpu``); rank 0 alone prints.  Every
family trains (``--arch`` any of ``configs.ARCH_NAMES``): the VLM's batches
carry its ``n_frontend_tokens`` seeded frontend embeddings and the audio
family's ``--seq`` seeded frames (``data_for``); ``--model-parallel`` above
1 and ``--sp-mode ulysses`` (tensor and sequence parallelism) are not
ported yet (ROADMAP §1).  ``main(argv)`` returns the history of the run.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.meshutil import default_group, mesh_device
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM
from repro_torch.runtime import TrainConfig, Trainer


def under_ranks() -> bool:
    """Whether the process is one rank of several (an initialized group, or
    ``torchrun``'s environment)."""
    return dist.is_initialized() or ("WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ)


def data_for(cfg, seq: int, global_batch: int) -> SyntheticLMData:
    """The seeded token stream of ``cfg``'s family: with frontend
    embeddings before the tokens for the VLM (``n_frontend_tokens`` a row)
    and ``seq`` frames a row for the audio encoder."""
    n = {"vlm": cfg.n_frontend_tokens, "audio": seq}.get(cfg.family)
    return SyntheticLMData(vocab=cfg.vocab, seq_len=seq, global_batch=global_batch,
                           frontend=None if n is None else (n, cfg.d_model))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--sp-mode", default="none", choices=["none", "ulysses"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.model_parallel > 1:
        raise NotImplementedError("--model-parallel > 1: tensor-parallel training is not ported "
                                  "yet (ROADMAP §1); the ranks train data-parallel")
    if args.sp_mode == "ulysses":
        raise NotImplementedError("--sp-mode ulysses: Ulysses sequence parallelism for training "
                                  "is not ported yet (ROADMAP §1 item 4)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train runs on a CUDA card and none is available; "
                           "pass --device cpu to run on the CPU")
    cfg = configs.smoke(args.arch) if args.preset == "smoke" else configs.get(args.arch)
    seq = args.seq or (32 if args.preset == "smoke" else 4096)
    gbs = args.global_batch or (4 if args.preset == "smoke" else 256)
    ranks = under_ranks()
    with default_group(device.type) if ranks else contextlib.nullcontext():
        mesh = make_host_mesh(1, device=device.type) if ranks else None
        lm = LM(cfg, q_block=min(512, seq), xent_chunks=min(8, seq),
                device=mesh_device(mesh) if mesh is not None else device)
        data = data_for(cfg, seq, gbs)
        tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                                f"repro_torch_train_{args.arch}"),
                         lr=args.lr, warmup=max(2, args.steps // 10))
        trainer = Trainer(lm, data, tc, mesh=mesh)

        def log(m):
            if trainer.lead:
                print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                      f"gnorm {m['grad_norm']:.2f}  {m['time']:.2f}s", flush=True)

        _, _, hist = trainer.run(on_metrics=log)
        if trainer.lead and hist:
            print(f"trained {len(hist)} steps; loss {hist[0]['loss']:.3f} -> "
                  f"{hist[-1]['loss']:.3f}")
    return hist


if __name__ == "__main__":
    main()

"""Wrapper of the causal flash-attention kernel (the port of
``repro/kernels/flash/ops.py``).

``flash_attention(q, k, v, causal=True)`` takes (B, S, Hq, dqk) queries,
(B, S, Hkv, dqk) keys and (B, S, Hkv, dv) values (GQA; dv == dqk but for
MLA, whose (192, 128) the kernel also takes) and returns (B, S, Hq, dv) in
v's dtype.  A tensor on the CPU takes the plain version (:mod:`.ref`) at any
head dims; a CUDA tensor launches the kernel (:mod:`.kernel`), which raises
on a pair of head dims it is not compiled for (``kernel.PAIRS``), and which
reads kv head ``h // G`` for q head ``h``
where the reference repeats k and v, and masks the ragged edge where the
reference pads.  ``block_q`` and ``block_k`` keep the reference's meaning
for the one rule they carry: a non-causal call whose Skv exceeds
``block_k`` and is not a multiple of it raises, as the reference does; the
kernel tiles by its own sizes.  With Sq > Skv and causal the two differ: the
reference's zero-padded keys are visible to queries past Skv, the port's
masked ones are not.  ``launches`` counts kernel launches per dtype,
``design_launches`` the same launches by design and dtype: bf16 runs the
tensor-core design (``"tc:bfloat16"``, ``mma.sync`` with p kept in
registers), fp32 the FMA design (``"fma:float32"``); the dtype alone
chooses.
"""

from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels.flash import ref

#: kernel launches per "flash_attention:<dtype>"
launches: Counter = Counter()
#: the same launches per design and dtype ("tc:bfloat16", "fma:float32")
design_launches: Counter = Counter()


def design(dtype: torch.dtype) -> str:
    """The design ``csrc/flash.cu`` runs for ``dtype``: ``"tc"`` (bf16 on the
    tensor cores) or ``"fma"`` (fp32)."""
    return "tc" if dtype == torch.bfloat16 else "fma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    del block_q  # the kernel's own query tile replaces it
    Skv = k.shape[1]
    bk = min(block_k, Skv)
    if not causal and Skv % bk:
        raise ValueError("non-causal flash path needs Skv % block_k == 0")
    if q.device.type == "cpu":
        return ref.attention_gqa_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    from repro_torch.kernels.flash import kernel

    o = kernel.flash_attention(q, k, v, causal=causal)
    dtype = str(q.dtype).removeprefix("torch.")
    launches[f"flash_attention:{dtype}"] += 1
    design_launches[f"{design(q.dtype)}:{dtype}"] += 1
    return o

"""ctypes binding of the flash-attention kernel (``csrc/flash.cu``).
The library is built and loaded at the first launch, never at import."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build

_c = ctypes.c_void_p
_i = ctypes.c_int

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128, 160)


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash")
    lib.flash_attention_fwd.argtypes = [_c, _c, _c, _c] + [_i] * 8 + [_c]
    lib.flash_attention_fwd.restype = _i
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Attention of CUDA (B, Sq, Hq, dh) queries over (B, Skv, Hkv, dh) keys
    and values, all float32 (the FMA design) or all bfloat16 (the
    tensor-core design), into a new (B, Sq, Hq, dh) tensor of v's dtype.
    Non-contiguous or misaligned inputs are copied."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dim() != 4:
            raise ValueError(f"flash_attention needs 4-D CUDA tensors, got {name} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v of one "
                             f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, Hq, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention has no kernel for head dim {dh} (has {HEAD_DIMS})")
    if k.shape != (B, Skv, Hkv, dh) or v.shape != k.shape or Hq % Hkv or Skv < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, S, H, dh) GQA tensors")
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    o = torch.empty_like(q)
    rc = _lib().flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    B, Sq, Skv, Hq, Hkv, dh, int(causal),
                                    int(q.dtype == torch.bfloat16),
                                    torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd failed with CUDA error {rc} at q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")
    return o

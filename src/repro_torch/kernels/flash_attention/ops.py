"""Public flash-attention op (port of ``src/repro/kernels/flash_attention/ops.py``).

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.
GQA runs inside the kernel; unlike the JAX wrapper, nothing here repeats
K/V.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    ptab: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA flash attention. q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D), or with
    ``ptab`` (B, n_ptab) int32 the page pools (P, page, Hkv, D) it maps;
    kv_len: (B,) int32 valid keys per row (None = Sk)."""
    if q.device.type == "cuda":
        return kernel.flash_attention(q, k, v, causal, window, softcap, kv_len,
                                      ptab)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window, softcap, kv_len,
                                   ptab)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


"""Public flash-decode ops, contiguous and paged (port of
``src/repro/kernels/flash_decode/ops.py``; the ``shard_map`` wrapper comes
with the sharded slice).

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.
GQA grouping lives inside the kernel; nothing here repeats K/V.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_decode import kernel
from repro_torch.kernels.flash_decode.ref import (flash_decode_ref,
                                                  paged_flash_decode_ref)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, softcap: Optional[float] = None) -> torch.Tensor:
    """Contiguous decode: q (B, H, D); k, v (B, S, Hkv, D) un-repeated;
    kv_len (B,) int32; ``softcap``: tanh logit cap or None."""
    if q.device.type == "cuda":
        return kernel.flash_decode(q, k, v, kv_len, softcap)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, kv_len, softcap)
    raise ValueError(f"flash_decode: unsupported device {q.device}")


def paged_flash_decode(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       ptab: torch.Tensor, kv_len: torch.Tensor,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None) -> torch.Tensor:
    """Paged decode: q (B, H, D); kp/vp (P, page, Hkv, D); ptab (B, n_ptab)
    logical block → physical page (0 = trash); kv_len (B,) int32."""
    if q.device.type == "cuda":
        return kernel.paged_flash_decode(q, kp, vp, ptab, kv_len, window, softcap)
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, kp, vp, ptab, kv_len, window, softcap)
    raise ValueError(f"paged_flash_decode: unsupported device {q.device}")


def paged_flash_decode_head_slice(q: torch.Tensor, kp: torch.Tensor,
                                  vp: torch.Tensor, ptab: torch.Tensor,
                                  kv_len: torch.Tensor, kv_head_offset: int,
                                  total_kv_heads: int,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None) -> torch.Tensor:
    """Paged decode over one contiguous KV-head slice.

    ``q`` carries the full head set (B, H, D); ``kp``/``vp`` carry exactly
    this slice's KV heads (P, page, Hkv_slice, D).  ``kv_head_offset``
    counts KV heads and selects the matching GQA query-head block
    ``[offset·G, (offset + Hkv_slice)·G)``.  Returns that block's outputs
    (B, G·Hkv_slice, D).
    """
    B, H, D = q.shape
    hkv_slice = kp.shape[2]
    if total_kv_heads <= 0 or H % total_kv_heads != 0:
        raise ValueError(
            f"GQA grouping needs n_heads ({H}) divisible by total KV heads "
            f"({total_kv_heads}): paged flash-decode cannot map query heads "
            f"onto KV-head slices otherwise")
    G = H // total_kv_heads
    q_slice = q[:, kv_head_offset * G:(kv_head_offset + hkv_slice) * G]
    return paged_flash_decode(q_slice.contiguous(), kp, vp, ptab, kv_len,
                              window=window, softcap=softcap)


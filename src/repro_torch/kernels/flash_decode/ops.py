"""Public flash-decode ops, contiguous and paged (port of
``src/repro/kernels/flash_decode/ops.py``), with the head-sharded paged
decode of sharded replicas.

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.
GQA grouping lives inside the kernel; nothing here repeats K/V.

A pool whose KV heads do not divide a replica's tensor-parallel degree is
replicated on every shard, and a shard's query heads may then cover part of
one KV head's group.  :func:`kv_head_rows` serves that case without a copy:
the pool (P, page, Hkv, D) read as (P·page·Hkv, 1, 1, D) is a page-size-1
pool with one KV head, and a row table maps key j of lane b to the row of
KV head h at j's position, so the same kernels (paged decode, and flash
attention for prefill chunks) read one KV head of the replicated pool.
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


def sharded_paged_flash_decode(q: torch.Tensor, kp, vp, ptab: torch.Tensor,
                               kv_len: torch.Tensor, mesh, axis: str = "model",
                               window: Optional[int] = None,
                               softcap: Optional[float] = None) -> torch.Tensor:
    """Paged decode over a head-sharded pool: each shard of the mesh's
    ``axis`` decodes its own KV-head slice through the replicated page
    table and lengths, with :func:`paged_flash_decode_head_slice` on its
    device.  Query-head block ``s·H/tp`` maps exactly onto KV-head block
    ``s·Hkv/tp``, so the outputs concatenate along heads in shard order (on
    q's device) with no combine.  ``kp``/``vp`` are the full pools
    (P, page, Hkv, D), sliced here, or lists of the shards' slices as a
    sharded engine holds them."""
    devices = mesh.axis_devices(axis)
    tp = len(devices)
    shards = isinstance(kp, (list, tuple))
    hkv = sum(k.shape[2] for k in kp) if shards else kp.shape[2]
    if hkv % tp != 0:
        raise ValueError(
            f"n_kv_heads={hkv} not divisible by tp={tp} on axis {axis!r}; "
            f"the sharded engine must fall back to the unfused paged path "
            f"(and record the fallback) for this config")
    local = hkv // tp
    outs = []
    for s, dev in enumerate(devices):
        if shards:
            kp_s, vp_s = kp[s], vp[s]
        else:
            heads = slice(s * local, (s + 1) * local)
            kp_s = kp[:, :, heads].to(dev).contiguous()
            vp_s = vp[:, :, heads].to(dev).contiguous()
        out = paged_flash_decode_head_slice(q.to(dev), kp_s, vp_s, ptab.to(dev),
                                            kv_len.to(dev), s * local, hkv,
                                            window=window, softcap=softcap)
        outs.append(out.to(q.device))
    return torch.cat(outs, dim=1)


def head_view(pool: torch.Tensor, width: int = 1) -> torch.Tensor:
    """A pool (P, page, Hkv, D) or a contiguous cache (B, S, Hkv, D) read
    as (rows·Hkv/width, 1, width, D): a page-size-1 pool of ``width`` KV
    heads, whose row ``r·Hkv/width + g`` holds heads ``[g·width,
    (g+1)·width)`` of row r (the row tables below with ``hkv = Hkv/width``
    and ``kv_head = g`` address it)."""
    return pool.view(-1, 1, width, pool.shape[-1])


def kv_head_rows(ptab: torch.Tensor, page: int, hkv: int, kv_head: int) -> torch.Tensor:
    """(B, n_ptab·page) int32 row table of KV head ``kv_head`` in the
    :func:`head_view` of a pool: key j of lane b is row ``(ptab[b, j //
    page]·page + j % page)·Hkv + kv_head``."""
    B, n = ptab.shape
    off = torch.arange(page, device=ptab.device)
    rows = (ptab.long()[:, :, None] * page + off) * hkv + kv_head
    return rows.reshape(B, n * page).to(torch.int32)


def contiguous_kv_head_rows(B: int, S: int, hkv: int, kv_head: int,
                            device) -> torch.Tensor:
    """The row table of KV head ``kv_head`` in the :func:`head_view` of a
    contiguous cache (B, S, Hkv, D): key j of lane b is row ``(b·S + j)·Hkv
    + kv_head``."""
    base = torch.arange(B * S, device=device).reshape(B, S)
    return (base * hkv + kv_head).to(torch.int32)

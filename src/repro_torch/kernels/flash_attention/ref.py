"""Plain PyTorch flash attention (port of
``src/repro/kernels/flash_attention/ref.py``), with GQA over un-repeated
K/V, an optional per-row ``kv_len`` and an optional page table.

The specification the CUDA kernel is held to, and what the op runs for
tensors on the CPU.  Query row ``i`` of batch row ``b`` sits at position
``kv_len[b] − Sq + i`` (end-aligned), keys at ``≥ kv_len[b]`` are masked,
and a row that can see no key writes zeros, as the kernel does.  With
``ptab`` the keys are the pages it maps, gathered here (the kernel reads
them in place), and the arithmetic is the same.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        ptab: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) un-repeated, or with ``ptab``
    (B, n_ptab) page pools (P, page, Hkv, D) read as Sk = n_ptab·page keys
    per row; kv_len: (B,) or None (= Sk).  Returns (B, Sq, H, D) in q's
    dtype; all arithmetic in f32."""
    B, Sq, H, D = q.shape
    if ptab is not None:
        idx = ptab.long()
        k = k[idx].reshape(B, -1, *k.shape[2:])
        v = v[idx].reshape(B, -1, *v.shape[2:])
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(D))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if kv_len is None:
        kl = torch.full((B,), Sk, dtype=torch.long, device=q.device)
    else:
        kl = kv_len.long()
    qpos = kl[:, None] - Sq + torch.arange(Sq, device=q.device)[None, :]
    kpos = torch.arange(Sk, device=q.device)
    diff = qpos[:, :, None] - kpos[None, None, :]               # (B, Sq, Sk)
    valid = (kpos[None, None, :] < kl[:, None, None]).expand(B, Sq, Sk)
    if causal:
        valid = valid & (diff >= 0)
    if window is not None:
        valid = valid & (diff < window)
    valid = valid[:, None]                                       # (B, 1, Sq, Sk)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l.clamp(min=1e-30), vf)
    return o.to(q.dtype)

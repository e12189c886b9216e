"""Plain PyTorch decode attention, paged and contiguous (port of
``src/repro/kernels/flash_decode/ref.py``).

The specifications the CUDA kernels are held to, and what the ops run for
tensors on the CPU.  They follow the kernels' contract exactly, including
a lane with ``kv_len = 0`` (nothing to attend) writing zeros, as the TPU
kernels' ``acc / max(l, 1e-30)`` flush does.  Unlike the JAX
``flash_decode_ref``, the contiguous version takes K/V un-repeated, and
both take an optional tanh logit softcap, ``cap·tanh(s/cap)`` on each
scaled score before the mask, as the JAX ``sdpa`` applies it (the TPU
decode kernels have none).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def _scores(qg: torch.Tensor, k: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """f32 scores (B, Hkv, G, S) of the grouped queries against k
    (B, S, Hkv, D), scaled by 1/√D and softcapped."""
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * (1.0 / math.sqrt(k.shape[-1]))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, S, Hkv, D) un-repeated; kv_len: (B,).
    Returns (B, H, D) in q's dtype; all arithmetic in f32."""
    B, S, Hkv, D = k.shape
    H = q.shape[1]
    qg = q.float().reshape(B, Hkv, H // Hkv, D)
    s = _scores(qg, k, softcap)
    valid = (torch.arange(S, device=q.device)[None, :]
             < kv_len.long()[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / l.clamp(min=1e-30)
    return o.reshape(B, H, D).to(q.dtype)


def paged_flash_decode_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                           ptab: torch.Tensor, kv_len: torch.Tensor,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, D); kp, vp: (P, page, Hkv, D); ptab: (B, n_ptab) logical
    block → physical page; kv_len: (B,).  Returns (B, H, D) in q's dtype;
    all arithmetic in f32."""
    P, page, Hkv, D = kp.shape
    B, H, _ = q.shape
    G = H // Hkv
    S = ptab.shape[1] * page
    idx = ptab.long()
    k = kp[idx].reshape(B, S, Hkv, D).float()              # gather pages
    v = vp[idx].reshape(B, S, Hkv, D).float()
    qg = q.float().reshape(B, Hkv, G, D)
    s = _scores(qg, k, softcap)
    kpos = torch.arange(S, device=q.device)[None, :]
    kl = kv_len.long()[:, None]
    valid = kpos < kl
    if window is not None:
        valid &= kpos >= (kl - window).clamp(min=0)
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v) / l.clamp(min=1e-30)
    return o.reshape(B, H, D).to(q.dtype)

"""Public flash-attention op (port of ``src/repro/kernels/flash_attention/ops.py``).

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.
GQA runs inside the kernel; unlike the JAX wrapper, nothing here repeats
K/V.

With grad enabled and an input that requires grad, the op runs through
:class:`_FlashAttention`, a ``torch.autograd.Function`` whose forward is the
same dispatch and whose backward is :func:`flash_attention_backward`,
explicit PyTorch ops that run alike on both devices.  The TPU kernel has no
``custom_vjp``: the reference trains through its jnp attention
(``src/repro/models/layers.py:131, 226``), whose gradient XLA derives, so
there is no backward kernel to port.  The CUDA kernel returns no
log-sum-exp, so the backward recomputes the scores from q, k and v.  Only
the full-sequence form trains (no ``kv_len``, no page table).  Otherwise
the op calls the kernel exactly as it does for serving.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref

BACKWARD_RANGE = "repro_torch::flash_attention_backward"    # profiler range


def _forward(q, k, v, causal, window, softcap, kv_len, ptab) -> torch.Tensor:
    if q.device.type == "cuda":
        return kernel.flash_attention(q, k, v, causal, window, softcap, kv_len,
                                      ptab)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window, softcap, kv_len,
                                   ptab)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor, causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of the full-sequence attention (queries end-aligned to the
    keys, as the kernel and its plain version place them) for the output
    gradient ``do`` (B, Sq, H, D).  In f32: the scores ``s = q·kᵀ/√D`` are
    recomputed, softcapped (``c·tanh(s/c)``) and masked, ``P = softmax``;
    ``dV = Pᵀ·dO``, ``dP = dO·Vᵀ``, ``dS = P ∘ (dP − rowsum(P ∘ dP))`` (the
    row sum equals ``rowsum(dO ∘ O)`` for O in f32), through the softcap
    ``dS·(1 − tanh²)``, then ``dQ = dS·K/√D`` and ``dK = dSᵀ·Q/√D``; dK and
    dV are summed over the query heads that share a KV head.  Returns
    (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    diff = (torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
            - torch.arange(Sk, device=q.device)[None, :])
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (diff >= 0)
    if window is not None:
        valid = valid & (diff < window)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dk = dk.reshape(B, Sk, Hkv, rep, D).sum(dim=3)
    dv = dv.reshape(B, Sk, Hkv, rep, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap)
        return _forward(q, k, v, causal, window, softcap, None, None)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD_RANGE):
            dq, dk, dv = flash_attention_backward(q, k, v, do, *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    ptab: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA flash attention. q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D), or with
    ``ptab`` (B, n_ptab) int32 the page pools (P, page, Hkv, D) it maps;
    kv_len: (B,) int32 valid keys per row (None = Sk).  Differentiable in
    q, k and v without ``kv_len`` and ``ptab`` (NotImplementedError with
    either when a gradient is required)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if kv_len is not None or ptab is not None:
            raise NotImplementedError(
                "flash_attention: no gradient with kv_len or a page table "
                "(training runs the full-sequence form)")
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, kv_len, ptab)

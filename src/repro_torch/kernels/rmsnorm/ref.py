"""Plain PyTorch RMSNorm (port of ``src/repro/kernels/rmsnorm/ref.py``).

The specification the CUDA kernel is held to, and what the op runs for
tensors on the CPU.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·(1+scale)`` in f32, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)

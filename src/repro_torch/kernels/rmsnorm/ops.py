"""Public RMSNorm op (port of ``src/repro/kernels/rmsnorm/ops.py``).

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (..., D) → same shape and dtype; scale: (D,) f32."""
    if x.device.type == "cuda":
        return kernel.rmsnorm(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")


"""Public RMSNorm op (port of ``src/repro/kernels/rmsnorm/ops.py``).

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.

With grad enabled and an input that requires grad, the op runs through
:class:`_RMSNorm`, a ``torch.autograd.Function`` whose forward is the same
dispatch and whose backward is :func:`rmsnorm_backward`, explicit PyTorch
ops that run alike on both devices.  The TPU kernel has no ``custom_vjp``:
the reference trains through its jnp ``rmsnorm`` (``src/repro/models/
layers.py:46``), whose gradient XLA derives, so there is no backward kernel
to port.  Otherwise the op calls the kernel exactly as it does for serving.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

BACKWARD_RANGE = "repro_torch::rmsnorm_backward"    # profiler range of the backward


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cuda":
        return kernel.rmsnorm(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``y = x·r·(1+scale)``, ``r = rsqrt(mean(x²)+eps)``, for
    the output gradient ``g``: ``dscale = Σ g·x·r`` over every row and
    ``dx = r·(h − x·r·mean(h·x·r))`` with ``h = g·(1+scale)``, all in f32,
    returned in the inputs' dtypes."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    h = gf * (1.0 + scale.float())
    dx = r * (h - xhat * (h * xhat).mean(dim=-1, keepdim=True))
    dscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD_RANGE):
            dx, dscale = rmsnorm_backward(x, scale, g, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (..., D) → same shape and dtype; scale: (D,) f32."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)

"""Public grouped MoE SwiGLU op (port of ``src/repro/kernels/moe_gmm/ops.py``).

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.
Unlike the JAX wrapper there are no block sizes: the kernel masks the
token axis, so any C runs unpadded.

With grad enabled and an input that requires grad, the op runs through
:class:`_MoEGMM`, a ``torch.autograd.Function`` whose forward is the same
dispatch and whose backward is :func:`moe_gmm_backward`, explicit PyTorch
ops that run alike on both devices.  The TPU kernel has no ``custom_vjp``:
the reference trains through its jnp MoE einsums (``src/repro/models/
layers.py:493-545``), whose gradient XLA derives, so there is no backward
kernel to port.  Otherwise the op calls the kernel exactly as it does for
serving.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm import kernel
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

BACKWARD_RANGE = "repro_torch::moe_gmm_backward"    # profiler range of the backward


def _forward(x, w_gate, w_up, w_down) -> torch.Tensor:
    if x.device.type == "cuda":
        return kernel.moe_gmm(x, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w_gate, w_up, w_down)
    raise ValueError(f"moe_gmm: unsupported device {x.device}")


def moe_gmm_backward(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, dy: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``y = (silu(hg)·hu)·Wd``, ``hg = x·Wg``, ``hu = x·Wu``
    per expert, for the output gradient ``dy`` (E, C, D).  The kernel keeps
    neither product, so ``hg`` and ``hu`` are recomputed; with ``s =
    silu(hg)``, ``a = s·hu`` and ``da = dy·Wdᵀ``: ``dWd = aᵀ·dy``, ``dhu =
    da·s``, ``dhg = da·hu·σ(hg)·(1 + hg·(1 − σ(hg)))``, ``dWg = xᵀ·dhg``,
    ``dWu = xᵀ·dhu`` and ``dx = dhg·Wgᵀ + dhu·Wuᵀ``.  Every product and
    element-wise factor is rounded to the input dtype where the reference's
    jnp einsums and products round (``da·hu`` before the SiLU derivative,
    which runs in f32 as ``F.silu``'s backward does).  ``x`` may have
    expert stride 0; dx comes back (E, C, D) whole.  Returns (dx, dWg, dWu,
    dWd) in the inputs' dtypes."""
    hg = torch.bmm(x, w_gate)
    hu = torch.bmm(x, w_up)
    s = F.silu(hg)
    a = s * hu
    da = torch.bmm(dy, w_down.transpose(1, 2))
    dhu = da * s
    hgf = hg.float()
    sig = torch.sigmoid(hgf)
    dhg = ((da * hu).float() * sig * (1.0 + hgf * (1.0 - sig))).to(x.dtype)
    xt = x.transpose(1, 2)
    dw_gate = torch.bmm(xt, dhg)
    dw_up = torch.bmm(xt, dhu)
    dw_down = torch.bmm(a.transpose(1, 2), dy)
    dx = torch.bmm(dhg, w_gate.transpose(1, 2)) + torch.bmm(dhu, w_up.transpose(1, 2))
    return dx, dw_gate, dw_up, dw_down


class _MoEGMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        return _forward(x, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        x, w_gate, w_up, w_down = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD_RANGE):
            grads = moe_gmm_backward(x, w_gate, w_up, w_down, dy.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def moe_gmm(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """x (E, C, D), possibly with expert stride 0; w_gate, w_up (E, D, F);
    w_down (E, F, D).  Returns (E, C, D).  Differentiable in every input:
    an expanded ``x`` gets its gradient per expert, which autograd's
    ``expand`` sums."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, w_gate, w_up, w_down)):
        return _MoEGMM.apply(x, w_gate, w_up, w_down)
    return _forward(x, w_gate, w_up, w_down)

"""Public grouped MoE SwiGLU op (port of ``src/repro/kernels/moe_gmm/ops.py``).

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.
The kernel has no gradient yet: on a CUDA tensor that requires grad the op
raises ``NotImplementedError`` (the plain version differentiates on the CPU).
Unlike the JAX wrapper there are no block sizes: the kernel masks the
token axis, so any C runs unpadded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import no_grad_on_card
from repro_torch.kernels.moe_gmm import kernel
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref


def moe_gmm(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """x (E, C, D), possibly with expert stride 0; w_gate, w_up (E, D, F);
    w_down (E, F, D).  Returns (E, C, D)."""
    if x.device.type == "cuda":
        no_grad_on_card("moe_gmm", x, w_gate, w_up, w_down)
        return kernel.moe_gmm(x, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w_gate, w_up, w_down)
    raise ValueError(f"moe_gmm: unsupported device {x.device}")


"""Plain PyTorch grouped (per-expert) SwiGLU (port of
``src/repro/kernels/moe_gmm/ref.py``).

The specification the CUDA kernel is held to, and what the op runs for
tensors on the CPU: three ``einsum`` s in the input type.  ``x`` may be an
expanded view with expert stride 0 (one copy of the tokens for every
expert).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_gmm_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) expert-buffered tokens; weights: (E, D, F) / (E, F, D).

    Returns (E, C, D): per-expert SwiGLU FFN.
    """
    g = F.silu(torch.einsum("ecd,edf->ecf", x, w_gate))
    u = torch.einsum("ecd,edf->ecf", x, w_up)
    return torch.einsum("ecf,efd->ecd", g * u, w_down)

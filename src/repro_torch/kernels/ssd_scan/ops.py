"""Public SSD scan op (port of ``src/repro/kernels/ssd_scan/ops.py``).

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.
Unlike the JAX wrapper, it takes the carried state and returns the final
state with y.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, h, p); dt (b, s, h) f32; A (h,) f32; B, C (b, s, 1, n);
    initial_state (b, h, p, n) or None.  Returns (y, final_state) in x's
    dtype.  ``chunk`` is the plain version's chunk length (``s`` must be a
    multiple of it); the kernel chunks the sequence its own way."""
    if x.device.type == "cuda":
        return kernel.ssd_scan(x, dt, A, B, C, initial_state)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk, initial_state)
    raise ValueError(f"ssd_scan: unsupported device {x.device}")

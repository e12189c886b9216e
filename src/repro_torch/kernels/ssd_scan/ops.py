"""Public SSD scan op (port of ``src/repro/kernels/ssd_scan/ops.py``).

A tensor on the card goes to the CUDA kernel; a tensor on the CPU goes to
the plain PyTorch version.  Nothing else: no fall-back between the two.
Unlike the JAX wrapper, it takes the carried state and returns the final
state with y.

With grad enabled and an input that requires grad, the op runs through
:class:`_SSDScan`, a ``torch.autograd.Function`` whose forward is the same
dispatch and whose backward is :func:`ssd_scan_backward`: autograd through
the plain version, recomputed from the saved inputs, alike on both
devices.  The TPU kernel has no ``custom_vjp``: the reference trains
through its jnp ``ssd_chunked`` (``src/repro/models/ssd.py:174``), whose
gradient XLA derives, so there is no backward kernel to port.  Otherwise
the op calls the kernel exactly as it does for serving.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

BACKWARD_RANGE = "repro_torch::ssd_scan_backward"   # profiler range of the backward


def _forward(x, dt, A, B, C, chunk, initial_state):
    if x.device.type == "cuda":
        return kernel.ssd_scan(x, dt, A, B, C, initial_state)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk, initial_state)
    raise ValueError(f"ssd_scan: unsupported device {x.device}")


def ssd_scan_backward(x, dt, A, B, C, chunk: int, initial_state, dy, dfinal,
                      needs=(True,) * 6) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``(y, final_state) = ssd_scan_ref(x, dt, A, B, C, chunk,
    initial_state)`` for the output gradients ``dy`` and ``dfinal`` (either
    may be None: a state nobody reads has none).  The plain version is
    recomputed on detached copies and differentiated by autograd, so ``s``
    must be a multiple of ``chunk``, as the reference's ``ssd_chunked``
    asserts (``src/repro/models/ssd.py:70``); the kernel's own chunking
    plays no part.  ``needs`` says which of (x, dt, A, B, C, initial_state)
    want a gradient.  Returns their gradients in their dtypes (None where
    not wanted or absent); those of the f32 ``A`` and ``dt`` sum over lanes
    and positions as their broadcasts say."""
    ins = [t.detach().requires_grad_(bool(need)) if t is not None else None
           for t, need in zip((x, dt, A, B, C, initial_state), needs)]
    leaves = [t for t in ins if t is not None and t.requires_grad]
    outs = [(o, g) for o, g in zip((0, 1), (dy, dfinal)) if g is not None]
    if not leaves or not outs:
        return (None,) * 6
    with torch.enable_grad():
        y, fin = ssd_scan_ref(*ins[:5], chunk, ins[5])
        got = iter(torch.autograd.grad([(y, fin)[i] for i, _ in outs],
                                       leaves, [g for _, g in outs],
                                       allow_unused=True))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in ins)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, chunk):
        s = x.shape[1]
        if chunk <= 0 or s % chunk:
            raise ValueError(f"ssd_scan: a gradient needs seq {s} divisible by "
                             f"chunk {chunk}")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, chunk, initial_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, initial_state = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD_RANGE):
            grads = ssd_scan_backward(x, dt, A, B, C, ctx.chunk, initial_state,
                                      dy, dfinal, ctx.needs_input_grad[:6])
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, h, p); dt (b, s, h) f32; A (h,) f32; B, C (b, s, 1, n);
    initial_state (b, h, p, n) or None.  Returns (y, final_state) in x's
    dtype.  ``chunk`` is the plain version's chunk length (``s`` must be a
    multiple of it on the CPU, and on the card when a gradient is
    required); the kernel chunks the sequence its own way.  Differentiable
    in every tensor input."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B, C, initial_state)):
        return _SSDScan.apply(x, dt, A, B, C, initial_state, chunk)
    return _forward(x, dt, A, B, C, chunk, initial_state)

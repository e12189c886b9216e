"""Fused RMSNorm — Triton kernel for Hopper.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_kernel``
(row-block tiles streamed HBM→VMEM once, f32 reduction, rsqrt and scale
multiply fused in one pass).

Bound on the card: bytes.  One row is read once and written once (plus the
``(D,)`` scale, which stays in L2); the arithmetic is a few operations per
element.  Design: one program per row holds the whole row in registers
(``BLOCK_D`` = next power of two ≥ D, masked loads cover D = 130 and any
row count), reduces ``x²`` in f32, and writes ``x·rsqrt(var+eps)·(1+scale)``
back in x's dtype — one read and one write of each element, as in the TPU
kernel.  On the main path a row is one token's hidden state (D = 1536).

``triton`` is imported on first launch only, so this module imports on a
host without it.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import build

# bound to ``triton.language`` on first launch; the jitted body below reads
# it as a module global when Triton compiles it
tl = None
_jitted = None

launches = 0          # kernel launches since the last reset (main-path check)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _rmsnorm_fwd(x_ptr, s_ptr, o_ptr, D, eps, BLOCK_D: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / D
    s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = (x * tl.rsqrt(var + eps)) * (1.0 + s)
    tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=mask)


def _compiled():
    global tl, _jitted
    if _jitted is None:
        # Triton caches compiled kernels under $TRITON_HOME/.triton; keep
        # them in the checkout's build directory unless the caller chose
        os.environ.setdefault("TRITON_HOME", str(build.TRITON_HOME))
        import triton
        import triton.language as language
        tl = language
        _jitted = triton.jit(_rmsnorm_fwd)
    return _jitted


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Launch the Triton kernel on ``x (..., D)`` (contiguous, f32/bf16/f16,
    on the card) with ``scale (D,)`` f32; returns a new tensor like ``x``."""
    global launches
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got x on {x.device}, scale on {scale.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    D = x.shape[-1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (D,):
        raise ValueError(f"rmsnorm kernel: scale must be f32 ({D},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel: inputs must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    block = 1 << (D - 1).bit_length()
    _compiled()[(rows,)](x, scale, out, D, float(eps), BLOCK_D=block,
                         num_warps=4 if block <= 1024 else 8)
    launches += 1
    return out

"""Grouped MoE SwiGLU — CUDA C++ kernel for Hopper (``csrc/moe_gmm.cu``).

Replaces the TPU kernel ``src/repro/kernels/moe_gmm/kernel.py:45``
``moe_gmm_kernel`` (body ``_moe_kernel``): the capacity-buffered expert FFN
``y[e] = (silu(x[e] Wg[e]) * (x[e] Wu[e])) Wd[e]`` with an f32 accumulator.

Bound on the card: bytes at serving shapes — a decode step reads every
expert's weights (3·E·D·F values, 2.82 GB per mixtral layer in bf16, 0.84 ms
at 3.35 TB/s), while the tensor cores would need ~400 tokens per expert to
become the limit.  Design: two passes of one grouped-GEMM kernel — gate/up
writes ``H = silu(x Wg) * (x Wu)`` (E, C, F) to device memory, down reads it
— because H is tiny beside the weights at decode (3.7 MB in f32 at C = 8)
and each pass then reads its weights once over a grid that fills the card.
Blocks own (16 or 128 tokens) × 64-column tiles of one expert and stream the
weights through a 4-stage ``cp.async`` ring; bf16 multiplies on the tensor
cores (``mma.sync``), f32 on the CUDA cores, both accumulating in f32.  The
token axis is masked (any C), and ``x`` may have expert stride 0, which the
dense mix uses so that no (E, C, D) copy is made.  One call is two CUDA
launches and counts as one launch of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0          # kernel calls since the last reset (main-path check)

_NAME = "moe_gmm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 64            # D and F must be multiples of the kernel's 64-column tile
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.moe_gmm
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def moe_gmm(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) with contiguous rows and expert stride C·D or 0 (an
    expanded view); w_gate, w_up (E, D, F) and w_down (E, F, D) contiguous;
    one CUDA device, one dtype (f32 or bf16); D and F multiples of 64.
    Returns (E, C, D) in x's dtype."""
    global launches
    tensors = (x, w_gate, w_up, w_down)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("moe_gmm kernel needs CUDA tensors on one device: "
                         + ", ".join(str(t.device) for t in tensors))
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in tensors):
        raise ValueError("moe_gmm kernel: x and the weights must share f32 or "
                         "bf16, got " + ", ".join(str(t.dtype) for t in tensors))
    if x.dim() != 3 or w_gate.dim() != 3:
        raise ValueError(f"moe_gmm kernel: bad shapes x {tuple(x.shape)} "
                         f"w_gate {tuple(w_gate.shape)}")
    E, C, D = x.shape
    F = w_gate.shape[-1]
    if (tuple(w_gate.shape) != (E, D, F) or tuple(w_up.shape) != (E, D, F)
            or tuple(w_down.shape) != (E, F, D)):
        raise ValueError(f"moe_gmm kernel: inconsistent shapes x {tuple(x.shape)} "
                         f"w_gate {tuple(w_gate.shape)} w_up {tuple(w_up.shape)} "
                         f"w_down {tuple(w_down.shape)}")
    if D % ALIGN or F % ALIGN:
        raise ValueError(f"moe_gmm kernel: D {D} and F {F} must be multiples "
                         f"of {ALIGN}")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("moe_gmm kernel: weights must be contiguous")
    if ((C > 1 and x.stride(1) != D) or x.stride(2) != 1
            or x.stride(0) not in (0, C * D)):
        raise ValueError(f"moe_gmm kernel: x strides {x.stride()} are not rows "
                         f"of {D} with expert stride {C * D} or 0")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("moe_gmm kernel: inputs must be 16-byte aligned")
    y = torch.empty((E, C, D), dtype=x.dtype, device=x.device)
    if E == 0 or C == 0:
        return y
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    lib, fn = _launcher()
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), w_gate.data_ptr(),
             w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), y.data_ptr(),
             E, C, D, F, build.stream(x))
    build.check(lib, err, _NAME)
    launches += 1
    return y

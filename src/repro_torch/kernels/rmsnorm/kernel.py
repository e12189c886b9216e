"""Fused RMSNorm — CUDA C++ kernel for Hopper (``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_kernel``
(row-block tiles streamed HBM→VMEM once, f32 reduction, rsqrt and scale
multiply fused in one pass).

Bound on the card: bytes.  One row is read once and written once (plus the
``(D,)`` scale, which stays in L2); the arithmetic is a few operations per
element.  At the paths' shapes the bytes take about a microsecond or less,
so the device time is latency and what a decode step pays is the launch:
the wrapper does its checks, one ``torch.empty_like`` and one ``ctypes``
call.  Design: one 128-thread block per row; every thread issues its
16-byte loads of x and of the scale at once and keeps them in registers, the
sum of ``x²`` is reduced in f32 with warp shuffles and across the 4 warps,
and ``x·rsqrt(mean(x²)+eps)·(1+scale)`` is written back in x's dtype with
16-byte stores (element by element for a row that is not 16-byte aligned,
as with D = 130).  On the main paths a row is one token's hidden state
(D = 1536, 2048 or 4096).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import telemetry
from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (main-path check)

_NAME = "rmsnorm"
_SPAN_ATTRS = {"kernel": _NAME}     # a kernel.launch span's attributes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.rmsnorm
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Launch the CUDA kernel on ``x (..., D)`` (contiguous, f32/bf16/f16,
    on the card) with ``scale (D,)`` f32; returns a new tensor like ``x``."""
    global launches
    if not x.is_cuda or scale.get_device() != x.get_device():
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got x on {x.device}, scale on {scale.device}")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise ValueError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    D = x.shape[-1]
    if scale.dtype != torch.float32 or scale.shape != (D,):
        raise ValueError(f"rmsnorm kernel: scale must be f32 ({D},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel: inputs must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    lib, fn = _fn or _launcher()
    rec = telemetry.REC
    if rec is not None:
        span = rec.begin("kernel.launch", attrs=_SPAN_ATTRS)
    err = fn(code, x.data_ptr(), scale.data_ptr(),
             out.data_ptr(), rows, D, eps,
             build.stream(x))
    if rec is not None:
        rec.end(span)
    if err:
        build.check(lib, err, _NAME)
    launches += 1
    return out

"""Mamba-2 SSD chunked scan — CUDA C++ kernel for Hopper (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan/kernel.py::ssd_scan_kernel``
(body ``_ssd_kernel``): the chunked SSD scan with the (h, p, n) state
carried across chunks in f32.  Unlike it, this kernel starts from a given
state and returns the final one, which chunked prefill needs.

Bound on the card: operations at long sequences, bytes at short ones (the
state, 64 × 128 values per head, is read and written once per call).
Design: the TPU walks the chunks in grid order with the state in VMEM
scratch; on the card the chunk loop runs inside one block per (lane, head),
which keeps the state in registers and shared memory across chunks of 32
positions.  B and C are staged per block, so all heads of a lane read them
again (from L2); the products run on the CUDA cores.  With one active lane
a prefill dispatch fills 64 of the card's 132 SMs.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (main-path check)

_NAME = "ssd_scan"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SHAPES = ((64, 128),)     # (head_dim p, d_state n) the kernel is built for
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.ssd_scan
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, h, p); dt (b, s, h) f32; A (h,) f32; B, C (b, s, 1, n);
    initial_state (b, h, p, n) or None — contiguous, on one CUDA device,
    x/B/C of one dtype (f32 or bf16), (p, n) in ``SHAPES``.  The state is
    cast to x's dtype.  Returns (y, final_state) in x's dtype."""
    global launches
    tensors = (x, dt, A, B, C) + (() if initial_state is None else (initial_state,))
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("ssd_scan kernel needs CUDA tensors on one device: "
                         + ", ".join(str(t.device) for t in tensors))
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan kernel: x/B/C must share f32 or bf16, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_scan kernel: dt and A must be f32")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"ssd_scan kernel: bad shapes x {tuple(x.shape)} "
                         f"B {tuple(B.shape)} C {tuple(C.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, s, 1, n)):
        raise ValueError(f"ssd_scan kernel: inconsistent shapes x {tuple(x.shape)}"
                         f" dt {tuple(dt.shape)} A {tuple(A.shape)} "
                         f"B {tuple(B.shape)}")
    if (p, n) not in SHAPES:
        raise ValueError(f"ssd_scan kernel: (head_dim, d_state) = ({p}, {n}) "
                         f"not in {SHAPES}")
    if initial_state is not None:
        if tuple(initial_state.shape) != (b, h, p, n):
            raise ValueError(f"ssd_scan kernel: initial_state "
                             f"{tuple(initial_state.shape)} != {(b, h, p, n)}")
        initial_state = initial_state.to(x.dtype)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan kernel: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan kernel: x, B and C must be 16-byte aligned")
    y = torch.empty_like(x)
    fin = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device)
    if b == 0 or h == 0:
        return y, fin
    if s == 0:
        if initial_state is None:
            return y, fin.zero_()
        return y, fin.copy_(initial_state)
    lib, fn = _launcher()
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
             B.data_ptr(), C.data_ptr(),
             0 if initial_state is None else initial_state.data_ptr(),
             y.data_ptr(), fin.data_ptr(), b, s, h, p, n,
             build.stream(x))
    build.check(lib, err, _NAME)
    launches += 1
    return y, fin

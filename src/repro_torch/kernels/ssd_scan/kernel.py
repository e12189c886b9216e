"""Mamba-2 SSD chunked scan — CUDA C++ kernel for Hopper (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan/kernel.py::ssd_scan_kernel``
(body ``_ssd_kernel``): the chunked SSD scan with the (h, p, n) state
carried across chunks in f32.  Unlike it, this kernel starts from a given
state and returns the final one, which chunked prefill needs.

Bound on the card: bytes at the serving shapes (the state, p × n values
per head, is read and written once), and short of it latency.  Design: the
TPU walks the chunks in grid order with the state in VMEM scratch; on the
card the chunk loop runs inside the block, which keeps its state in
registers.  bf16 runs on the tensor cores: a block owns ``PB`` state rows
(y columns) of one (lane, head), grid ``(h, p / PB, b)`` — 128 blocks for
one lane of mamba2 on 132 SMs — and takes ``CHUNK`` = 64 positions a round,
its copies (``cp.async``) overlapped with the products.  f32 stays on the
CUDA cores, one block per (lane, head), 32 positions a round, held to
2e-5.  :func:`grid` and :func:`smem_bytes` mirror the source's launch
plan; ``tests/test_torch_ssd_plan.py`` holds them to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import telemetry
from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (main-path check)

_NAME = "ssd_scan"
_SPAN_ATTRS = {"kernel": _NAME}     # a kernel.launch span's attributes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SHAPES = ((64, 128), (64, 64))   # (head_dim p, d_state n) the kernel is built for
CHUNK = 64            # positions per round of the bf16 body (csrc: tc::kChunk)
PB = 32               # state rows (y columns) per bf16 block (tc::kPb)
THREADS = 128         # threads per bf16 block (tc::kThreads)
_PAD = 8              # bf16 padding of a shared-memory row (tc::kPad)
_F32_CHUNK = 32       # positions per round of the f32 body (kL)
_fn = None


def _shape(p: int, n: int) -> None:
    if (p, n) not in SHAPES:
        raise ValueError(f"ssd_scan kernel: (head_dim, d_state) = ({p}, {n}) "
                         f"not in {SHAPES}")


def grid(b: int, h: int, p: int) -> Tuple[int, int, int]:
    """The bf16 body's launch grid (x, y, z): block (x, y, z) owns head x,
    state rows (y columns) [y·PB, (y + 1)·PB) and lane z.  (The f32 body
    runs one block per (head, lane).)"""
    if p % PB:
        raise ValueError(f"ssd_scan kernel: head_dim {p} is not a multiple of {PB}")
    return h, p // PB, b


def smem_bytes(dtype: torch.dtype, p: int, n: int) -> int:
    """Dynamic shared memory of one block, as the source lays it out.
    bf16: two stages of dt (f32), B and C (CHUNK × (n + 8)) and x
    (CHUNK × (PB + 8)), the state's hi and lo halves (PB × (n + 8)), cum
    and w (f32); f32: B, C (32 × (n + 1)), dt·x (32 × p), the score
    matrix (32 × 33), the state (p × (n + 1)) and three vectors of 32."""
    _shape(p, n)
    if dtype == torch.bfloat16:
        ldn, ldp = n + _PAD, PB + _PAD
        stage = 4 * CHUNK + 2 * (2 * CHUNK * ldn + CHUNK * ldp)
        return 2 * stage + 2 * 2 * PB * ldn + 2 * 4 * CHUNK
    lc = _F32_CHUNK
    return 4 * (2 * lc * (n + 1) + lc * p + lc * (lc + 1) + p * (n + 1) + 3 * lc)


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.ssd_scan
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_scan_smem_bytes.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def built_smem_bytes(dtype: torch.dtype, p: int, n: int) -> int:
    """Dynamic shared memory of one block as the built library reports it
    (builds it; 0 for a shape it does not take)."""
    lib, _ = _launcher()
    return int(lib.ssd_scan_smem_bytes(_DTYPE_CODE[dtype], p, n))


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
    _shape(p, n)
    if initial_state is not None:
        if tuple(initial_state.shape) != (b, h, p, n):
            raise ValueError(f"ssd_scan kernel: initial_state "
                             f"{tuple(initial_state.shape)} != {(b, h, p, n)}")
        initial_state = initial_state.to(x.dtype)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan kernel: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, B, C)) or (
            initial_state is not None and initial_state.data_ptr() % 16):
        raise ValueError("ssd_scan kernel: x, B, C and initial_state must be "
                         "16-byte aligned")
    y = torch.empty_like(x)
    fin = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device)
    if b == 0 or h == 0:
        return y, fin
    if s == 0:
        if initial_state is None:
            return y, fin.zero_()
        return y, fin.copy_(initial_state)
    lib, fn = _launcher()
    rec = telemetry.REC
    if rec is not None:
        span = rec.begin("kernel.launch", attrs=_SPAN_ATTRS)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
             B.data_ptr(), C.data_ptr(),
             0 if initial_state is None else initial_state.data_ptr(),
             y.data_ptr(), fin.data_ptr(), b, s, h, p, n,
             build.stream(x))
    if rec is not None:
        rec.end(span)
    build.check(lib, err, _NAME)
    launches += 1
    return y, fin

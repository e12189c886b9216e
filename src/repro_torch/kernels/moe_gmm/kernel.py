"""Grouped MoE SwiGLU — CUDA C++ kernel for Hopper (``csrc/moe_gmm.cu``).

Replaces the TPU kernel ``src/repro/kernels/moe_gmm/kernel.py:45``
``moe_gmm_kernel`` (body ``_moe_kernel``): the capacity-buffered expert FFN
``y[e] = (silu(x[e] Wg[e]) * (x[e] Wu[e])) Wd[e]`` with an f32 accumulator.

Bound on the card: bytes at decode — every call reads every expert's
weights (3·E·D·F values, 2.82 GB per mixtral layer in bf16, 0.84 ms at
3.35 TB/s) — and operations at dense prefill (C 512: 1.44e12 flops, 1.46 ms
at 989 TFLOP/s).  Design: two passes — gate/up writes ``H = silu(x Wg) *
(x Wu)`` (E, C, F) to device memory, down reads it — so each pass reads its
weights once.  bf16 with C > 32 runs on ``wgmma`` fed by TMA: persistent
clusters of two blocks walk the tile order of :mod:`plan` (the token tiles
of one weight tile are neighbours, so the weights come from HBM once) and
share each stage through a TMA multicast — the weights when the blocks take
two token tiles (C > 192), the token rows when they take two halves of the
columns (C ≤ 192) — a producer thread keeps a ring of 64-deep stages full
through ``mbarrier`` s, and two or three consumer warpgroups of 64 token
rows multiply, a part wholly past C idle.  bf16 decode (C ≤ 32) runs
the swapped product ``out^T = W^T x^T`` on ``wgmma`` (weights as the 64-row
operand, tokens padded to 32), streaming the weights through a TMA ring
near the byte bound.  The tensor maps are encoded on every call through
``cudaGetDriverEntryPoint`` (nothing links ``libcuda``).  f32 keeps a
``cp.async`` ring and CUDA-core FMAs.  The token axis is masked (any
C), and ``x`` may have expert stride 0, which the dense mix uses so that no
(E, C, D) copy is made.  One call is two CUDA launches and counts as one
launch of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import telemetry
from repro_torch.kernels import build
from repro_torch.kernels.moe_gmm import plan

launches = 0          # kernel calls since the last reset (main-path check)

_NAME = "moe_gmm"
_SPAN_ATTRS = {"kernel": _NAME}     # a kernel.launch span's attributes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 64            # D and F must be multiples of the kernel's 64-column tile
_fn = None


def smem_bytes(dtype: torch.dtype, C: int, which: str) -> int:
    """Dynamic shared memory of one block of pass ``which`` ("gate_up" or
    "down") at C tokens per expert, as the launcher requests it: bf16 takes
    the TMA ring of the swapped decode body (C ≤ 32, :func:`plan.decode_smem`)
    or the ring and output staging of the prefill body (:func:`plan.smem`,
    the same for both passes); f32 the 4-stage ``cp.async`` ring of 32-row
    slices (16 or 128 token rows, padded by 16 bytes a row)."""
    nmat = 2 if which == "gate_up" else 1
    if dtype == torch.bfloat16:
        if C < plan.TC_MIN_C:
            return plan.decode_smem(nmat)["total"]
        return plan.smem(plan.shape(C))["total"]
    es = torch.empty((), dtype=dtype).element_size()
    bm = 16 if C < plan.TC_MIN_C else 128
    return 4 * es * (bm * (32 + 16 // es) + nmat * 32 * (64 + 16 // es))


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.moe_gmm
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.moe_gmm_resident_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.moe_gmm_resident_clusters.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def resident_clusters(C: int) -> dict:
    """Clusters of two blocks per pass ("gate_up", "down") of the prefill
    body, in the shape it takes at C, that fit on the card at once, as that
    pass's first launch in that shape found them (0 before it): the most
    clusters a pass runs."""
    lib, _ = _launcher()
    columns = int(plan.shape(C) == "column_pairs")
    return {w: lib.moe_gmm_resident_clusters(i, columns)
            for i, w in enumerate(("gate_up", "down"))}


def moe_gmm(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) with contiguous rows and expert stride C·D or 0 (an
    expanded view); w_gate, w_up (E, D, F) and w_down (E, F, D) contiguous;
    one CUDA device, one dtype (f32 or bf16); D and F multiples of 64.
    Returns (E, C, D) in x's dtype.  Raises on anything else before the
    library is built."""
    global launches
    E, C, D, F = _checked(x, w_gate, w_up, w_down)
    y = torch.empty((E, C, D), dtype=x.dtype, device=x.device)
    if E == 0 or C == 0:
        return y
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    lib, fn = _launcher()
    rec = telemetry.REC
    if rec is not None:
        span = rec.begin("kernel.launch", attrs=_SPAN_ATTRS)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), w_gate.data_ptr(),
             w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), y.data_ptr(),
             E, C, D, F, build.stream(x))
    if rec is not None:
        rec.end(span)
    build.check(lib, err, _NAME)
    launches += 1
    return y


def _checked(x, w_gate, w_up, w_down):
    """(E, C, D, F) of a call the kernel takes; raises ValueError on any
    type, shape, stride, alignment or device it does not."""
    tensors = (x, w_gate, w_up, w_down)
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
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("moe_gmm kernel needs CUDA tensors on one device: "
                         + ", ".join(str(t.device) for t in tensors))
    return E, C, D, F

"""Flash-decode, paged and contiguous — CUDA C++ kernels for Hopper
(``csrc/paged_flash_decode.cu``).

:func:`paged_flash_decode` replaces the TPU kernel
``src/repro/kernels/flash_decode/kernel.py::paged_flash_decode_kernel``
(body ``_paged_decode_kernel``): one-token GQA decode over a block-paged KV
pool, online softmax in f32, dead pages skipped, ``acc / max(l, 1e-30)``.
:func:`flash_decode` replaces ``flash_decode_kernel`` (body
``_decode_kernel``), the same over a contiguous ``(B, S, Hkv, D)`` cache
with a ``kv_len`` mask; it is the paged kernel's split and combine passes
with a contiguous addressing mode (tile ``p`` of lane ``b`` is rows
``b·S + p·tile …`` by stride), not an identity page table.

Bound on the card: bytes.  Each lane streams its live K/V pages once and
does ~4·G flops per element read (G = H/Hkv query heads share one K/V
stream), far below the ~295 flop/byte the H100 needs to be compute-bound.
Design: one block per (batch lane, KV head) handles the lane's whole GQA
group against one un-repeated K/V stream, so each K/V byte is read once for
all G heads.  The page id comes from ``ptab`` inside the kernel, per page —
no contiguous copy.  ``B·Hkv`` blocks alone would leave most of the 132 SMs
idle (16 blocks at B = 8, Hkv = 2), so the pages of a lane are split over
``n_splits`` blocks (split-K); each writes a partial (m, l, acc) in f32 and
a second, small kernel combines them.  Splits whose pages are all dead
(past ``kv_len`` or below the window) exit at once.  The next page is
fetched with 16-byte loads while the current one is processed from shared
memory (f32); scores and the P·V product run on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0          # paged kernel launches since the last reset
contig_launches = 0   # contiguous kernel launches since the last reset

_NAME = "paged_flash_decode"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CONTIG_TILE = 16      # cache rows per tile of the contiguous mode
_fn = None
_contig_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.paged_flash_decode
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _contig_launcher():
    global _contig_fn
    if _contig_fn is None:
        lib = build.load(_NAME)
        fn = lib.flash_decode
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _contig_fn = (lib, fn)
    return _contig_fn


def split_plan(batch_heads: int, n_ptab: int, n_sm: int) -> tuple:
    """(pages_per_split, n_splits) aiming at four blocks per SM."""
    want = max(1, -(-4 * n_sm // max(batch_heads, 1)))
    per = max(1, -(-n_ptab // want))
    return per, -(-n_ptab // per)


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def paged_flash_decode(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       ptab: torch.Tensor, kv_len: torch.Tensor,
                       window: Optional[int] = None) -> torch.Tensor:
    """q (B, H, D); kp, vp (P, page, Hkv, D); ptab (B, n_ptab) int32;
    kv_len (B,) int32 — all contiguous on one CUDA device, q/kp/vp of one
    dtype (f32 or bf16).  Returns (B, H, D) in q's dtype."""
    global launches
    tensors = (q, kp, vp, ptab, kv_len)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("paged_flash_decode kernel needs CUDA tensors on one "
                         "device: " + ", ".join(str(t.device) for t in tensors))
    if q.dtype not in _DTYPE_CODE or kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise ValueError(f"paged_flash_decode kernel: q/kp/vp must share f32 "
                         f"or bf16, got {q.dtype}, {kp.dtype}, {vp.dtype}")
    if ptab.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError("paged_flash_decode kernel: ptab and kv_len must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode kernel: inputs must be contiguous")
    if q.dim() != 3 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"paged_flash_decode kernel: bad shapes q {tuple(q.shape)}"
                         f" kp {tuple(kp.shape)} vp {tuple(vp.shape)}")
    B, H, D = q.shape
    P, page, Hkv, Dk = kp.shape
    if Dk != D or H % Hkv != 0 or tuple(ptab.shape[:1]) != (B,) \
            or ptab.dim() != 2 or tuple(kv_len.shape) != (B,):
        raise ValueError(f"paged_flash_decode kernel: inconsistent shapes q "
                         f"{tuple(q.shape)} kp {tuple(kp.shape)} ptab "
                         f"{tuple(ptab.shape)} kv_len {tuple(kv_len.shape)}")
    if D % 8 or page * D > 4096 or any(t.data_ptr() % 16 for t in (q, kp, vp)):
        raise ValueError(f"paged_flash_decode kernel: needs D % 8 == 0, "
                         f"page·D ≤ 4096 and 16-byte aligned q/kp/vp (D={D}, "
                         f"page={page})")
    n_ptab = ptab.shape[1]
    G = H // Hkv
    out = torch.empty_like(q)
    if B == 0 or n_ptab == 0:
        return out.zero_()
    per, n_splits = split_plan(B * Hkv, n_ptab, _sm_count(q.device))
    part_acc = torch.empty((B * Hkv * n_splits * G * D,), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B * Hkv * n_splits * 2 * G,), dtype=torch.float32,
                          device=q.device)
    lib, fn = _launcher()
    err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
             ptab.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
             part_acc.data_ptr(), part_ml.data_ptr(),
             B, H, Hkv, D, page, n_ptab, per, n_splits,
             -1 if window is None else int(window),
             1.0 / math.sqrt(D), build.stream(q))
    build.check(lib, err, _NAME)
    launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); k, v (B, S, Hkv, D) un-repeated; kv_len (B,) int32 with
    values ≤ S — contiguous, on one CUDA device, q/k/v of one dtype (f32 or
    bf16).  Returns (B, H, D) in q's dtype; zeros for a lane with
    ``kv_len = 0``."""
    global contig_launches
    tensors = (q, k, v, kv_len)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_decode kernel needs CUDA tensors on one "
                         "device: " + ", ".join(str(t.device) for t in tensors))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode kernel: q/k/v must share f32 or bf16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len.dtype != torch.int32:
        raise ValueError("flash_decode kernel: kv_len must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode kernel: inputs must be contiguous")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode kernel: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, H, D = q.shape
    _, S, Hkv, Dk = k.shape
    if (k.shape[0] != B or Dk != D or H % Hkv != 0
            or tuple(kv_len.shape) != (B,)):
        raise ValueError(f"flash_decode kernel: inconsistent shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} kv_len "
                         f"{tuple(kv_len.shape)}")
    if D % 8 or CONTIG_TILE * D > 4096 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_decode kernel: needs D % 8 == 0, "
                         f"{CONTIG_TILE}·D ≤ 4096 and 16-byte aligned q/k/v "
                         f"(D={D})")
    G = H // Hkv
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out.zero_()
    n_tiles = -(-S // CONTIG_TILE)
    per, n_splits = split_plan(B * Hkv, n_tiles, _sm_count(q.device))
    part_acc = torch.empty((B * Hkv * n_splits * G * D,), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B * Hkv * n_splits * 2 * G,), dtype=torch.float32,
                          device=q.device)
    lib, fn = _contig_launcher()
    err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             kv_len.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
             part_ml.data_ptr(), B, H, Hkv, D, S, CONTIG_TILE, per, n_splits,
             1.0 / math.sqrt(D), build.stream(q))
    build.check(lib, err, "flash_decode")
    contig_launches += 1
    return out

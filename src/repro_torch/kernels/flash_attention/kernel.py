"""Flash attention (prefill) — CUDA C++ kernel for Hopper (``csrc/flash_attention.cu``).

Replaces the TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel``
(body ``_attn_kernel``): blocked online-softmax attention, end-aligned
causal mask, sliding window, tanh softcap, fully masked kv blocks skipped.
Here GQA runs inside the kernel on un-repeated K/V, an optional per-row
``kv_len`` (default: every key) bounds the keys and end-aligns the queries
— ``kv_len = Sk`` is the TPU kernel, ``kv_len = lens`` the paged prefill
mask — and with ``ptab`` the keys are read through a page table from the
layer's page pools, so the caller makes no gathered copy.

Bound on the card: bytes at the serving contexts (each live K/V element is
read once for its GQA group), operations only at long contexts with long
chunks; at the paths' shapes (64-token chunks, ≤ 2048 keys) the time is
latency: the longest chain of tile steps in one block and how many blocks
have work.  Design: one block per 64 flattened (query, head-in-group) rows
of one KV head, so each K/V tile serves the whole group.  bf16 runs on the
tensor cores (``mma.sync`` m16n8k16, K/V tiles of 64 keys in a 2-stage
``cp.async`` ring, P kept in registers for P·V as bf16 hi and lo halves,
softmax and masks in f32);
f32 runs on the CUDA cores (its 2e-5 tolerance rules out TF32).  Head dims
64, 112 (zamba2) and 128 hold Q in registers; at 256 (gemma2) the
accumulator takes 128 registers a thread, Q is read from shared memory
each k-step and one block fits an SM, so the split plan's target follows
the body's shared memory (:func:`repro_torch.kernels.split_plan.target`).
A key split fills the card when few lanes have work: every block computes the
same plan from ``kv_len`` on the card (``csrc/common.cuh``, shared with
flash-decode; :mod:`repro_torch.kernels.split_plan` mirrors it), splits write
partial (m, l, acc) rows in f32 to scratch allocated here, and a combine
pass finishes them; with no split the kernel writes the output itself and
no combine runs.  One call is one count in ``launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import split_plan as plan
from repro_torch.kernels.split_plan import TILE, lane_tiles  # noqa: F401

launches = 0          # kernel launches since the last reset (main-path check)

_NAME = "flash_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 112, 128, 256)
ROWS = 64             # flattened (query, head-in-group) rows per block
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.flash_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


@functools.cache
def smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory per block of the split kernel, as the CUDA
    source lays it out (builds the library)."""
    lib, _ = _launcher()
    return int(lib.flash_attention_smem_bytes(_DTYPE_CODE[dtype], head_dim))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    ptab: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, D).  Without ``ptab``: k, v (B, Sk, Hkv, D)
    un-repeated.  With ``ptab`` (B, n_ptab) int32: k, v are page pools
    (P, page, Hkv, D), page a power of two, and Sk = n_ptab·page.
    kv_len (B,) int32 with values ≤ Sk, or None for Sk.  Contiguous, on
    one CUDA device, one dtype (f32 or bf16), D in :data:`HEAD_DIMS`.  Returns
    (B, Sq, H, D)."""
    global launches
    dt = q.dtype
    code = _DTYPE_CODE.get(dt)
    if code is None or k.dtype != dt or v.dtype != dt:
        raise ValueError(f"flash_attention kernel: q/k/v must share f32 or "
                         f"bf16, got {dt}, {k.dtype}, {v.dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.shape != ks:
        raise ValueError(f"flash_attention kernel: bad shapes q {tuple(qs)}"
                         f" k {tuple(ks)} v {tuple(v.shape)}")
    B, Sq, H, D = qs
    Hkv = ks[2]
    if ptab is None:
        Sk, shift, n_ptab, rows_ok = ks[1], 0, 0, ks[0] == B
    else:
        pts = ptab.shape
        if ptab.dtype != torch.int32 or len(pts) != 2 or pts[0] != B:
            raise ValueError(f"flash_attention kernel: ptab must be int32 "
                             f"({B}, n_ptab), got {ptab.dtype} {tuple(pts)}")
        page, n_ptab = ks[1], pts[1]
        if page < 1 or page & (page - 1):
            raise ValueError(f"flash_attention kernel: page size {page} is "
                             f"not a power of two")
        Sk, shift, rows_ok = n_ptab * page, page.bit_length() - 1, True
    if not rows_ok or ks[3] != D or H % Hkv:
        raise ValueError(f"flash_attention kernel: inconsistent shapes q "
                         f"{tuple(qs)} k {tuple(ks)}")
    tensors = [t for t in (q, k, v, kv_len, ptab) if t is not None]
    dev = q.get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError("flash_attention kernel needs CUDA tensors on one "
                             "device: " + ", ".join(str(t.device) for t in tensors))
        if not t.is_contiguous():
            raise ValueError("flash_attention kernel: inputs must be contiguous")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in {HEAD_DIMS}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError("flash_attention kernel: q, k and v must be 16-byte aligned")
    if kv_len is None:
        kv_len = torch.full((B,), Sk, dtype=torch.int32, device=q.device)
    elif kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"flash_attention kernel: kv_len must be int32 ({B},),"
                         f" got {kv_len.dtype} {tuple(kv_len.shape)}")
    out = torch.empty_like(q)
    if B * Sq * H == 0:
        return out
    n_sm = build.sm_count(dev)
    pairs = -(-Sq * (H // Hkv) // ROWS) * Hkv
    tgt = plan.target(n_sm, smem_bytes(dt, D))
    grid = plan.grid_bound(pairs, B, tgt)
    n_cap = plan.max_splits(pairs, Sk, tgt)
    if n_cap > 1:          # partial acc [grid][ROWS][D], then (m, l) [grid][ROWS][2]
        part = torch.empty((grid * ROWS * (D + 2),), dtype=torch.float32,
                           device=q.device)
        parts = (part.data_ptr(), part.data_ptr() + grid * ROWS * D * 4)
    else:
        parts = (None, None)
    lib, fn = _fn or _launcher()
    err = fn(code, *ptrs, None if ptab is None else ptab.data_ptr(),
             kv_len.data_ptr(), out.data_ptr(), *parts, B, Sq, Sk, H, Hkv, D,
             shift, n_ptab, int(causal), -1 if window is None else int(window),
             0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(D),
             tgt, n_cap, grid, build.stream(q))
    if err:
        build.check(lib, err, _NAME)
    launches += 1
    return out

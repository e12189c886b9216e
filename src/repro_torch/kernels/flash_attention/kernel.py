"""Flash attention (prefill) — CUDA C++ kernel for Hopper (``csrc/flash_attention.cu``).

Replaces the TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel``
(body ``_attn_kernel``): blocked online-softmax attention, end-aligned
causal mask, sliding window, tanh softcap, fully masked kv blocks skipped.
Here GQA runs inside the kernel on un-repeated K/V, and an optional per-row
``kv_len`` (default ``Sk``) bounds the keys and end-aligns the queries —
``kv_len = Sk`` is the TPU kernel, ``kv_len = lens`` the paged prefill mask.

Bound on the card: operations at long contexts (4·D flops per visible
(query, key) pair), bytes at short ones.  Design: one block per 64
flattened (query, head-in-group) rows of one KV head, so each K/V tile is
read once for the whole GQA group; K/V tiles of 32 keys are staged in
shared memory as f32 (the next tile is fetched with 16-byte loads while
the current one is processed) and multiplied on the CUDA cores from 4×4
register tiles, with the online softmax in f32.  Tiles no row of the block
can see (past ``kv_len``, above the causal diagonal, below the window) are
never loaded.  It does not use the tensor cores yet.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset (main-path check)

_NAME = "flash_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.flash_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, Hkv, D) un-repeated; kv_len (B,) int32
    with values ≤ Sk, or None for Sk.  Contiguous, on one CUDA device, one
    dtype (f32 or bf16), D in {64, 128}.  Returns (B, Sq, H, D)."""
    global launches
    tensors = (q, k, v) if kv_len is None else (q, k, v, kv_len)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_attention kernel needs CUDA tensors on one "
                         "device: " + ", ".join(str(t.device) for t in tensors))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: q/k/v must share f32 or "
                         f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention kernel: inputs must be contiguous")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel: bad shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv != 0:
        raise ValueError(f"flash_attention kernel: inconsistent shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (k, v)):
        raise ValueError("flash_attention kernel: k and v must be 16-byte aligned")
    if kv_len is None:
        kv_len = torch.full((B,), Sk, dtype=torch.int32, device=q.device)
    elif kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise ValueError(f"flash_attention kernel: kv_len must be int32 ({B},),"
                         f" got {kv_len.dtype} {tuple(kv_len.shape)}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib, fn = _launcher()
    err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             kv_len.data_ptr(), out.data_ptr(), B, Sq, Sk, H, Hkv, D,
             int(causal), -1 if window is None else int(window),
             0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, _NAME)
    launches += 1
    return out

"""Flash-decode, paged and contiguous — CUDA C++ kernels for Hopper
(``csrc/paged_flash_decode.cu``).

:func:`paged_flash_decode` replaces the TPU kernel
``src/repro/kernels/flash_decode/kernel.py::paged_flash_decode_kernel``
(body ``_paged_decode_kernel``): one-token GQA decode over a block-paged KV
pool, keys below ``kv_len`` and, with a window, at or above ``kv_len −
window``, online softmax in f32, ``acc / max(l, 1e-30)`` (0 for a lane
with ``kv_len = 0``).  :func:`flash_decode` replaces
``flash_decode_kernel`` (body ``_decode_kernel``), the same over a
contiguous ``(B, S, Hkv, D)`` cache; one kernel body serves both, with a
contiguous addressing mode (key j of lane b is row ``b·S + j``, by stride),
not an identity page table.

Bound on the card: bytes (each live K/V element is read once for the G =
H/Hkv query heads of its group, ~4·G flops per element), but at the serving
shapes the bytes take ~2 µs and the time is latency: the longest chain of
tile steps in one block, plus the launches.  Design:

* **The split plan over live tiles, made on the card** (``csrc/common.cuh``,
  shared with flash attention; :mod:`repro_torch.kernels.split_plan` mirrors
  it here for the grid bound).  Every block reads ``kv_len``: T_b live
  64-key tiles of lane b (counting the window), ``per = max(1, ⌈Hkv·ΣT_b /
  target⌉, ⌈max T_b / 16⌉)``, ``⌈T_b / per⌉`` splits for each KV head of
  lane b (so at most 16, which bounds the combine).  A block
  takes one (lane, KV head) and at most ``per`` tiles; the grid is
  ``target + Hkv·B`` and blocks past the last item exit at once.  An idle
  (lane, KV head) gets one item that writes its zeros; a lane with one
  split writes its output directly; split lanes write partial (m, l, acc)
  rows in f32 to scratch allocated here, and the last split of a (lane,
  KV head) to finish, found by a counter the kernel resets, combines them
  (a warp per query head).  One launch per call; no length crosses to the
  host.
* **bf16 on the tensor cores.**  The group's G ≤ 16 query rows are one
  ``mma.sync`` m16 A fragment, kept in registers; each of 4 warps streams
  16 keys of every 64-key tile through its own 2-stage ``cp.async`` ring
  and runs S = Q·Kᵀ and O += P·V (P as bf16 hi and lo halves) with its own
  online softmax in f32; the block merges its warps once, at the end.
* **f32 on the CUDA cores** under the same plan (its 2e-5 tolerance rules
  out TF32).
* **An optional tanh logit softcap** (gemma2's 50), ``cap·tanh(s/cap)`` on
  each scaled score before the mask, in both bodies and both modes; the
  TPU decode kernels have none.

Head dims 64, 112, 128 and 256 and G ≤ 16; at D 256 the Q fragments are
read from shared memory each k-step and one block fits an SM, so the split
plan's target follows the body's shared memory
(:func:`repro_torch.kernels.split_plan.target`).  The paged pool's page is
a power of two.  One call is one count in ``launches`` /
``contig_launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch import telemetry
from repro_torch.kernels import build
from repro_torch.kernels import split_plan as plan

launches = 0          # paged kernel launches since the last reset
contig_launches = 0   # contiguous kernel launches since the last reset

_NAME = "paged_flash_decode"
_SPAN_ATTRS = {"kernel": _NAME}     # a kernel.launch span's attributes
_CONTIG_SPAN_ATTRS = {"kernel": "flash_decode"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 112, 128, 256)
MAX_GROUP = 16        # query heads per KV head: one m16 fragment
MAX_SPLITS = 16       # most splits of a lane: the last of them merges
                      # them all, 8 at a time
_fn = None
_contig_fn = None
_counters = {}        # (device, stream) -> zeroed int32 arrival counters


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.paged_flash_decode
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _contig_launcher():
    global _contig_fn
    if _contig_fn is None:
        lib = build.load(_NAME)
        fn = lib.flash_decode
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _contig_fn = (lib, fn)
    return _contig_fn


@functools.cache
def smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory per block of the split kernel, as the CUDA
    source lays it out (builds the library)."""
    lib, _ = _launcher()
    return int(lib.flash_decode_smem_bytes(_DTYPE_CODE[dtype], head_dim))


def max_splits(Hkv: int, Sk: int, target: int) -> int:
    """The plan's ``n_cap``: at most MAX_SPLITS splits a lane, fewer when
    ``Sk`` keys or ``target`` blocks need fewer; 1 means no lane splits."""
    return min(plan.max_splits(Hkv, Sk, target), MAX_SPLITS)


def check_dims(name: str, D: int, G: int) -> None:
    """Raise unless the kernel is built for head dim ``D`` (one of
    :data:`HEAD_DIMS`, the source's instantiations) and ``G`` query heads
    per KV head fit one m16 fragment."""
    if D not in HEAD_DIMS:
        raise ValueError(f"{name} kernel: head dim {D} not in {HEAD_DIMS}")
    if G > MAX_GROUP:
        raise ValueError(f"{name} kernel: {G} query heads per KV head,"
                         f" more than one m16 fragment ({MAX_GROUP})")


def _checked(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             ints: Tuple[torch.Tensor, ...]) -> Tuple[int, int, int, int]:
    """The checks both entry points share, device first (a CPU tensor
    raises before anything else is looked at); returns (dtype code, B, H,
    Hkv)."""
    tensors = (q, k, v) + ints
    dev = q.get_device()
    if any(not t.is_cuda or t.get_device() != dev for t in tensors):
        raise ValueError(f"{name} kernel needs CUDA tensors on one device: "
                         + ", ".join(str(t.device) for t in tensors))
    code = _DTYPE_CODE.get(q.dtype)
    if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} kernel: q/k/v must share f32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{name} kernel: ptab and kv_len must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel: inputs must be contiguous")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name} kernel: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    B, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"{name} kernel: inconsistent shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)}")
    check_dims(name, D, H // Hkv)
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError(f"{name} kernel: q, k and v must be 16-byte aligned")
    return code, B, H, Hkv


def _scratch(q: torch.Tensor, B: int, H: int, Hkv: int, Sk: int, stream: int):
    """(target, n_cap, grid, scratch tensor or None, pointers) for a launch
    on ``stream``: partial (acc, (m, l)) rows of G heads per work item,
    sized by the grid bound, and the arrival counters of the B·Hkv (lane,
    KV head) pairs.  The kernel leaves every counter at 0, so they are
    zeroed once, when allocated, and shared by the calls on the stream."""
    D, dev = q.shape[2], q.get_device()
    tgt = plan.target(build.sm_count(dev), smem_bytes(q.dtype, D))
    grid = plan.grid_bound(Hkv, B, tgt)
    n_cap = max_splits(Hkv, Sk, tgt)
    if n_cap <= 1:
        return tgt, n_cap, grid, None, (None, None, None)
    cnt = _counters.get((dev, stream))      # the default stream is 0 on every device
    if cnt is None or cnt.numel() < B * Hkv:
        cnt = _counters[dev, stream] = torch.zeros((max(B * Hkv, 256),),
                                                   dtype=torch.int32, device=q.device)
    rows = grid * (H // Hkv)      # acc [grid][G][D], then (m, l) [grid][G][2]
    part = torch.empty((rows * (D + 2),), dtype=torch.float32, device=q.device)
    return tgt, n_cap, grid, part, (part.data_ptr(), part.data_ptr() + rows * D * 4,
                                    cnt.data_ptr())


def paged_flash_decode(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       ptab: torch.Tensor, kv_len: torch.Tensor,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, H, D); kp, vp (P, page, Hkv, D), page a power of two; ptab
    (B, n_ptab) int32; kv_len (B,) int32 — all contiguous on one CUDA
    device, q/kp/vp of one dtype (f32 or bf16), D in :data:`HEAD_DIMS`,
    H/Hkv ≤ 16.  Returns (B, H, D) in q's dtype."""
    global launches
    code, B, H, Hkv = _checked("paged_flash_decode", q, kp, vp, (ptab, kv_len))
    page = kp.shape[1]
    if ptab.dim() != 2 or ptab.shape[0] != B or tuple(kv_len.shape) != (B,):
        raise ValueError(f"paged_flash_decode kernel: inconsistent shapes q "
                         f"{tuple(q.shape)} ptab {tuple(ptab.shape)} kv_len "
                         f"{tuple(kv_len.shape)}")
    if page < 1 or page & (page - 1):
        raise ValueError(f"paged_flash_decode kernel: page size {page} is not "
                         f"a power of two")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_ptab = ptab.shape[1]
    stream = build.stream(q)
    tgt, n_cap, grid, part, parts = _scratch(q, B, H, Hkv, n_ptab * page, stream)
    lib, fn = _fn or _launcher()
    rec = telemetry.REC
    if rec is not None:
        span = rec.begin("kernel.launch", attrs=_SPAN_ATTRS)
    err = fn(code, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ptab.data_ptr(),
             kv_len.data_ptr(), out.data_ptr(), *parts, B, H, Hkv, q.shape[2],
             page.bit_length() - 1, n_ptab, -1 if window is None else int(window),
             1.0 / math.sqrt(q.shape[2]), 0.0 if softcap is None else float(softcap), tgt, n_cap, grid, stream)
    if rec is not None:
        rec.end(span)
    if err:
        build.check(lib, err, _NAME)
    launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, H, D); k, v (B, S, Hkv, D) un-repeated; kv_len (B,) int32 with
    values ≤ S — contiguous, on one CUDA device, q/k/v of one dtype (f32 or
    bf16), D in :data:`HEAD_DIMS`, H/Hkv ≤ 16.  Returns (B, H, D) in q's
    dtype; zeros for a lane with ``kv_len = 0``."""
    global contig_launches
    code, B, H, Hkv = _checked("flash_decode", q, k, v, (kv_len,))
    if k.shape[0] != B or tuple(kv_len.shape) != (B,):
        raise ValueError(f"flash_decode kernel: inconsistent shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} kv_len "
                         f"{tuple(kv_len.shape)}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    S = k.shape[1]
    stream = build.stream(q)
    tgt, n_cap, grid, part, parts = _scratch(q, B, H, Hkv, S, stream)
    lib, fn = _contig_fn or _contig_launcher()
    rec = telemetry.REC
    if rec is not None:
        span = rec.begin("kernel.launch", attrs=_CONTIG_SPAN_ATTRS)
    err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             out.data_ptr(), *parts, B, H, Hkv, q.shape[2], S,
             1.0 / math.sqrt(q.shape[2]), 0.0 if softcap is None else float(softcap), tgt, n_cap, grid, stream)
    if rec is not None:
        rec.end(span)
    if err:
        build.check(lib, err, "flash_decode")
    contig_launches += 1
    return out

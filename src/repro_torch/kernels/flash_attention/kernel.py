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

Bound on the card: operations at long sequences (whisper's encoder),
bytes at the serving chunks (each live K/V element is read once for its
GQA group); at the paths' 64-token chunks the time is latency: a block's
chain of tile steps plus its fixed cost, and how many blocks have work.
Design (``csrc/flash_attention.cu``): bf16 is a warp-specialised Hopper
kernel, a producer warp streaming 64-key K/V tiles by TMA (a ``cp.async``
gather for a tile that crosses ``kv_len`` and for page tables of pages
under 8 rows) into a ring of swizzled shared-memory stages under mbarriers,
and one or two consumer warpgroups of 64 flattened (query, head-in-group)
rows of one KV head (:func:`launch_plan`: two when a KV head has more than
64 rows), each running S = Q·Kᵀ as a ``wgmma`` from shared memory and O +=
P·V as a ``wgmma`` with P from registers in bf16 hi and lo halves, softmax
and masks in f32.  Two consumers split rows (128-row blocks) or, for a
latency-bound launch, keys (:func:`block_plan`, which the card decides from
``kv_len``).  f32 runs on the CUDA cores (its 2e-5 tolerance rules out
TF32), 64 rows a block.  Head dims 64, 112 (zamba2), 128 and 256 (gemma2).
A key split across blocks fills the card when few lanes have work: every
block computes the same plan from ``kv_len`` on the card
(``csrc/common.cuh``, shared with flash-decode, here under ``kAttention``;
:mod:`repro_torch.kernels.split_plan` mirrors it), splits write partial
(m, l, acc) rows in f32 to scratch allocated here, and the last split of a
(row block, KV head) to arrive merges them and writes the rows, so a call
is one launch and one count in ``launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch import telemetry
from repro_torch.kernels import build
from repro_torch.kernels import split_plan as plan
from repro_torch.kernels.split_plan import TILE, lane_tiles  # noqa: F401

launches = 0          # kernel launches since the last reset (main-path check)

_NAME = "flash_attention"
_SPAN_ATTRS = {"kernel": _NAME}     # a kernel.launch span's attributes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 112, 128, 256)
WG_ROWS = 64          # rows of a bf16 consumer warpgroup (wgmma M); an f32 block's rows
# blocks an SM: bf16 blocks of 384 threads at 168 registers (the source's
# __launch_bounds__(kTcThreads, 1)) fill the register file alone; f32
# blocks of 128 threads fit two
BLOCKS_PER_SM = {torch.bfloat16: 1, torch.float32: plan.MAX_BLOCKS}
MAX_SPLITS = 16       # most splits of a lane (csrc kMaxSplits): the last split of
                      # a pair merges them all, weights in shared memory
KEY_SPLIT_MIN_PER = 2  # a key split's fewest tiles a split (csrc kKeySplitMinPer)
_fn = None
_counters = {}        # (device, stream) -> zeroed int32 arrival counters


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load(_NAME)
        fn = lib.flash_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


@functools.cache
def smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory per block of the kernel, as the CUDA source
    lays it out (builds the library)."""
    lib, _ = _launcher()
    return int(lib.flash_attention_smem_bytes(_DTYPE_CODE[dtype], head_dim))


class LaunchPlan(NamedTuple):
    consumers: int    # bf16 consumer warpgroups a block (f32: 1, unused)
    pairs: int        # (row block, KV head) pairs a lane at 64-row blocks (the most)
    target: int       # blocks the card's plan aims at
    grid: int         # the host's bound on work items
    n_cap: int        # most splits of a lane; 1: no split, no scratch
    rows: int         # rows of a scratch slot: the largest block


def launch_plan(dtype: torch.dtype, n_sm: int, smem: int, B: int, Sq: int,
                H: int, Hkv: int, Sk: int) -> LaunchPlan:
    """The host's part of the split plan for a launch on ``n_sm`` SMs of a
    body of ``smem`` bytes a block: what sizes the grid (at the most pairs:
    64-row blocks), the scratch (``grid·rows`` partial rows) and the
    counters (``B·pairs``).  The card picks the bf16 blocks' rows itself
    (:func:`block_plan`)."""
    rows = Sq * (H // Hkv)
    pairs = -(-rows // WG_ROWS) * Hkv
    tgt = plan.target(n_sm, smem, BLOCKS_PER_SM[dtype])
    consumers = 2 if dtype == torch.bfloat16 and rows > WG_ROWS else 1
    big = consumers * WG_ROWS
    n_cap = min(plan.max_splits(-(-rows // big) * Hkv, Sk, tgt), MAX_SPLITS)
    return LaunchPlan(consumers, pairs, tgt, plan.grid_bound(pairs, B, tgt), n_cap, big)


class BlockPlan(NamedTuple):
    rows: int         # rows a block
    key_split: bool   # the two consumer warpgroups take alternate tiles
    pairs: int        # (row block, KV head) pairs a lane
    min_per: int      # fewest tiles a split takes


def block_plan(dtype: torch.dtype, Sq: int, H: int, Hkv: int,
               lane_tiles, target: int, consumers: int = 2) -> BlockPlan:
    """The blocks the card picks from ``kv_len`` (``key_split`` and
    ``plan_item`` in ``csrc/flash_attention.cu``), given each lane's live
    tiles and the launch's ``consumers`` (:func:`launch_plan`).  A bf16
    launch of two consumer warpgroups splits keys, 64-row blocks whose two
    warpgroups take alternate tiles (each split at least
    :data:`KEY_SPLIT_MIN_PER`), when 128-row blocks would visit at most
    ``target`` tiles in all; else it splits rows, 128-row blocks.  One
    consumer (bf16) and f32: 64-row blocks."""
    rows = Sq * (H // Hkv)
    if dtype != torch.bfloat16 or consumers < 2:
        return BlockPlan(WG_ROWS, False, -(-rows // WG_ROWS) * Hkv, 1)
    ks = -(-rows // (2 * WG_ROWS)) * Hkv * sum(lane_tiles) <= target
    r = WG_ROWS if ks else 2 * WG_ROWS
    return BlockPlan(r, ks, -(-rows // r) * Hkv, KEY_SPLIT_MIN_PER if ks else 1)


def _scratch(q: torch.Tensor, lp: LaunchPlan, B: int, D: int, stream: int):
    """Pointers (part_acc, part_ml, counters) for a launch that may split:
    partial acc [grid][rows][D] then (m, l) [grid][rows][2] in f32, and the
    arrival counters of the B·pairs (lane, row block, KV head) pairs.  The
    kernel leaves every counter at 0, so they are zeroed once, when
    allocated, and shared by the calls on the stream."""
    if lp.n_cap <= 1:
        return (None, None, None), None
    dev = q.get_device()
    cnt = _counters.get((dev, stream))      # the default stream is 0 on every device
    if cnt is None or cnt.numel() < B * lp.pairs:
        cnt = _counters[dev, stream] = torch.zeros((max(B * lp.pairs, 256),),
                                                   dtype=torch.int32, device=q.device)
    n = lp.grid * lp.rows
    part = torch.empty((n * (D + 2),), dtype=torch.float32, device=q.device)
    return (part.data_ptr(), part.data_ptr() + n * D * 4, cnt.data_ptr()), part


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
    lp = launch_plan(dt, build.sm_count(dev), smem_bytes(dt, D), B, Sq, H, Hkv, Sk)
    stream = build.stream(q)
    parts, _scratch_buf = _scratch(q, lp, B, D, stream)
    lib, fn = _fn or _launcher()
    rec = telemetry.REC
    if rec is not None:
        span = rec.begin("kernel.launch", attrs=_SPAN_ATTRS)
    err = fn(code, *ptrs, None if ptab is None else ptab.data_ptr(),
             kv_len.data_ptr(), out.data_ptr(), *parts, B, Sq, Sk, H, Hkv, D,
             shift, n_ptab, ks[0] * ks[1], int(causal),
             -1 if window is None else int(window),
             0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(D),
             lp.consumers, lp.target, lp.n_cap, lp.grid, stream)
    if rec is not None:
        rec.end(span)
    if err:
        build.check(lib, err, _NAME)
    launches += 1
    return out

"""The split plan of the attention kernels, mirrored on the host (no
counterpart in ``src/repro/``).

``csrc/common.cuh`` computes the plan on the card: every block of the
flash-attention and flash-decode split kernels reads ``kv_len`` and finds
its work item, so no length crosses to the host.  This mirror gives the
wrappers the grid bound (and so the scratch size) and gives
``chip_smoke.py`` and the tests the plan itself.

A lane with ``kv_len`` keys has ``T`` live tiles of ``TILE`` keys
(:func:`lane_tiles`).  With ``pairs`` (row block, KV head) pairs per lane,
``target`` blocks (:func:`target`: one wave, from the kernel's shared
memory and its blocks an SM) and at most ``n_cap`` splits a lane, ``per =
max(min_per, ⌈pairs·ΣT / target⌉, ⌈max T / n_cap⌉)`` tiles per split, and lane b gives
each pair ``⌈T_b / per⌉`` splits (:func:`split_plan`), which share its tiles
evenly (:func:`split_tiles`).  Items are numbered lane
by lane; a pair of an idle lane still gets one item, so a launch has at
most :func:`grid_bound` items.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

TILE = 64             # keys per tile, the plan's unit
SMEM_PER_SM = 233_472  # H100 (sm_90): 228 KiB of shared memory an SM
SMEM_RESERVED = 1_024  # the runtime's shared memory reserved per block
MAX_BLOCKS = 2         # 128 threads of up to 255 registers: two blocks
                       # fill the 64 Ki-register file (the decode kernels and
                       # flash attention's f32 body)


def target(n_sm: int, smem: int, max_blocks: int = MAX_BLOCKS) -> int:
    """Blocks the plan aims at, one wave on a card of ``n_sm`` SMs, for a
    kernel of ``smem`` bytes of dynamic shared memory a block: as many
    blocks as fit an SM by shared memory, at most ``max_blocks`` (what the
    kernel's threads and registers allow an SM), at least one."""
    fit = SMEM_PER_SM // (smem + SMEM_RESERVED)
    return n_sm * max(1, min(max_blocks, fit))


def lane_keys(kv_len: int, Sq: int, Sk: int,
              window: Optional[int]) -> Tuple[int, int]:
    """Keys ``[lo, hi)`` that some query of a lane may see: below
    ``min(kv_len, Sk)``; with a window, not below the first query's reach
    (its Sq queries sit at positions ``kv_len − Sq … kv_len − 1``; causal or
    not, the last one sees up to ``kv_len − 1``)."""
    hi = min(kv_len, Sk)
    lo = max(0, kv_len - Sq - window + 1) if window else 0
    return lo, hi


def lane_tiles(kv_len: int, Sq: int, Sk: int, window: Optional[int]) -> int:
    """Tiles of TILE keys that hold a key of :func:`lane_keys`."""
    lo, hi = lane_keys(kv_len, Sq, Sk, window)
    return -(-hi // TILE) - lo // TILE if hi > lo else 0


def max_splits(pairs: int, Sk: int, target: int) -> int:
    """The most splits a lane needs: ``pairs`` times it stays near
    ``target``, and it never exceeds the tiles of ``Sk`` keys.  1 means no
    lane splits and no combine runs."""
    return max(1, min(-(-Sk // TILE), -(-target // pairs)))


def split_plan(pairs: int, lane_tiles: Sequence[int], target: int,
               n_cap: Optional[int] = None, min_per: int = 1,
               one_wave: bool = False) -> Tuple[int, List[int]]:
    """(tiles per split, splits of each lane): ``per = max(min_per, ⌈pairs·ΣT /
    target⌉, ⌈max T / n_cap⌉)`` and ``⌈T_b / per⌉`` splits for each pair of
    lane b, so at most ``n_cap`` (default ⌈target / pairs⌉, which the second
    term already keeps to; ``n_cap = 1``: no split, 1 for a lane with
    work).  ``min_per`` is 1 but for flash attention's key split (2: a tile
    for each of a block's two consumer warpgroups).  ``one_wave`` (flash
    attention): ``per`` then rises until the items with tiles, ``pairs·Σ
    ⌈T_b / per⌉``, fit ``target``, where ``pairs`` × the busy lanes do.
    Mirrors ``plan_per``/``lane_splits`` in ``csrc/common.cuh`` (``min_per``
    and ``one_wave``: its ``kAttention``)."""
    if n_cap is None:
        n_cap = -(-target // pairs)
    most = max(lane_tiles, default=0)
    per = max(min_per, -(-pairs * sum(lane_tiles) // target), -(-most // n_cap))
    if one_wave and pairs * sum(t > 0 for t in lane_tiles) <= target:
        while per < most and pairs * sum(-(-t // per) for t in lane_tiles) > target:
            per += 1
    return per, [-(-t // per) for t in lane_tiles]


def split_tiles(tiles: int, n: int) -> List[Tuple[int, int]]:
    """Tiles ``[begin, end)`` of each of a pair's ``n`` splits, counted
    from its first live tile (``split_tiles`` in ``csrc/common.cuh``)."""
    if n <= 1:
        return [(0, tiles)]
    q = -(-tiles // n)
    return [(s * q, min(tiles, (s + 1) * q)) for s in range(n)]


def work_items(pairs: int, splits: Sequence[int]) -> int:
    """Items of a launch: one per split, one for each pair of an idle lane."""
    return pairs * sum(max(n, 1) for n in splits)


def grid_bound(pairs: int, B: int, target: int) -> int:
    """The host's grid: ``target + pairs·B`` holds every item, since
    ``per ≥ pairs·ΣT / target``."""
    return target + pairs * B

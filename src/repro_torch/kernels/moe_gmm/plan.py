"""The tile plans of the grouped SwiGLU's bf16 bodies, mirrored on the host
(no counterpart in ``src/repro/``).

``csrc/moe_gmm.cu`` (namespace ``tc``) runs bf16 calls with C > 32 as two
persistent passes: gate/up writes ``H`` (E, C, F) in pair tiles of 128
columns of F, down writes ``y`` (E, C, D) in pair tiles of 256 columns of
D.  Blocks run in clusters of two, each cluster computing one pair tile at
a time in one of two shapes (:func:`shape`):

* token pairs (C > 192): each block owns 128 token rows (two consumer
  warpgroups of 64), block ``rank`` token tile ``2·mp + rank``, and the
  blocks share the stage's weights (each loads half, multicast to both);
* column pairs (C ≤ 192): each block owns all the token rows (three
  warpgroups) and half of the tile's columns, and the blocks share the
  stage's token rows.

A 64-row part that lies wholly past C is idle (:func:`live_warpgroups`),
so no tile computes more than 63 rows past C (:func:`rows_computed`).  Pair
tile ``p = (e·NT + n)·MP + mp`` (:func:`pair_of`; MP = 1 for column pairs),
so the pairs that share one weight tile are neighbours; cluster ``c`` of
``G = min(pairs, resident)`` takes pair ``c`` of each even round of G pairs
and ``G − 1 − c`` of each odd one (:func:`tile_at`, :func:`cluster_pairs`).

Decode (C ≤ 32) runs the swapped product ``out^T = W^T x^T`` (``dec``):
one tile per (expert, DEC_COLS output columns), taken by block ``b`` of
``min(tiles, SMs)`` as ``b, b + grid, …`` (:func:`decode_tiles`,
:func:`decode_smem`).  This mirror gives ``chip_smoke.py`` the plan it
prints and the tests the properties they hold.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

WG_ROWS = 64                  # token rows of one consumer warpgroup (wgmma M)
BK = 64                       # reduction depth of one ring stage
WN = 128                      # columns of a weight tile, of an epilogue round
CLUSTER = 2                   # blocks per cluster
COLS = {"gate_up": WN, "down": 2 * WN}   # output columns of a pair tile
# (consumer warpgroups a block, weight boxes of 64 columns a stage)
SHAPES = {"token_pairs": (2, 4), "column_pairs": (3, 2)}
SMEM_MAX = 232448             # dynamic shared memory a block may use (H100)
TC_MIN_C = 33                 # C ≤ 32 (decode) takes the swapped body
DEC_TOK = 32                  # decode: token columns of the swapped product
DEC_COLS = 128                # decode: output columns of a tile


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def shape(C: int) -> str:
    """The cluster shape at C (``tc::splits_columns``)."""
    return "column_pairs" if C <= 192 else "token_pairs"


def live_warpgroups(rows_left: int, wg: int) -> int:
    """Consumer warpgroups (of ``wg``) that compute a block's tile with
    ``rows_left`` token rows from its first to C (``tc::live_warpgroups``)."""
    return 0 if rows_left <= 0 else min(wg, cdiv(rows_left, WG_ROWS))


def rows_computed(C: int) -> List[int]:
    """Token rows that each token tile of a pass computes (column pairs: one
    tile of all the rows, computed by both blocks for their columns)."""
    wg, _ = SHAPES[shape(C)]
    if shape(C) == "column_pairs":
        return [WG_ROWS * live_warpgroups(C, wg)]
    return [WG_ROWS * live_warpgroups(C - m * WG_ROWS * wg, wg)
            for m in range(cdiv(C, WG_ROWS * wg))]


def pass_shape(E: int, C: int, N: int, which: str) -> Tuple[int, int, int]:
    """(experts, column tiles, pair tiles per column tile) of pass
    ``which`` over N output columns (F for gate/up, D for down)."""
    mt = len(rows_computed(C))
    mp = 1 if shape(C) == "column_pairs" else cdiv(mt, CLUSTER)
    return E, cdiv(N, COLS[which]), mp


def pair_of(p: int, MP: int, NT: int) -> Tuple[int, int, int]:
    """(expert, column tile, pair index) of pair tile ``p`` (``tc::pair_of``)."""
    return p // (MP * NT), (p // MP) % NT, p % MP


def tile_at(r: int, c: int, G: int) -> int:
    """The pair tile cluster ``c`` of G computes in its round ``r``: rounds
    run forward and backward in turn, so pairs of unequal size are shared
    out evenly (``tc::tile_at``)."""
    return r * G + (G - 1 - c if r % 2 else c)


def clusters(pairs: int, resident: int) -> int:
    """Clusters of a pass: as many as pair tiles, no more than fit at once."""
    return min(pairs, resident)


def cluster_pairs(c: int, pairs: int, G: int) -> List[int]:
    """Pair tiles of cluster ``c``, in the order it computes them."""
    out = []
    while (p := tile_at(len(out), c, G)) < pairs:
        out.append(p)
    return out


def smem(name: str) -> Dict[str, int]:
    """Shared-memory layout of a prefill block of cluster shape ``name``
    (``tc::Shape``): bytes of a ring stage (64-row token boxes, one per
    warpgroup, and the weight boxes), stages, staging for the output tile
    (64 rows × 128 columns per consumer warpgroup), and the total with 1024
    bytes of alignment slack and 256 of barriers.  Gate/up and down share
    it."""
    wg, boxes = SHAPES[name]
    box = 64 * BK * 2
    stage = (wg + boxes) * box
    epi = wg * WG_ROWS * WN * 2
    stages = (SMEM_MAX - 1024 - 256 - epi) // stage
    return dict(stage=stage, stages=stages, epi=epi,
                total=1024 + stages * stage + epi + 256)


def describe(E: int, C: int, D: int, F: int, resident: Dict[str, int]) -> str:
    """One line for a log: cluster shape, token tiles, pair tiles and
    clusters of both passes (``resident``: clusters that fit at once)."""
    name = shape(C)
    rows = rows_computed(C)
    parts = []
    for which, N in (("gate_up", F), ("down", D)):
        e, nt, mp = pass_shape(E, C, N, which)
        pairs = e * nt * mp
        parts.append(f"{which} {pairs} pair tiles ({e}×{nt}×{mp} of "
                     f"{COLS[which]} columns) on {clusters(pairs, resident[which])} "
                     f"clusters of {CLUSTER} ({resident[which]} fit at once)")
    lay = smem(name)
    return (f"{name}: token tiles of {rows} rows ({sum(rows) - C} past C); "
            + "; ".join(parts) + f"; {lay['stages']} stages of {lay['stage']:,} B")


def decode_tiles(E: int, N: int) -> int:
    """Tiles of a decode pass over N output columns (``dec``)."""
    return E * cdiv(N, DEC_COLS)


def decode_smem(nmat: int) -> Dict[str, int]:
    """Shared-memory layout of a decode block (``dec::Ring``): a stage holds
    DEC_TOK token rows and ``nmat`` weight tiles of BK × DEC_COLS; as many
    stages as fit."""
    stage = DEC_TOK * BK * 2 + nmat * BK * DEC_COLS * 2
    stages = (SMEM_MAX - 1024 - 256) // stage
    return dict(stage=stage, stages=stages, total=1024 + stages * stage + 256)


def describe_decode(E: int, D: int, F: int, sms: int) -> str:
    """One line for a log: tiles, grid and ring of both decode passes."""
    parts = []
    for which, N, nmat in (("gate_up", F, 2), ("down", D, 1)):
        tiles = decode_tiles(E, N)
        lay = decode_smem(nmat)
        parts.append(f"{which} {tiles} tiles of {DEC_COLS} columns on "
                     f"{min(tiles, sms)} blocks, {lay['stages']} stages of "
                     f"{lay['stage']:,} B")
    return "swapped product, " + "; ".join(parts)

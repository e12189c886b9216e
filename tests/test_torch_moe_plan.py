"""The tile plans of ``moe_gmm``'s bf16 bodies, as ``kernels/moe_gmm/plan.py``
mirrors them from ``csrc/moe_gmm.cu``: the prefill body (C > 32) computes
every (token tile, column) once in clusters of two blocks, the pair tiles
of one weight tile neighbours in the order and clusters sharing the work
evenly, at most 63 rows past C; the decode body covers every column once;
every block's shared memory within the card's limit; and the mirror's
constants and thresholds the same as the source's."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.moe_gmm import kernel as moe_kernel
from repro_torch.kernels.moe_gmm import plan

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "moe_gmm.cu").read_text()
# (E, D, F): ragged widths (multiples of 64, not of the 128/256-column
# tiles) and mixtral-8x7b's
WIDTHS = ((2, 192, 320), (8, 4096, 14336))


def _block_work(C, e, n, q, rank, which):
    """(expert, token tile, first output column) of block ``rank`` of pair
    ``q`` of column tile ``n``, or None when it has no rows before C."""
    wg, _ = plan.SHAPES[plan.shape(C)]
    if plan.shape(C) == "column_pairs":
        half = plan.COLS[which] // plan.CLUSTER
        return e, 0, n * plan.COLS[which] + rank * half
    m = plan.CLUSTER * q + rank
    return (e, m, n * plan.COLS[which]) if m * plan.WG_ROWS * wg < C else None


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("which", sorted(plan.COLS))
def test_every_tile_once_and_pairs_of_a_weight_tile_adjacent(sms, which):
    """At most ``sms // 2`` clusters fit at once (the card may hold fewer;
    any number works).  C ≤ 32 takes the decode body; the prefill plan's
    properties hold there too."""
    resident = max(1, sms // plan.CLUSTER)
    for E, D, F in WIDTHS:
        N = F if which == "gate_up" else D
        for C in range(1, 601):
            e_, nt, mp = plan.pass_shape(E, C, N, which)
            pairs = e_ * nt * mp
            G = plan.clusters(pairs, resident)
            assert 1 <= G <= resident
            order = [p for c in range(G) for p in plan.cluster_pairs(c, pairs, G)]
            assert sorted(order) == list(range(pairs))
            work = [_block_work(C, *plan.pair_of(p, mp, nt), rank, which)
                    for p in range(pairs) for rank in range(plan.CLUSTER)]
            live = [w for w in work if w is not None]
            mt = len(plan.rows_computed(C))
            cols = plan.CLUSTER if plan.shape(C) == "column_pairs" else 1
            assert len(set(live)) == len(live) == e_ * nt * mt * cols
            # the pairs of one (expert, column tile) are consecutive
            first = {}
            for p in range(pairs):
                e, n, q = plan.pair_of(p, mp, nt)
                first.setdefault((e, n), p)
                assert p == first[(e, n)] + q
            # the column tiles cover N, the last one reaching past it by
            # less than one tile
            assert 0 <= nt * plan.COLS[which] - N < plan.COLS[which]


def test_token_tiles_compute_at_most_63_rows_past_c():
    assert [plan.live_warpgroups(n, 2) for n in (-64, 0, 1, 64, 65, 128, 500)] == [
        0, 0, 1, 1, 2, 2, 2]
    assert [plan.live_warpgroups(n, 3) for n in (0, 64, 65, 129, 192, 500)] == [
        0, 1, 2, 3, 3, 3]
    for C in range(1, 601):
        rows = plan.rows_computed(C)
        assert all(r == rows[0] for r in rows[:-1])
        assert 0 <= sum(rows) - C <= 63
    # C 160: one tile of 192 rows (three warpgroups) per block, each block
    # half of the columns, where token pairs would leave one block half
    # idle; C 512: four full 128-row tiles in two pairs
    assert plan.shape(160) == "column_pairs" and plan.rows_computed(160) == [192]
    assert plan.shape(512) == "token_pairs" and plan.rows_computed(512) == [128] * 4
    assert [plan.shape(C) for C in (33, 192, 193)] == [
        "column_pairs", "column_pairs", "token_pairs"]


def test_smem_of_every_configuration_fits_a_block():
    for name in plan.SHAPES:
        lay = plan.smem(name)
        assert lay["stages"] >= 4
        assert lay["total"] <= plan.SMEM_MAX == 232448
        assert lay["stage"] % 1024 == 0 and lay["epi"] % 1024 == 0
    for nmat, which in ((2, "gate_up"), (1, "down")):
        lay = plan.decode_smem(nmat)
        assert lay["stages"] >= 4 and lay["stage"] % 1024 == 0
        assert moe_kernel.smem_bytes(torch.bfloat16, 8, which) == lay["total"] <= 232448
    for dtype in (torch.bfloat16, torch.float32):
        for C in (1, 3, 8, 32, 33, 63, 65, 130, 160, 200, 512, 600):
            for which in ("gate_up", "down"):
                assert 0 < moe_kernel.smem_bytes(dtype, C, which) <= 232448
    assert moe_kernel.smem_bytes(torch.bfloat16, 512, "down") == plan.smem("token_pairs")["total"]
    assert moe_kernel.smem_bytes(torch.bfloat16, 160, "down") == plan.smem("column_pairs")["total"]


def test_plan_mirrors_the_cuda_source():
    """The mirror's constants and C thresholds are the source's; the plan's
    arithmetic is held by the property tests here and on the card by
    ``chip_smoke.py``'s ragged shapes."""
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE))
    assert int(consts["kWgRows"]) == plan.WG_ROWS
    assert int(consts["kBK"]) == plan.BK
    assert int(consts["kWN"]) == plan.WN
    assert int(consts["kSmemMax"]) == plan.SMEM_MAX
    assert int(consts["kCluster"]) == plan.CLUSTER
    assert int(consts["kTok"]) == plan.DEC_TOK
    assert int(consts["kTileCols"]) == plan.DEC_COLS
    # (consumer warpgroups, weight boxes) with COLUMNS true / false
    wg, boxes = (tuple(map(int, re.search(
        rf"constexpr int {k} = COLUMNS \? (\d+) : (\d+);", SOURCE).groups()))
        for k in ("kWG", "kBBoxes"))
    assert plan.SHAPES == {"column_pairs": (wg[0], boxes[0]), "token_pairs": (wg[1], boxes[1])}
    assert int(re.search(r"if \(C <= (\d+)\) return dec::run", SOURCE).group(1)) == \
        plan.TC_MIN_C - 1
    split = int(re.search(r"splits_columns\(int C\) \{ return C <= (\d+); \}", SOURCE).group(1))
    assert plan.shape(split) == "column_pairs" and plan.shape(split + 1) == "token_pairs"
    assert [plan.tile_at(r, 1, 4) for r in range(4)] == [1, 6, 9, 14]


@pytest.mark.parametrize("C", [130, 160, 200, 320, 512])
def test_clusters_share_uneven_pair_tiles_evenly(C):
    """At mixtral's widths on 66 clusters no cluster computes more than one
    pair tile of rows beyond the mean share (with an odd number of token
    tiles the last pair of each weight tile has one idle block)."""
    wg, _ = plan.SHAPES[plan.shape(C)]
    for which, N in (("gate_up", 14336), ("down", 4096)):
        e, nt, mp = plan.pass_shape(8, C, N, which)
        pairs = e * nt * mp
        G = plan.clusters(pairs, 66)
        rows = plan.rows_computed(C)
        if plan.shape(C) == "column_pairs":     # both blocks compute every row
            pair_rows = [plan.CLUSTER * rows[0]]
        else:
            rows += [0] * (plan.CLUSTER * mp - len(rows))
            pair_rows = [sum(rows[plan.CLUSTER * q:plan.CLUSTER * (q + 1)]) for q in range(mp)]
        work = [sum(pair_rows[p % mp] for p in plan.cluster_pairs(c, pairs, G))
                for c in range(G)]
        assert sum(work) == e * nt * sum(pair_rows)
        assert max(work) <= sum(work) / G + plan.CLUSTER * plan.WG_ROWS * wg


def test_decode_plan_covers_every_column_once():
    for E, D, F in WIDTHS:
        for N in (D, F):
            assert plan.decode_tiles(E, N) == E * plan.cdiv(N, plan.DEC_COLS)
            assert 0 <= plan.cdiv(N, plan.DEC_COLS) * plan.DEC_COLS - N < plan.DEC_COLS
    assert plan.decode_tiles(8, 14336) == 896 and plan.decode_tiles(8, 4096) == 256

"""The work formulas against sums by hand at the two configurations'
published widths."""
import pytest

import harness
import work


def shapes(cell):
    c = harness.cell_files(cell)[1]
    fam = harness.family(c)
    return c, fam.dims(c), fam.layer_params(c)


def test_mixtral_counts_by_hand():
    c, dims, layer = shapes("mixtral.chat")
    attn = 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096
    expert = 3 * 4096 * 14336
    assert layer == {"attn": attn, "ffn_active": 4096 * 8 + 2 * expert, "expert": expert}
    assert work.token_flops(layer, dims, 0) == 2 * 8 * (41_943_040 + 352_354_304)
    assert work.token_flops(layer, dims, 100) - work.token_flops(layer, dims, 0) \
        == 8 * 2 * 32 * 100 * (128 + 128)
    assert work.head_flops(dims) == 2 * 4096 * 32000
    total = sum(sum(__import__("math").prod(s) for _, s, _, _ in g)
                for g in harness.family(c).param_groups(c))
    assert total == 8 * (attn + 4096 * 8 + 8 * expert + 2 * 4096) + 2 * 32000 * 4096 + 4096
    assert round(total / 1e9, 2) == 11.87


def test_minicpm3_counts_by_hand():
    c, dims, layer = shapes("minicpm3.docqa")
    attn = (2560 * 768 + 768 * 40 * 96 + 2560 * 288 + 2 * 256 * 40 * 64 + 40 * 64 * 2560)
    assert attn == 13_516_800
    assert layer == {"attn": attn, "ffn_active": 49_152_000, "expert": 0}
    assert work.token_flops(layer, dims, 0) == 2 * 62 * 62_668_800
    assert work.token_flops(layer, dims, 10) - work.token_flops(layer, dims, 0) \
        == 62 * 2 * 40 * 10 * (96 + 64)
    total = sum(sum(__import__("math").prod(s) for _, s, _, _ in g)
                for g in harness.family(c).param_groups(c))
    assert round(total / 1e9, 2) == 4.07


@pytest.mark.parametrize("cell", ["mixtral.chat", "minicpm3.docqa"])
def test_prefill_is_the_sum_of_its_tokens(cell):
    _, dims, layer = shapes(cell)
    direct = sum(work.token_flops(layer, dims, p + 1) for p in range(40, 104))
    assert work.prefill_flops(layer, dims, 40, 104) == pytest.approx(
        direct + work.head_flops(dims), rel=1e-12)


def test_moe_and_decode_bounds():
    _, dims, layer = shapes("mixtral.chat")
    assert work.experts_touched(dims, 1) == pytest.approx(2.0)
    assert work.experts_touched(dims, 10_000) == pytest.approx(8.0)
    one = work.moe_step_bound_s(layer, dims, 1)
    assert one == pytest.approx(8 * (2 * layer["expert"] * 2 + 2 * 4096 * 2) / 3.35e12)
    assert work.decode_attn_bound_s(dims, [1000]) == pytest.approx(
        8 * (1000 * 2 * 8 * 128 * 2 + 32 * 256 * 2) / 3.35e12)
    assert work.PEAKS["bf16_flops_per_s"] == 989e12

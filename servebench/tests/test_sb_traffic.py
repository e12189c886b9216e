"""The generator: the same seed gives the same requests; every seed sends
the same lengths and gaps, in an order of its own unless the mix pins one,
and with tokens of its own."""
import pytest

import harness
import traffic

CHAT = harness.cell_files("mixtral.chat")[2]
DOCQA = harness.cell_files("minicpm3.docqa")[2]
SEEDS = [0, 2**31 + 5, 3_000_000_019]


def open_items(seed, seconds=20.0):
    return traffic.open_loop(CHAT, seed, seconds, 32000)


def closed_items(seed, n=200):
    s = traffic.closed_stream(DOCQA, seed, 73448)
    return [next(s) for _ in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_is_deterministic_per_seed(seed):
    a, b = open_items(seed), open_items(seed)
    assert [(x.prompt, x.max_new_tokens, x.due_s) for x in a] == \
        [(x.prompt, x.max_new_tokens, x.due_s) for x in b]


def test_open_loop_seeds_share_the_work_not_its_order():
    runs = [open_items(s) for s in SEEDS]
    n = round(CHAT["rate_per_s"] * 20.0)
    for items in runs:
        assert len(items) == n
        assert all(0 < x.due_s < 20.0 for x in items)
        assert all(CHAT["prompt"]["min"] <= len(x.prompt) <= CHAT["prompt"]["max"] for x in items)
    order = lambda items: [(len(x.prompt), x.max_new_tokens, x.due_s) for x in items]
    assert [sorted(len(x.prompt) for x in r) for r in runs] == \
        [sorted(traffic.quantiles(CHAT["prompt"], n).tolist())] * 3
    assert [sorted(x.max_new_tokens for x in r) for r in runs] == \
        [sorted(traffic.quantiles(CHAT["output"], n).tolist())] * 3
    assert runs[0][0].prompt[:8] != runs[1][0].prompt[:8]
    assert order(runs[0]) == order(runs[1]) == order(runs[2])     # chat pins its order
    free = {k: v for k, v in CHAT.items() if k != "schedule_seed"}
    drawn = [traffic.open_loop(free, s, 20.0, 32000) for s in SEEDS]
    assert len({repr(order(r)) for r in drawn}) == 3
    for size in (lambda x: len(x.prompt), lambda x: x.max_new_tokens):
        assert [sorted(map(size, r)) for r in drawn] == [sorted(map(size, runs[0]))] * 3
    assert order(traffic.open_loop(free, CHAT["schedule_seed"], 20.0, 32000)) == order(runs[0])


def test_open_loop_gaps_are_the_same_multiset_for_every_seed():
    n = round(CHAT["rate_per_s"] * 20.0)
    spans = [[x.due_s for x in open_items(s)] for s in SEEDS]
    deltas = [sorted(round(b - a, 6) for a, b in zip([0.0] + t, t)) for t in spans]
    assert deltas[0] == deltas[1] == deltas[2] and len(deltas[0]) == n


def test_lognormal_quantiles_have_the_stated_median():
    q = traffic.quantiles(CHAT["prompt"], 1001)
    assert q[500] == CHAT["prompt"]["median"]
    assert q.min() >= CHAT["prompt"]["min"] and q.max() <= CHAT["prompt"]["max"]


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_stream_is_deterministic_and_blocks_share_sizes(seed):
    a, b = closed_items(seed), closed_items(seed)
    assert [(x.prompt, x.max_new_tokens) for x in a] == [(x.prompt, x.max_new_tokens) for x in b]
    blocks = [a[i:i + traffic.BLOCK] for i in (0, traffic.BLOCK)]
    for size in (lambda x: len(x.prompt), lambda x: x.max_new_tokens):
        assert sorted(map(size, blocks[0])) == sorted(map(size, blocks[1]))
    counts = traffic.zipf_counts(4, 1.0, traffic.BLOCK)
    assert [sum(1 for x in blocks[0] if x.doc == k) for k in range(4)] == counts


def test_documents_are_shared_prefixes_and_questions_unique():
    items = closed_items(7)
    docs = traffic.documents(DOCQA, 7, 73448)
    for x in items:
        assert x.prompt[:1024] == docs[x.doc]
        assert DOCQA["question"]["min"] <= len(x.prompt) - 1024 <= DOCQA["question"]["max"]
    assert len({tuple(x.prompt[1024:]) for x in items}) == len(items)


def test_zipf_counts_follow_the_weights():
    assert traffic.zipf_counts(4, 1.0, 64) == [31, 15, 10, 8]


def test_warmup_serves_every_document_once():
    w = traffic.warmup_items(DOCQA, 3, 73448)
    docs = traffic.documents(DOCQA, 3, 73448)
    assert [x.prompt[:1024] for x in w if x.doc >= 0] == docs
    assert 127 in [len(x.prompt) for x in traffic.warmup_items(CHAT, 3, 32000)]


def test_percentile_is_nearest_rank():
    assert traffic.percentile(list(range(1, 101)), 0.95) == 95
    assert traffic.percentile([3.0], 0.95) == 3.0


def test_closed_stream_order_follows_the_seed():
    a, b = closed_items(SEEDS[0], traffic.BLOCK), closed_items(SEEDS[1], traffic.BLOCK)
    for key in (lambda x: len(x.prompt), lambda x: x.max_new_tokens, lambda x: x.doc):
        assert list(map(key, a)) != list(map(key, b))
        assert sorted(map(key, a)) == sorted(map(key, b))

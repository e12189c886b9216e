"""Traffic generation from a mix's data file (``servebench/workloads/<traffic>.json``).

One general generator reads every mix.  Sizes are stratified: a run of N
requests takes the N quantiles ``F^-1((k + 0.5) / N)`` of each length
distribution, and the open loop's N gaps the N quantiles of the exponential,
so every seed sends the same work.  The run's seed draws the order of the
lengths and gaps (which long prompts arrive together), the token ids and the
documents.  A mix file may pin the order with a ``schedule_seed`` of its
own: then every seed replays that one schedule with its own tokens.

* ``open`` loop: N = round(rate x seconds) Poisson arrivals; the N
  exponential-quantile gaps in the schedule's order, scaled so that the last
  request is due before the window closes.
* ``closed`` loop: ``clients`` clients, each sending its next request when
  its answer ends; requests come from an endless stream cut into blocks of 64,
  each block an ordering of the same 64 quantiles.  With ``documents``, each
  prompt is one of a few shared documents (chosen with Zipf weights, in the
  same proportions in every block) followed by a unique question, as
  ``shared_prefix_requests`` in the program's trace module builds them, with
  the lengths drawn instead of fixed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, List, Optional, Sequence

import numpy as np

BLOCK = 64          # closed-loop requests per stratified block


@dataclass
class Item:
    """One request as the generator makes it."""
    prompt: List[int]
    max_new_tokens: int
    due_s: float = 0.0          # open loop: seconds after the window opens
    doc: int = -1               # closed loop with documents: which document


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The n mid-quantiles of a length distribution, rounded and clipped:
    ``lognormal`` (median, sigma) or ``loguniform``, within [min, max]."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        vals = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "loguniform":
        vals = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any seed below 2**63."""
    return np.random.Generator(np.random.PCG64([int(seed) % (1 << 63), stream]))


def tokens(rng: np.random.Generator, n: int, vocab: int) -> List[int]:
    return rng.integers(0, vocab, size=n).tolist()


def open_loop(mix: dict, seed: int, seconds: float, vocab: int) -> List[Item]:
    """Every request due in a window of ``seconds``, in due order."""
    n = max(int(round(mix["rate_per_s"] * seconds)), 1)
    order = mix.get("schedule_seed", seed)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / mix["rate_per_s"]
    gaps = rng_for(order, 1).permutation(gaps)
    gaps *= seconds * (n - 0.5) / n / gaps.sum()
    due = np.cumsum(gaps)
    plen = rng_for(order, 2).permutation(quantiles(mix["prompt"], n))
    olen = rng_for(order, 3).permutation(quantiles(mix["output"], n))
    tok = rng_for(seed, 4)
    return [Item(tokens(tok, int(plen[i]), vocab), int(olen[i]), float(due[i]))
            for i in range(n)]


def zipf_counts(count: int, s: float, total: int) -> List[int]:
    """Integer counts per document summing to ``total``, in proportion to
    Zipf weights 1/k^s (largest remainders)."""
    w = np.array([1.0 / (k + 1) ** s for k in range(count)])
    raw = w / w.sum() * total
    out = np.floor(raw).astype(int)
    for k in np.argsort(-(raw - out))[:total - out.sum()]:
        out[k] += 1
    return out.tolist()


def documents(mix: dict, seed: int, vocab: int) -> List[List[int]]:
    d = mix["documents"]
    rng = rng_for(seed, 5)
    return [tokens(rng, d["length"], vocab) for _ in range(d["count"])]


def closed_stream(mix: dict, seed: int, vocab: int) -> Iterator[Item]:
    """The closed loop's endless request stream, in sending order."""
    docs = documents(mix, seed, vocab) if "documents" in mix else None
    plen_spec = mix["question"] if docs is not None else mix["prompt"]
    plens, olens = quantiles(plen_spec, BLOCK), quantiles(mix["output"], BLOCK)
    doc_ids: Optional[np.ndarray] = None
    if docs is not None:
        d = mix["documents"]
        doc_ids = np.repeat(np.arange(d["count"]),
                            zipf_counts(d["count"], d["zipf_s"], BLOCK))
    perm, tok = rng_for(mix.get("schedule_seed", seed), 6), rng_for(seed, 7)
    while True:
        p, o = perm.permutation(plens), perm.permutation(olens)
        dd = perm.permutation(doc_ids) if doc_ids is not None else None
        for j in range(BLOCK):
            body = tokens(tok, int(p[j]), vocab)
            if dd is None:
                yield Item(body, int(o[j]))
            else:
                yield Item(docs[dd[j]] + body, int(o[j]), doc=int(dd[j]))


def warmup_items(mix: dict, seed: int, vocab: int) -> List[Item]:
    """Set-up's requests: prompts of the mix file's ``warmup_prompts``
    lengths (127 = 64 + 32 + ... + 1 builds every chunk size), and with
    documents one request per document, so the prefix cache holds them."""
    rng = rng_for(seed, 8)
    n_out = mix["warmup_output"]
    items = [Item(tokens(rng, n, vocab), n_out) for n in mix["warmup_prompts"]]
    if "documents" in mix:
        for k, doc in enumerate(documents(mix, seed, vocab)):
            items.append(Item(doc + tokens(rng, mix["question"]["min"], vocab), n_out, doc=k))
    return items


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (rank ceil(q n)) of an unsorted sample; nan
    when empty."""
    if not values:
        return float("nan")
    s = sorted(values)
    return float(s[min(max(math.ceil(q * len(s)) - 1, 0), len(s) - 1)])

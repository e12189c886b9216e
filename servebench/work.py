"""Work formulas: operations and bytes from the published shapes, and the
H100's datasheet peaks (``peaks.json``).  Nothing here reads the program or
a kernel's launch arguments, so a formula counts the same work whatever
implements it.

Useful FLOPs of a token are 2 x the matrix parameters it multiplies by (for
a MoE layer: the router and its top-k experts, not every expert), plus
attention at the context it saw, 2 x heads x context x (d_qk + d_v) a layer;
the head's 2 x d x vocab counts once for each token produced, since logits
are computed only where a token is drawn.  Embedding lookups and norms count
nothing.  After ``RooflineTerms`` and ``model_flops`` of the program's dry
run, with the attention term added.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

BYTES = 2                                    # bf16 weights and caches

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def body_params(layer: dict, dims: dict) -> int:
    """Matrix parameters one token multiplies by below the head."""
    return dims["layers"] * (layer["attn"] + layer["ffn_active"])


def token_flops(layer: dict, dims: dict, ctx: int) -> float:
    """One token through every layer, attending to ``ctx`` keys."""
    attn = 2.0 * dims["heads"] * ctx * (dims["d_qk"] + dims["d_v"])
    return 2.0 * body_params(layer, dims) + dims["layers"] * attn


def head_flops(dims: dict) -> float:
    return 2.0 * dims["d"] * dims["vocab"]


def prefill_flops(layer: dict, dims: dict, start: int, end: int) -> float:
    """Positions ``start .. end-1`` of a prompt, each attending to itself and
    every earlier position, plus the head once (the first token)."""
    n = end - start
    ctx_sum = (start + 1 + end) * n / 2.0
    attn = 2.0 * dims["heads"] * (dims["d_qk"] + dims["d_v"]) * ctx_sum
    return 2.0 * body_params(layer, dims) * n + dims["layers"] * attn + head_flops(dims)


def experts_touched(dims: dict, tokens: int) -> float:
    """Expected distinct experts that ``tokens`` tokens route to, each
    choosing top_k of E uniformly: E (1 - (1 - k/E)^n)."""
    E, k = dims["experts"], dims["top_k"]
    return E * (1.0 - (1.0 - k / E) ** tokens) if E and tokens else 0.0


def moe_step_bound_s(layer: dict, dims: dict, tokens: int) -> float:
    """Least time the expert FFNs of every layer take for one step's live
    tokens: the experts they touch read once, their top-k products."""
    d = dims["d"]
    nbytes = dims["layers"] * (experts_touched(dims, tokens) * layer["expert"] * BYTES
                               + 2 * tokens * d * BYTES)
    flops = dims["layers"] * tokens * dims["top_k"] * 2.0 * layer["expert"]
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / PEAKS["bf16_flops_per_s"])


def kv_bytes_per_token_layer(dims: dict) -> int:
    """Cache bytes one position holds in one layer (GQA: K and V)."""
    return 2 * dims["kv_heads"] * dims["d_qk"] * BYTES


def decode_attn_bound_s(dims: dict, ctxs: Iterable[int]) -> float:
    """Least time one decode step's attention takes over its live lanes,
    lane i reading ``ctxs[i]`` cached positions: every cached K/V byte read
    once, the query read and the output written once."""
    ctxs = list(ctxs)
    H, dq, dv = dims["heads"], dims["d_qk"], dims["d_v"]
    nbytes = dims["layers"] * (sum(ctxs) * kv_bytes_per_token_layer(dims)
                               + len(ctxs) * H * (dq + dv) * BYTES)
    flops = dims["layers"] * 2.0 * H * (dq + dv) * sum(ctxs)
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / PEAKS["bf16_flops_per_s"])

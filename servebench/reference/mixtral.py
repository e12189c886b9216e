"""Plain float32 Mixtral forward (arXiv:2401.04088; the published
``MixtralForCausalLM``): pre-norm layers of grouped-query attention with
rotary embeddings and a top-k router over SwiGLU experts, the top-k weights
renormalised to sum to one.  Full causal attention over each whole sequence;
no cache, no batching.  Layers run one at a time over every sequence, so
only one layer's float32 weights are held.  Departures from the published
description are listed in the configuration file (``departures``)."""
from __future__ import annotations

from typing import List, Sequence

import torch

from reference.common import (GetGroup, causal_attention, embed_tokens,
                              head_logits, rmsnorm, rope, swiglu)


def moe(h: torch.Tensor, W, p: str, top_k: int) -> torch.Tensor:
    probs = torch.softmax(h @ W[p + "ffn.router"], dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(W[p + "ffn.router"].shape[1]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], W[p + "ffn.w_gate"][e], W[p + "ffn.w_up"][e],
                       W[p + "ffn.w_down"][e])
            out.index_add_(0, tok, y * top_p[tok, slot][:, None])
    return out


def layer(x: torch.Tensor, W, p: str, c: dict) -> torch.Tensor:
    H, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    D = c["hidden_size"] // H
    eps, theta = float(c["rms_norm_eps"]), float(c["rope_theta"])
    S = x.shape[0]
    h = rmsnorm(x, W[p + "ln1.scale"], eps)
    q = rope((h @ W[p + "attn.wq"]).view(S, H, D), theta)
    k = rope((h @ W[p + "attn.wk"]).view(S, Hkv, D), theta)
    v = (h @ W[p + "attn.wv"]).view(S, Hkv, D)
    k, v = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
    o = causal_attention(q, k, v, D ** -0.5).reshape(S, H * D)
    x = x + o @ W[p + "attn.wo"]
    h = rmsnorm(x, W[p + "ln2.scale"], eps)
    return x + moe(h, W, p, c["num_experts_per_tok"])


def logits(c: dict, get: GetGroup, seqs: Sequence[Sequence[int]],
           want: Sequence[Sequence[int]], device) -> List[torch.Tensor]:
    """float32 logits (len(want[i]), vocab) of sequence i at positions
    ``want[i]``."""
    top = get(0)
    xs = embed_tokens(top, seqs, device)
    for l in range(c["num_hidden_layers"]):
        W = get(l + 1)
        xs = [layer(x, W, f"layers.{l}.", c) for x in xs]
        del W
    return head_logits(xs, want, top, float(c["rms_norm_eps"]),
                       c["tie_word_embeddings"])

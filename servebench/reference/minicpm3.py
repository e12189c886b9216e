"""Plain float32 MiniCPM3 forward (the published ``MiniCPM3ForCausalLM``
block): pre-norm layers of multi-head latent attention, written out
unabsorbed as published (queries through a low-rank projection; keys and
values expanded per head from a shared latent; a rotary part of the key
shared by every head), and a SwiGLU feed-forward; the head is the
embedding's transpose.  Full causal attention over each whole sequence; no
cache, no batching.  Layers run one at a time over every sequence, so only
one layer's float32 weights are held.  Departures from the published
description are listed in the configuration file (``departures``): among
them, no latent norms and no muP scalings, as the program has none."""
from __future__ import annotations

from typing import List, Sequence

import torch

from reference.common import (GetGroup, causal_attention, embed_tokens,
                              head_logits, rmsnorm, rope, swiglu)


def layer(x: torch.Tensor, W, p: str, c: dict) -> torch.Tensor:
    H, dn, dr = c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    dv, r = c["v_head_dim"], c["kv_lora_rank"]
    eps, theta = float(c["rms_norm_eps"]), float(c["rope_theta"])
    S = x.shape[0]
    h = rmsnorm(x, W[p + "ln1.scale"], eps)
    q = ((h @ W[p + "attn.wq_a"]) @ W[p + "attn.wq_b"]).view(S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], theta)], dim=-1)
    ckv = h @ W[p + "attn.wkv_a"]
    lat, k_rope = ckv[:, :r], rope(ckv[:, r:], theta)
    k_nope = (lat @ W[p + "attn.wk_b"]).view(S, H, dn)
    v = (lat @ W[p + "attn.wv_b"]).view(S, H, dv)
    k = torch.cat([k_nope, k_rope[:, None, :].expand(S, H, dr)], dim=-1)
    o = causal_attention(q, k, v, (dn + dr) ** -0.5).reshape(S, H * dv)
    x = x + o @ W[p + "attn.wo"]
    h = rmsnorm(x, W[p + "ln2.scale"], eps)
    return x + swiglu(h, W[p + "ffn.w_gate"], W[p + "ffn.w_up"], W[p + "ffn.w_down"])


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

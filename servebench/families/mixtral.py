"""Mixtral (GQA attention, RoPE, top-k routed SwiGLU experts): the program's
configuration, the parameter groups drawn for it, and its shapes for the
work formulas.  Sizes come from the configuration file alone."""
from __future__ import annotations

import math

import torch

BF16, F32 = torch.bfloat16, torch.float32
NORM_SCALE = 0.1


def dims(c: dict) -> dict:
    d, H = c["hidden_size"], c["num_attention_heads"]
    dh = d // H
    return {"d": d, "layers": c["num_hidden_layers"], "heads": H,
            "kv_heads": c["num_key_value_heads"], "d_qk": dh, "d_v": dh,
            "vocab": c["vocab_size"], "ffn": c["intermediate_size"],
            "experts": c["num_local_experts"], "top_k": c["num_experts_per_tok"],
            "tied": c["tie_word_embeddings"]}


def program_config(c: dict):
    """The program's ``ModelConfig`` for this file (imported lazily: the
    program is only loaded by the run)."""
    from repro_torch.configs.base import ModelConfig
    s = dims(c)
    return ModelConfig(
        name=c["name"], family="moe", n_layers=s["layers"], d_model=s["d"],
        n_heads=s["heads"], n_kv_heads=s["kv_heads"], d_head=s["d_qk"],
        d_ff=s["ffn"], vocab_size=s["vocab"], n_experts=s["experts"],
        top_k=s["top_k"], sliding_window=c["sliding_window"],
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=s["tied"], dtype="bfloat16")


def param_groups(c: dict):
    s = dims(c)
    d, V, F, E = s["d"], s["vocab"], s["ffn"], s["experts"]
    q, kv = s["heads"] * s["d_qk"], s["kv_heads"] * s["d_qk"]
    r = lambda n: 1.0 / math.sqrt(n)
    head = [("embed", (V, d), r(d), BF16)]
    if not s["tied"]:
        head.append(("lm_head", (d, V), r(d), BF16))
    head.append(("final_norm.scale", (d,), NORM_SCALE, F32))
    groups = [head]
    for l in range(s["layers"]):
        p = f"layers.{l}."
        groups.append([
            (p + "ln1.scale", (d,), NORM_SCALE, F32),
            (p + "attn.wq", (d, q), r(d), BF16),
            (p + "attn.wk", (d, kv), r(d), BF16),
            (p + "attn.wv", (d, kv), r(d), BF16),
            (p + "attn.wo", (q, d), r(q), BF16),
            (p + "ln2.scale", (d,), NORM_SCALE, F32),
            (p + "ffn.router", (d, E), r(d), BF16),
            (p + "ffn.w_gate", (E, d, F), r(d), BF16),
            (p + "ffn.w_up", (E, d, F), r(d), BF16),
            (p + "ffn.w_down", (E, F, d), r(F), BF16),
        ])
    return groups


def layer_params(c: dict) -> dict:
    """Matrix parameters of one layer: ``attn``; ``ffn_active``, those one
    token multiplies by (the router and its top-k experts); ``expert``, one
    expert's three matrices."""
    s = dims(c)
    d, q, kv = s["d"], s["heads"] * s["d_qk"], s["kv_heads"] * s["d_qk"]
    expert = 3 * d * s["ffn"]
    return {"attn": d * q + 2 * d * kv + q * d,
            "ffn_active": d * s["experts"] + s["top_k"] * expert,
            "expert": expert}

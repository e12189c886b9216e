"""MiniCPM3 (multi-head latent attention, SwiGLU, tied head): the program's
configuration, the parameter groups drawn for it, and its shapes for the
work formulas.  Sizes come from the configuration file alone."""
from __future__ import annotations

import math

import torch

BF16, F32 = torch.bfloat16, torch.float32
NORM_SCALE = 0.1


def dims(c: dict) -> dict:
    return {"d": c["hidden_size"], "layers": c["num_hidden_layers"],
            "heads": c["num_attention_heads"],
            "d_qk": c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
            "d_nope": c["qk_nope_head_dim"], "d_rope": c["qk_rope_head_dim"],
            "d_v": c["v_head_dim"], "q_rank": c["q_lora_rank"],
            "kv_rank": c["kv_lora_rank"], "vocab": c["vocab_size"],
            "ffn": c["intermediate_size"], "experts": 0, "top_k": 0,
            "tied": c["tie_word_embeddings"]}


def program_config(c: dict):
    from repro_torch.configs.base import MLAConfig, ModelConfig
    s = dims(c)
    return ModelConfig(
        name=c["name"], family="dense", n_layers=s["layers"], d_model=s["d"],
        n_heads=s["heads"], n_kv_heads=c["num_key_value_heads"],
        d_head=s["d"] // s["heads"], d_ff=s["ffn"], vocab_size=s["vocab"],
        mla=MLAConfig(kv_lora_rank=s["kv_rank"], q_lora_rank=s["q_rank"],
                      qk_nope_head_dim=s["d_nope"], qk_rope_head_dim=s["d_rope"],
                      v_head_dim=s["d_v"]),
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=s["tied"], dtype="bfloat16")


def param_groups(c: dict):
    s = dims(c)
    d, V, F, H = s["d"], s["vocab"], s["ffn"], s["heads"]
    qr, kr = s["q_rank"], s["kv_rank"]
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
            (p + "attn.wq_a", (d, qr), r(d), BF16),
            (p + "attn.wq_b", (qr, H * s["d_qk"]), r(qr), BF16),
            (p + "attn.wkv_a", (d, kr + s["d_rope"]), r(d), BF16),
            (p + "attn.wk_b", (kr, H * s["d_nope"]), r(kr), BF16),
            (p + "attn.wv_b", (kr, H * s["d_v"]), r(kr), BF16),
            (p + "attn.wo", (H * s["d_v"], d), r(H * s["d_v"]), BF16),
            (p + "ln2.scale", (d,), NORM_SCALE, F32),
            (p + "ffn.w_gate", (d, F), r(d), BF16),
            (p + "ffn.w_up", (d, F), r(d), BF16),
            (p + "ffn.w_down", (F, d), r(F), BF16),
        ])
    return groups


def layer_params(c: dict) -> dict:
    """Matrix parameters of one layer (as in the MoE family; no experts)."""
    s = dims(c)
    d, H, qr, kr = s["d"], s["heads"], s["q_rank"], s["kv_rank"]
    attn = (d * qr + qr * H * s["d_qk"] + d * (kr + s["d_rope"])
            + kr * H * s["d_nope"] + kr * H * s["d_v"] + H * s["d_v"] * d)
    return {"attn": attn, "ffn_active": 3 * d * s["ffn"], "expert": 0}

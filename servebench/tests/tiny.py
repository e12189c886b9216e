"""Cut-down configurations and mixes for the CPU tests: the cells' files
with every width and length shrunk, nothing else changed."""
import harness

SEED = 2**31 + 977           # larger than 32 signed bits hold
SECONDS = 12.0               # a window in which several requests finish on a loaded CPU


def config(cell: str) -> dict:
    c = dict(harness.cell_files(cell)[1])
    if c["model_type"] == "mixtral":
        c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                 intermediate_size=96, num_local_experts=4, vocab_size=128,
                 num_hidden_layers=2)
    else:
        c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                 q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                 qk_rope_head_dim=8, v_head_dim=8, intermediate_size=96,
                 vocab_size=128, num_hidden_layers=2)
    return c


def mix(cell: str) -> dict:
    plan = {"batch": 4, "max_seq_len": 96, "page_size": 16}
    if cell == "mixtral.chat":
        return {"rate_per_s": 1.5, "plan": plan, "warmup_prompts": [31, 24],
                "prompt": {"dist": "lognormal", "median": 10, "sigma": 0.6, "min": 4, "max": 24},
                "output": {"dist": "lognormal", "median": 5, "sigma": 0.5, "min": 3, "max": 8}}
    return {"clients": 4, "plan": plan, "warmup_prompts": [31, 24],
            "documents": {"count": 4, "length": 32, "zipf_s": 1.0},
            "question": {"dist": "loguniform", "min": 4, "max": 16},
            "output": {"dist": "loguniform", "min": 3, "max": 8}}


def overrides(cell: str) -> dict:
    return {"config": config(cell), "mix": mix(cell)}

"""Zamba2-7B — Mamba2 backbone + shared attention block (port of
``src/repro/configs/zamba2_7b.py``). [arXiv:2411.15242]

81 block slots; every 6th slot applies the single SHARED attention+MLP block
(Zamba weight-sharing trick), the rest are Mamba2 SSD blocks.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    attn_every=6,
)

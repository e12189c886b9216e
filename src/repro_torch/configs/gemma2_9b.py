"""Gemma2-9B — alternating local/global attention, logit softcaps (port of
``src/repro/configs/gemma2_9b.py``). [arXiv:2408.00118]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=14336,
    vocab_size=256000,
    sliding_window=4096,
    local_global_every=2,            # even layers local (SWA), odd layers global
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
)

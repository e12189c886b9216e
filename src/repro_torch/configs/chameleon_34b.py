"""Chameleon-34B — early-fusion VLM backbone; VQ image tokens share the vocab
(port of ``src/repro/configs/chameleon_34b.py``). [arXiv:2405.09818]
The modality frontend is a stub in the reference too: requests carry token
ids (text and VQ image tokens drawn from the shared 65536 vocab).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab_size=65536,
)

"""Whisper-tiny — enc-dec transformer backbone; conv frontend is a STUB
(port of ``src/repro/configs/whisper_tiny.py``). [arXiv:2212.04356]

The encoder takes precomputed frame embeddings (B, n_frames, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                      # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_head=64,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    n_frames=1500,
    tie_embeddings=True,
)

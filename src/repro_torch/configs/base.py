"""Model / shape configuration dataclasses (port of ``src/repro/configs/base.py``).

A copy, not an import: the PyTorch port never imports the JAX package.
Every architecture is described by a single :class:`ModelConfig`; the port's
model (``repro_torch.models``) consumes these fields.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    kv_lora_rank: int = 256
    q_lora_rank: int = 768
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block configuration."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering all assigned families."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None     # default: d_model // n_heads

    # --- attention variants -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None      # SWA window (tokens) or None
    local_global_every: int = 0               # gemma2: 2 => alternate local/global
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    mla: Optional[MLAConfig] = None

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0

    # --- SSM / hybrid ---------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0              # zamba2: shared attn block after every k-th layer

    # --- encoder-decoder (audio) ----------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_frames: int = 0                # precomputed frame embeddings (conv stub)

    # --- misc -------------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # ---------------------------------------------------------------------------
    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # Derived quantities used by the simulator & roofline ------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def n_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid" and self.attn_every:
            return self.n_layers // self.attn_every
        return self.n_layers

    @property
    def n_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid" and self.attn_every:
            return self.n_layers - self.n_attn_layers
        return 0

    def param_count(self) -> int:
        """Analytical parameter count (matches models.zoo init to ~1%)."""
        d, dh = self.d_model, self.d_head
        n = 0
        # embeddings (+ output head unless tied)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        # attention layers
        attn = 0
        if self.mla is not None:
            m = self.mla
            q_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * q_head
            attn += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            attn += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            attn += self.n_heads * m.v_head_dim * d
        elif self.family != "ssm":
            attn += d * self.n_heads * dh          # Q
            attn += 2 * d * self.n_kv_heads * dh   # K, V
            attn += self.n_heads * dh * d          # O
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv_heads) * dh
        ffn_dense = 3 * d * self.d_ff              # SwiGLU: gate, up, down
        if self.family == "moe":
            ffn = self.n_experts * ffn_dense + d * self.n_experts  # + router
        else:
            ffn = ffn_dense
        ssm_p = 0
        if self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj (z,x,B,C,dt) + conv + out_proj + A,D,dt_bias + norm
            conv_dim = di + 2 * s.n_groups * s.d_state
            ssm_p = (d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                     + conv_dim * s.d_conv + di * d + 2 * nh + di)
        if self.family == "ssm":
            n += self.n_layers * (ssm_p + d)       # + norm
        elif self.family == "hybrid":
            n += self.n_ssm_layers * (ssm_p + d)
            # shared attention block: ONE param set reused at each application
            n += (attn + ffn_dense + 2 * d)
            if self.d_ff == 0:
                n -= ffn_dense
        else:
            per_layer = attn + (2 * d)             # two norms
            per_layer += ffn
            n += self.n_layers * per_layer
        if self.is_encoder_decoder:
            # encoder layers (self-attn + ffn) and decoder cross-attn
            enc = self.n_encoder_layers * (attn + ffn_dense + 2 * d)
            cross = self.n_layers * attn
            n += enc + cross
        return int(n)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only top-k experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * self.d_ff
        return int(dense + self.n_layers * self.top_k * 3 * d * self.d_ff)

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes appended per generated token (all layers)."""
        if self.family == "ssm":
            return 0
        if self.mla is not None:
            per_layer = self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
        else:
            per_layer = 2 * self.n_kv_heads * self.d_head
        return self.n_attn_layers * per_layer * bytes_per_el

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw["name"] = self.name + "-smoke"
        kw["n_layers"] = min(self.n_layers, 4 if not self.attn_every else self.attn_every + 1)
        kw["d_model"] = 64
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4
        kw["d_head"] = 16
        kw["d_ff"] = 128 if self.d_ff else 0
        kw["vocab_size"] = 256
        if self.n_experts:
            kw["n_experts"] = 4
            kw["top_k"] = 2
        if self.sliding_window:
            kw["sliding_window"] = 16
        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora_rank=16, q_lora_rank=32,
                                  qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                                  n_groups=1, chunk_size=16)
        if self.is_encoder_decoder:
            kw["n_encoder_layers"] = 2
            kw["n_frames"] = 8
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 5
        # rebuild nested dataclasses
        if kw.get("mla") and isinstance(kw["mla"], dict):
            kw["mla"] = MLAConfig(**kw["mla"])
        if kw.get("ssm") and isinstance(kw["ssm"], dict):
            kw["ssm"] = SSMConfig(**kw["ssm"])
        return ModelConfig(**kw)


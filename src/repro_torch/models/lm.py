"""Paged language model, dense subset (port of ``src/repro/models/lm.py``).

The JAX model is a pure function over a parameter pytree with a
``lax.scan`` over stacked layers; here it is an ``nn.Module``
(:class:`PagedLM`, an ``nn.ModuleList`` of :class:`DecoderLayer`) and the
scan is a Python loop.  :func:`paged_step` keeps the JAX contract (same
write-index prelude, same logits) but updates the page pools in place.
Weights come from :func:`init_params` (seeded ``torch.Generator``) or from
JAX weights through :func:`params_from_jax` (numpy in, no JAX import).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, working_dtype
from repro_torch.models.layers import Attention, RMSNorm, SwiGLU, softcap

Cache = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# paging rules (copies of the JAX gates)
# --------------------------------------------------------------------------- #
def pageable(cfg: ModelConfig) -> bool:
    """Families whose cache is pure positional KV: dense/moe (incl. pure
    SWA), MLA, vlm.  Recurrent state (ssm/hybrid), encoder-decoder xattn and
    gemma-style local/global pairs stay on the contiguous path."""
    return (cfg.family not in ("ssm", "hybrid")
            and not cfg.is_encoder_decoder
            and cfg.local_global_every == 0)


def paged_window(cfg: ModelConfig) -> Optional[int]:
    """Sliding window for the paged mask: a paged SWA cache stores every
    position and masks by window instead of ring-rotating."""
    if cfg.sliding_window is not None and cfg.local_global_every == 0:
        return cfg.sliding_window
    return None


def _check_served(cfg: ModelConfig) -> None:
    if not pageable(cfg) or cfg.family != "dense" or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port serves dense GQA configs on "
            f"the paged path; MLA, MoE, SSM, hybrid and encoder-decoder come "
            f"with later slices")


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype: Optional[torch.dtype] = None,
                     device: DeviceLike = None) -> Cache:
    """Zero-filled page pools ``{"kp", "vp"}`` of shape
    (L, n_pages, page_size, Hkv, D).  Physical page 0 is the trash page."""
    if not pageable(cfg):
        raise ValueError(f"family {cfg.family!r} is not pageable")
    _check_served(cfg)
    device = resolve_device(device)
    dtype = working_dtype(cfg) if dtype is None else dtype
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #
class DecoderLayer(nn.Module):
    """Pre-norm decoder layer: rmsnorm → paged attention → rmsnorm → SwiGLU.
    Its ``forward`` is the JAX ``_paged_decoder_layer_fwd`` (dense path)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, x, pos2, window, kp, vp, ptab, lens, widx):
        x = x + self.attn(self.ln1(x), pos2, window, kp, vp, ptab, lens, widx)
        return x + self.ffn(self.ln2(x))


class PagedLM(nn.Module):
    """Dense decoder-only LM served from a paged KV pool.  Parameter names
    mirror the JAX pytree (``layers.{l}.attn.wq`` ↔ ``layers/attn/wq[l]``)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        _check_served(cfg)
        device = resolve_device(device)
        dtype = working_dtype(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.zeros((cfg.vocab_size, cfg.d_model), dtype=dtype, device=device),
            requires_grad=False)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros((cfg.d_model, cfg.vocab_size), dtype=dtype,
                            device=device), requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head


def _init_scale(cfg: ModelConfig, name: str, shape) -> float:
    """lm.init_params' distributions: uniform ±1/√d_in for matrices (the
    embedding uses 1/√d_model), zeros for biases and norm scales."""
    if len(shape) < 2:
        return 0.0
    if name == "embed":
        return 1.0 / math.sqrt(cfg.d_model)
    return 1.0 / math.sqrt(shape[0])


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> PagedLM:
    """Fresh random weights drawn from ``generator`` (seed 0 on the CPU when
    None) in parameter order, on the generator's device, then stored on
    ``device`` in the working dtype (norm scales in f32)."""
    model = PagedLM(cfg, device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            s = _init_scale(cfg, name, p.shape)
            if s == 0.0:
                p.zero_()
            else:
                p.copy_(torch.empty(p.shape, dtype=torch.float32,
                                    device=gen.device).uniform_(-s, s, generator=gen))
    return model


def _flatten_jax(cfg: ModelConfig, np_params: Mapping) -> Dict[str, np.ndarray]:
    """JAX pytree (stacked ``layers`` with a leading L axis) → torch names."""
    flat: Dict[str, np.ndarray] = {"embed": np_params["embed"],
                                   "final_norm.scale": np_params["final_norm"]["scale"]}
    if "lm_head" in np_params:
        flat["lm_head"] = np_params["lm_head"]

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
            return
        arr = np.asarray(node)
        if arr.shape[0] != cfg.n_layers:
            raise ValueError(f"layers/{prefix}: leading axis {arr.shape[0]} "
                             f"!= n_layers {cfg.n_layers}")
        for l in range(cfg.n_layers):
            flat[f"layers.{l}.{prefix}"] = arr[l]
    walk("", np_params["layers"])
    return flat


def params_from_jax(cfg: ModelConfig, np_params: Mapping,
                    device: DeviceLike = None) -> PagedLM:
    """Build the port's model from the JAX parameter pytree given as numpy
    arrays (``jax.tree.map(np.asarray, params)``): a plain copy, since both
    keep the ``(d_in, d_out)`` layout.  Takes numpy only — no JAX import."""
    model = PagedLM(cfg, device)
    flat = _flatten_jax(cfg, np_params)
    names = dict(model.named_parameters())
    if set(flat) != set(names):
        raise ValueError(f"parameter mismatch: missing {sorted(set(names) - set(flat))}"
                         f", unexpected {sorted(set(flat) - set(names))}")
    with torch.no_grad():
        for name, p in names.items():
            src = _to_torch(flat[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
    return model


def _to_torch(arr) -> torch.Tensor:
    arr = np.array(arr, order="C", copy=True)    # JAX hands out read-only views
    if arr.dtype.name == "bfloat16":           # ml_dtypes bf16 from JAX
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def paged_cache_from_numpy(cache: Mapping, device: DeviceLike = None) -> Cache:
    """JAX paged pools ``{"kp", "vp"}`` as numpy arrays → port tensors."""
    device = resolve_device(device)
    return {k: _to_torch(cache[k]).to(device) for k in ("kp", "vp")}


# --------------------------------------------------------------------------- #
# paged step
# --------------------------------------------------------------------------- #
def paged_step(model: PagedLM, cfg: ModelConfig, cache: Cache,
               tokens: torch.Tensor, pos2: torch.Tensor, ptab: torch.Tensor,
               active: torch.Tensor, *, page_size: int,
               last_only: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Cache-backed forward over a token chunk, paged pool edition.

    tokens/pos2: (B, C) int; ptab: (B, n_ptab) logical block → physical page
    (0 = unmapped/trash); active: (B,) bool.  The write index is computed
    once and shared by every layer: active lanes scatter into their mapped
    page at ``pos % page_size``, inactive lanes into the trash page at
    ``arange(C) % page_size``.  Valid kv length per lane is
    ``pos2[:, -1] + 1`` (0 when inactive).  The pools in ``cache`` are
    updated in place and returned.  Returns logits (B, C, V) in f32, or
    (B, 1, V) for the last position only when ``last_only``.
    """
    B, C = tokens.shape
    x = model.embed[tokens]
    active = active.bool()
    pos2 = pos2.long()
    lens = torch.where(active, pos2[:, -1] + 1, 0).to(torch.int32)
    ptab = ptab.to(torch.int32).contiguous()
    phys = torch.gather(ptab.long(), 1, pos2 // page_size)            # (B, C)
    widx = phys * page_size + pos2 % page_size
    trash = (torch.arange(C, device=pos2.device) % page_size)[None, :]
    widx = torch.where(active[:, None], widx, trash).reshape(-1)
    window = paged_window(cfg)

    for layer, kp, vp in zip(model.layers, cache["kp"], cache["vp"]):
        x = layer(x, pos2, window, kp, vp, ptab, lens, widx)

    x = model.final_norm(x)
    if last_only:
        x = x[:, -1:]
    logits = (x @ model.head()).float()
    return softcap(logits, cfg.final_logit_softcap), cache

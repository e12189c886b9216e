"""Step functions of the model zoo (port of ``src/repro/models/zoo.py``).

``train_step``     — loss + grads + AdamW update of the f32 masters
``prefill_step``   — full-sequence forward returning last-token logits
``serve_step``     — one decode token against a contiguous cache
``input_specs``    — every input of a cell's step as ``meta`` tensors in the
                     reference's pytree layout, names and dtypes (the dry
                     run's; nothing is allocated)

A step takes the :class:`~repro_torch.models.lm.LM` where the reference
takes the parameter pytree; the train step updates its parameters in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import lm
from repro_torch.training import optim

Specs = Dict[str, Any]          # nested dicts with ``meta`` tensor leaves


def loss_fn(model: lm.LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Mean next-token NLL of the f32 ``log_softmax`` of the logits;
    ``batch`` holds ``tokens`` and ``labels`` (B, S) and, for an
    encoder-decoder config, ``frames`` (B, F, d)."""
    logits = lm.forward(model, cfg, batch["tokens"], frames=batch.get("frames"))
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return nll.mean()


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[optim.AdamWConfig] = None):
    """``train_step(model, opt_state, batch, masters=None) -> (loss,
    opt_state)``: one gradient of :func:`loss_fn` over the model's
    parameters (which must require grad) and one AdamW update of the f32
    ``masters`` — the reference's f32 parameters — whose rounding is
    written into the model
    (:func:`~repro_torch.training.optim.update_masters`).  Without
    ``masters`` the parameters are their own masters, which only an f32
    model's can be (:func:`~repro_torch.training.optim.own_masters`)."""
    opt_cfg = opt_cfg or optim.AdamWConfig()

    def train_step(model, opt_state, batch, masters=None):
        params = dict(model.named_parameters())
        if masters is None:
            masters = optim.own_masters(params)
        loss = loss_fn(model, cfg, batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        opt_state = optim.update_masters(opt_cfg, params, masters, grads, opt_state)
        return loss.detach(), opt_state

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        with torch.inference_mode():
            logits = lm.forward(model, cfg, batch["tokens"], frames=batch.get("frames"))
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(model, cache, tokens, positions):
        with torch.inference_mode():
            logits, cache = lm.decode_step(model, cfg, cache, tokens, positions)
        return logits[:, -1, :].argmax(dim=-1).to(torch.int32), cache

    return serve_step


def step_fn_for(cfg: ModelConfig, shape):
    """The step of a cell's kind (``shape.kind``: ``train``, ``prefill`` or
    decode)."""
    if shape.kind == "train":
        return make_train_step(cfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg)


# --------------------------------------------------------------------------- #
# dry-run input specs (shapes only: meta tensors, nothing allocated)
# --------------------------------------------------------------------------- #
def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@functools.lru_cache(maxsize=None)
def stored_param_specs(cfg: ModelConfig) -> Specs:
    """The port's model's parameters in the reference's pytree layout, in
    the dtypes the port stores them (bf16 matrices of a bf16 config, f32
    norm scales and mixer vectors); built once per config."""
    from repro_torch.distributed.sharding import jax_layout
    return jax_layout(lm.LM(cfg, device="meta"), meta=True)


def _retyped(tree: Mapping, dtype: torch.dtype) -> Specs:
    return {k: (_retyped(v, dtype) if isinstance(v, Mapping) else _meta(v.shape, dtype))
            for k, v in tree.items()}


def param_specs(cfg: ModelConfig, dtype: Optional[torch.dtype] = None) -> Specs:
    """The parameters in the reference's pytree layout (stacks with their
    leading axes): f32, as the reference's ``init_params`` draws them, or
    ``dtype``."""
    return _retyped(stored_param_specs(cfg), torch.float32 if dtype is None else dtype)


def opt_state_specs(cfg: ModelConfig) -> Specs:
    """AdamW's state: f32 ``m`` and ``v`` beside each parameter and an int32
    ``step``."""
    return {"m": param_specs(cfg), "v": param_specs(cfg),
            "step": _meta((), torch.int32)}


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Specs:
    B, S = shape.global_batch, shape.seq_len
    b: Specs = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        b["labels"] = _meta((B, S), torch.int32)
    if cfg.is_encoder_decoder:
        b["frames"] = _meta((B, cfg.n_frames, cfg.d_model), torch.bfloat16)
    return b


def cache_specs(cfg: ModelConfig, B: int, seq_len: int) -> Specs:
    """The contiguous cache (:func:`~repro_torch.models.lm.init_cache`) in
    bf16, the reference's ``init_cache`` default."""
    return lm.init_cache(cfg, B, seq_len, dtype=torch.bfloat16, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Specs:
    """Every input of the cell's step function:

    train   -> params (f32), opt_state, batch
    prefill -> params (bf16), batch
    decode  -> params (bf16), cache, tokens, positions
    """
    if shape.kind == "train":
        return {"params": param_specs(cfg), "opt_state": opt_state_specs(cfg),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": param_specs(cfg, torch.bfloat16),
                "batch": batch_specs(cfg, shape)}
    B = shape.global_batch
    return {"params": param_specs(cfg, torch.bfloat16),
            "cache": cache_specs(cfg, B, shape.seq_len),
            "tokens": _meta((B, 1), torch.int32),
            "positions": _meta((B,), torch.int32)}

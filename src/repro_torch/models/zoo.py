"""Step functions of the model zoo (port of ``src/repro/models/zoo.py``).

``train_step``     — loss + grads + AdamW update
``prefill_step``   — full-sequence forward returning last-token logits
``serve_step``     — one decode token against a contiguous cache

The reference's dry-run specs (``param_specs``, ``opt_state_specs``,
``batch_specs``, ``cache_specs``, ``input_specs``) need its ``ShapeSpec``
and the dry run, which the port does not have yet (ROADMAP queue 1 item
11).  A step takes the :class:`~repro_torch.models.lm.LM` where the
reference takes the parameter pytree; the train step updates its
parameters in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.training import optim


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
    """``train_step(model, opt_state, batch) -> (loss, opt_state)``: one
    gradient of :func:`loss_fn` over the model's parameters (which must
    require grad) and one :func:`~repro_torch.training.optim.apply_updates`,
    written into the parameters."""
    opt_cfg = opt_cfg or optim.AdamWConfig()

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss = loss_fn(model, cfg, batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        new_params, opt_state = optim.apply_updates(opt_cfg, params, grads, opt_state)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
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

"""AdamW over a dict of named tensors: f32 moments, decoupled weight decay
(port of ``src/repro/training/optim.py``).

The arithmetic and its dtypes follow the reference leaf for leaf:

* ``m`` and ``v`` are f32, whatever the parameter's dtype;
* the gradient is upcast to f32, then clipped by ``min(1, clip/(‖g‖+1e-9))``
  with ‖g‖ over every leaf (:func:`global_norm`);
* the learning rate warms up from the incremented step;
* the bias corrections are ``1 − b**step`` in f32;
* the new parameter ``p − lr·(m̂/(√v̂+eps) + wd·p)`` is computed in f32
  (``wd·p`` in the parameter's dtype with ``wd`` rounded to it, as JAX's
  weak-typed scalar is)
  and cast back to the parameter's dtype once: an in-place ``add_`` on a
  bf16 parameter would round at other places;
* weight decay applies to every leaf, norm scales and the tied embedding
  included.

:func:`apply_updates` is functional, as the reference's is: it returns new
tensors and leaves its inputs untouched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
RANGE = "repro_torch::adamw"      # profiler range of :func:`apply_updates`


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_state(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """``{"m": zeros f32, "v": zeros f32, "step": int32 0}`` beside each
    parameter, on its device."""
    zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def init_masters(params: Mapping[str, torch.Tensor],
                 given: Optional[Mapping[str, object]] = None) -> Tensors:
    """The f32 master of every parameter, on its device: an f32 parameter is
    its own master; any other gets an f32 copy.  With ``given`` (f32 values
    under the same names, tensors or numpy arrays — e.g.
    :func:`repro_torch.models.lm.named_from_jax` of the reference's
    parameters) the masters take those values and the parameters their
    rounding; without it, the masters are the parameters upcast."""
    masters: Tensors = {}
    with torch.no_grad():
        for k, p in params.items():
            m = p if p.dtype == torch.float32 else torch.empty(
                p.shape, dtype=torch.float32, device=p.device)
            if given is not None:
                src = given[k]
                m.copy_(src if isinstance(src, torch.Tensor) else
                        torch.from_numpy(np.array(src, dtype=np.float32)))
            elif m is not p:
                m.copy_(p)
            masters[k] = m
        if given is not None:
            round_into(params, masters)
    return masters


def own_masters(params: Mapping[str, torch.Tensor]) -> Tensors:
    """``params`` as their own masters, which only f32 parameters can be: a
    parameter of another dtype raises, since an update written straight
    into it would be rounded to its dtype (pass its f32 master instead)."""
    low = [k for k, p in params.items() if p.dtype != torch.float32]
    if low:
        raise ValueError(f"{len(low)} parameters are not f32 (e.g. {low[0]}): "
                         f"the step needs their f32 masters (init_masters)")
    return dict(params)


@torch.no_grad()
def round_into(params: Mapping[str, torch.Tensor], masters: Mapping[str, torch.Tensor]
               ) -> None:
    """Write each master's rounding to its parameter's dtype into the
    parameter (a parameter that is its own master is left as it is)."""
    for k, p in params.items():
        if masters[k] is not p:
            p.copy_(masters[k])


def update_masters(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                   masters: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                   state: Mapping[str, object]) -> Dict[str, object]:
    """One AdamW step of the f32 ``masters`` (updated in place) on
    ``grads``, then their rounding written into ``params``; returns the new
    optimizer state."""
    new, state = apply_updates(cfg, masters, grads, state)
    with torch.no_grad():
        for k, m in masters.items():
            m.copy_(new[k])
    del new
    round_into(params, masters)
    return state


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ over leaves of Σ x²) in f32, leaves summed in order."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: Mapping[str, object]
                  ) -> Tuple[Tensors, Dict[str, object]]:
    """One AdamW step: (new params, new state), both new tensors."""
    with torch.profiler.record_function(RANGE):
        return _apply(cfg, params, grads, state)


def _apply(cfg: AdamWConfig, params, grads, state):
    step = state["step"] + 1
    lr = _schedule(cfg, step)
    clip = torch.clamp(cfg.grad_clip / (global_norm(grads) + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=step.device) ** stepf
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=step.device) ** stepf
    new_p, new_m, new_v, wd = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * clip
        m2 = b1 * state["m"][k] + (1 - b1) * g
        v2 = b2 * state["v"][k] + (1 - b2) * g * g
        if p.dtype not in wd:      # JAX rounds the weak-typed scalar to p's dtype
            wd[p.dtype] = torch.tensor(cfg.weight_decay, dtype=p.dtype, device=p.device)
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps) + wd[p.dtype] * p
        new_p[k] = (p - lr * upd).to(p.dtype)
        new_m[k], new_v[k] = m2, v2
    return new_p, {"m": new_m, "v": new_v, "step": step}

"""Fault-tolerant training loop (port of ``src/repro/training/trainer.py``).

* f32 master weights: the reference's parameters are f32 and cast at use,
  so AdamW updates an f32 master of every parameter
  (:func:`repro_torch.training.optim.init_masters`; an f32 parameter is its
  own) and each step writes the masters' rounding into the model's weights,
  which the forward reads; the checkpoint holds the masters;
* microbatch gradient accumulation: each microbatch's gradient
  (``torch.autograd.grad``, in the parameters' dtype) is added into an f32
  buffer per parameter, then the sum is divided by the count — never
  accumulated in a bf16 ``.grad``;
* NaN/inf guard: when the global gradient norm or the loss is not finite
  the update is skipped, masters, model and optimizer state (its step
  counter included) unchanged, and counted;
* async atomic checkpointing + resume from ``LATEST`` (restart-safe data
  pipeline, the reference's batches), in the reference's on-disk layout and
  leaf order, f32 parameter leaves as the reference writes them;
* straggler monitor (per-step wall-clock watchdog).

The model's parameters are trained in place, so the trainer turns on
``requires_grad`` for the model it trains; serving models keep it off.  The
forward checkpoints its layers as the ``remat`` flag says
(:mod:`repro_torch.models.flags`, "full" by default).  On the card the
forward runs the RMSNorm, flash-attention, ``moe_gmm`` and SSD-scan
kernels, whose gradients are explicit PyTorch ops (``kernels/*/ops.py``),
so every family trains there as on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm, zoo
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import data as data_lib
from repro_torch.training import optim


@dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 5.0       # step > factor × median ⇒ flag
    opt: optim.AdamWConfig = field(default_factory=optim.AdamWConfig)


@dataclass
class TrainReport:
    losses: List[float] = field(default_factory=list)
    skipped_nan: int = 0
    straggler_events: int = 0
    resumed_from: Optional[int] = None
    steps_done: int = 0
    # bytes the loop held on its device at its last step, by part: the f32
    # masters, the working copy beside them (the model's weights that are
    # not their own master), the moments, the step counter and the batch
    held_bytes: Dict[str, int] = field(default_factory=dict)
    # the f32 masters at the end, under the model's parameter names (an f32
    # parameter is its own)
    masters: Dict[str, torch.Tensor] = field(default_factory=dict)


def make_accum_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig,
                          microbatches: int):
    """``train_step(model, opt_state, batch, masters=None) -> (loss,
    opt_state, ok)``: the batch split into ``microbatches`` equal row
    blocks, their gradients (over the model's parameters, which must
    require grad) averaged in f32, and when ``ok`` one AdamW update of the
    f32 ``masters`` whose rounding is written into the model
    (:func:`~repro_torch.training.optim.update_masters`).  Without
    ``masters`` the parameters are their own masters, which only an f32
    model's can be (:func:`~repro_torch.training.optim.own_masters`)."""

    def train_step(model, opt_state, batch, masters=None):
        params = dict(model.named_parameters())
        if masters is None:
            masters = optim.own_masters(params)
        plist = list(params.values())
        if microbatches <= 1:
            loss = zoo.loss_fn(model, cfg, batch)
            grads = dict(zip(params, torch.autograd.grad(loss, plist)))
            loss = loss.detach()
        else:
            n = batch["tokens"].shape[0] // microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=plist[0].device)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l = zoo.loss_fn(model, cfg, mb)
                for acc, g in zip(grads.values(), torch.autograd.grad(l, plist)):
                    acc.add_(g)
                loss = loss + l.detach()
            for g in grads.values():
                g.div_(microbatches)
            loss = loss / microbatches
        # NaN guard: skip the update when the gradient is poisoned
        ok = torch.isfinite(optim.global_norm(grads)) & torch.isfinite(loss)
        if bool(ok):
            opt_state = optim.update_masters(opt_cfg, params, masters, grads, opt_state)
        return loss, opt_state, ok

    return train_step


def state_tree(cfg: ModelConfig, params: Dict[str, torch.Tensor],
               opt_state: Dict[str, object], convert: Optional[Callable] = None):
    """``(params, opt_state)`` laid out as the reference's pytree
    (:func:`repro_torch.models.lm.params_to_jax`), the checkpoint's tree;
    the trainer passes its f32 masters as ``params``."""
    jax_like = lambda named: lm.params_to_jax(cfg, named, convert)
    step = opt_state["step"]
    return (jax_like(params), {"m": jax_like(opt_state["m"]),
                               "step": step if convert is None else convert(step),
                               "v": jax_like(opt_state["v"])})


def _restore(cfg: ModelConfig, ckpt_dir: str, params: Dict[str, torch.Tensor],
             opt_state: Dict[str, object]) -> None:
    """Copy the latest checkpoint into ``params`` (the masters) and
    ``opt_state`` in place."""
    meta = lambda named: {k: torch.empty(t.shape, dtype=t.dtype, device="meta")
                          for k, t in named.items()}
    like = state_tree(cfg, meta(params), {"m": meta(opt_state["m"]),
                                          "step": opt_state["step"],
                                          "v": meta(opt_state["v"])})
    (p_tree, o_tree), _, _ = ckpt_lib.restore(ckpt_dir, like)
    with torch.no_grad():
        for dst, tree in ((params, p_tree), (opt_state["m"], o_tree["m"]),
                          (opt_state["v"], o_tree["v"])):
            for k, t in lm.named_from_jax(cfg, tree).items():
                dst[k].copy_(t)
        opt_state["step"].copy_(o_tree["step"])


def _held_bytes(named: Dict[str, torch.Tensor], masters: Dict[str, torch.Tensor],
                opt_state: Dict[str, object], batch: Dict[str, torch.Tensor]
                ) -> Dict[str, int]:
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    return {"masters": size(masters.values()),
            "working_copy": size(p for k, p in named.items() if masters[k] is not p),
            "m": size(opt_state["m"].values()), "v": size(opt_state["v"].values()),
            "step": size([opt_state["step"]]), "batch": size(batch.values())}


def train(cfg: ModelConfig, tcfg: TrainConfig,
          data_cfg: Optional[data_lib.DataConfig] = None,
          params: Optional[lm.LM] = None, seed: int = 0,
          on_step: Optional[Callable[[int, float], None]] = None,
          device: DeviceLike = None,
          masters: Optional[Mapping[str, object]] = None) -> TrainReport:
    """Train ``params`` (a model, trained in place; default: fresh weights
    drawn from a generator seeded ``seed`` on ``device``) for
    ``tcfg.steps`` steps.  ``device=None`` means the card; a given model
    trains where it lies.  ``masters`` (f32 values under the model's
    parameter names, e.g. the reference's parameters through
    :func:`repro_torch.models.lm.named_from_jax`) start the f32 masters and
    the model gets their rounding; by default the masters start as the
    model's weights upcast, and on resume they come from the checkpoint.
    ``report.masters`` holds them.  Batches go to the device as int32, the
    reference's type."""
    report = TrainReport()
    data_cfg = data_cfg or data_lib.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    if params is None:
        dev = resolve_device(device)
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    elif device is not None and resolve_device(device) != params.device:
        raise ValueError(f"the model lies on {params.device}, not on {device}")
    model, dev = params, params.device
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    masters = report.masters = optim.init_masters(named, masters)
    opt_state = optim.init_state(masters)
    start_step = 0

    ckpt = None
    if tcfg.ckpt_dir:
        ckpt = ckpt_lib.AsyncCheckpointer(tcfg.ckpt_dir)
        last = ckpt_lib.latest_step(tcfg.ckpt_dir)
        if last is not None:
            _restore(cfg, tcfg.ckpt_dir, masters, opt_state)
            optim.round_into(named, masters)
            start_step = last
            report.resumed_from = last

    def save(step: int, loss) -> None:
        ckpt.save(step, state_tree(cfg, masters, opt_state, ckpt_lib.to_host),
                  extra={"loss": loss})

    step_fn = make_accum_train_step(cfg, tcfg.opt, tcfg.microbatches)
    durations: List[float] = []
    for step in range(start_step, tcfg.steps):
        t0 = time.monotonic()
        batch = {k: v.to(dev, torch.int32)
                 for k, v in data_lib.batch_at(data_cfg, step).items()}
        loss, opt_state, ok = step_fn(model, opt_state, batch, masters)
        report.held_bytes = _held_bytes(named, masters, opt_state, batch)
        loss = float(loss)
        dt = time.monotonic() - t0
        if durations and dt > tcfg.straggler_factor * (
                sorted(durations)[len(durations) // 2]):
            report.straggler_events += 1
        durations.append(dt)
        if not bool(ok):
            report.skipped_nan += 1
        report.losses.append(loss)
        report.steps_done = step + 1
        if on_step:
            on_step(step, loss)
        if ckpt and (step + 1) % tcfg.ckpt_every == 0:
            save(step + 1, loss)
    if ckpt:
        save(tcfg.steps, report.losses[-1] if report.losses else None)
        ckpt.wait()
    return report

"""Resumable synthetic data pipeline (port of ``src/repro/training/data.py``).

Every batch is a pure function of ``(seed, step)``: the reference's
counter-based keys — ``fold_in(PRNGKey(seed), step)`` split in three — drawn
through :mod:`repro_torch.training.prng`, JAX's threefry on numpy, so the
port's batch of a step is the reference's bit for bit and a run resumed
across packages goes on over the same batches.  The language is a learnable
LCG ``t_{i+1} = (31·t_i + 7) mod V`` from a random first token, with 5%
of the tokens replaced by uniform random ones; ``labels`` are the tokens
shifted by one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.training import prng

NOISE = 0.05          # share of tokens replaced by a uniform random token


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def batch_at(cfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    """The batch of ``step``: ``tokens`` and ``labels``, (B, S) int64 on the
    CPU, equal to the reference's int32 values.  ``seed`` and ``step``
    must be non-negative."""
    if cfg.seed < 0 or step < 0:
        raise ValueError(f"seed {cfg.seed} and step {step} must be non-negative")
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    k0, k1, k2 = prng.split(prng.fold_in(prng.key(cfg.seed), step), 3)
    seq = np.empty((B, S + 1), dtype=np.int64)
    seq[:, 0] = prng.randint(k0, (B,), 0, V)
    for i in range(S):
        seq[:, i + 1] = (31 * seq[:, i] + 7) % V
    noise = prng.bernoulli(k1, NOISE, (B, S + 1))
    seq = np.where(noise, prng.randint(k2, (B, S + 1), 0, V), seq)
    seq = torch.from_numpy(seq)
    return {"tokens": seq[:, :-1].contiguous(), "labels": seq[:, 1:].contiguous()}


def stream(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1

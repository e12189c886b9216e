"""Resumable synthetic data pipeline (port of ``src/repro/training/data.py``).

Every batch is a pure function of ``(seed, step)``: it is drawn from a
``torch.Generator`` seeded from the pair, so a restart needs no iterator
state beyond the step counter.  The language is the reference's — a
learnable LCG ``t_{i+1} = (31·t_i + 7) mod V`` with 5% random noise tokens,
``labels`` the tokens shifted by one — but not its random stream: JAX's
threefry bits are not reproduced, so parity tests hand JAX's batches to the
port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

NOISE = 0.05          # share of tokens replaced by a uniform random token


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _generator(cfg: DataConfig, step: int) -> torch.Generator:
    """A CPU generator keyed by ``(seed, step)`` (both non-negative): the
    pair is hashed by ``numpy``'s ``SeedSequence`` into the 32 bits the CPU
    generator's Mersenne Twister takes."""
    if cfg.seed < 0 or step < 0:
        raise ValueError(f"seed {cfg.seed} and step {step} must be non-negative")
    key = np.random.SeedSequence([cfg.seed, step]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(key))


def batch_at(cfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    """The batch of ``step``: ``tokens`` and ``labels``, (B, S) int64 on the
    CPU."""
    gen = _generator(cfg, step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    seq = torch.empty((B, S + 1), dtype=torch.int64)
    seq[:, 0] = torch.randint(0, V, (B,), generator=gen)
    for i in range(S):
        seq[:, i + 1] = (31 * seq[:, i] + 7) % V
    noise = torch.rand((B, S + 1), generator=gen) < NOISE
    rand = torch.randint(0, V, (B, S + 1), generator=gen)
    seq = torch.where(noise, rand, seq)
    return {"tokens": seq[:, :-1].contiguous(), "labels": seq[:, 1:].contiguous()}


def stream(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1

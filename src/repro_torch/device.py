"""Device policy of the PyTorch port (no counterpart in ``src/repro/``).

Every entry point takes ``device=None``, which means the CUDA card.  There
is no silent fall-back: without a CUDA device ``None`` raises, and only an
explicit ``device="cpu"`` runs on the host (the tests do that, with the
kernels' plain PyTorch versions).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises RuntimeError;
    anything other than CPU or CUDA raises ValueError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' explicitly to run the plain "
                "PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def working_dtype(cfg) -> torch.dtype:
    """Activation / weight storage dtype named by ``cfg.dtype``."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

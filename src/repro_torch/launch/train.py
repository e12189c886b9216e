"""Training driver: ``python -m repro_torch.launch.train --arch <id> [--steps N]
[--device cuda|cpu]`` (port of ``src/repro/launch/train.py``).

Runs the fault-tolerant training loop (reduced config by default; ``--full``
uses the real architecture) on the CUDA card unless ``--device cpu``.  Every
family trains on either device: on the card the forward runs the CUDA
kernels (RMSNorm, flash attention, ``moe_gmm``, the SSD scan) and their
backwards are explicit PyTorch ops, e.g. ``--arch mamba2-1.3b --full
--steps 8``.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.training import data as data_lib
from repro_torch.training import optim
from repro_torch.training.trainer import TrainConfig, train


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="use the full architecture config (large!)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def configs(args: argparse.Namespace
            ) -> Tuple[ModelConfig, TrainConfig, data_lib.DataConfig]:
    """The model, loop and data configs the flags name."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    dcfg = data_lib.DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=args.seq_len, global_batch=args.batch)
    tcfg = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir,
                       opt=optim.AdamWConfig(lr=args.lr, warmup_steps=20))
    return cfg, tcfg, dcfg


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    cfg, tcfg, dcfg = configs(args)
    report = train(cfg, tcfg, dcfg, device=args.device,
                   on_step=lambda s, l: print(f"step {s:5d} loss {l:.4f}")
                   if s % 10 == 0 else None)
    print(f"done: {report.steps_done} steps, final loss "
          f"{report.losses[-1]:.4f}, nan-skips {report.skipped_nan}, "
          f"stragglers {report.straggler_events}, resumed={report.resumed_from}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

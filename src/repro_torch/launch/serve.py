"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id> [--device cuda|cpu]``
(port of ``src/repro/launch/serve.py``, its default path).

Boots the plan-driven engine pool on a reduced config: a serving plan maps
each replica group to continuous-batching engines (paged KV for the dense,
vlm and moe configs — a MoE FFN follows ``REPRO_MOE_IMPL``, ``dense`` or
``dispatch`` — the paged latent pool for the MLA ``minicpm3-4b``, the
contiguous SSM state cache for ``mamba2-1.3b``, the contiguous cache for
``gemma2-9b``'s local/global pairs and ``zamba2-7b``'s hybrid groups).  A
batch of synthetic requests is routed across the replicas; ``--resize``
then applies a second plan with half the per-replica batch and reports the
measured reconfiguration (in-flight requests drain).  Runs on the CUDA
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

from repro_torch.configs import list_archs
from repro_torch.core.plan import Plan, ReplicaGroup
from repro_torch.serving.backend import make_torch_backend
from repro_torch.serving.engine import Request


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--resize", action="store_true",
                    help="apply a second plan (halved batch) and report the "
                         "measured reconfiguration wall-clock (drain)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cuda: the card and its "
                         "kernels; cpu: the plain PyTorch versions)")
    args = ap.parse_args(argv)

    backend = make_torch_backend(args.arch, seed=0, device=args.device,
                                 max_seq_len=128, slots_cap=args.slots,
                                 max_replicas_per_group=args.replicas)
    model = backend.cfg.name
    plan = Plan((ReplicaGroup(model, "H100-80G", tp=1, batch=args.slots,
                              count=args.replicas),))
    report = backend.apply_plan(plan, None)
    print(f"plan applied on {backend.device}: built={len(report.built)} groups "
          f"({args.replicas}×{args.slots}-slot engines) "
          f"in {report.wall_s * 1e3:.1f}ms")

    t0 = time.monotonic()
    for r in range(args.requests):
        backend.pool.submit(model, Request(
            rid=r, prompt=[1 + (r + j) % 9 for j in range(args.prompt_len)],
            max_new_tokens=args.max_new, arrival_time=time.monotonic()))
    done = backend.pool.run_until_drained()
    dt = time.monotonic() - t0
    toks = sum(len(d.generated) for d in done)
    disp = backend.pool.total_dispatches
    print(f"arch={args.arch} served {len(done)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks / dt:.1f} tok/s, dispatches={disp}, "
          f"{disp / max(len(done), 1):.1f}/request)")

    if args.resize:
        # resubmit a burst so the resize happens with requests in flight
        for r in range(args.requests, args.requests + args.slots):
            backend.pool.submit(model, Request(
                rid=r, prompt=[1 + (r + j) % 9 for j in range(args.prompt_len)],
                max_new_tokens=args.max_new, arrival_time=time.monotonic()))
        for eng in backend.pool.engines:
            eng.step()
        plan2 = Plan((ReplicaGroup(model, "H100-80G", tp=1,
                                   batch=max(args.slots // 2, 1),
                                   count=args.replicas),))
        rep2 = backend.apply_plan(plan2, None)
        print(f"resize[drain]: rebuilt={len(rep2.built)} "
              f"reused={len(rep2.reused)} removed={len(rep2.removed)} "
              f"drained={rep2.drained_requests} "
              f"measured reconfig={rep2.wall_s * 1e3:.1f}ms "
              f"(drain {rep2.drain_wall_s * 1e3:.1f}ms)")
        done2 = backend.pool.run_until_drained()
        print(f"post-resize: served {len(done2)} carried/queued requests")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

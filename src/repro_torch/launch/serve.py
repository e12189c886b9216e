"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id> [--device cuda|cpu]``
(port of ``src/repro/launch/serve.py``, its default path).

Boots the plan-driven engine pool on a reduced config: a serving plan maps
each replica group to continuous-batching engines (paged KV for the dense,
vlm and moe configs — a MoE FFN follows ``REPRO_MOE_IMPL``, ``dense`` or
``dispatch`` — the paged latent pool for the MLA ``minicpm3-4b``, the
contiguous SSM state cache for ``mamba2-1.3b``, the contiguous cache for
``gemma2-9b``'s local/global pairs, ``zamba2-7b``'s hybrid groups and
``whisper-tiny``'s decoder, which serves with zero cross-attention state as
the JAX engine does).  A batch of synthetic requests is routed across the
replicas; ``--resize`` then applies a second plan with half the per-replica
batch and reports the measured reconfiguration.  ``--priority`` orders
admission (request domain) and ``--reconfig`` says what happens to the
requests in flight on a removed replica (reconfig domain), both through
policies the port renders itself (:func:`repro_torch.core.policy.render_policy`).
Runs on the CUDA card unless ``--device cpu``.

``--faults SEED`` replays a seeded kill schedule against the pool while it
serves: each injected replica death is contained by the recovery domain
(salvage live slots onto a survivor, requeue the rest with backoff) and the
per-failure :class:`~repro_torch.serving.pool.FailureReport` is printed.

``--guarded`` demonstrates the control plane's guarded rollout instead:
one evolution cycle through the evaluation ladder (analytic screen → shadow
replay), a canary-ticketed publish, and a planted regression that is
caught and rolled back.  It runs on the deterministic shadow data plane
and serves nothing on any device.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

from repro_torch.configs import list_archs
from repro_torch.core.plan import Plan, ReplicaGroup
from repro_torch.core.policy import render_policy
from repro_torch.serving.backend import make_torch_backend
from repro_torch.serving.engine import Request


def guarded_demo(steps: Optional[int] = None) -> None:
    """Evaluation ladder + canary/rollback on the deterministic shadow data
    plane (no model runs on any device).  ``steps`` cuts the volatile trace
    to its first observations (None: all ten, a control-plane cycle every
    third step)."""
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.evolution import EvolutionConfig
    from repro_torch.core.plan import HARDWARE, QWEN25_FAMILY
    from repro_torch.core.policy import Policy, seed_policies
    from repro_torch.core.runtime import Autopoiesis, CanaryTicket
    from repro_torch.core.simulator import Simulator
    from repro_torch.serving.shadow import (BAD_REQUEST_SOURCE, ShadowBackend,
                                            ShadowReplayEval)
    from repro_torch.traces import volatile_workload_trace

    models = {m.name: m for m in QWEN25_FAMILY.values()}
    sim = Simulator(models, HARDWARE)
    ev = Evaluator(sim, models, HARDWARE)
    ap = Autopoiesis(
        ev, seed_policies()["greedy-reactive"],
        EvolutionConfig(max_iterations=4, patience=4,
                        evolution_timeout_s=45, shadow_top_k=3, seed=0),
        window=6, evolve_every=3,
        backend=ShadowBackend(sim, seed=0),
        shadow=ShadowReplayEval(sim, models, HARDWARE,
                                candidate_timeout_s=20.0))
    trace = volatile_workload_trace()
    print("guarded evolution over the volatile trace "
          "(shadow data plane, virtual clock):")
    for i, obs in enumerate(trace.observations[:steps]):
        out = ap.data_plane.step(obs)
        c = out["canary"]
        if c is not None:
            print(f"  step {i}: canary[{c['candidate']}] {c['status']}"
                  + (f" — {c['reason']}" if c.get("reason") else ""))
        if i > 0 and i % 3 == 0:
            ap.control_plane.run_cycle(ap.data_plane.policy)
    # plant a regression: it must be canaried and rolled back, not committed
    ap.stage.publish(Policy(source=BAD_REQUEST_SOURCE, name="regressor"),
                     ticket=CanaryTicket(intervals=2, max_regression=0.5,
                                         policy_name="regressor"))
    for i, obs in enumerate(trace.observations[:3]):
        out = ap.data_plane.step(obs)
        c = out["canary"]
        if c is not None and c["status"] != "running":
            print(f"  planted regressor: {c['status']}"
                  + (f" — {c['reason']}" if c.get("reason") else ""))
    cp, dp = ap.control_plane, ap.data_plane
    print(f"control plane: cycles={cp.cycles} skipped={cp.skipped_cycles} "
          f"published={cp.published} cache_hits={cp.incumbent_cache_hits}")
    print(f"data plane: swaps={dp.swap_count} commits={dp.commits} "
          f"rollbacks={dp.rollbacks}")
    for reason in dp.rollback_reasons:
        print(f"  rollback: {reason}")


def recovery_policy():
    """The ``retry-migrate`` recovery program ``--faults`` serves under:
    salvage live slots, three retries with 10 ms base backoff."""
    return render_policy(
        {"domains": ["placement", "recovery"],
         "recovery_mode": "salvage", "retry_budget": 3,
         "backoff_base_s": 0.01},
        name="retry-migrate").recovery_policy()


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
                         "measured reconfiguration wall-clock")
    ap.add_argument("--priority", default="fifo",
                    choices=["fifo", "sjf", "slo-aware"],
                    help="request-domain admission order (Policy API v2); "
                         "fifo keeps the v1 behaviour")
    ap.add_argument("--reconfig", default="drain",
                    choices=["drain", "migrate", "recompute"],
                    help="what happens to in-flight requests when --resize "
                         "removes their replica (reconfig domain)")
    ap.add_argument("--guarded", action="store_true",
                    help="demonstrate the evaluation ladder + canary "
                         "rollout/rollback on the shadow data plane")
    ap.add_argument("--guarded-steps", type=int, default=None, metavar="N",
                    help="with --guarded: serve only the trace's first N "
                         "observations before the planted regression")
    ap.add_argument("--faults", type=int, default=None, metavar="SEED",
                    help="replay a seeded fault schedule (replica kills + "
                         "stragglers) against the pool while it serves and "
                         "print each FailureReport (recovery domain)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cuda: the card and its "
                         "kernels; cpu: the plain PyTorch versions)")
    args = ap.parse_args(argv)

    if args.guarded:
        guarded_demo(args.guarded_steps)
        return 0

    backend = make_torch_backend(args.arch, seed=0, device=args.device,
                                 max_seq_len=128, slots_cap=args.slots,
                                 max_replicas_per_group=args.replicas)
    if args.priority != "fifo":
        backend.set_request_policy(render_policy(
            {"domains": ["placement", "request"],
             "priority_kind": args.priority},
            name=args.priority).request_policy())
        print(f"request policy: {args.priority} admission order")
    model = backend.cfg.name
    plan = Plan((ReplicaGroup(model, "H100-80G", tp=1, batch=args.slots,
                              count=args.replicas),))
    report = backend.apply_plan(plan, None)
    print(f"plan applied on {backend.device}: built={len(report.built)} groups "
          f"({args.replicas}×{args.slots}-slot engines) "
          f"in {report.wall_s * 1e3:.1f}ms")

    inj = None
    if args.faults is not None:
        from repro_torch.serving.faults import FaultInjector
        backend.pool.set_recovery_policy(recovery_policy())
        inj = FaultInjector.from_seed(args.faults, n_events=3, horizon=3,
                                      kill_ratio=1.0, deny_export_rate=0.0)
        print(f"fault injection: seed={args.faults} schedule="
              f"{[(ev.step, ev.kind) for ev in inj.schedule]} "
              f"(recovery policy: retry-migrate)")

    t0 = time.monotonic()
    for r in range(args.requests):
        backend.pool.submit(model, Request(
            rid=r, prompt=[1 + (r + j) % 9 for j in range(args.prompt_len)],
            max_new_tokens=args.max_new, arrival_time=time.monotonic()))
    if inj is not None:
        pool = backend.pool
        for i in range(3):
            for eng in pool.engines:
                eng.step(); eng.step()   # let kills land mid-decode
            seen = len(pool.failure_log)
            inj.step(pool, i)
            for rep in pool.failure_log[seen:]:
                print(f"  fault@step{i}: {rep.reason} model={rep.model} "
                      f"salvaged={rep.salvaged} recomputed={rep.recomputed} "
                      f"requeued={rep.requeued} shed={rep.shed} "
                      f"leaked_pages={rep.leaked_pages}")
            backend.apply_plan(plan, None)   # heal to the target count
    done = backend.pool.run_until_drained()
    dt = time.monotonic() - t0
    toks = sum(len(d.generated) for d in done)
    disp = backend.pool.total_dispatches
    print(f"arch={args.arch} served {len(done)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks / dt:.1f} tok/s, dispatches={disp}, "
          f"{disp / max(len(done), 1):.1f}/request)")
    if inj is not None:
        pool = backend.pool
        print(f"faults: kills={inj.kills} skipped={inj.skipped} "
              f"straggles={inj.straggles} | recovered: "
              f"salvaged={pool.salvaged_requests} "
              f"retry_exhausted={pool.retry_exhausted} "
              f"shed={len(pool.shed_requests)} "
              f"leaked_pages={sum(r.leaked_pages for r in pool.failure_log)}")

    if args.resize:
        if args.reconfig != "drain":
            backend.set_reconfig_policy(render_policy(
                {"domains": ["placement", "reconfig"],
                 "migration_mode": args.reconfig},
                name=args.reconfig).reconfig_policy())
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
        print(f"resize[{args.reconfig}]: rebuilt={len(rep2.built)} "
              f"reused={len(rep2.reused)} removed={len(rep2.removed)} "
              f"drained={rep2.drained_requests} "
              f"migrated={rep2.migrated_requests} "
              f"recomputed={rep2.recomputed_requests} "
              f"measured reconfig={rep2.wall_s * 1e3:.1f}ms "
              f"(hand-off: migrate {rep2.migrate_wall_s * 1e3:.1f}ms / "
              f"drain {rep2.drain_wall_s * 1e3:.1f}ms)")
        done2 = backend.pool.run_until_drained()
        print(f"post-resize: served {len(done2)} carried/queued requests")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Plan-driven engine pool (port of ``src/repro/serving/pool.py``).

A serving :class:`~repro_torch.core.plan.Plan` assigns each model a set of
:class:`~repro_torch.core.plan.ReplicaGroup` s.  The pool materialises every
group as :class:`~repro_torch.serving.engine.Engine` replicas and, on each
new plan, diffs against the current one: unchanged groups keep their
engines; changed/new groups are (re)built (cache allocation is the measured
RECONFIG-COST); removed groups hand off their work — queued requests are
requeued onto survivors, and each in-flight request is **migrated** (its
cache state moves to a survivor's free slot, no re-prefill), **drained**
(finishes on the old replica, blocking the reconfiguration) or
**recomputed** (a continuation is requeued) per the reconfig policy, with
the fallbacks migrate → recompute → drain.

Requests are routed per model to the least-loaded replica.  Failure
recovery (``fail``) comes with a later slice and raises
``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.plan import Plan, ReplicaGroup
from repro_torch.core.policy import (HookCircuitBreaker, KVCachePolicy,
                                     ReconfigPolicy, RecoveryPolicy,
                                     RequestPolicy)
from repro_torch.serving.engine import (DrainStallError, Engine, Request,
                                        RequestState)

EngineFactory = Callable[[ReplicaGroup], Engine]

MIGRATION_MODES = ("drain", "migrate", "recompute")


@dataclass(frozen=True)
class PoolDiff:
    """Outcome of one reconfiguration, with measured wall-clock."""
    built: Tuple[ReplicaGroup, ...]
    reused: Tuple[ReplicaGroup, ...]
    removed: Tuple[ReplicaGroup, ...]
    drained_requests: int
    wall_s: float
    migrated_requests: int = 0
    recomputed_requests: int = 0
    migrate_wall_s: float = 0.0
    drain_wall_s: float = 0.0

    @property
    def changed(self) -> bool:
        return bool(self.built or self.removed)


class EnginePool:
    """Replica engines keyed by their (hashable, frozen) ReplicaGroup."""

    def __init__(self, factory: EngineFactory, max_replicas_per_group: int = 2,
                 backlog_cap: int = 256):
        self._factory = factory
        self._max_replicas = max_replicas_per_group
        self._backlog_cap = backlog_cap
        self.backlog_dropped = 0
        self._replicas: Dict[ReplicaGroup, List[Engine]] = {}
        self.request_policy: Optional[RequestPolicy] = None
        self.reconfig_policy: Optional[ReconfigPolicy] = None
        self.kv_cache_policy: Optional[KVCachePolicy] = None
        self.recovery_policy: Optional[RecoveryPolicy] = None
        self.policy_errors = 0           # failing admit/reconfig hooks (advisory)
        self.plan: Optional[Plan] = None
        self.finished: List[RequestState] = []
        self.backlog: List[Tuple[str, Request]] = []   # (model, request)
        self.reconfig_count = 0
        self._retired_dispatches = 0     # counters of torn-down engines
        self._absorbed: Dict[int, int] = {}   # id(engine) -> finished absorbed
        self.breaker = HookCircuitBreaker()

    def _absorb(self, eng: Engine) -> List[RequestState]:
        """Move an engine's not-yet-absorbed finished records into
        ``self.finished`` exactly once."""
        start = self._absorbed.get(id(eng), 0)
        done = eng.finished[start:]
        self._absorbed[id(eng)] = len(eng.finished)
        self.finished.extend(done)
        return done

    # ------------------------------------------------------------------ #
    def engines_for(self, model: str) -> List[Engine]:
        return [e for g, engines in self._replicas.items()
                for e in engines if g.model == model]

    @property
    def engines(self) -> List[Engine]:
        return [e for engines in self._replicas.values() for e in engines]

    def set_request_policy(self, rp: Optional[RequestPolicy]) -> None:
        """Install request-domain hooks on every current and future replica
        (None restores FIFO admission)."""
        self.request_policy = rp
        self.breaker.reset("request")
        for eng in self.engines:
            eng.request_policy = rp

    def set_reconfig_policy(self, rp: Optional[ReconfigPolicy]) -> None:
        """Install the reconfig-domain hook (None restores drain)."""
        self.reconfig_policy = rp
        self.breaker.reset("reconfig")

    def set_kv_cache_policy(self, kp: Optional[KVCachePolicy]) -> None:
        """Install prefix-cache admission/eviction hooks on every current
        and future replica (None restores admit-everything + LRU)."""
        self.kv_cache_policy = kp
        self.breaker.reset("kv_cache")
        for eng in self.engines:
            eng.kv_cache_policy = kp

    def set_recovery_policy(self, rp: Optional[RecoveryPolicy]) -> None:
        """Store the recovery-domain hook; the failure path that consults it
        comes with the faults slice."""
        self.recovery_policy = rp
        self.breaker.reset("recovery")

    def fail(self, eng: Engine, deny_export: bool = False,
             reason: str = "fault"):
        """Abrupt replica death and its recovery — the faults slice."""
        raise NotImplementedError("replica failure recovery (fail/salvage/"
                                  "retry) comes with the faults slice")

    # --- circuit-breaker plumbing (pool-level hook call sites) --------- #
    def _hook_error(self, domain: str) -> None:
        self.policy_errors += 1
        self.breaker.failure(domain)

    def _hook_ok(self, domain: str) -> None:
        self.breaker.success(domain)

    # ------------------------------------------------------------------ #
    def _migration_mode(self, eng: Engine, st: RequestState) -> str:
        """Per-request drain|migrate|recompute decision.  Hook failures and
        unknown answers fall back to drain."""
        rp = self.reconfig_policy
        if rp is None or self.breaker.tripped("reconfig"):
            return "drain"
        try:
            mode = rp.migration_mode(eng.migration_ctx_for(st))
        except Exception:  # noqa: BLE001 — evolved code must not kill serving
            self._hook_error("reconfig")
            return "drain"
        self._hook_ok("reconfig")
        return mode if mode in MIGRATION_MODES else "drain"

    def reconfigure(self, plan: Plan) -> PoolDiff:
        """Apply a new plan; rebuild only what changed.  Measured wall-clock
        covers the in-flight hand-off (migrate/recompute/drain) and the
        build."""
        t0 = time.monotonic()
        new_groups = set(plan.groups)
        old_groups = set(self._replicas)
        removed = old_groups - new_groups
        added = new_groups - old_groups
        reused = old_groups & new_groups

        def adopt(eng: Engine) -> Engine:
            eng.request_policy = self.request_policy
            eng.kv_cache_policy = self.kv_cache_policy
            eng.breaker = self.breaker
            return eng

        def build_added() -> None:
            # sorted: replica construction order must not depend on
            # set-iteration order
            for g in sorted(added, key=repr):
                n = max(1, min(g.count, self._max_replicas))
                self._replicas[g] = [adopt(self._factory(g))
                                     for _ in range(n)]
            for g in sorted(reused, key=repr):
                n = max(1, min(g.count, self._max_replicas))
                while len(self._replicas[g]) < n:
                    self._replicas[g].append(adopt(self._factory(g)))

        # recompute hands continuations to the NEW groups, so they are built
        # first when a reconfig policy is installed; without one,
        # teardown-first keeps one cache generation live at a time
        build_first = (self.reconfig_policy is not None
                       and getattr(self.reconfig_policy, "may_migrate", True))
        if build_first:
            build_added()

        drained = migrated = recomputed = 0
        migrate_s = drain_s = 0.0
        requeue: List[Tuple[str, Request]] = []
        for g in sorted(removed, key=repr):   # deterministic teardown order
            survivors = [e for gg, engines in self._replicas.items()
                         if gg.model == g.model and gg not in removed
                         for e in engines]

            def route_continuation(req: Request) -> bool:
                """Hand an in-flight continuation to the least-loaded
                survivor it fits."""
                fitting = [e for e in survivors
                           if len(req.prompt) <= e.max_prompt_len(
                               req.max_new_tokens)]
                if not fitting:
                    return False
                min(fitting,
                    key=lambda e: e.load / max(e.n_slots, 1)).submit(req)
                return True

            for eng in self._replicas[g]:
                requeue.extend((g.model, r) for r in eng.waiting)
                eng.waiting.clear()
                self._absorb(eng)
                for slot in sorted(eng.active):
                    st = eng.active[slot]
                    mode = self._migration_mode(eng, st)
                    if mode == "drain":
                        continue
                    # the slot's pages stay mapped until the request lives
                    # elsewhere, so a fall-through drain decodes from them
                    if mode == "migrate" and any(e.free_slots()
                                                 for e in survivors):
                        t1 = time.monotonic()
                        export = eng.export_slot(slot, release=False)
                        ok = any(tgt.install_active(export) for tgt in sorted(
                            (e for e in survivors if e.free_slots()),
                            key=lambda e: e.load / max(e.n_slots, 1)))
                        migrate_s += time.monotonic() - t1
                        if ok:
                            migrated += 1
                        elif route_continuation(export.request):
                            recomputed += 1     # incompatible target
                        else:            # nowhere it fits losslessly: drain
                            eng.active[slot] = export.state
                            continue
                    else:                # recompute (or migrate w/o a slot)
                        export = eng.export_slot(slot, with_state=False,
                                                 release=False)
                        if route_continuation(export.request):
                            recomputed += 1
                        else:            # fits nowhere: drain in place
                            eng.active[slot] = export.state
                            continue
                    eng.release_exported(slot, st)
                if eng.active:
                    t1 = time.monotonic()
                    eng.run_until_drained()
                    drained += len(self._absorb(eng))
                    drain_s += time.monotonic() - t1
                self._retired_dispatches += eng.dispatches
                self._absorbed.pop(id(eng), None)
            del self._replicas[g]

        if not build_first:
            build_added()

        pending, self.backlog = requeue + self.backlog, []
        for model, req in pending:
            if not self.submit(model, req):
                self.add_backlog(model, req)

        self.plan = plan
        self.reconfig_count += 1
        return PoolDiff(built=tuple(sorted(added, key=repr)),
                        reused=tuple(sorted(reused, key=repr)),
                        removed=tuple(sorted(removed, key=repr)),
                        drained_requests=drained,
                        wall_s=time.monotonic() - t0,
                        migrated_requests=migrated,
                        recomputed_requests=recomputed,
                        migrate_wall_s=migrate_s, drain_wall_s=drain_s)

    # ------------------------------------------------------------------ #
    def add_backlog(self, model: str, req: Request) -> None:
        """Hold a request no current replica can take; bounded."""
        if req.arrival_time == 0.0:
            req.arrival_time = time.monotonic()
        self.backlog.append((model, req))
        if len(self.backlog) > self._backlog_cap:
            drop = len(self.backlog) - self._backlog_cap
            del self.backlog[:drop]
            self.backlog_dropped += drop

    def submit(self, model: str, req: Request, force: bool = False) -> bool:
        """Route to the least-loaded replica serving ``model``, gated by the
        request policy's ``admit`` hook.  Returns False when no replica
        serves the model or the policy declines; ``force`` bypasses the
        gate, never the coverage check."""
        if req.arrival_time == 0.0:
            req.arrival_time = time.monotonic()
        engines = self.engines_for(model)
        if not engines:
            return False
        target = min(engines, key=lambda e: (e.load / max(e.n_slots, 1)))
        if (self.request_policy is not None and not force
                and not self.breaker.tripped("request")):
            try:
                admitted = self.request_policy.admit(
                    target.request_ctx_for(req))
            except Exception:  # noqa: BLE001 — advisory hook, never fatal
                self._hook_error("request")
            else:
                self._hook_ok("request")
                if not admitted:
                    return False
        target.submit(req)
        return True

    # ------------------------------------------------------------------ #
    def _flush_backlog(self) -> None:
        """Retry backlogged requests against the current topology/load."""
        if not self.backlog:
            return
        pending, self.backlog = self.backlog, []
        for model, req in pending:
            if not self.submit(model, req):
                self.backlog.append((model, req))

    def _force_one_backlogged(self) -> bool:
        """Forced progress when every engine is idle yet the admit gate
        still declines: push the first routable backlog entry through."""
        for i, (model, req) in enumerate(self.backlog):
            if self.submit(model, req, force=True):
                del self.backlog[i]
                return True
        return False

    def run_until_drained(self, max_steps: int = 10_000) -> List[RequestState]:
        """Step engines round-robin until all queues empty; returns every
        finished record not yet absorbed into ``self.finished``.  Raises
        :class:`DrainStallError` when ``max_steps`` runs out with work in
        flight."""
        taken = 0
        while taken < max_steps:
            self._flush_backlog()
            busy = [e for e in self.engines if e.waiting or e.active]
            if not busy:
                if self.backlog and self._force_one_backlogged():
                    continue
                break
            for eng in busy:
                eng.step()
            taken += 1
        if taken >= max_steps and (
                any(e.waiting or e.active for e in self.engines)
                or any(self.engines_for(m) for m, _ in self.backlog)):
            n_q = sum(len(e.waiting) + len(e.active) for e in self.engines)
            raise DrainStallError(
                f"pool stalled: {n_q} requests on engines, "
                f"{len(self.backlog)} backlogged after {max_steps} steps")
        done: List[RequestState] = []
        for eng in self.engines:
            done.extend(self._absorb(eng))
        return done

    @property
    def total_dispatches(self) -> int:
        return (self._retired_dispatches
                + sum(e.dispatches for e in self.engines))

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

Requests are routed per model to the least-loaded replica.  An unplanned
replica death (:meth:`EnginePool.fail`) is contained per the recovery
policy: each in-flight request is **salvaged** (its state installed into a
survivor), **recomputed** (a continuation requeued with capped exponential
backoff) or **shed**, and the dead engine's pages are released exactly
once.  Straggler quarantine biases routing away from replicas whose step
time runs far above the pool median.  The pool stamps arrivals and waits
out backoff windows through an injectable clock (``now_fn``/``wait_fn``),
which the shadow pool drives on virtual time.
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
RECOVERY_MODES = ("salvage", "recompute", "shed")


@dataclass(frozen=True)
class FailureReport:
    """Outcome of one ``fail(engine)`` — per-request dispositions plus the
    page-accounting check (``leaked_pages`` must be 0 when the dead engine
    owned its page pool exclusively)."""
    model: str
    reason: str
    salvaged: int          # live KV/SSM state moved to a survivor
    recomputed: int        # continuation requeued, pays re-prefill
    requeued: int          # queued (never-prefilled) work re-routed
    shed: int              # dropped per policy / retry-budget exhaustion
    leaked_pages: int


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
                 backlog_cap: int = 256,
                 now_fn: Callable[[], float] = time.monotonic,
                 wait_fn: Optional[Callable[[float], None]] = None):
        self._factory = factory
        self._max_replicas = max_replicas_per_group
        self._backlog_cap = backlog_cap
        # arrival-stamping clock; a virtually-clocked shadow pool injects its
        # deterministic clock, and wait_fn its backoff "sleep"
        self._now = now_fn
        self._wait = wait_fn if wait_fn is not None else time.sleep
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
        # fault-tolerance state: one breaker shared with every replica, the
        # shed ledger (finished + shed == submitted), and the straggler
        # quarantine (ids excluded from new-submission routing)
        self.breaker = HookCircuitBreaker()
        self.failures = 0
        self.failure_log: List[FailureReport] = []
        self.shed_requests: List[Request] = []
        self.salvaged_requests = 0
        self.requeued_requests = 0
        self.retry_exhausted = 0
        self.straggler_quarantines = 0
        self._quarantined: set = set()       # id(engine)

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

    def group_of(self, engine: Engine) -> Optional[ReplicaGroup]:
        for g, engines in self._replicas.items():
            if engine in engines:
                return g
        return None

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
        """Install the recovery-domain hook deciding each in-flight request's
        fate when its replica dies (None restores the salvage-first default),
        plus the retry/backoff/straggler knobs riding on the policy."""
        self.recovery_policy = rp
        self.breaker.reset("recovery")

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
                self._absorbed.pop(id(eng), None)   # engine retires; its id
                self._quarantined.discard(id(eng))  # may be reused by Python
                eng.release_devices()
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
            req.arrival_time = self._now()
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
            req.arrival_time = self._now()
        engines = self.engines_for(model)
        if not engines:
            return False
        # healthy-first routing: quarantined stragglers keep decoding what
        # they hold but take no new work unless they are all that's left
        healthy = [e for e in engines if id(e) not in self._quarantined]
        target = min(healthy or engines,
                     key=lambda e: (e.load / max(e.n_slots, 1)))
        if not force and self._degraded_declines(target):
            return False
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

    def degraded(self) -> bool:
        """True while any replica group runs below its plan's target count
        (i.e. fail() removed capacity that no reconfigure has healed yet)."""
        return any(len(engines) < max(1, min(g.count, self._max_replicas))
                   for g, engines in self._replicas.items())

    def _degraded_declines(self, target: Engine) -> bool:
        """Recovery-policy admission clamp: while capacity is reduced, shed
        ingress past ``degraded_admit_cap × n_slots`` outstanding instead of
        queueing work the shrunken pool cannot serve in time."""
        rp = self.recovery_policy
        cap = 0.0 if rp is None else float(rp.degraded_admit_cap)
        return (cap > 0.0 and self.degraded()
                and target.load >= cap * max(target.n_slots, 1))

    # ------------------------------------------------------------------ #
    # unplanned-failure containment: fail(), recovery dispositions,
    # retry/backoff requeue, straggler quarantine
    # ------------------------------------------------------------------ #
    def fail(self, eng: Engine, deny_export: bool = False,
             reason: str = "fault") -> FailureReport:
        """Abrupt replica death — the unplanned counterpart of a reconfigure
        teardown.  Per the evolvable recovery policy, each in-flight request
        is **salvaged** (live KV/SSM slot state installed into a survivor via
        the migration machinery), **recomputed** (continuation requeued with
        capped exponential backoff, paying re-prefill), or **shed**; queued
        work is requeued under the same backoff/budget.  ``deny_export``
        models a crash that corrupts slot exports (spot preemption with no
        warning): state cannot leave the replica, only recompute/shed apply.
        The dead engine's page references are released exactly once."""
        g = self.group_of(eng)
        if g is None:
            raise ValueError("fail(): engine is not in this pool")
        model = g.model
        now = self._now()
        self._absorb(eng)                # finished records are not lost
        self._replicas[g] = [e for e in self._replicas[g] if e is not eng]
        survivors = self.engines_for(model)
        salvaged = recomputed = requeued = shed = 0

        for req in eng.waiting:          # queued, never-prefilled work
            if self._requeue_failed(model, req, now):
                requeued += 1
            else:
                shed += 1
        eng.waiting.clear()

        for slot in sorted(eng.active):
            st = eng.active[slot]
            mode = self._recovery_mode(eng, st, survivors, deny_export)
            if mode == "salvage" and not deny_export:
                export = eng.export_slot(slot)
                ok = False
                for tgt in sorted((e for e in survivors if e.free_slots()),
                                  key=lambda e: e.load / max(e.n_slots, 1)):
                    if tgt.install_active(export):
                        ok = True
                        break
                if ok:
                    salvaged += 1
                    continue
                # nowhere the state fits losslessly: the continuation (which
                # carries first_token_time/prior_generated) recomputes
                if self._requeue_failed(model, export.request, now):
                    recomputed += 1
                else:
                    shed += 1
                continue
            # recompute or shed: no cache copy either way — export_slot
            # still runs to pop the slot and release its pages exactly once
            export = eng.export_slot(slot, with_state=False)
            if mode == "shed":
                self.shed_requests.append(export.request)
                shed += 1
            elif self._requeue_failed(model, export.request, now):
                recomputed += 1
            else:
                shed += 1

        leaked = eng.release_all_pages()
        eng.release_devices()            # a kill frees the dead replica's
        self._retired_dispatches += eng.dispatches   # submesh for re-carving
        self._absorbed.pop(id(eng), None)
        self._quarantined.discard(id(eng))
        self.failures += 1
        self.salvaged_requests += salvaged
        report = FailureReport(model=model, reason=reason, salvaged=salvaged,
                               recomputed=recomputed, requeued=requeued,
                               shed=shed, leaked_pages=leaked)
        self.failure_log.append(report)
        return report

    def _recovery_mode(self, eng: Engine, st: RequestState,
                       survivors: List[Engine], deny_export: bool) -> str:
        """Per-request salvage|recompute|shed decision.  Advisory like every
        evolved hook: failures, tripped breakers, and unknown answers fall
        back to salvage-when-possible (the lossless default)."""
        exportable = (not deny_export
                      and any(e.free_slots() for e in survivors))
        fallback = "salvage" if exportable else "recompute"
        rp = self.recovery_policy
        if rp is None or self.breaker.tripped("recovery"):
            return fallback
        fctx = eng.failure_ctx_for(
            st, exportable, len(survivors),
            sum(len(e.free_slots()) for e in survivors),
            sum(e.load for e in survivors) + len(self.backlog))
        try:
            mode = rp.on_failure(fctx)
        except Exception:  # noqa: BLE001 — evolved code must not kill serving
            self._hook_error("recovery")
            return fallback
        self._hook_ok("recovery")
        return mode if mode in RECOVERY_MODES else fallback

    def _requeue_failed(self, model: str, req: Request, now: float) -> bool:
        """Requeue a request off a dead replica under the recovery policy's
        retry budget and capped exponential backoff.  Returns False (request
        shed, recorded in ``shed_requests``) once the budget is spent."""
        rp = self.recovery_policy
        budget = 3 if rp is None else int(rp.retry_budget)
        base = 0.02 if rp is None else float(rp.backoff_base_s)
        cap = 2.0 if rp is None else float(rp.backoff_cap_s)
        if req.retries >= budget:
            self.shed_requests.append(req)
            self.retry_exhausted += 1
            return False
        req.retries += 1
        req.not_before = now + min(base * (2.0 ** (req.retries - 1)), cap)
        self.requeued_requests += 1
        self.add_backlog(model, req)
        return True

    def _detect_stragglers(self) -> None:
        """Quarantine replicas whose measured step-time EMA exceeds
        ``straggler_factor`` × the pool median (recovery-policy knob; 0
        disables).  Quarantine only biases routing — the replica keeps
        decoding what it holds and is released when its EMA recovers."""
        rp = self.recovery_policy
        factor = 0.0 if rp is None else float(rp.straggler_factor)
        if factor <= 1.0:
            return
        engines = [e for e in self.engines if e.health_samples >= 4]
        if len(engines) < 2:
            return                        # no peer group to compare against
        med = sorted(e.step_ema_s for e in engines)[len(engines) // 2]
        if med <= 0.0:
            return
        for e in engines:
            if e.step_ema_s > factor * med:
                if id(e) not in self._quarantined:
                    self._quarantined.add(id(e))
                    self.straggler_quarantines += 1
            else:
                self._quarantined.discard(id(e))

    # ------------------------------------------------------------------ #
    def _flush_backlog(self) -> None:
        """Retry backlogged requests against the current topology/load; the
        admit gate turns the backlog into a throttle, not a drop.  Entries
        inside their backoff window (``not_before`` in the future) wait."""
        if not self.backlog:
            return
        now = self._now()
        pending, self.backlog = self.backlog, []
        for model, req in pending:
            if req.not_before > now or not self.submit(model, req):
                self.backlog.append((model, req))

    def _force_one_backlogged(self) -> bool:
        """Forced progress when every engine is idle yet the admit gate still
        declines (evolved hooks may decline unconditionally): push the first
        routable backlog entry straight to a replica, bypassing the gate.  An
        admit gate may shed load, never stall a drain.  Backoff windows are
        honoured — a retry waiting out its backoff is not forced early.
        Returns False when nothing is routable (models no current plan covers
        stay backlogged)."""
        now = self._now()
        for i, (model, req) in enumerate(self.backlog):
            if req.not_before > now:
                continue
            if self.submit(model, req, force=True):
                del self.backlog[i]
                return True
        return False

    def _next_backoff_delay(self) -> Optional[float]:
        """Wait needed before the earliest routable backoff entry becomes
        eligible; None when no backlog entry is waiting on a backoff window
        (then an idle pool is genuinely drained — or holds only un-routable
        models, which waiting cannot fix)."""
        now = self._now()
        pending = [req.not_before - now for model, req in self.backlog
                   if req.not_before > now and self.engines_for(model)]
        if not pending:
            return None
        return max(min(pending), 0.0) + 1e-4

    def run_until_drained(self, max_steps: int = 10_000) -> List[RequestState]:
        """Step engines round-robin until all queues empty; returns every
        finished record not yet absorbed into ``self.finished``.
        Interleaving keeps per-request timing (TTFT/TPOT) honest
        across replicas — serial draining would charge replica B's requests
        for replica A's entire runtime.  Backlogged requests are retried as
        load drains (admission throttling releases them); retries inside a
        backoff window are waited out via ``wait_fn`` (each wait consumes a
        step so a pathological backoff horizon still hits ``max_steps``).
        Raises :class:`DrainStallError` when ``max_steps`` is exhausted with
        work still in flight — a stall must not masquerade as a drain."""
        taken = 0
        while taken < max_steps:
            self._flush_backlog()
            engines = self.engines       # fail() may remove replicas mid-run
            busy = [e for e in engines if e.waiting or e.active]
            if not busy:
                if self.backlog and self._force_one_backlogged():
                    continue
                delay = self._next_backoff_delay()
                if delay is None:
                    break
                self._wait(delay)
                taken += 1
                continue
            for eng in busy:
                eng.step()
            self._detect_stragglers()
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

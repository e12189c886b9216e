"""Two-plane self-evolving runtime (§4, §6.2) (port of ``src/repro/core/runtime.py``).

* DataPlane — executes the live policy at every monitoring step, applies
  plans to a backend (simulator, shadow or the port's engines on the card), records runtime
  conditions into a circular buffer (sliding-window snapshotting), and
  hot-swaps in staged policy code at step boundaries.
* ControlPlane — asynchronously snapshots the recent trace, runs an
  LLM-driven evolution cycle (warm-started from the previous cycle), and
  stages superior policies for the data plane.

Both planes can run threaded (``run_async``) or be stepped deterministically
(``step``) for tests and benchmarks.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Deque, Dict, List, Optional

from repro_torch.core.evaluator import Evaluator, EvalResult
from repro_torch.core.evolution import Evolution, EvolutionConfig, EvolutionState
from repro_torch.core.mutation import Mutator
from repro_torch.core.execution_model import (ExecutionAccumulator, IntervalMetrics,
                                        IntervalRecord, canary_regression)
from repro_torch.core.plan import ClusterState, Ctx, Plan, Workload
from repro_torch.core.policy import Policy
from repro_torch.traces.workload import TimestampObservation, Trace

if TYPE_CHECKING:                    # structural Backend protocol lives in
    from repro_torch.serving.backend import Backend   # serving; core stays import-free


# --------------------------------------------------------------------------- #
# staging area: policy hot-swap (§6.2, Fig. 6 left) + canary tickets
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class CanaryTicket:
    """Rollout contract attached to a staged policy: serve ``intervals``
    monitoring steps under the candidate, compare against the incumbent's
    trailing window, and commit or roll back (guarded adaptation)."""
    intervals: int = 2
    max_regression: float = 0.5          # tolerated fractional regression
    policy_name: str = ""
    fitness: float = float("inf")        # ladder fitness that won the cycle
    incumbent_fitness: float = float("inf")


class PolicyStage:
    """Shared staging area; swap is a pure source-code replacement.  A
    publish may carry a :class:`CanaryTicket` — the data plane then treats
    the swap as a canary rollout instead of an unconditional commit.

    The stage is also the planes' rollback ledger: the data plane reports
    sources whose canary regressed live, and the control plane consults the
    quarantine before republishing — a shadow-winning but live-regressing
    candidate must not take a fresh canary window every cycle.
    """

    def __init__(self, path: Optional[Path] = None):
        self._lock = threading.Lock()
        self._source: Optional[str] = None
        self._ticket: Optional[CanaryTicket] = None
        self._version = 0
        self._path = path
        self._quarantine: set = set()

    def report_rollback(self, source: str) -> None:
        with self._lock:
            self._quarantine.add(source)

    def quarantined(self, source: str) -> bool:
        with self._lock:
            return source in self._quarantine

    def publish(self, policy: Policy,
                ticket: Optional[CanaryTicket] = None) -> int:
        with self._lock:
            self._source = policy.source
            self._ticket = ticket
            self._version += 1
            if self._path is not None:
                tmp = self._path.with_suffix(".tmp")
                tmp.write_text(policy.source)
                tmp.rename(self._path)          # atomic swap on POSIX
            return self._version

    def poll(self, seen_version: int) -> Optional[tuple]:
        with self._lock:
            if self._version > seen_version and self._source is not None:
                return self._version, self._source, self._ticket
        return None


# --------------------------------------------------------------------------- #
# sliding-window trace snapshotting (§6.2, Fig. 6 right)
# --------------------------------------------------------------------------- #
class SnapshotBuffer:
    """Fixed-size circular buffer of monitoring observations."""

    def __init__(self, capacity: int = 64):
        self._buf: Deque[TimestampObservation] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, obs: TimestampObservation) -> None:
        with self._lock:
            self._buf.append(obs)
            self._seq += 1

    @property
    def seq(self) -> int:
        """Total observations ever recorded — lets the control plane skip
        cycles when nothing new arrived since the last one."""
        with self._lock:
            return self._seq

    def snapshot(self, window: int, name: str = "snapshot") -> Optional[Trace]:
        with self._lock:
            if not self._buf:
                return None
            obs = list(self._buf)[-window:]
        models = tuple(sorted({w.model for o in obs for w in o.workloads}))
        reindexed = tuple(
            TimestampObservation(i, o.time, o.workloads, o.cluster, o.metrics)
            for i, o in enumerate(obs))
        return Trace(name, reindexed, models)


def snapshot_fingerprint(trace: Trace) -> tuple:
    """Content identity of a snapshot (metrics excluded — evaluation depends
    only on workloads/cluster), for caching evaluations across cycles."""
    return tuple((o.time, o.workloads, o.cluster) for o in trace.observations)


# --------------------------------------------------------------------------- #
# data plane
# --------------------------------------------------------------------------- #
@dataclass
class _CanaryState:
    """One in-flight canary rollout: the candidate is live, the incumbent is
    retained for instant restoration."""
    ticket: CanaryTicket
    candidate: Policy
    incumbent: Policy                    # placement policy to restore
    incumbent_hooks: Policy              # program whose request/reconfig hooks
    remaining: int = 0                   # were pushed before the swap
    records: List[IntervalRecord] = field(default_factory=list)
    baseline: List[IntervalRecord] = field(default_factory=list)


@dataclass
class DataPlane:
    evaluator: Evaluator                       # supplies ctx/cost machinery
    policy: Policy
    stage: PolicyStage
    buffer: SnapshotBuffer
    backend: Optional["Backend"] = None        # plan execution target
    acc: ExecutionAccumulator = None
    plan: Optional[Plan] = None
    swap_count: int = 0
    commits: int = 0                           # canaries that held
    rollbacks: int = 0                         # canaries that regressed
    rollback_reasons: List[str] = field(default_factory=list)
    _seen_version: int = 0
    _last_w: Optional[List[Workload]] = None
    _last_c: Optional[ClusterState] = None
    _scratch: Dict = field(default_factory=lambda: {"steps_since_resched": 0})
    _step_idx: int = 0
    _canary: Optional[_CanaryState] = None
    _recent: Deque = field(default_factory=lambda: deque(maxlen=16))
    _hooks_policy: Policy = None               # program behind the live hooks
    _force_resched: bool = False               # re-plan after a rollback
    _live_recovery: object = None              # RecoveryPolicy behind the hooks
    _seen_failures: int = 0                    # backend failure_count watermark
    _seen_trips: int = 0                       # breaker trip-count watermark

    def __post_init__(self):
        if self.acc is None:
            self.acc = ExecutionAccumulator(self.evaluator.sim)
        self.policy.compile()
        self._push_request_policy(self.policy)
        self._hooks_policy = self.policy

    def _push_request_policy(self, policy: Policy) -> None:
        """Hand the program's request-, reconfig- and kv_cache-domain hooks
        to the backend (None for programs without the domain restores the
        backend defaults: FIFO admission, synchronous drain on reconfigure,
        admit-everything LRU prefix caching)."""
        if self.backend is None:
            return
        if hasattr(self.backend, "set_request_policy"):
            self.backend.set_request_policy(policy.request_policy())
        if hasattr(self.backend, "set_reconfig_policy"):
            self.backend.set_reconfig_policy(policy.reconfig_policy())
        if hasattr(self.backend, "set_kv_cache_policy"):
            self.backend.set_kv_cache_policy(policy.kv_cache_policy())
        if hasattr(self.backend, "set_recovery_policy"):
            rec = policy.recovery_policy()
            self.backend.set_recovery_policy(rec)
            self._live_recovery = rec

    def maybe_hot_swap(self) -> bool:
        """Load staged policy code at a monitoring-step boundary (§6.2).

        Policy API v2: the staged source is a multi-domain PolicyProgram.
        Its placement hooks (if implemented) replace the live policy; its
        request hooks are pushed to the serving backend.  A staged program
        that compiles but implements no known domain is rejected exactly
        like one that fails to compile — serving is never disrupted.

        A staged publish carrying a :class:`CanaryTicket` starts a guarded
        rollout: the candidate goes live, but the incumbent (and its hooks)
        is retained until the canary window resolves — commit or rollback.
        A newer publish is deferred while a canary is in flight.
        """
        if self._canary is not None:
            return False                 # resolve the active canary first
        staged = self.stage.poll(self._seen_version)
        if staged is None:
            return False
        version, source, ticket = staged
        try:
            new_policy = Policy(source=source,
                                name=f"swap-v{version}").compile()
        except Exception:  # noqa: BLE001 — bad staged code never disrupts serving
            self._seen_version = version
            return False
        if ticket is not None and ticket.intervals > 0:
            self._canary = _CanaryState(
                ticket=ticket, candidate=new_policy,
                incumbent=self.policy, incumbent_hooks=self._hooks_policy,
                remaining=ticket.intervals,
                baseline=list(self._recent)[-max(ticket.intervals, 2):])
        if new_policy.implements("placement"):
            self.policy = new_policy
        # a request-only program rides alongside the live placement policy;
        # a placement-only one resets engines to their FIFO default
        self._push_request_policy(new_policy)
        self._hooks_policy = new_policy
        self._seen_version = version
        self.swap_count += 1
        return True

    def _canary_observe(self, rec: IntervalRecord) -> Dict:
        """Account one canary interval; resolve the window when it closes."""
        c = self._canary
        c.records.append(rec)
        c.remaining -= 1
        name = c.ticket.policy_name or c.candidate.name
        if c.remaining > 0:
            return {"status": "running", "candidate": name,
                    "remaining": c.remaining}
        self._canary = None
        reason = canary_regression(c.records, c.baseline,
                                   c.ticket.max_regression)
        if reason is not None:
            # rollback: restore the incumbent placement policy AND the
            # request/reconfig hooks that were live before the swap; force a
            # reschedule so the candidate's applied PLAN is displaced too —
            # a reactive incumbent trigger might otherwise keep serving the
            # regressing plan indefinitely
            self.policy = c.incumbent
            self._push_request_policy(c.incumbent_hooks)
            self._hooks_policy = c.incumbent_hooks
            self._force_resched = True
            self.rollbacks += 1
            self.rollback_reasons.append(f"{name}: {reason}")
            self.stage.report_rollback(c.candidate.source)
            return {"status": "rolled_back", "candidate": name,
                    "reason": reason}
        self.commits += 1
        # the candidate's window becomes the new trailing baseline
        self._recent.extend(c.records)
        return {"status": "committed", "candidate": name}

    def step(self, obs: TimestampObservation) -> Dict:
        """One monitoring step: hot-swap, trigger, schedule, apply the plan to
        the backend, serve the interval, record the (measured) observation."""
        swapped = self.maybe_hot_swap()
        ctx = Ctx(time=obs.time, timestamp_idx=self._step_idx,
                  workloads=list(obs.workloads), cluster=obs.cluster,
                  current_plan=self.plan, models=self.evaluator.models,
                  hardware=self.evaluator.hardware,
                  simulator=self.evaluator.sim,
                  last_resched_workloads=self._last_w,
                  last_resched_cluster=self._last_c, scratch=self._scratch)
        forced = False
        if self.plan is not None and self.plan.groups:
            ok, _ = self.evaluator.sim.plan_feasible(
                self.plan, obs.cluster, list(obs.workloads))
            forced = not ok
        trigger = (self.plan is None or forced or self._force_resched
                   or self.policy.should_reschedule(ctx))
        self._force_resched = False
        report = None
        metrics: Optional[IntervalMetrics] = None
        if trigger:
            t0 = time.monotonic()
            new_plan = self.policy.schedule(ctx)
            dt = (time.monotonic() - t0) * self.evaluator.sched_time_scale
            if self.backend is not None:
                report = self.backend.apply_plan(new_plan, ctx)
                metrics = self._serve(obs, reconfig_s=report.wall_s)
            rec = self.acc.interval(self._step_idx, self.plan, new_plan,
                                    list(obs.workloads), t_sched=dt,
                                    rescheduled=True, measured=metrics)
            self.plan = new_plan
            self._last_w, self._last_c = list(obs.workloads), obs.cluster
            self._scratch["steps_since_resched"] = 0
        else:
            if self.backend is not None:
                metrics = self._serve(obs, reconfig_s=0.0)
            rec = self.acc.interval(self._step_idx, self.plan, self.plan,
                                    list(obs.workloads), t_sched=0.0,
                                    rescheduled=False, measured=metrics)
            self._scratch["steps_since_resched"] += 1
        # unplanned-failure containment surfacing: a replica death this
        # interval forces a re-plan when the live recovery policy says
        # failure should heal capacity (fail_replan); hook-circuit-breaker
        # trips quarantine the source in the rollback ledger so the control
        # plane never republishes the program whose hooks crashed serving
        failures = int(getattr(self.backend, "failure_count", 0) or 0)
        new_failures = failures - self._seen_failures
        self._seen_failures = failures
        if (new_failures > 0 and self._live_recovery is not None
                and getattr(self._live_recovery, "fail_replan", False)):
            self._force_resched = True
        breaker = getattr(self.backend, "breaker", None)
        breaker_open: tuple = ()
        if breaker is not None:
            breaker_open = breaker.open_domains
            trips = sum(breaker.trips.values())
            if trips > self._seen_trips and self._hooks_policy is not None:
                self.stage.report_rollback(self._hooks_policy.source)
            self._seen_trips = trips
        canary = None
        if self._canary is not None:
            canary = self._canary_observe(rec)
        else:
            self._recent.append(rec)
        # the snapshot buffer sees what the interval actually measured
        self.buffer.record(dataclasses.replace(obs, metrics=metrics)
                           if metrics is not None else obs)
        self._step_idx += 1
        return {"rescheduled": rec.rescheduled, "interval_total": rec.total,
                "hot_swapped": swapped, "plan": self.plan,
                "reconfig_report": report, "metrics": metrics,
                "canary": canary, "rollbacks": self.rollbacks,
                "failures": new_failures, "breaker_open": breaker_open}

    def _serve(self, obs: TimestampObservation,
               reconfig_s: float) -> IntervalMetrics:
        metrics = self.backend.serve_interval(list(obs.workloads))
        return dataclasses.replace(metrics, reconfig_s=reconfig_s)


# --------------------------------------------------------------------------- #
# control plane
# --------------------------------------------------------------------------- #
@dataclass
class ControlPlane:
    evaluator: Evaluator
    stage: PolicyStage
    buffer: SnapshotBuffer
    evolution_cfg: EvolutionConfig
    window: int = 16
    mutator: Optional[Mutator] = None
    state: Optional[EvolutionState] = None          # warm-start carrier (§6.1)
    shadow: Optional[object] = None                 # EvalBackend: second rung
    canary_intervals: int = 2                       # guarded-rollout window
    canary_max_regression: float = 0.5
    cycles: int = 0
    skipped_cycles: int = 0                         # no new observations
    published: int = 0
    quarantined_skips: int = 0                      # winners vetoed by ledger
    best_fitness: float = float("inf")
    incumbent_cache_hits: int = 0
    _last_seq: int = -1
    _incumbent_cache: Dict = field(default_factory=dict)

    def _eval_incumbent(self, policy: Policy, snap: Trace,
                        backend) -> EvalResult:
        """Incumbent evaluation on the SAME ladder rung that produced the
        winning candidate (fitness scales are rung-specific), cached per
        (rung, policy source, snapshot content) — identical snapshots across
        cycles stop re-replaying an unchanged incumbent from scratch."""
        key = (getattr(backend, "name", type(backend).__name__),
               policy.source, snapshot_fingerprint(snap))
        hit = self._incumbent_cache.get(key)
        if hit is not None:
            self.incumbent_cache_hits += 1
            return hit
        res = backend.evaluate(policy, snap)
        if len(self._incumbent_cache) >= 16:        # bounded: snapshots churn
            self._incumbent_cache.clear()
        self._incumbent_cache[key] = res
        return res

    def run_cycle(self, current_policy: Optional[Policy] = None) -> Optional[EvolutionState]:
        seq = self.buffer.seq
        if seq <= self._last_seq:
            # nothing new observed since the last cycle: an identical
            # snapshot can only reproduce the last cycle's verdicts
            self.skipped_cycles += 1
            return None
        snap = self.buffer.snapshot(self.window, name=f"cycle{self.cycles}")
        if snap is None or len(snap) < 2:
            return None
        self._last_seq = seq
        if (self.shadow is not None and current_policy is not None
                and current_policy.implements("placement")):
            # request-only candidates ride alongside the live placement
            # policy after a hot-swap; the shadow replays them the same way
            self.shadow.fallback_placement = current_policy
        evo = Evolution(self.evaluator, self.evolution_cfg,
                        mutator=self.mutator, shadow=self.shadow)
        extra = [current_policy] if current_policy is not None else None
        state = evo.run(snap, warm_start=self.state, extra_seeds=extra)
        self.cycles += 1
        # the deepest rung that produced a winner decides the rollout; the
        # incumbent comparison runs on that same rung — shadow and analytic
        # fitness carry different terms and are never compared to each other.
        # Candidates the data plane already rolled back are quarantined:
        # deterministic replay would otherwise re-elect them every cycle and
        # live serving would take a recurring canary regression window.
        if self.shadow is not None and state.shadow_best is not None:
            rung = self.shadow
            ranked = state.finalists
        else:
            rung = self.evaluator
            ranked = state.elites(k=8, backend="analytic")
        best = next((c for c in ranked
                     if not self.stage.quarantined(c.policy.source)), None)
        if best is None and ranked:
            self.quarantined_skips += 1
        if best is not None:
            incumbent = float("inf")
            if current_policy is not None:
                incumbent = self._eval_incumbent(current_policy, snap,
                                                 rung).fitness
            if best.fitness < incumbent:
                # staged rollout: the data plane canaries the candidate
                # against the incumbent's live trailing window before commit
                self.stage.publish(best.policy, ticket=CanaryTicket(
                    intervals=self.canary_intervals,
                    max_regression=self.canary_max_regression,
                    policy_name=best.policy.name, fitness=best.fitness,
                    incumbent_fitness=incumbent))
                self.published += 1
                self.best_fitness = best.fitness
        self.state = state                           # warm start for e_{i+1}
        return state


# --------------------------------------------------------------------------- #
# whole system: Autopoiesis
# --------------------------------------------------------------------------- #
@dataclass
class Autopoiesis:
    """Convenience wrapper wiring both planes over a live trace."""
    evaluator: Evaluator
    initial_policy: Policy
    evolution_cfg: EvolutionConfig
    window: int = 16
    mutator: Optional[Mutator] = None
    backend: Optional["Backend"] = None
    evolve_every: int = 4                       # control cycle cadence (steps)
    shadow: Optional[object] = None             # EvalBackend: ladder rung 2
    canary_intervals: int = 2
    canary_max_regression: float = 0.5

    def __post_init__(self):
        self.stage = PolicyStage()
        self.buffer = SnapshotBuffer(capacity=4 * self.window)
        self.data_plane = DataPlane(self.evaluator, self.initial_policy,
                                    self.stage, self.buffer,
                                    backend=self.backend)
        self.control_plane = ControlPlane(
            self.evaluator, self.stage, self.buffer, self.evolution_cfg,
            window=self.window, mutator=self.mutator, shadow=self.shadow,
            canary_intervals=self.canary_intervals,
            canary_max_regression=self.canary_max_regression)

    # deterministic co-stepping (tests / benchmarks)
    def run_trace(self, trace: Trace, evolve: bool = True) -> ExecutionAccumulator:
        for i, obs in enumerate(trace.observations):
            self.data_plane.step(obs)
            if evolve and i > 0 and i % self.evolve_every == 0:
                self.control_plane.run_cycle(self.data_plane.policy)
        return self.data_plane.acc

    # threaded (live) mode
    def run_async(self, trace: Trace, step_interval_s: float = 0.05
                  ) -> ExecutionAccumulator:
        stop = threading.Event()

        def control_loop():
            while not stop.is_set():
                self.control_plane.run_cycle(self.data_plane.policy)
                stop.wait(step_interval_s)

        th = threading.Thread(target=control_loop, daemon=True)
        th.start()
        try:
            for obs in trace.observations:
                self.data_plane.step(obs)
                time.sleep(step_interval_s)
        finally:
            stop.set()
            th.join(timeout=10)
        return self.data_plane.acc

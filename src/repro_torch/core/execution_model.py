"""Execution model (§5.1, Eq. 13 / Figure 4) — interval accounting under the
continuous execution constraint (port of ``src/repro/core/execution_model.py``).

Interval i ≥ 2 (triggered by should_reschedule):
  Phase 1 (scheduling):      duration = measured t_sched; serving continues
                             under plan_{i-1} at relative efficiency e_old.
  Phase 2 (reconfiguration): duration = RECONFIG-COST; overlapping portion
                             serves at e_overlap = overlap × e_old.
  Phase 3 (serving):         remaining work at full efficiency.

Work units: one timestamp's workload W_i costs serve_time(plan_i, W_i)
seconds at full efficiency under the NEW plan.  Work done during phases 1–2
is credited at the degraded rates, so

  t_serve(i) = max(0, serve_time(plan_i, W_i) − t_stale·e_old − t_reconfig·e_ov)

which preserves Eq. 13's additivity while modelling "serving never pauses".
Cold start (i = 1): nothing serves during scheduling (e_old = 0).
Non-rescheduled timestamps: the old plan simply serves the new workload
(mismatch shows up as a larger t_serve — accounting note in DESIGN.md §8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.plan import Plan, Workload
from repro_torch.core.simulator import PENALTY, Simulator


@dataclass(frozen=True)
class IntervalMetrics:
    """Measured serving-interval feedback from a real backend (Table 1's
    artifact fields, but observed instead of simulated).  ``measured`` is
    False for simulator-backed intervals — such metrics are recorded but
    never blended into the cost accounting."""
    requests: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    ttft_s: float = 0.0              # mean time-to-first-token
    ttft_p50_s: float = 0.0          # median TTFT (tail behaviour ≠ mean)
    ttft_p95_s: float = 0.0          # p95 TTFT
    tpot_s: float = 0.0              # pooled time-per-output-token
    tokens_per_s: float = 0.0
    reconfig_s: float = 0.0          # measured engine-rebuild wall-clock
    simulated_serve_s: float = 0.0
    backlogged: int = 0              # requests no replica could take this interval
    shed: int = 0                    # requests dropped (failure recovery /
    measured: bool = True            # retry-budget exhaustion / backlog cap)


@dataclass
class IntervalRecord:
    timestamp_idx: int
    rescheduled: bool
    t_sched: float = 0.0
    t_stale: float = 0.0
    t_reconfig: float = 0.0
    t_serve: float = 0.0
    t_request: float = 0.0           # blended measured TTFT/backlog penalty
    serve_full: float = 0.0          # serve_time(plan_i, W_i) at full efficiency
    plan_changed: bool = False
    metrics: Optional[IntervalMetrics] = None   # measured backend feedback

    @property
    def total(self) -> float:
        return self.t_stale + self.t_reconfig + self.t_serve + self.t_request

    @property
    def measured_reconfig_s(self) -> float:
        return self.metrics.reconfig_s if (self.metrics is not None
                                           and self.metrics.measured) else 0.0


@dataclass
class ExecutionAccumulator:
    sim: Simulator
    records: List[IntervalRecord] = field(default_factory=list)
    # Blend weight for measured vs simulated reconfiguration cost.  0.0 keeps
    # the pure-simulated accounting (bit-identical to the pre-backend path);
    # 1.0 trusts the measured wall-clock entirely.  ``measured_scale`` maps
    # backend wall-clock seconds onto cluster-scale simulator seconds
    # (reduced-model engines run orders of magnitude below production).
    measured_blend: float = 0.0
    measured_scale: float = 1.0
    # Weight on the measured *request-level* quality of an interval: tail
    # latency (p95 TTFT per served request) and backlog (requests no replica
    # admitted, charged one interval wall-clock each).  0.0 (default) keeps
    # fitness purely plan-level — the v1 accounting, bit-identical.
    request_blend: float = 0.0

    def interval(self, idx: int, old_plan: Optional[Plan], new_plan: Plan,
                 workloads: List[Workload], t_sched: float,
                 rescheduled: bool,
                 measured: Optional[IntervalMetrics] = None) -> IntervalRecord:
        serve_new = self.sim.serve_cost(new_plan, workloads)
        rec = IntervalRecord(idx, rescheduled, serve_full=serve_new,
                             metrics=measured)
        rec.t_request = self._request_penalty(measured)
        if not rescheduled:
            rec.t_serve = serve_new
            self.records.append(rec)
            return rec

        rec.t_sched = t_sched
        rec.plan_changed = (old_plan is None
                            or any(old_plan.placement(m) != new_plan.placement(m)
                                   for m in {g.model for g in new_plan.groups}))
        if old_plan is None or not old_plan.groups:
            # cold start: nothing serves during scheduling (model init folded in)
            rec.t_stale = t_sched
            rec.t_serve = serve_new
            self.records.append(rec)
            return rec

        serve_old = self.sim.serve_cost(old_plan, workloads)
        e_old = 0.0 if serve_old >= PENALTY else min(serve_new / max(serve_old, 1e-9), 1.0)
        t_rc = self.sim.reconfig_cost(old_plan, new_plan)
        if (measured is not None and measured.measured
                and self.measured_blend > 0.0):
            t_rc = ((1.0 - self.measured_blend) * t_rc
                    + self.measured_blend * self.measured_scale
                    * measured.reconfig_s)
        # overlap fraction: share of devices whose assignment is unchanged
        same = len(set(old_plan.groups) & set(new_plan.groups))
        denom = max(len(new_plan.groups), 1)
        overlap = same / denom
        e_ov = overlap * e_old

        rec.t_stale = t_sched
        rec.t_reconfig = t_rc
        done = t_sched * e_old + t_rc * e_ov
        rec.t_serve = max(serve_new - done, 0.0)
        self.records.append(rec)
        return rec

    def _request_penalty(self, measured: Optional[IntervalMetrics]) -> float:
        """Measured request-level term folded into the interval total: scaled
        tail TTFT across served requests plus a wall-clock charge per
        backlogged request."""
        if (measured is None or not measured.measured
                or self.request_blend <= 0.0):
            return 0.0
        tail = measured.ttft_p95_s * measured.requests
        backlog = measured.backlogged * measured.wall_s
        return self.request_blend * self.measured_scale * (tail + backlog)

    # aggregate (Table 1 artifact feedback fields)
    @property
    def T_total(self) -> float:
        return sum(r.total for r in self.records)

    @property
    def N(self) -> int:
        return sum(1 for r in self.records if r.rescheduled)

    @property
    def sum_sched(self) -> float:
        return sum(r.t_sched for r in self.records)

    @property
    def sum_stale(self) -> float:
        return sum(r.t_stale for r in self.records)

    @property
    def sum_reconfig(self) -> float:
        return sum(r.t_reconfig for r in self.records)

    @property
    def sum_serve(self) -> float:
        return sum(r.t_serve for r in self.records)

    @property
    def sum_request(self) -> float:
        return sum(r.t_request for r in self.records)

    @property
    def sum_measured_reconfig(self) -> float:
        return sum(r.measured_reconfig_s for r in self.records)

    @property
    def sum_backlogged(self) -> int:
        return sum(r.metrics.backlogged for r in self.records
                   if r.metrics is not None and r.metrics.measured)


# --------------------------------------------------------------------------- #
# canary window comparison (guarded rollout)
# --------------------------------------------------------------------------- #
def _weighted_p95(metrics: List[IntervalMetrics]) -> float:
    reqs = sum(m.requests for m in metrics)
    if reqs <= 0:
        return 0.0
    return sum(m.ttft_p95_s * m.requests for m in metrics) / reqs


def canary_regression(candidate: List[IntervalRecord],
                      baseline: List[IntervalRecord],
                      max_regression: float = 0.5) -> Optional[str]:
    """Did the candidate's canary window regress against the incumbent's
    trailing window?  Returns a human-readable reason (→ rollback), or None
    when the candidate holds (→ commit).

    Measured windows compare on request-level quality: request-weighted p95
    TTFT and backlog.  Interval totals are compared *normalised by
    ``serve_full``* (the interval's full-efficiency serving cost), so the
    ratio tracks policy-induced overhead rather than workload swings — the
    two windows almost never carry the same workload phases.

    An empty window on either side is no basis for a verdict: commit (the
    staged policy already won its evaluation-ladder comparison).
    """
    if not candidate or not baseline:
        return None
    tol = 1.0 + max(max_regression, 0.0)
    c_m = [r.metrics for r in candidate
           if r.metrics is not None and r.metrics.measured]
    b_m = [r.metrics for r in baseline
           if r.metrics is not None and r.metrics.measured]
    if c_m and b_m:
        c_p95, b_p95 = _weighted_p95(c_m), _weighted_p95(b_m)
        if b_p95 > 0.0 and c_p95 > b_p95 * tol:
            return (f"p95 TTFT {c_p95:.4f}s vs incumbent {b_p95:.4f}s "
                    f"(>{tol:.2f}x)")
        # per-interval rates: the two windows may have different lengths
        c_bk = sum(m.backlogged for m in c_m) / len(c_m)
        b_bk = sum(m.backlogged for m in b_m) / len(b_m)
        # one stray backlogged request per interval is noise, a pile is not
        if c_bk > max(b_bk * tol, b_bk + 1.0):
            return (f"backlog {c_bk:.1f}/interval vs incumbent "
                    f"{b_bk:.1f}/interval")
        # shed work is a loss, not a latency win: a recovery policy that
        # drops requests looks GOOD on TTFT (only survivors are timed), so
        # the guard compares shed rates with a tighter absolute allowance
        c_sh = sum(m.shed for m in c_m) / len(c_m)
        b_sh = sum(m.shed for m in b_m) / len(b_m)
        if c_sh > max(b_sh * tol, b_sh + 0.5):
            return (f"shed {c_sh:.1f}/interval vs incumbent "
                    f"{b_sh:.1f}/interval")

    def overhead_ratio(recs: List[IntervalRecord]) -> float:
        vals = [r.total / max(r.serve_full, 1e-9)
                for r in recs if r.serve_full > 0]
        return sum(vals) / len(vals) if vals else 0.0

    c_eff, b_eff = overhead_ratio(candidate), overhead_ratio(baseline)
    if b_eff > 0.0 and c_eff > b_eff * tol:
        return (f"interval cost {c_eff:.2f}x full-efficiency vs incumbent "
                f"{b_eff:.2f}x (>{tol:.2f}x)")
    return None

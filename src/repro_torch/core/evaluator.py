"""Trace-replay evaluation — the first rung of the evaluation ladder (port of ``src/repro/core/evaluator.py``).

The control plane ranks candidate policies through pluggable
:class:`EvalBackend` s:

  * :class:`AnalyticEval` (this module; §5.3) replays the snapshotted trace
    against the roofline simulator and produces structured artifact
    feedback (Table 1).  Cheap — it screens the whole population — but
    blind to request-level behaviour: programs without a placement domain
    return :data:`INFEASIBLE_FITNESS` here.
  * :class:`repro_torch.serving.shadow.ShadowReplayEval` (second rung) replays
    the same window through a deterministic engine-pool shadow, exercising
    the candidate's request/reconfig hooks, so request-only and
    reconfig-bearing programs become fitness-rankable.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, runtime_checkable

from repro_torch.core.execution_model import ExecutionAccumulator, IntervalRecord
from repro_torch.core.plan import ClusterState, Ctx, GPUType, ModelSpec, Plan
from repro_torch.core.policy import Policy
from repro_torch.core.simulator import PENALTY, Simulator
from repro_torch.core.timeouts import CandidateTimeout, run_with_deadline
from repro_torch.traces.workload import Trace

INFEASIBLE_FITNESS = float("inf")

# structured marker for "valid hot-swap payload, but this rung cannot rank
# it" — the evolution funnel forwards such candidates to the shadow rung
NO_PLACEMENT_ERROR = "no placement domain to evaluate"


@dataclass
class EvalResult:
    fitness: float                       # T_total (lower better); inf = invalid
    N: int = 0
    sum_sched: float = 0.0
    sum_stale: float = 0.0
    sum_reconfig: float = 0.0
    sum_serve: float = 0.0
    records: List[IntervalRecord] = field(default_factory=list)
    error: Optional[str] = None
    wall_s: float = 0.0
    backend: str = "analytic"            # which EvalBackend produced this
    ttft_p95_s: float = 0.0              # shadow rung: replayed tail latency
    backlogged: int = 0                  # shadow rung: unserved request count

    @property
    def valid(self) -> bool:
        return self.error is None and self.fitness < INFEASIBLE_FITNESS

    def artifact_feedback(self) -> Dict[str, float]:
        """Table 1 row for this candidate."""
        fb = {
            "N": self.N,
            "sum_sched": round(self.sum_sched, 3),
            "sum_stale": round(self.sum_stale, 3),
            "sum_reconfig": round(self.sum_reconfig, 3),
            "sum_serve": round(self.sum_serve, 3),
            "T_total": round(self.fitness, 3)
            if self.fitness < INFEASIBLE_FITNESS else float("inf"),
        }
        if self.backend != "analytic":
            # request-level terms only a replaying rung can observe
            fb["ttft_p95_s"] = round(self.ttft_p95_s, 4)
            fb["backlogged"] = self.backlogged
        return fb


@runtime_checkable
class EvalBackend(Protocol):
    """One rung of the evaluation ladder: scores a policy against a trace."""

    name: str

    def evaluate(self, policy: Policy, trace: Trace) -> EvalResult:
        ...


@dataclass
class Evaluator:
    sim: Simulator
    models: Dict[str, ModelSpec]
    hardware: Dict[str, GPUType]
    candidate_timeout_s: float = 20.0     # candidate-level timeout (§6.1)
    sched_time_scale: float = 1.0         # calibrate measured CPU time → cluster
    monitor_interval_s: float = 5.0
    name: str = "analytic"                # EvalBackend rung identity

    def make_ctx(self, trace: Trace, idx: int, current_plan: Optional[Plan],
                 last_w, last_c, scratch: Dict) -> Ctx:
        obs = trace.observations[idx]
        return Ctx(
            time=obs.time, timestamp_idx=idx,
            workloads=list(obs.workloads), cluster=obs.cluster,
            current_plan=current_plan, models=self.models,
            hardware=self.hardware, simulator=self.sim,
            history=[list(o.workloads) for o in trace.observations[max(0, idx - 3):idx]],
            last_resched_workloads=last_w, last_resched_cluster=last_c,
            scratch=scratch)

    def plan_step(self, policy: Policy, ctx: Ctx, obs, plan: Optional[Plan],
                  idx: int):
        """One replay step's trigger → schedule → validation chain, shared
        by every ladder rung (only the cost accounting differs between
        them).  Returns ``(trigger, new_plan, measured_dt, error)``; when
        ``error`` is set the candidate is infeasible and the rest of the
        tuple is meaningless."""
        forced = False
        if plan is not None and plan.groups:
            # mandatory resched when the plan no longer fits the cluster
            feas, _ = self.sim.plan_feasible(plan, obs.cluster,
                                             list(obs.workloads))
            forced = not feas
        try:
            if idx == 0 or plan is None or forced:
                trigger = True
            else:
                trigger, _ = run_with_deadline(
                    lambda: policy.should_reschedule(ctx),
                    self.candidate_timeout_s)
        except CandidateTimeout:
            return False, None, 0.0, "trigger timeout"
        except Exception as e:  # noqa: BLE001
            return False, None, 0.0, f"trigger: {e}"
        if not trigger:
            return False, None, 0.0, None
        try:
            new_plan, dt = run_with_deadline(
                lambda: policy.schedule(ctx), self.candidate_timeout_s)
        except CandidateTimeout:
            return True, None, 0.0, "schedule timeout"
        except Exception as e:  # noqa: BLE001
            return True, None, 0.0, f"schedule: {e}"
        if not isinstance(new_plan, Plan) or not new_plan.groups:
            return True, None, dt, "empty plan"
        feas, why = self.sim.plan_feasible(new_plan, obs.cluster,
                                           list(obs.workloads))
        if not feas:
            return True, None, dt, f"infeasible: {why}"
        # plans must cover every model in the workload
        served = {g.model for g in new_plan.groups}
        if any(w.model not in served for w in obs.workloads):
            return True, None, dt, "uncovered model"
        return True, new_plan, dt, None

    def evaluate(self, policy: Policy, trace: Trace) -> EvalResult:
        t_start = time.monotonic()

        def fail(err: str) -> EvalResult:
            # even failed candidates cost evaluation wall-clock; report it so
            # evolution telemetry sees where the cycle budget actually went
            return EvalResult(INFEASIBLE_FITNESS, error=err,
                              wall_s=time.monotonic() - t_start)

        try:
            policy.compile()
        except Exception as e:  # noqa: BLE001
            return fail(f"compile: {e}")
        if not policy.implements("placement"):
            # trace replay scores placement behaviour; request-only programs
            # are valid hot-swap payloads but cannot be fitness-ranked here —
            # the shadow rung of the ladder can (see module docstring)
            return fail(NO_PLACEMENT_ERROR)

        acc = ExecutionAccumulator(self.sim)
        plan: Optional[Plan] = None
        last_w = last_c = None
        scratch: Dict = {"steps_since_resched": 0}

        for idx in range(len(trace)):
            ctx = self.make_ctx(trace, idx, plan, last_w, last_c, scratch)
            obs = trace.observations[idx]
            trigger, new_plan, dt, err = self.plan_step(policy, ctx, obs,
                                                        plan, idx)
            if err is not None:
                return fail(err)

            if trigger:
                acc.interval(idx, plan, new_plan, list(obs.workloads),
                             t_sched=dt * self.sched_time_scale, rescheduled=True)
                plan = new_plan
                last_w, last_c = list(obs.workloads), obs.cluster
                scratch["steps_since_resched"] = 0
            else:
                acc.interval(idx, plan, plan, list(obs.workloads),
                             t_sched=0.0, rescheduled=False)
                scratch["steps_since_resched"] += 1

            if acc.T_total >= PENALTY:
                return fail("penalty serve cost")

        return EvalResult(
            fitness=acc.T_total, N=acc.N, sum_sched=acc.sum_sched,
            sum_stale=acc.sum_stale, sum_reconfig=acc.sum_reconfig,
            sum_serve=acc.sum_serve, records=acc.records,
            wall_s=time.monotonic() - t_start)


# ladder name for the analytic rung (the class predates the EvalBackend
# protocol; the alias keeps every existing Evaluator call-site working)
AnalyticEval = Evaluator

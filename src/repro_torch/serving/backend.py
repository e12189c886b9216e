"""Serving backends (port of ``src/repro/serving/backend.py``): how the data
plane executes a serving plan.

* :class:`SimBackend` closes the loop against the roofline simulator
  (``IntervalMetrics.measured`` is False, so nothing is blended into
  fitness).
* :class:`TorchBackend` is the counterpart of ``JaxBackend``: a real
  multi-replica :class:`~repro_torch.serving.pool.EnginePool` over the
  port's engines (paged for pageable families, contiguous otherwise).
  ``apply_plan`` measures the rebuild wall-clock and ``serve_interval``
  runs real requests and measures TTFT/TPOT/tok/s; an optional
  :class:`~repro_torch.serving.faults.FaultInjector` kills replicas while
  it serves.
* :class:`repro_torch.serving.shadow.ShadowBackend` is the deterministic,
  virtually-clocked pool of roofline-costed shadow engines.

All satisfy the :class:`Backend` protocol, so the port's ``DataPlane`` (and
the JAX package's, by duck typing) drives any of them.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import (List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.execution_model import IntervalMetrics
from repro_torch.core.plan import Ctx, Plan, ReplicaGroup, Workload
from repro_torch.core.policy import (KVCachePolicy, ReconfigPolicy,
                                     RecoveryPolicy, RequestPolicy)
from repro_torch.core.simulator import Simulator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import LogicalDevice
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.pool import EnginePool, PoolDiff
from repro_torch.serving.sharded import SubmeshAllocator, engine_for_group


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (rank ⌈q·n⌉) over a sorted sample (0 if
    empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(max(math.ceil(q * len(sorted_vals)) - 1, 0),
              len(sorted_vals) - 1)
    return float(sorted_vals[idx])


def measured_interval_metrics(done: Sequence, wall: float,
                              backlogged: int = 0,
                              shed: int = 0) -> IntervalMetrics:
    """Aggregate finished RequestStates into measured interval feedback:
    TTFT mean and p50/p95, pooled TPOT (Σ decode wall-clock / Σ post-first
    tokens over all completions), tokens per second."""
    def ngen(d) -> int:
        return len(d.generated) + getattr(d, "prior_generated", 0)

    ttfts = sorted(d.first_token_time - d.request.arrival_time
                   for d in done if d.first_token_time is not None)
    decode_s = sum(d.finish_time - d.first_token_time for d in done
                   if d.finish_time is not None
                   and d.first_token_time is not None
                   and ngen(d) > 1)
    decode_tokens = sum(max(ngen(d) - 1, 0) for d in done)
    tokens = sum(ngen(d) for d in done)
    return IntervalMetrics(
        requests=len(done), tokens=tokens, wall_s=wall,
        ttft_s=sum(ttfts) / len(ttfts) if ttfts else 0.0,
        ttft_p50_s=_percentile(ttfts, 0.50),
        ttft_p95_s=_percentile(ttfts, 0.95),
        tpot_s=decode_s / decode_tokens if decode_tokens > 0 else 0.0,
        tokens_per_s=tokens / wall if wall > 0 else 0.0,
        backlogged=backlogged, shed=shed, measured=True)


@dataclass(frozen=True)
class ReconfigReport:
    """What applying a plan did, and what it cost (measured wall-clock plus
    the simulator's RECONFIG-COST estimate when a simulator is at hand)."""
    wall_s: float
    simulated_s: float
    built: Tuple[ReplicaGroup, ...] = ()
    reused: Tuple[ReplicaGroup, ...] = ()
    removed: Tuple[ReplicaGroup, ...] = ()
    drained_requests: int = 0
    migrated_requests: int = 0
    recomputed_requests: int = 0
    migrate_wall_s: float = 0.0
    drain_wall_s: float = 0.0

    @property
    def changed(self) -> bool:
        return bool(self.built or self.removed)


@runtime_checkable
class Backend(Protocol):
    """Data-plane execution target for serving plans."""

    def apply_plan(self, plan: Plan, ctx: Ctx) -> ReconfigReport:
        """Reconfigure to ``plan``; returns measured + simulated cost."""
        ...

    def serve_interval(self, workloads: Sequence[Workload]) -> IntervalMetrics:
        """Serve one monitoring interval's workloads under the current plan."""
        ...

    def set_request_policy(self, rp: Optional[RequestPolicy]) -> None:
        """Install (or clear, with None) the request-domain scheduling hooks
        of the live PolicyProgram — Policy API v2's second evolvable surface."""
        ...

    def set_reconfig_policy(self, rp: Optional[ReconfigPolicy]) -> None:
        """Install (or clear, with None) the reconfig-domain hook deciding
        drain|migrate|recompute per in-flight request on plan changes —
        the third evolvable surface (reconfiguration-overhead axis)."""
        ...

    def set_kv_cache_policy(self, kp: Optional[KVCachePolicy]) -> None:
        """Install (or clear, with None) the kv_cache-domain hooks governing
        cross-request prefix retention and eviction over the paged KV pool —
        the fourth evolvable surface (cache-memory axis)."""
        ...

    def set_recovery_policy(self, rp: Optional[RecoveryPolicy]) -> None:
        """Install (or clear, with None) the recovery-domain hook deciding
        salvage|recompute|shed per in-flight request when a replica dies
        unexpectedly, plus the retry/backoff/straggler knobs — the fifth
        evolvable surface (unplanned-failure containment)."""
        ...


# --------------------------------------------------------------------------- #
# simulator-backed (closes the loop without hardware)
# --------------------------------------------------------------------------- #
@dataclass
class SimBackend:
    """Plan execution modelled by the roofline simulator.  Produces the same
    interval totals as the pre-backend accounting path (metrics carry
    ``measured=False`` and are never blended into fitness)."""
    sim: Simulator
    plan: Optional[Plan] = None
    applied: List[Plan] = field(default_factory=list)
    request_policy: Optional[RequestPolicy] = None
    reconfig_policy: Optional[ReconfigPolicy] = None
    kv_cache_policy: Optional[KVCachePolicy] = None
    recovery_policy: Optional[RecoveryPolicy] = None

    def set_request_policy(self, rp: Optional[RequestPolicy]) -> None:
        # the roofline simulator has no per-request queue to reorder; the
        # hooks are recorded so tests (and future sim upgrades) can see what
        # the control plane pushed
        self.request_policy = rp

    def set_reconfig_policy(self, rp: Optional[ReconfigPolicy]) -> None:
        # no live slots to migrate in the simulator; recorded for visibility
        self.reconfig_policy = rp

    def set_kv_cache_policy(self, kp: Optional[KVCachePolicy]) -> None:
        # no page pool in the simulator either; recorded for visibility
        self.kv_cache_policy = kp

    def set_recovery_policy(self, rp: Optional[RecoveryPolicy]) -> None:
        # no replicas to kill in the simulator; recorded for visibility
        self.recovery_policy = rp

    def apply_plan(self, plan: Plan, ctx: Ctx) -> ReconfigReport:
        sim_cost = self.sim.reconfig_cost(self.plan, plan)
        old_groups = set(self.plan.groups) if self.plan is not None else set()
        new_groups = set(plan.groups)
        self.plan = plan
        self.applied.append(plan)
        # same group-set diff semantics as EnginePool.reconfigure — dropping
        # a model entirely is a change even if every surviving group matches
        return ReconfigReport(
            wall_s=0.0, simulated_s=sim_cost,
            built=tuple(sorted(new_groups - old_groups, key=repr)),
            reused=tuple(sorted(new_groups & old_groups, key=repr)),
            removed=tuple(sorted(old_groups - new_groups, key=repr)))

    def serve_interval(self, workloads: Sequence[Workload]) -> IntervalMetrics:
        serve_s = self.sim.serve_cost(self.plan, list(workloads))
        tokens = sum(w.batch * (w.prefill_len + w.decode_len) for w in workloads)
        return IntervalMetrics(
            requests=sum(w.batch for w in workloads), tokens=tokens,
            wall_s=serve_s, tokens_per_s=tokens / serve_s if serve_s > 0 else 0.0,
            simulated_serve_s=serve_s, measured=False)


# --------------------------------------------------------------------------- #
# real engine pool on the card
# --------------------------------------------------------------------------- #
@dataclass
class TorchBackend:
    """Physical data plane on the card: one ``(cfg, model)`` stands in for
    every logical model in the plan (as in ``JaxBackend``); the topology —
    replicas, per-replica batch, what a plan change rebuilds — is real and
    every cost is measured wall-clock.

    ``devices`` is the logical device set the replicas are carved from
    (:func:`repro_torch.launch.mesh.logical_devices`; default: one entry on
    ``device``).  With more than one entry and ``shard_replicas``, a
    :class:`~repro_torch.serving.sharded.SubmeshAllocator` carves them, as
    ``JaxBackend`` does over ``jax.devices()``: engines come from
    :func:`~repro_torch.serving.sharded.engine_for_group` — a
    ``PipelinedEngine`` for ``pp > 1``, a ``ShardedEngine`` for
    ``tp·dp > 1``, a plain engine otherwise or when the allocator is short.
    With one device a ``pp > 1`` group still pipelines (its stages share the
    device) and a ``tp·dp > 1`` group runs as a plain engine, exactly as the
    JAX backend does on one device.
    """
    cfg: ModelConfig
    params: lm.LM
    max_seq_len: int = 96
    slots_cap: int = 8
    max_replicas_per_group: int = 2
    requests_per_model: int = 3
    max_new_tokens: int = 6
    page_size: int = 16
    device: DeviceLike = None
    # optional deterministic fault injection (serving/faults.FaultInjector):
    # applied once per serve_interval, keyed on the interval index so the
    # same injector seed replays the same faults at the same points
    fault_injector: Optional[object] = None
    devices: Optional[Sequence[LogicalDevice]] = None
    shard_replicas: bool = True
    pool: EnginePool = field(init=False)
    allocator: Optional[SubmeshAllocator] = field(init=False, default=None)
    _rid: int = 0
    _interval_no: int = 0
    _shed_seen: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.devices is None:
            self.devices = [LogicalDevice(0, self.device)]
        if self.shard_replicas and len(self.devices) > 1:
            self.allocator = SubmeshAllocator(self.devices)
        self.pool = EnginePool(self._make_engine,
                               max_replicas_per_group=self.max_replicas_per_group)

    def _make_engine(self, group: ReplicaGroup) -> Engine:
        return engine_for_group(
            self.cfg, self.params, group, self.allocator,
            n_slots=max(1, min(group.batch, self.slots_cap)),
            max_seq_len=self.max_seq_len, page_size=self.page_size,
            device=self.device)

    # ------------------------------------------------------------------ #
    def set_request_policy(self, rp: Optional[RequestPolicy]) -> None:
        self.pool.set_request_policy(rp)

    def set_reconfig_policy(self, rp: Optional[ReconfigPolicy]) -> None:
        self.pool.set_reconfig_policy(rp)

    def set_kv_cache_policy(self, kp: Optional[KVCachePolicy]) -> None:
        self.pool.set_kv_cache_policy(kp)

    def set_recovery_policy(self, rp: Optional[RecoveryPolicy]) -> None:
        self.pool.set_recovery_policy(rp)

    @property
    def failure_count(self) -> int:
        """Replica deaths so far (DataPlane reads this to trigger re-plans)."""
        return self.pool.failures

    @property
    def breaker(self):
        """The pool's shared hook circuit breaker (trip surfacing)."""
        return self.pool.breaker

    def apply_plan(self, plan: Plan, ctx: Optional[Ctx]) -> ReconfigReport:
        sim_cost = 0.0
        if ctx is not None and ctx.simulator is not None:
            sim_cost = ctx.simulator.reconfig_cost(self.pool.plan, plan)
        diff: PoolDiff = self.pool.reconfigure(plan)
        return ReconfigReport(wall_s=diff.wall_s, simulated_s=sim_cost,
                              built=diff.built, reused=diff.reused,
                              removed=diff.removed,
                              drained_requests=diff.drained_requests,
                              migrated_requests=diff.migrated_requests,
                              recomputed_requests=diff.recomputed_requests,
                              migrate_wall_s=diff.migrate_wall_s,
                              drain_wall_s=diff.drain_wall_s)

    def serve_interval(self, workloads: Sequence[Workload]) -> IntervalMetrics:
        """Serve a scaled-down burst per workload model and measure."""
        t0 = time.monotonic()
        for w in workloads:
            p_len = max(2, min(w.prefill_len // 64, self.max_seq_len // 3))
            d_len = max(2, min(w.decode_len // 256, self.max_new_tokens))
            for _ in range(self.requests_per_model):
                self._rid += 1
                req = Request(rid=self._rid,
                              prompt=[(self._rid + j) % (self.cfg.vocab_size - 1) + 1
                                      for j in range(p_len)],
                              max_new_tokens=d_len,
                              arrival_time=time.monotonic())
                if not self.pool.submit(w.model, req):
                    self.pool.add_backlog(w.model, req)
        if self.fault_injector is not None:
            # a step of real progress first, so kills land mid-decode, then
            # the interval's scheduled faults
            for eng in self.pool.engines:
                if eng.waiting or eng.active:
                    eng.step()
            self.fault_injector.step(self.pool, self._interval_no)
        self._interval_no += 1
        done = self.pool.run_until_drained()
        wall = time.monotonic() - t0
        # shed = new drops this interval (recovery policy / retry budget /
        # backlog cap), a loss the canary guard weighs against TTFT wins
        shed_total = len(self.pool.shed_requests) + self.pool.backlog_dropped
        shed_new, self._shed_seen = shed_total - self._shed_seen, shed_total
        return measured_interval_metrics(done, wall, len(self.pool.backlog),
                                         shed=shed_new)


def make_torch_backend(arch: str = "qwen2-1.5b", seed: int = 0,
                       device: DeviceLike = None, reduced: bool = True,
                       **kwargs) -> TorchBackend:
    """Convenience constructor: config (``.reduced()`` unless ``reduced`` is
    False) and fresh weights from a seeded generator on ``device``."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = lm.init_params(cfg, gen, device)
    return TorchBackend(cfg, model, device=device, **kwargs)

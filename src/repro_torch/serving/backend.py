"""PyTorch serving backend (port of ``src/repro/serving/backend.py``).

:class:`TorchBackend` is the counterpart of ``JaxBackend``: a real
multi-replica :class:`~repro_torch.serving.pool.EnginePool` over the port's
engines (paged for pageable families, contiguous otherwise).  ``apply_plan`` measures the rebuild wall-clock and
``serve_interval`` runs real requests and measures TTFT/TPOT/tok/s, so the
two-plane runtime's ``DataPlane`` drives it exactly like the JAX backend
(it satisfies the same ``Backend`` protocol by duck typing).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.execution_model import IntervalMetrics
from repro_torch.core.plan import Ctx, Plan, ReplicaGroup, Workload
from repro_torch.core.policy import (KVCachePolicy, ReconfigPolicy,
                                     RecoveryPolicy, RequestPolicy)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.pool import EnginePool, PoolDiff


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


@dataclass
class TorchBackend:
    """Physical data plane on the card: one ``(cfg, model)`` stands in for
    every logical model in the plan (as in ``JaxBackend``); the topology —
    replicas, per-replica batch, what a plan change rebuilds — is real and
    every cost is measured wall-clock.

    Replica groups with ``pp > 1``, or ``tp·dp > 1`` on a host with more
    than one device, need the sharded slice and raise.  On a single-device
    host a ``tp·dp > 1`` group runs as a plain engine, exactly as the JAX
    backend does there (its allocator is off with one device).
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
    pool: EnginePool = field(init=False)
    _rid: int = 0
    _shed_seen: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.pool = EnginePool(self._make_engine,
                               max_replicas_per_group=self.max_replicas_per_group)

    def _devices(self) -> int:
        return torch.cuda.device_count() if self.device.type == "cuda" else 1

    def _make_engine(self, group: ReplicaGroup) -> Engine:
        if group.pp > 1 or (group.tp * group.dp > 1 and self._devices() > 1):
            raise NotImplementedError(
                f"replica group tp={group.tp} dp={group.dp} pp={group.pp}: "
                f"sharded and pipelined replicas come with the sharded slice")
        return Engine(self.cfg, self.params,
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
        """Replica deaths so far (DataPlane reads this to trigger re-plans);
        always 0 until the faults slice brings ``EnginePool.fail``."""
        return 0

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
        done = self.pool.run_until_drained()
        wall = time.monotonic() - t0
        shed_total = self.pool.backlog_dropped
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

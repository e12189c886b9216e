"""Shadow replay: the evaluation ladder's second rung (deterministic) (port of ``src/repro/serving/shadow.py``).

The analytic evaluator ranks *placement* behaviour on the roofline
simulator; it is blind to everything the request and reconfig domains do.
This module replays a snapshot window through a **shadow serving stack**:

  * :class:`ShadowEngine` — a virtually-clocked stand-in for
    :class:`repro_torch.serving.engine.Engine` with the same queueing/slot
    semantics (policy-ordered admission, preemption, slot export/install)
    but service times taken from the roofline simulator instead of real
    model compute.  No wall clock ever enters the accounting.
  * :class:`ShadowBackend` — the real :class:`~repro_torch.serving.pool.EnginePool`
    over shadow engines, satisfying the serving ``Backend`` protocol.  The
    *pool logic under test is the production code*: least-loaded routing,
    the admit gate, backlog throttling with forced progress, and the
    drain/migrate/recompute reconfiguration paths all run unmodified.
  * :class:`ShadowReplayEval` — an ``EvalBackend`` that drives a fresh
    seeded ShadowBackend through the snapshot and scores the candidate via
    ``ExecutionAccumulator(measured=…, request_blend>0)``, so request-only
    and reconfig-bearing programs receive finite, comparable fitness.

Determinism: requests are synthesized from a seeded RNG keyed on the
snapshot interval, all clocks are virtual, and pool construction order is
sorted — two evaluations of the same (policy, snapshot, seed) produce
bit-identical fitness.
"""
from __future__ import annotations

import dataclasses
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.evaluator import EvalResult, Evaluator, INFEASIBLE_FITNESS
from repro_torch.core.execution_model import ExecutionAccumulator, IntervalMetrics
from repro_torch.core.plan import Ctx, Plan, ReplicaGroup, Workload
from repro_torch.core.policy import (KVCachePolicy, Policy, ReconfigPolicy,
                               RequestPolicy, seed_policies)
from repro_torch.core.simulator import PENALTY, Simulator
from repro_torch.distributed import hlo_analysis
from repro_torch.serving import kvcache
from repro_torch.serving.backend import ReconfigReport, measured_interval_metrics
from repro_torch.serving.engine import (DrainStallError, Request,
                                  RequestSchedulingMixin, RequestState,
                                  SlotExport)
from repro_torch.serving.pool import EnginePool
from repro_torch.traces.workload import Trace

# sentinel standing in for extracted device cache state (the shadow carries
# no tensors; compatibility is decided by model identity + position headroom)
_SHADOW_CACHE = object()

# deny-all request program — the canonical planted regression for canary
# demos/tests/benchmarks: the pool only makes progress through the
# forced-progress guard, so serving serialises and tail latency explodes,
# which a correct canary must catch and roll back
BAD_REQUEST_SOURCE = (
    'POLICY_DOMAINS = ("request",)\n'
    "def admit(r):\n"
    "    return False\n"
    "def prioritize(r):\n"
    "    return 0.0\n"
)

# cache-thrash kv_cache program — the planted regression for the kv_cache
# domain: never retains new prefixes AND evicts the hottest blocks first, so
# every shared-prefix request pays full prefill and TTFT regresses against a
# caching incumbent; a correct canary must catch and roll it back
BAD_KV_SOURCE = (
    'POLICY_DOMAINS = ("kv_cache",)\n'
    "def cache_prefix(k):\n"
    "    return False\n"
    "def evict_priority(k):\n"
    "    return float(k.hits)\n"
)

# shed-everything recovery program — the planted regression for the recovery
# domain: every request on a failed replica is dropped instead of salvaged
# or retried.  The insidious part: survivors' TTFT looks GREAT (only the
# lucky requests are timed), so the canary guard must weigh the shed rate,
# not latency alone, to catch and roll it back
BAD_RECOVERY_SOURCE = (
    'POLICY_DOMAINS = ("recovery",)\n'
    "def on_failure(f):\n"
    "    return 'shed'\n"
)


@dataclass
class ShadowCosts:
    """Roofline-derived virtual service times for one replica-group shape."""
    prefill_per_token_s: float
    decode_step_s: float                 # one batched decode step
    migrate_slot_s: float                # per-slot state hand-off


@dataclass
class ShadowStats:
    """Virtual hand-off cost accumulated across a reconfiguration."""
    drain_s: float = 0.0
    migrate_s: float = 0.0

    def reset(self) -> None:
        self.drain_s = 0.0
        self.migrate_s = 0.0


class ShadowEngine(RequestSchedulingMixin):
    """Engine-compatible replica on a virtual clock.

    Implements exactly the surface :class:`EnginePool` and the request
    hooks touch — submit/step/drain and slot export/install — while
    policy-ordered admission, preemption, and hook-context construction are
    INHERITED from the production engine's
    :class:`~repro_torch.serving.engine.RequestSchedulingMixin` (same code, only
    the clock differs), so evolved ``admit``/``prioritize``/
    ``migration_mode`` code runs against exactly the live semantics with
    time as pure arithmetic.
    """

    def __init__(self, model: str, n_slots: int, max_seq_len: int,
                 costs: ShadowCosts, stats: ShadowStats,
                 request_policy: Optional[RequestPolicy] = None,
                 kv_cache_policy: Optional[KVCachePolicy] = None,
                 page_size: int = 8, prefix_pages_cap: int = 64):
        self.model = model
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.costs = costs
        self.stats = stats
        self.request_policy = request_policy
        self.kv_cache_policy = kv_cache_policy
        self.policy_errors = 0
        self.preemptions = 0
        # fault-tolerance state, mirroring Engine: the breaker is installed
        # by the owning pool; fault_slowdown scales VIRTUAL service time (a
        # shadow straggler is genuinely slower on the virtual clock, so the
        # EMA detector and shadow fitness both see it)
        self.breaker = None
        self.fault_slowdown = 1.0
        self.step_ema_s = 0.0
        self.health_samples = 0
        self.t = 0.0                     # virtual clock (engine-local)
        self.waiting: List[Request] = []
        self.active: Dict[int, RequestState] = {}
        self.finished: List[RequestState] = []
        self.steps = 0
        self.dispatches = 0
        # toy paged-KV prefix cache on virtual time: the REAL radix index /
        # page-pool structures (same admission + eviction semantics as the
        # paged Engine), with prefill cost discounted by the matched tokens —
        # what the kv_cache policy domain controls becomes visible to shadow
        # fitness without any tensor work
        self.page_size = page_size
        self.prefix_index = kvcache.PrefixIndex(page_size)
        self.prefix_pool = kvcache.PagePool(prefix_pages_cap + 1)
        self.prefix_evictions = 0

    # ------------------------------------------------------------------ #
    # virtual prefix cache (kv_cache policy domain)
    # ------------------------------------------------------------------ #
    @property
    def prefix_hits(self) -> int:
        return self.prefix_index.hits

    @property
    def prefix_tokens_saved(self) -> int:
        return self.prefix_index.tokens_matched

    def _kv_ctx(self, node=None, prefix_pages: int = 0,
                prompt_len: int = 0) -> kvcache.KVCacheCtx:
        return kvcache.KVCacheCtx(
            prefix_pages=node.depth if node is not None else prefix_pages,
            prompt_len=prompt_len,
            hits=node.hits if node is not None else 0,
            idle_s=max(self.t - node.last_used, 0.0) if node is not None
            else 0.0,
            pool_free=self.prefix_pool.free_pages,
            pool_total=self.prefix_pool.n_pages - 1)

    def _alloc_prefix_page(self) -> Optional[int]:
        while True:
            pid = self.prefix_pool.alloc()
            if pid is not None:
                return pid
            leaves = self.prefix_index.leaves()
            if not leaves:
                return None
            kp = self.kv_cache_policy
            if kp is not None:
                try:
                    victim = max(leaves, key=lambda n: float(
                        kp.evict_priority(self._kv_ctx(n))))
                except Exception:  # noqa: BLE001 — advisory hook
                    self.policy_errors += 1
                    victim = max(leaves, key=lambda n: self.t - n.last_used)
            else:                        # default: LRU (longest idle first)
                victim = max(leaves, key=lambda n: self.t - n.last_used)
            self.prefix_pool.unref(self.prefix_index.remove(victim))
            self.prefix_evictions += 1

    def _retain_prefix(self, st: RequestState) -> None:
        tokens = (list(st.request.prompt) + list(st.generated))[:st.position]
        n_full = len(tokens) // self.page_size
        if n_full <= 0:
            return
        kp = self.kv_cache_policy
        if kp is not None:
            try:
                if not kp.cache_prefix(self._kv_ctx(
                        prefix_pages=n_full, prompt_len=len(tokens))):
                    return
            except Exception:  # noqa: BLE001 — advisory: fall back to admit
                self.policy_errors += 1
        pages: List[int] = []
        for _ in range(n_full):
            pid = self._alloc_prefix_page()
            if pid is None:
                break
            pages.append(pid)
        used = {n.page for n in self.prefix_index.insert(tokens, pages,
                                                         self.t)}
        for pid in pages:                # blocks already resident keep their
            if pid not in used:          # canonical page; return the spares
                self.prefix_pool.unref(pid)

    # ------------------------------------------------------------------ #
    def max_prompt_len(self, max_new_tokens: int = 1) -> int:
        return max(1, self.max_seq_len - max(max_new_tokens, 1))

    def submit(self, req: Request) -> None:
        if req.arrival_time == 0.0:
            req.arrival_time = self.t
        limit = self.max_prompt_len(req.max_new_tokens)
        if len(req.prompt) > limit:
            # replace() keeps every accounting field (first_token_time,
            # prior_generated, retries, not_before) on the truncated copy
            req = dataclasses.replace(req, prompt=req.prompt[-limit:])
        self.waiting.append(req)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if s not in self.active]

    @property
    def load(self) -> int:
        return len(self.waiting) + len(self.active)

    def _now(self) -> float:
        return self.t                    # the mixin's clock is virtual here

    # ------------------------------------------------------------------ #
    # slot migration (virtual): same contract as Engine export/install
    # ------------------------------------------------------------------ #
    def export_slot(self, slot: int, with_state: bool = True,
                    release: bool = True) -> SlotExport:
        # ``release`` is the paged engine's keep-pages-until-handed-off
        # switch; a shadow slot maps no pages, so both forms are the same
        st = self.active.pop(slot)
        req = st.request
        remaining = max(req.max_new_tokens - len(st.generated), 1)
        cont = Request(req.rid, list(req.prompt) + list(st.generated),
                       remaining, req.eos_id, req.arrival_time,
                       first_token_time=st.first_token_time,
                       prior_generated=st.prior_generated + len(st.generated),
                       retries=req.retries)   # retry budget survives migration
        cache = _SHADOW_CACHE if with_state else None
        return SlotExport(cont, st, self.model, cache, st.position)

    def export_active(self, with_state: bool = True) -> List[SlotExport]:
        return [self.export_slot(s, with_state=with_state)
                for s in sorted(self.active)]

    def release_exported(self, slot: int, st: RequestState) -> None:
        """Shadow twin of Engine.release_exported: nothing to release."""

    def install_active(self, export: SlotExport) -> bool:
        free = self.free_slots()
        remaining = max(export.request.max_new_tokens, 1)
        if (not free or export.cache is None or export.cfg != self.model
                or export.position + remaining >= self.max_seq_len):
            return False
        slot = free[0]
        st = export.state
        st.slot = slot
        self.active[slot] = st
        self.t += self.costs.migrate_slot_s
        self.stats.migrate_s += self.costs.migrate_slot_s
        return True

    # ------------------------------------------------------------------ #
    def _prefill(self, req: Request, slot: int) -> None:
        st = RequestState(req, slot)
        self.active[slot] = st
        _, matched = self.prefix_index.match(req.prompt, self.t)
        self.t += (self.costs.prefill_per_token_s * self.fault_slowdown
                   * max(len(req.prompt) - matched, 1))
        self.dispatches += 1
        st.prefill_dispatches = 1
        st.position = len(req.prompt)
        st.generated.append(1)           # token identity is irrelevant here
        st.first_token_time = self.t
        if req.first_token_time is not None:
            st.first_token_time = req.first_token_time
        st.prior_generated = req.prior_generated

    def _finish(self, st: RequestState) -> None:
        st.done = True
        st.finish_time = self.t
        self.finished.append(st)
        del self.active[st.slot]
        self._retain_prefix(st)

    def step(self) -> int:
        t0 = self.t
        self._maybe_preempt()
        free = self.free_slots()
        for slot, req in zip(free, self._select_admissions(len(free))):
            self._prefill(req, slot)
            st = self.active[slot]
            if len(st.generated) >= req.max_new_tokens:
                self._finish(st)
        if not self.active:
            return 0
        self.t += self.costs.decode_step_s * self.fault_slowdown
        self.dispatches += 1
        produced = 0
        for slot, st in sorted(self.active.items()):
            st.position += 1
            st.generated.append(1)
            produced += 1
            if (len(st.generated) >= st.request.max_new_tokens
                    or st.position >= self.max_seq_len - 1):
                self._finish(st)
        self.steps += 1
        self._record_step_time(self.t - t0)
        return produced

    def _record_step_time(self, dt: float) -> None:
        # virtual dt already carries fault_slowdown (unlike Engine, which
        # scales the recorded real wall-time — the observation either way)
        if self.health_samples == 0:
            self.step_ema_s = dt
        else:
            self.step_ema_s = 0.7 * self.step_ema_s + 0.3 * dt
        self.health_samples += 1

    def release_devices(self) -> None:
        """Shadow twin of Engine.release_devices: shadow replicas hold no
        physical submesh, so teardown/failure device reclaim is a no-op."""

    def release_all_pages(self) -> int:
        """Drop the virtual prefix cache's page references (the shadow twin
        of Engine.release_all_pages — a dead shadow replica must not strand
        refcounts in its PagePool either)."""
        while True:
            leaves = self.prefix_index.leaves()
            if not leaves:
                break
            for leaf in leaves:
                self.prefix_pool.unref(self.prefix_index.remove(leaf))
        return self.prefix_pool.used_pages

    def run_until_drained(self, max_steps: int = 10_000) -> List[RequestState]:
        # only EnginePool.reconfigure drains a single engine: the elapsed
        # virtual time IS the synchronous-drain hand-off cost
        t0 = self.t
        taken = 0
        while (self.waiting or self.active) and taken < max_steps:
            self.step()
            taken += 1
        self.stats.drain_s += self.t - t0
        if self.waiting or self.active:
            raise DrainStallError(
                f"shadow engine stalled: {len(self.waiting)} waiting, "
                f"{len(self.active)} active after {max_steps} steps")
        return self.finished


# --------------------------------------------------------------------------- #
# deterministic backend: production EnginePool over shadow engines
# --------------------------------------------------------------------------- #
class ShadowBackend:
    """Serving ``Backend`` on virtual time: deterministic, roofline-costed.

    Satisfies the same protocol as Sim/TorchBackend, so it can sit under a
    live :class:`~repro_torch.core.runtime.DataPlane` (reproducible canary tests)
    or under :class:`ShadowReplayEval` (the evaluation ladder's second
    rung).  ``preload`` puts part of the upcoming interval's burst in
    flight so an immediately following ``apply_plan`` exercises the
    reconfig policy on live slots.
    """

    REF_PREFILL = 256                    # roofline reference lengths
    # pipeline-bubble depth: the engine streams each prefill chunk as up to
    # pp micro-chunks, and the chunked-prefill chunk stream keeps ~4 in
    # flight — the m in (pp-1)/(pp-1+m)
    PIPELINE_MICROBATCHES = 4

    def __init__(self, sim: Simulator, seed: int = 0, slots_cap: int = 2,
                 max_replicas_per_group: int = 1, requests_per_model: int = 4,
                 max_new_cap: int = 6, max_seq_len: int = 256,
                 time_scale: float = 1.0, faults=None):
        self.sim = sim
        self.seed = seed
        self.slots_cap = slots_cap
        self.requests_per_model = requests_per_model
        self.max_new_cap = max_new_cap
        self.max_seq_len = max_seq_len
        self.time_scale = time_scale
        # optional FaultInjector replayed on the interval index: candidates
        # are shadow-evaluated against the same seeded fault schedule they
        # will face live
        self.faults = faults
        self.stats = ShadowStats()
        self.vnow = 0.0                  # global virtual clock
        self.pool = EnginePool(self._make_engine,
                               max_replicas_per_group=max_replicas_per_group,
                               now_fn=lambda: self.vnow,
                               wait_fn=self._vwait)
        self._interval_idx = 0
        self._fin_seen = 0
        self._shed_seen = 0
        self._rid = 0
        self._pending: Optional[List[Tuple[str, Request]]] = None
        self._pending_off = 0
        self._t0 = 0.0
        self._costs: Dict[Tuple, ShadowCosts] = {}
        self._tpl: Dict[Tuple[str, int, int], List[int]] = {}

    # ------------------------------------------------------------------ #
    def _costs_for(self, g: ReplicaGroup) -> ShadowCosts:
        key = (g.model, g.gpu_type, g.tp, g.dp, g.pp)
        hit = self._costs.get(key)
        if hit is not None:
            return hit
        z = self.sim.models.get(g.model)
        gpu = self.sim.hardware.get(g.gpu_type)
        if z is None or gpu is None:     # unknown shapes: flat fallback
            costs = ShadowCosts(2e-4 * self.time_scale,
                                1e-3 * self.time_scale,
                                5e-4 * self.time_scale)
        else:
            # honest TP: a degree the sharding layer would fully fall back
            # on (heads AND experts indivisible) is costed at tp=1 — the
            # replica burns tp× devices without the speedup, which is
            # exactly the trade the shadow rung must surface, not hide.
            eff = hlo_analysis.effective_tp(z, g.tp)
            ref = self.REF_PREFILL
            k_p = self.sim.prefill_time(z, gpu, eff, 1, ref) / ref
            k_d = self.sim.decode_time(z, gpu, eff, 1, ref, 1)
            # intra-replica DP shards the step batch dp-ways (per-step
            # collective cost is already inside prefill/decode_time Eq. 6)
            k_p /= g.dp
            k_d /= g.dp
            if g.pp > 1:
                # honest PP: prefill streams micro-chunks, so per-token work
                # drops to 1/pp minus the fill/drain bubble; decode is
                # SEQUENTIAL across stages (a token's step latency spans the
                # whole pipeline — no 1/pp there), and every boundary pays
                # the activation hand-off.  This is what lets shadow replay
                # rank pp-vs-tp honestly: pp wins on fragmented capacity or
                # unshardable heads, NOT as a free decode speedup.
                bub = hlo_analysis.pipeline_bubble_fraction(
                    g.pp, self.PIPELINE_MICROBATCHES)
                hand = hlo_analysis.stage_handoff_s(z, gpu, g.pp, 1)
                k_p = k_p / g.pp / max(1.0 - bub, 1e-6) + hand
                k_d = k_d + hand
            if not hlo_analysis.fused_paged_supported(z, g.tp):
                # honest paged decode: a tp that doesn't divide the KV
                # heads forces the engine off the fused shard_map kernel
                # onto the unfused gather (materialised contiguous K/V per
                # layer, written then re-read) — priced per step at a
                # nominal REF_PREFILL-token context so the evolved
                # placement/kv domains see that choosing this tp costs a
                # kernel downgrade, not just a sharding fallback.
                k_d += hlo_analysis.unfused_paged_decode_overhead_s(
                    z, gpu, g.tp, 1, self.REF_PREFILL)
            costs = ShadowCosts(prefill_per_token_s=k_p * self.time_scale,
                                decode_step_s=k_d * self.time_scale,
                                migrate_slot_s=0.5 * k_d * self.time_scale)
        self._costs[key] = costs
        return costs

    def _make_engine(self, g: ReplicaGroup) -> ShadowEngine:
        return ShadowEngine(model=g.model,
                            n_slots=max(1, min(g.batch, self.slots_cap)),
                            max_seq_len=self.max_seq_len,
                            costs=self._costs_for(g), stats=self.stats)

    # ------------------------------------------------------------------ #
    def set_request_policy(self, rp: Optional[RequestPolicy]) -> None:
        self.pool.set_request_policy(rp)

    def set_reconfig_policy(self, rp: Optional[ReconfigPolicy]) -> None:
        self.pool.set_reconfig_policy(rp)

    def set_kv_cache_policy(self, kp: Optional[KVCachePolicy]) -> None:
        self.pool.set_kv_cache_policy(kp)

    def set_recovery_policy(self, rp) -> None:
        self.pool.set_recovery_policy(rp)

    @property
    def failure_count(self) -> int:
        return self.pool.failures

    @property
    def breaker(self):
        return self.pool.breaker

    def _vwait(self, dt: float) -> None:
        """Backoff 'sleep' on the virtual clock: advance vnow and pull every
        engine clock forward so retried requests genuinely pay the wait."""
        self.vnow += dt
        for e in self.pool.engines:
            e.t = max(e.t, self.vnow)

    # ------------------------------------------------------------------ #
    def _template(self, model: str, p_base: int, which: int) -> List[int]:
        """Deterministic shared system-prompt templates, stable ACROSS
        intervals (keyed on seed+model, never the interval index) so
        cross-request prefix reuse can actually accumulate."""
        key = (model, p_base, which)
        hit = self._tpl.get(key)
        if hit is None:
            rng = random.Random(f"{self.seed}:tpl:{model}:{p_base}:{which}")
            hit = [rng.randint(2, 99)
                   for _ in range(max((p_base * 3) // 4, 2))]
            self._tpl[key] = hit
        return hit

    def _begin_interval(self, workloads: Sequence[Workload]) -> None:
        """Synthesize the interval's deterministic request burst (scaled
        down per model, lengths jittered by the interval-keyed RNG so
        priority orderings actually differ from FIFO).  Prompts are a
        shared per-model template + a unique suffix — the agentic /
        shared-system-prompt shape the kv_cache domain exists for."""
        if self._pending is not None:
            return
        self._t0 = self.vnow
        for e in self.pool.engines:
            e.t = max(e.t, self._t0)
        rng = random.Random(f"{self.seed}:{self._interval_idx}")
        self._interval_idx += 1
        reqs: List[Tuple[str, Request]] = []
        for w in workloads:
            p_base = min(max(w.prefill_len // 16, 4), self.max_seq_len // 4)
            d_base = min(max(w.decode_len // 512, 2), self.max_new_cap)
            for _ in range(self.requests_per_model):
                self._rid += 1
                p = max(2, p_base + rng.randint(-(p_base // 2), p_base // 2))
                d = max(1, d_base + rng.randint(-1, 1))
                tpl = self._template(w.model, p_base, rng.randint(0, 1))
                suffix = [rng.randint(2, 99)
                          for _ in range(max(p - len(tpl), 1))]
                reqs.append((w.model,
                             Request(rid=self._rid, prompt=tpl + suffix,
                                     max_new_tokens=d,
                                     arrival_time=self._t0)))
        self._pending = reqs
        self._pending_off = 0

    def preload(self, workloads: Sequence[Workload],
                k: Optional[int] = None) -> int:
        """Submit the first ``k`` requests of the upcoming interval and step
        the engines once, so reconfiguration hits in-flight slots."""
        if not self.pool.engines:
            return 0
        self._begin_interval(workloads)
        if k is None:
            k = max(1, sum(e.n_slots for e in self.pool.engines) // 2)
        n = min(k, len(self._pending))
        for model, req in self._pending[:n]:
            if not self.pool.submit(model, req):
                self.pool.add_backlog(model, req)
        self._pending_off = n
        for e in self.pool.engines:
            e.step()
        return n

    # ------------------------------------------------------------------ #
    # Backend protocol
    # ------------------------------------------------------------------ #
    def apply_plan(self, plan: Plan, ctx: Optional[Ctx]) -> ReconfigReport:
        sim_cost = self.sim.reconfig_cost(self.pool.plan, plan)
        self.stats.reset()
        diff = self.pool.reconfigure(plan)
        handoff = self.stats.drain_s + self.stats.migrate_s
        # shape-aware rebuild: each newly built group pays its per-device
        # weight-shard pull (weight_bytes / eff_tp over PCIe) on the virtual
        # clock, so a TP-widening plan is cheaper to stand up than a DP one
        # of equal device count and the canary guard sees that difference
        for g in diff.built:
            z = self.sim.models.get(g.model)
            gpu = self.sim.hardware.get(g.gpu_type)
            if z is not None and gpu is not None:
                handoff += (hlo_analysis.rebuild_cost_s(z, gpu, g.tp,
                                                        pp=g.pp)
                            * self.time_scale)
        self.vnow += handoff
        return ReconfigReport(wall_s=handoff, simulated_s=sim_cost,
                              built=diff.built, reused=diff.reused,
                              removed=diff.removed,
                              drained_requests=diff.drained_requests,
                              migrated_requests=diff.migrated_requests,
                              recomputed_requests=diff.recomputed_requests,
                              migrate_wall_s=self.stats.migrate_s,
                              drain_wall_s=self.stats.drain_s)

    def serve_interval(self, workloads: Sequence[Workload]) -> IntervalMetrics:
        self._begin_interval(workloads)
        t0 = self._t0
        for e in self.pool.engines:      # groups built after preload start at 0
            e.t = max(e.t, t0)
        for model, req in self._pending[self._pending_off:]:
            if not self.pool.submit(model, req):
                self.pool.add_backlog(model, req)
        self._pending = None
        if self.faults is not None:
            # one step of progress so kills land mid-decode, then this
            # interval's scheduled faults (keyed on the interval index —
            # _begin_interval already advanced it past the current one)
            for e in self.pool.engines:
                if e.waiting or e.active:
                    e.step()
            self.faults.step(self.pool, self._interval_idx - 1)
        self.pool.run_until_drained()
        done = self.pool.finished[self._fin_seen:]
        self._fin_seen = len(self.pool.finished)
        end = max((e.t for e in self.pool.engines), default=t0)
        wall = max(end - t0, 1e-9)
        self.vnow = max(self.vnow, end)
        shed_total = len(self.pool.shed_requests) + self.pool.backlog_dropped
        shed_new, self._shed_seen = (shed_total - self._shed_seen, shed_total)
        metrics = measured_interval_metrics(done, wall,
                                            len(self.pool.backlog),
                                            shed=shed_new)
        serve_s = (self.sim.serve_cost(self.pool.plan, list(workloads))
                   if self.pool.plan is not None else 0.0)
        return dataclasses.replace(metrics, simulated_serve_s=serve_s)


# --------------------------------------------------------------------------- #
# evaluation ladder, rung 2: shadow replay
# --------------------------------------------------------------------------- #
@dataclass
class ShadowReplayEval(Evaluator):
    """Replay a snapshot window through a fresh seeded ShadowBackend.

    Placement hooks come from the candidate itself when it implements the
    domain, otherwise from ``fallback_placement`` (the control plane sets
    this to the live policy — request-only programs are scored exactly as
    they would serve: riding alongside the incumbent's placement).  Fitness
    is ``ExecutionAccumulator`` interval accounting with the shadow's
    measured request-level metrics blended in (``request_blend > 0``), so
    tail latency and backlog — invisible to the analytic rung — move the
    ranking.

    Scheduling cost is charged as a deterministic *intent proxy* (greedy ≈
    cheap constant, anytime B&B ≈ its time budget) instead of measured CPU
    time: the rung's contract is bit-identical fitness for identical
    (policy, snapshot, seed).
    """
    name: str = "shadow"
    seed: int = 0
    requests_per_model: int = 4
    slots_cap: int = 2
    max_replicas_per_group: int = 1
    preload_in_flight: int = 2
    request_blend: float = 0.5
    measured_blend: float = 0.25
    measured_scale: float = 1.0
    fallback_placement: Optional[Policy] = None
    # seeded FailureEvent schedule replayed against every candidate (the
    # SAME faults the live pool will face); None evaluates fault-free
    fault_schedule: Optional[Tuple] = None

    def _fallback(self) -> Policy:
        if self.fallback_placement is None:
            self.fallback_placement = seed_policies()["greedy-reactive"]
        self.fallback_placement.compile()
        return self.fallback_placement

    def _sched_cost(self, placement: Policy) -> float:
        g = placement.genome or {}
        sched = g.get("scheduler")
        if sched in ("bnb", "hybrid"):
            return float(g.get("time_budget", 2.0))
        if sched == "greedy":
            return 0.05
        return 0.1                        # hand-written source: flat charge

    def _make_backend(self) -> ShadowBackend:
        faults = None
        if self.fault_schedule:
            from repro_torch.serving.faults import FaultInjector
            # a FRESH injector per evaluation: cursor/counters are replay
            # state, the schedule is the shared contract
            faults = FaultInjector(schedule=tuple(self.fault_schedule))
        return ShadowBackend(self.sim, seed=self.seed,
                             slots_cap=self.slots_cap,
                             max_replicas_per_group=self.max_replicas_per_group,
                             requests_per_model=self.requests_per_model,
                             faults=faults)

    # ------------------------------------------------------------------ #
    def evaluate(self, policy: Policy, trace: Trace) -> EvalResult:
        t_start = time.monotonic()

        def fail(err: str) -> EvalResult:
            return EvalResult(INFEASIBLE_FITNESS, error=err,
                              backend=self.name,
                              wall_s=time.monotonic() - t_start)

        try:
            policy.compile()
        except Exception as e:  # noqa: BLE001
            return fail(f"compile: {e}")
        placement = (policy if policy.implements("placement")
                     else self._fallback())
        backend = self._make_backend()
        backend.set_request_policy(policy.request_policy())
        backend.set_reconfig_policy(policy.reconfig_policy())
        backend.set_kv_cache_policy(policy.kv_cache_policy())
        backend.set_recovery_policy(policy.recovery_policy())
        acc = ExecutionAccumulator(self.sim,
                                   measured_blend=self.measured_blend,
                                   measured_scale=self.measured_scale,
                                   request_blend=self.request_blend)
        sched_cost = self._sched_cost(placement) * self.sched_time_scale
        plan: Optional[Plan] = None
        last_w = last_c = None
        scratch: Dict = {"steps_since_resched": 0}
        ttft_num = 0.0
        ttft_den = 0

        for idx in range(len(trace)):
            ctx = self.make_ctx(trace, idx, plan, last_w, last_c, scratch)
            obs = trace.observations[idx]
            # same trigger/schedule/validation chain as the analytic rung —
            # the rungs must agree on WHICH candidates are feasible, they
            # only differ in what an interval costs
            trigger, new_plan, _, err = self.plan_step(placement, ctx, obs,
                                                       plan, idx)
            if err is not None:
                return fail(err)

            try:
                if trigger:
                    # in-flight work first, so the plan change exercises the
                    # candidate's migration_mode on live slots
                    backend.preload(obs.workloads, k=self.preload_in_flight)
                    report = backend.apply_plan(new_plan, ctx)
                    metrics = backend.serve_interval(obs.workloads)
                    metrics = dataclasses.replace(metrics,
                                                  reconfig_s=report.wall_s)
                    acc.interval(idx, plan, new_plan, list(obs.workloads),
                                 t_sched=sched_cost, rescheduled=True,
                                 measured=metrics)
                    plan = new_plan
                    last_w, last_c = list(obs.workloads), obs.cluster
                    scratch["steps_since_resched"] = 0
                else:
                    metrics = backend.serve_interval(obs.workloads)
                    acc.interval(idx, plan, plan, list(obs.workloads),
                                 t_sched=0.0, rescheduled=False,
                                 measured=metrics)
                    scratch["steps_since_resched"] += 1
            except DrainStallError as e:
                # a candidate whose recovery/backoff loop never converges is
                # infeasible, not a crash of the evaluator
                return fail(f"drain stall: {e}")
            ttft_num += metrics.ttft_p95_s * metrics.requests
            ttft_den += metrics.requests
            if acc.T_total >= PENALTY:
                return fail("penalty serve cost")

        return EvalResult(
            fitness=acc.T_total, N=acc.N, sum_sched=acc.sum_sched,
            sum_stale=acc.sum_stale, sum_reconfig=acc.sum_reconfig,
            sum_serve=acc.sum_serve, records=acc.records,
            wall_s=time.monotonic() - t_start, backend=self.name,
            ttft_p95_s=ttft_num / ttft_den if ttft_den else 0.0,
            backlogged=acc.sum_backlogged)

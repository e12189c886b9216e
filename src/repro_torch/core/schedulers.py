"""Scheduling algorithms — the building blocks policies compose (§2.1, §8, App. C/F/G)
(port of ``src/repro/core/schedulers.py``: a copy on the port's plan types,
with the same outputs for the same inputs).

* ``greedy_schedule``  — lightweight heuristic (paper's greedy baseline)
* ``bnb_schedule``     — anytime branch-and-bound exact search over replica-group
                         assignments (the paper's "ILP-based" baseline: same
                         model — min-makespan ILP of App. G — solved by B&B with
                         per-variable bounds instead of CBC, which is not
                         available offline; anytime deadline = scheduling
                         thoroughness knob)
* ``full_migration`` / ``minimal_migration`` — §8.2 reconfiguration baselines
* ``agentic_*``        — §8.3 request-level schedulers

All schedulers consume Ctx (repro_torch.core.plan) and return Plan.  Candidate
generators implement the App. G search-space reductions (batch sweet spots,
tp floors for large models, heterogeneity-aware GPU ordering) as reusable
knobs that evolved policies tune.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.plan import (Ctx, ModelSpec, Plan, ReplicaGroup, Workload,
                                   default_stage_cuts)

TP_DEGREES = (1, 2, 4, 8)


# --------------------------------------------------------------------------- #
# candidate generation knobs (App. G)
# --------------------------------------------------------------------------- #
def batch_candidates(total_batch: int, scheme: str = "pow2",
                     max_batch: int = 512) -> List[int]:
    if scheme == "exhaustive":
        return [b for b in range(1, min(total_batch, max_batch) + 1)]
    if scheme == "sweet":
        # App. G / Eq. 18: small ints ∪ powers of two ∪ curated sweet spots
        # ∪ divisors of the total batch ("curated candidate selection")
        cand = {1, 2, 3, 4, 6} | {2 ** k for k in range(2, 7)} \
            | {20, 24, 28, 32, 40, 48}
        d = 1
        while d * d <= total_batch:
            if total_batch % d == 0:
                cand.add(d)
                cand.add(total_batch // d)
            d += 1
    else:  # pow2
        cand = {2 ** k for k in range(0, 10)}
    cand |= {total_batch} if total_batch <= max_batch else set()
    return sorted(b for b in cand if b <= min(total_batch, max_batch))


def tp_shardable(z: ModelSpec, t: int) -> bool:
    """Physical TP feasibility: Megatron head sharding needs the q-head
    count divisible by t; MoE models may instead shard the expert axis
    (expert parallelism), so a divisible expert count also qualifies.
    Mirrors ``distributed.sharding._tp_compatible`` on the ModelSpec side —
    the shared ``plan_feasible`` guard enforces the same rule, so filtering
    here keeps every scheduler's plans physically buildable."""
    if t <= 1:
        return True
    if z.n_heads and z.n_heads % t == 0:
        return True
    return bool(z.n_experts and z.n_experts % t == 0)


def tp_candidates(z: ModelSpec, g_name: str, ctx: Ctx,
                  tp_floor_large: int = 0, intra_node_only: bool = False
                  ) -> List[int]:
    g = ctx.hardware[g_name]
    out = []
    for t in TP_DEGREES:
        if not tp_shardable(z, t):
            continue
        if intra_node_only and t > g.devices_per_node:
            continue
        if t > ctx.cluster.count(g_name):
            continue
        if tp_floor_large and z.weight_bytes > 60e9 and t < tp_floor_large:
            continue
        # quick memory prune (weights only)
        if z.weight_bytes / t > 0.8 * g.mem_bytes:
            continue
        out.append(t)
    return out


def gpu_order(z: ModelSpec, ctx: Ctx, heterogeneity_aware: bool = True
              ) -> List[str]:
    """App. G / §7.2 (iv): large model -> fastest GPU first; small -> weakest."""
    types = ctx.cluster.types()
    if not heterogeneity_aware:
        return types
    big = z.weight_bytes > 25e9
    return sorted(types, key=lambda g: ctx.hardware[g].flops, reverse=big)


def apply_replica_dp(plan: Plan, ctx: Ctx, dp: int) -> Plan:
    """Post-pass widening each replica to a (dp, tp) submesh when devices
    allow — the ``replica_dp`` genome knob's entry point.

    Deterministic and auto-falling-back: groups are widened in plan order;
    a group keeps dp=1 when the cluster lacks the extra devices, when its
    per-replica batch is too small to shard dp-ways, or when dp would not
    divide the batch.  The widened plan is always feasible if the input
    plan was (device budget re-checked against the cluster here; memory
    cannot get worse — dp shards the same batch over more devices)."""
    dp = int(dp)
    if dp <= 1 or not plan.groups:
        return plan
    free = {g: ctx.cluster.count(g) for g in ctx.cluster.types()}
    for g in plan.groups:
        free[g.gpu_type] = free.get(g.gpu_type, 0) - g.devices
    out = []
    for g in plan.groups:
        extra = g.tp * (dp - 1) * g.count
        if (g.dp == 1 and g.batch >= dp and g.batch % dp == 0
                and free.get(g.gpu_type, 0) >= extra):
            free[g.gpu_type] -= extra
            g = ReplicaGroup(g.model, g.gpu_type, g.tp, g.batch, g.count,
                             dp=dp)
        out.append(g)
    return Plan(tuple(out))


def apply_replica_pp(plan: Plan, ctx: Ctx, pp: int,
                     stage_balance: str = "even") -> Plan:
    """Post-pass deepening each replica to a (pp, dp, tp) submesh when
    devices allow — the ``replica_pp`` genome knob's entry point.

    Deterministic and auto-falling-back like :func:`apply_replica_dp`:
    groups are deepened in plan order; a group keeps pp=1 when the cluster
    lacks the extra devices, when the model is recurrent (stage slicing
    needs a homogeneous layer stack) or shallower than the pipeline.
    Stage boundaries come from ``default_stage_cuts`` under the evolvable
    ``stage_balance`` policy ("even" / "front-light" / "rear-light").
    Memory cannot get worse — pp shards the layer stack over more devices —
    so a feasible input plan stays feasible."""
    pp = int(pp)
    if pp <= 1 or not plan.groups:
        return plan
    free = {g: ctx.cluster.count(g) for g in ctx.cluster.types()}
    for g in plan.groups:
        free[g.gpu_type] = free.get(g.gpu_type, 0) - g.devices
    out = []
    for g in plan.groups:
        z = ctx.models.get(g.model)
        extra = g.tp * g.dp * (pp - 1) * g.count
        if (g.pp == 1 and z is not None and not z.ssm_state
                and z.n_layers >= pp and free.get(g.gpu_type, 0) >= extra):
            free[g.gpu_type] -= extra
            g = replace(g, pp=pp,
                        stage_cuts=default_stage_cuts(z.n_layers, pp,
                                                      stage_balance))
        out.append(g)
    return Plan(tuple(out))


# --------------------------------------------------------------------------- #
# greedy scheduler
# --------------------------------------------------------------------------- #
def greedy_schedule(ctx: Ctx, batch_scheme: str = "pow2",
                    heterogeneity_aware: bool = True) -> Plan:
    """Load-share greedy packing: every model gets a device budget proportional
    to its FLOPs demand, then takes the best (gpu, tp, batch, count) within
    budget on its best-suited GPU type.  O(models × types × tp × batches)."""
    sim = ctx.simulator
    free = {g: ctx.cluster.count(g) for g in ctx.cluster.types()}
    total_dev = ctx.cluster.total
    # FLOPs-demand proxy: active params × tokens
    demand = {}
    for w in ctx.workloads:
        z = ctx.models[w.model]
        act = z.weight_bytes * z.active_ffn_factor
        demand[w.model] = act * w.batch * (w.prefill_len + w.decode_len)
    tot_demand = sum(demand.values()) or 1.0
    order = sorted(ctx.workloads,
                   key=lambda w: ctx.models[w.model].weight_bytes, reverse=True)
    # minimum footprint (smallest feasible tp anywhere) per model — the
    # reservation that guarantees every model gets placed
    min_dev = {}
    for w in order:
        z = ctx.models[w.model]
        fits = [t for g in ctx.cluster.types()
                for t in tp_candidates(z, g, ctx)]
        min_dev[w.model] = min(fits) if fits else 1
    groups: List[ReplicaGroup] = []
    for rank, w in enumerate(order):
        z = ctx.models[w.model]
        reserved = sum(min_dev[x.model] for x in order[rank + 1:])
        avail_total = sum(free.values()) - reserved
        budget = max(min_dev[w.model],
                     min(round(total_dev * demand[w.model] / tot_demand),
                         avail_total))

        def candidates(dev_cap: int):
            best_local = None
            for g_name in gpu_order(z, ctx, heterogeneity_aware):
                for t in tp_candidates(z, g_name, ctx):
                    max_rep = min(free.get(g_name, 0), dev_cap) // t
                    if max_rep <= 0:
                        continue
                    for b in batch_candidates(w.batch, batch_scheme):
                        n = min(math.ceil(w.batch / b), max_rep)
                        if n <= 0:
                            continue
                        waves = math.ceil(w.batch / (n * b))
                        lat = sim.group_latency(w.model, g_name, t, b,
                                                w.prefill_len, w.decode_len) * waves
                        if lat >= 1e9:
                            continue
                        key = (lat, t * n)
                        if best_local is None or key < best_local[0]:
                            best_local = (key, ReplicaGroup(w.model, g_name, t, b, n))
            return best_local

        best = candidates(budget)
        if best is None:      # budget too tight → any feasible placement
            best = candidates(max(avail_total, min_dev[w.model]))
        if best is None:
            continue
        grp = best[1]
        free[grp.gpu_type] -= grp.devices
        groups.append(grp)
    return Plan(tuple(groups))


# --------------------------------------------------------------------------- #
# anytime branch & bound ("ILP") scheduler
# --------------------------------------------------------------------------- #
@dataclass
class BnBStats:
    nodes: int = 0
    pruned: int = 0
    incumbent: float = float("inf")
    timed_out: bool = False


def _model_options(ctx: Ctx, w: Workload, batch_scheme: str,
                   tp_floor_large: int, intra_node_only: bool,
                   max_options: int) -> List[Tuple[float, ReplicaGroup]]:
    """Enumerate (latency, group) options for one model.

    Replica counts span a geometric ladder up to the per-variable bound
    (Eq. 19: min(capacity/t, ceil(λ/b))) so device-frugal options always
    exist and backtracking can trade devices between models.  Sorted
    best-latency-first, ties broken toward fewer devices.
    """
    sim = ctx.simulator
    z = ctx.models[w.model]
    opts: Dict[Tuple, Tuple[float, ReplicaGroup]] = {}
    for g_name in ctx.cluster.types():
        for t in tp_candidates(z, g_name, ctx, tp_floor_large, intra_node_only):
            for b in batch_candidates(w.batch, batch_scheme):
                n_cov = math.ceil(w.batch / b)
                n_cap = ctx.cluster.count(g_name) // t
                n_bound = min(n_cov, n_cap)           # Eq. 19 M_{z,g,t,b}
                if n_bound <= 0:
                    continue
                ns = {n_bound}
                n = 1
                while n < n_bound:
                    ns.add(n)
                    n *= 2
                for n in ns:
                    waves = math.ceil(w.batch / (n * b))
                    lat = sim.group_latency(w.model, g_name, t, b,
                                            w.prefill_len, w.decode_len) * waves
                    if lat >= 1e9:
                        continue
                    key = (g_name, t, b, n)
                    opts[key] = (lat, ReplicaGroup(w.model, g_name, t, b, n))
    by_lat = sorted(opts.values(), key=lambda o: (o[0], o[1].devices))
    # keep the most device-frugal options alive past truncation so full
    # assignments always exist under tight capacity
    by_dev = sorted(opts.values(), key=lambda o: (o[1].devices, o[0]))[:16]
    seen, out = set(), []
    for o in by_lat[:max_options] + by_dev:
        k = (o[1].gpu_type, o[1].tp, o[1].batch, o[1].count)
        if k not in seen:
            seen.add(k)
            out.append(o)
    out.sort(key=lambda o: (o[0], o[1].devices))
    return out


def _split_options(ctx: Ctx, w: Workload, singles, top_p: int = 10
                   ) -> List[Tuple[float, Tuple[ReplicaGroup, ...]]]:
    """Two-group splits across distinct GPU types (App. C: models may hold
    multiple active replica groups; L_z = slowest group).  Each side takes a
    capacity-proportional share of λ."""
    sim = ctx.simulator
    out = []
    top = singles[:top_p]
    for ai in range(len(top)):
        for bi in range(ai + 1, len(top)):
            (la, ga), (lb, gb) = top[ai], top[bi]
            if ga.gpu_type == gb.gpu_type:
                continue
            cap = ga.capacity + gb.capacity
            if cap <= 0:
                continue
            lam_a = math.ceil(w.batch * ga.capacity / cap)
            lam_b = w.batch - lam_a
            if lam_a <= 0 or lam_b <= 0:
                continue
            wav_a = math.ceil(lam_a / max(ga.capacity, 1))
            wav_b = math.ceil(lam_b / max(gb.capacity, 1))
            lat = max(
                sim.group_latency(w.model, ga.gpu_type, ga.tp, ga.batch,
                                  w.prefill_len, w.decode_len) * max(wav_a, 1),
                sim.group_latency(w.model, gb.gpu_type, gb.tp, gb.batch,
                                  w.prefill_len, w.decode_len) * max(wav_b, 1))
            if lat >= 1e9:
                continue
            out.append((lat, (ga, gb)))
    return out


def bnb_schedule(ctx: Ctx, deadline_s: float = 10.0,
                 batch_scheme: str = "exhaustive",
                 tp_floor_large: int = 0,
                 intra_node_only: bool = False,
                 max_options: int = 64,
                 weighted_obj: bool = False,
                 allow_split: bool = False,
                 stats: Optional[BnBStats] = None) -> Plan:
    """Min-makespan replica-group assignment via anytime depth-first B&B.

    Exact over its option space given enough time; ``deadline_s`` caps
    wall-clock (the scheduling-thoroughness trade-off knob).  ``allow_split``
    adds two-type split placements (quality ↑, search cost ↑↑).  Weighted
    secondary objective (Eq. 23) biases ties toward larger models.
    """
    st = stats or BnBStats()
    t0 = time.monotonic()
    # big models first (most constrained)
    order = sorted(ctx.workloads,
                   key=lambda w: ctx.models[w.model].weight_bytes, reverse=True)
    all_opts: List[List[Tuple[float, Tuple[ReplicaGroup, ...]]]] = []
    for w in order:
        singles = _model_options(ctx, w, batch_scheme, tp_floor_large,
                                 intra_node_only, max_options)
        opts = [(lat, (grp,)) for lat, grp in singles]
        if allow_split:
            opts += _split_options(ctx, w, singles)
        opts.sort(key=lambda o: (o[0], sum(g.devices for g in o[1])))
        all_opts.append(opts)
    # lower bound per model = its best latency ignoring capacity
    lb = [o[0][0] if o else float("inf") for o in all_opts]
    weights = [1.0 + 0.5 * i for i in range(len(order))][::-1]  # larger z heavier

    best_plan: List[ReplicaGroup] = []
    best_key = (float("inf"), float("inf"))
    free0 = {g: ctx.cluster.count(g) for g in ctx.cluster.types()}

    def score(lats: List[float]) -> Tuple[float, float]:
        mk = max(lats) if lats else float("inf")
        sec = 0.05 * sum(wt * l for wt, l in zip(weights, lats)) if weighted_obj else 0.0
        return (mk, sec)

    def dfs(i: int, free: Dict[str, int], groups: List[ReplicaGroup],
            lats: List[float]) -> None:
        nonlocal best_plan, best_key
        if time.monotonic() - t0 > deadline_s:
            st.timed_out = True
            return
        st.nodes += 1
        cur_mk = max(lats) if lats else 0.0
        # bound: even the best remaining options can't beat incumbent
        rem_lb = max(lb[i:]) if i < len(order) else 0.0
        if max(cur_mk, rem_lb) >= best_key[0]:
            st.pruned += 1
            return
        if i == len(order):
            k = score(lats)
            if k < best_key:
                best_key = k
                best_plan = list(groups)
                st.incumbent = k[0]
            return
        placed = False
        for lat, grps in all_opts[i]:
            if max(cur_mk, lat) >= best_key[0]:
                break  # options sorted: nothing better follows
            need: Dict[str, int] = {}
            for g in grps:
                need[g.gpu_type] = need.get(g.gpu_type, 0) + g.devices
            if any(n > free.get(t, 0) for t, n in need.items()):
                continue
            placed = True
            for t, n in need.items():
                free[t] -= n
            groups.extend(grps)
            lats.append(lat)
            dfs(i + 1, free, groups, lats)
            lats.pop()
            del groups[-len(grps):]
            for t, n in need.items():
                free[t] += n
            if st.timed_out:
                return
        if not placed:
            st.pruned += 1

    dfs(0, dict(free0), [], [])
    if not best_plan:
        return greedy_schedule(ctx)
    return Plan(tuple(best_plan))


# --------------------------------------------------------------------------- #
# §8.2 reconfiguration baselines
# --------------------------------------------------------------------------- #
def full_migration(ctx: Ctx, deadline_s: float = 10.0) -> Plan:
    """Always reconfigure to the globally optimal plan for current conditions."""
    return bnb_schedule(ctx, deadline_s=deadline_s, batch_scheme="sweet",
                        allow_split=True)


def minimal_migration(ctx: Ctx) -> Plan:
    """Nearest operational plan: keep every group that still fits the cluster,
    only (re)place models whose groups reference missing devices."""
    sim = ctx.simulator
    old = ctx.current_plan or Plan(())
    free = {g: ctx.cluster.count(g) for g in ctx.cluster.types()}
    kept: List[ReplicaGroup] = []
    homeless: List[Workload] = []
    for w in ctx.workloads:
        groups = old.for_model(w.model)
        ok = bool(groups)
        for g in groups:
            if free.get(g.gpu_type, 0) >= g.devices:
                free[g.gpu_type] -= g.devices
            else:
                ok = False
        if ok and groups:
            kept.extend(groups)
        else:
            for g in groups:  # release partial reservations
                if g in kept:
                    continue
            homeless.append(w)
    if homeless:
        sub_ctx = Ctx(
            time=ctx.time, timestamp_idx=ctx.timestamp_idx,
            workloads=homeless,
            cluster=type(ctx.cluster)(tuple((g, n) for g, n in free.items())),
            current_plan=None, models=ctx.models, hardware=ctx.hardware,
            simulator=sim)
        extra = greedy_schedule(sub_ctx)
        kept.extend(extra.groups)
    return Plan(tuple(kept))


# --------------------------------------------------------------------------- #
# §8.3 agentic request scheduling (round-based, disaggregated P/D)
# --------------------------------------------------------------------------- #
@dataclass
class AgenticInstance:
    name: str
    kind: str                       # "prefill" | "decode"
    speed_tok_s: float
    token_capacity: int = 1 << 30
    free_at: float = 0.0
    queued_tokens: int = 0


@dataclass(frozen=True)
class AgenticAssignment:
    call_key: Tuple[int, int]       # (workflow, call_idx)
    prefill_inst: str
    decode_inst: str
    priority: float                 # queue order (lower first)


def agentic_greedy(calls, prefill_insts: Sequence[AgenticInstance],
                   decode_insts: Sequence[AgenticInstance]
                   ) -> List[AgenticAssignment]:
    """FIFO earliest-available-instance greedy."""
    out = []
    pi = sorted(prefill_insts, key=lambda i: i.free_at)
    di = sorted(decode_insts, key=lambda i: i.free_at)
    for k, c in enumerate(calls):
        p = min(pi, key=lambda i: i.free_at + i.queued_tokens / i.speed_tok_s)
        d = min(di, key=lambda i: i.free_at + i.queued_tokens / i.speed_tok_s)
        p.queued_tokens += c.prefill_len
        d.queued_tokens += c.decode_len
        out.append(AgenticAssignment((c.workflow, c.call_idx), p.name, d.name,
                                     priority=float(k)))
    return out


def agentic_bnb(calls, prefill_insts, decode_insts,
                deadline_s: float = 2.0) -> List[AgenticAssignment]:
    """Exact assignment+ordering (min makespan) by B&B — the MILP baseline."""
    calls = list(calls)
    t0 = time.monotonic()
    best: Tuple[float, Optional[List[int]]] = (float("inf"), None)
    n_p = len(prefill_insts)
    n_d = len(decode_insts)

    # order by SPT as the initial incumbent heuristic
    order = sorted(range(len(calls)),
                   key=lambda i: calls[i].prefill_len + calls[i].decode_len)

    def simulate(assign: List[int]) -> float:
        p_free = [i.free_at for i in prefill_insts]
        d_free = [i.free_at for i in decode_insts]
        mk = 0.0
        for idx, a in zip(order, assign):
            c = calls[idx]
            p, d = a % n_p, (a // n_p) % n_d
            t_p = p_free[p] + c.prefill_len / prefill_insts[p].speed_tok_s
            p_free[p] = t_p
            t_d = max(t_p, d_free[d]) + c.decode_len / decode_insts[d].speed_tok_s
            d_free[d] = t_d
            mk = max(mk, t_d)
        return mk

    def dfs(i: int, assign: List[int], mk_so_far: float) -> None:
        nonlocal best
        if time.monotonic() - t0 > deadline_s:
            return
        if mk_so_far >= best[0]:
            return
        if i == len(order):
            best = (mk_so_far, list(assign))
            return
        for a in range(n_p * n_d):
            assign.append(a)
            dfs(i + 1, assign, simulate(assign))
            assign.pop()

    greedy0 = [0] * len(order)
    best = (simulate(greedy0), greedy0)
    dfs(0, [], 0.0)
    assign = best[1] or greedy0
    out = []
    for rank, (idx, a) in enumerate(zip(order, assign)):
        c = calls[idx]
        out.append(AgenticAssignment(
            (c.workflow, c.call_idx),
            prefill_insts[a % n_p].name,
            decode_insts[(a // n_p) % n_d].name,
            priority=float(rank)))
    return out

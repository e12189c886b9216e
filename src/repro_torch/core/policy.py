"""Policy-as-source-code, Policy API v2: multi-domain programs (port of
``src/repro/core/policy.py``).

A serving policy is source code compiled with ``exec`` in a restricted
namespace (:func:`policy_namespace`).  A :class:`PolicyProgram` declares
the domains it implements — ``placement`` (``should_reschedule``,
``schedule``), ``request`` (``admit``, ``prioritize``), ``reconfig``
(``migration_mode``), ``kv_cache`` (``cache_prefix``, ``evict_priority``)
and ``recovery`` (``on_failure``) — through its GENOME header or
``POLICY_DOMAINS``; a raw v1 source gets its domains inferred from the
hooks it defines.  :func:`render_policy` renders a genome into source and
:func:`seed_policies` gives the seed vocabulary.  The templates are the
reference's text, so a genome renders to the same source in both
packages, and the placement namespace holds the port's copies of the
schedulers and plan types.  The hook dataclasses (:class:`RequestPolicy`,
:class:`ReconfigPolicy`, :class:`KVCachePolicy`, :class:`RecoveryPolicy`,
:class:`HookCircuitBreaker`) are what the engines and the pool consume,
duck-typed, so hooks compiled by either control plane drive either
package's engines.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core import schedulers
from repro_torch.core.plan import Ctx, Plan, ReplicaGroup

GENOME_PREFIX = "# GENOME: "

POLICY_API_VERSION = 2

# domain registry: domain name -> required hook functions
DOMAINS: Dict[str, Tuple[str, ...]] = {
    "placement": ("should_reschedule", "schedule"),
    "request": ("admit", "prioritize"),
    # reconfig: what happens to each in-flight request when its replica is
    # removed by a plan change — drain (block until it finishes), migrate
    # (carry its KV/SSM slot state to a survivor), or recompute (requeue a
    # continuation and pay the re-prefill)
    "reconfig": ("migration_mode",),
    # kv_cache: cross-request prefix-cache management over the paged KV pool —
    # admission ("retain this finished prompt's pages for reuse?") and
    # eviction ordering under page-pool pressure (higher score evicts first),
    # both over a KVCacheCtx plain-scalar view
    "kv_cache": ("cache_prefix", "evict_priority"),
    # recovery: unplanned-failure containment — called once per in-flight
    # request on a replica that died, over a FailureCtx plain-scalar view;
    # answers salvage (live-migrate the slot state to a survivor) |
    # recompute (requeue a continuation with capped backoff) | shed (drop)
    "recovery": ("on_failure",),
}

# default genome = paper's "reactive baseline" starting point
DEFAULT_GENOME: Dict[str, Any] = {
    "domains": ["placement"],       # which DOMAINS the program implements
    "scheduler": "greedy",          # greedy | bnb | hybrid
    "time_budget": 2.0,             # B&B anytime deadline (thoroughness)
    "batch_scheme": "pow2",         # pow2 | sweet | exhaustive
    "tp_floor_large": 0,            # App. G parallel-strategy constraint
    "replica_dp": 1,                # intra-replica data parallelism (TP×DP)
    "replica_pp": 1,                # pipeline stages per replica (pp, dp, tp)
    "stage_balance": "even",        # even | front-light | rear-light cuts
    "intra_node_only": False,       # §7.2 (i): bound TP within a node
    "heterogeneity_aware": True,    # §7.2 (iv)
    "weighted_obj": False,          # Eq. 23
    "allow_split": False,           # App. C multi-group placements (thorough)
    "reconfig_penalty": 0.0,        # plan choice: serve + penalty × reconfig
    "migration_keep_threshold": 0.0,  # per-model cost-benefit keep rule (§8.2)
    "trigger_kind": "always",       # always | threshold | periodic | hybrid
    "shift_threshold": 0.3,         # workload_shift() trigger level
    "min_interval": 1,              # periodic trigger / cooldown
    # --- request domain (consulted only when "request" in domains) ---
    "priority_kind": "fifo",        # fifo | sjf | slo-aware
    "admit_load_cap": 0.0,          # 0 = unlimited; else outstanding ≤ cap×slots
    "preempt": False,               # evict the worst-priority running request
    "slo_ttft_s": 2.0,              # slo-aware target for slack computation
    # --- reconfig domain (consulted only when "reconfig" in domains) ---
    "migration_mode": "drain",      # drain | migrate | recompute
    "migrate_min_progress": 0.0,    # min decode-budget fraction to carry state
    # --- kv_cache domain (consulted only when "kv_cache" in domains) ---
    "kv_admit_min_pages": 1,        # retain prefixes spanning ≥ this many pages
    "kv_evict_kind": "lru",         # lru | lfu | pin-hot
    "kv_pin_hits": 4,               # pin-hot: blocks with ≥ this many hits stay
    # --- recovery domain (consulted only when "recovery" in domains) ---
    "recovery_mode": "salvage",     # salvage | recompute | shed
    "retry_budget": 3,              # failed-request requeues before shedding
    "backoff_base_s": 0.02,         # capped exponential backoff base
    "backoff_cap_s": 2.0,           # backoff ceiling
    "straggler_factor": 0.0,        # 0 = off; quarantine at factor × median
    "fail_replan": False,           # a failure forces a re-plan next step
    "degraded_admit_cap": 0.0,      # 0 = off; load clamp while degraded
}


# --------------------------------------------------------------------------- #
# restricted execution environment
# --------------------------------------------------------------------------- #
_SAFE_BUILTINS = {
    "len": len, "min": min, "max": max, "sum": sum, "abs": abs, "range": range,
    "enumerate": enumerate, "sorted": sorted, "zip": zip, "map": map,
    "filter": filter, "list": list, "dict": dict, "set": set, "tuple": tuple,
    "float": float, "int": int, "bool": bool, "str": str, "round": round,
    "any": any, "all": all, "print": print, "isinstance": isinstance,
    "ValueError": ValueError, "Exception": Exception, "reversed": reversed,
    "__build_class__": __builtins__["__build_class__"]
    if isinstance(__builtins__, dict) else __builtins__.__build_class__,
    "__name__": "policy",
}


def policy_namespace(domain: Optional[str] = None) -> Dict[str, Any]:
    """Names available to policy code in ``domain`` (``None`` = the union of
    every domain — what :meth:`PolicyProgram.compile` executes sources in).

    The paper exposes the simulator and scheduling building blocks to
    generated *placement* programs; *request* and *reconfig* programs run on
    the serving hot path / inside the reconfiguration critical section and
    see only arithmetic — they must stay cheap and effect-free.
    """
    base: Dict[str, Any] = {
        "__builtins__": dict(_SAFE_BUILTINS),
        "math": math,
    }
    if domain in ("request", "reconfig", "kv_cache", "recovery"):
        return base
    base.update({
        "schedulers": schedulers,
        "Plan": Plan,
        "ReplicaGroup": ReplicaGroup,
        "greedy_schedule": schedulers.greedy_schedule,
        "bnb_schedule": schedulers.bnb_schedule,
        "full_migration": schedulers.full_migration,
        "minimal_migration": schedulers.minimal_migration,
    })
    return base


class PolicyDomainError(RuntimeError):
    """A hook from a domain the program does not implement was invoked."""


@dataclass
class RequestPolicy:
    """Compiled request-domain hooks: ``admit(rctx) -> bool`` and
    ``prioritize(rctx) -> float`` (lower runs first) over a ``RequestCtx``;
    ``preempt`` lets the engine evict a running request for a waiting one."""
    admit_fn: Callable[[Any], bool]
    prioritize_fn: Callable[[Any], float]
    preempt: bool = False
    name: str = "anon"

    def admit(self, rctx: Any) -> bool:
        return bool(self.admit_fn(rctx))

    def prioritize(self, rctx: Any) -> float:
        return float(self.prioritize_fn(rctx))


@dataclass
class ReconfigPolicy:
    """Compiled reconfig-domain hook: ``migration_mode(mctx)`` answers
    drain | migrate | recompute per in-flight request on a removed replica.
    ``may_migrate`` False keeps the teardown-before-build order."""
    mode_fn: Callable[[Any], str]
    name: str = "anon"
    may_migrate: bool = True

    def migration_mode(self, mctx: Any) -> str:
        return str(self.mode_fn(mctx))


@dataclass
class KVCachePolicy:
    """Compiled kv_cache-domain hooks over a ``KVCacheCtx``:
    ``cache_prefix`` admits a finished prompt's pages into the prefix index,
    ``evict_priority`` scores a retained block (higher evicts sooner)."""
    cache_prefix_fn: Callable[[Any], bool]
    evict_priority_fn: Callable[[Any], float]
    name: str = "anon"

    def cache_prefix(self, kctx: Any) -> bool:
        return bool(self.cache_prefix_fn(kctx))

    def evict_priority(self, kctx: Any) -> float:
        return float(self.evict_priority_fn(kctx))


@dataclass
class RecoveryPolicy:
    """Compiled recovery-domain hook plus its fault-handling knobs:
    ``on_failure(fctx)`` answers salvage | recompute | shed per in-flight
    request on a replica that died; the knobs drive the pool's retry
    budget, capped exponential backoff, straggler quarantine, re-plan on
    failure and degraded-capacity admission clamp."""
    mode_fn: Callable[[Any], str]
    name: str = "anon"
    retry_budget: int = 3
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 2.0
    straggler_factor: float = 0.0
    fail_replan: bool = False
    degraded_admit_cap: float = 0.0

    def on_failure(self, fctx: Any) -> str:
        return str(self.mode_fn(fctx))


@dataclass
class HookCircuitBreaker:
    """Per-domain circuit breaker over evolved-hook exceptions: after
    ``threshold`` consecutive failures in one domain the breaker opens and
    call sites skip that domain's hook until :meth:`reset`."""
    threshold: int = 5
    consecutive: Dict[str, int] = field(default_factory=dict)
    trips: Dict[str, int] = field(default_factory=dict)   # domain -> trip count
    _open: set = field(default_factory=set)

    def failure(self, domain: str) -> bool:
        """Record one hook exception; True when this failure trips the
        breaker (first trip only — an open breaker stays open)."""
        n = self.consecutive.get(domain, 0) + 1
        self.consecutive[domain] = n
        if n >= self.threshold and domain not in self._open:
            self._open.add(domain)
            self.trips[domain] = self.trips.get(domain, 0) + 1
            return True
        return False

    def success(self, domain: str) -> None:
        self.consecutive[domain] = 0

    def tripped(self, domain: str) -> bool:
        return domain in self._open

    def reset(self, domain: str) -> None:
        """Close the breaker — freshly installed hooks earn a clean count."""
        self.consecutive[domain] = 0
        self._open.discard(domain)

    @property
    def open_domains(self) -> Tuple[str, ...]:
        return tuple(sorted(self._open))


@dataclass
class PolicyProgram:
    """Compiled multi-domain policy: source of record is the code string."""
    source: str
    genome: Optional[Dict[str, Any]] = None
    name: str = "anon"
    domains: Tuple[str, ...] = ()
    api_version: int = 0             # set at compile: 2 declared, 1 inferred
    _hooks: Dict[str, Tuple[Callable, ...]] = field(default_factory=dict,
                                                    repr=False)

    def compile(self) -> "PolicyProgram":
        ns = policy_namespace()
        exec(compile(self.source, f"<policy:{self.name}>", "exec"), ns)  # noqa: S102
        if self.genome is None:
            self.genome = parse_genome(self.source)

        declared = ns.get("POLICY_DOMAINS")
        if declared is None and self.genome is not None:
            declared = self.genome.get("domains")
        if declared is not None:
            self.api_version = POLICY_API_VERSION
            declared = tuple(declared)
            unknown = [d for d in declared if d not in DOMAINS]
            if unknown:
                raise ValueError(f"policy declares unknown domains {unknown}; "
                                 f"known: {sorted(DOMAINS)}")
        else:
            # v1 back-compat adapter: infer domains from the hooks defined
            self.api_version = 1
            declared = tuple(d for d, fns in DOMAINS.items()
                             if all(f in ns and callable(ns[f]) for f in fns))
        if not declared:
            raise ValueError(
                "policy source implements no known domain — it must define "
                "should_reschedule+schedule (placement) and/or "
                "admit+prioritize (request)")

        # per-domain namespaces: each domain's hooks close over exactly that
        # domain's restricted namespace, so a request hook physically cannot
        # reach the scheduler/simulator machinery from the serving hot path
        # (it raises NameError there, which the engine treats as advisory).
        # The placement namespace equals the union one, so its hooks come
        # from the detection exec; only restricted domains re-exec.
        hooks: Dict[str, Tuple[Callable, ...]] = {}
        for d in declared:
            missing = [f for f in DOMAINS[d]
                       if f not in ns or not callable(ns[f])]
            if missing:
                raise ValueError(f"policy declares domain '{d}' but does not "
                                 f"define {missing}")
            if d == "placement":
                dns = ns
            else:
                dns = policy_namespace(d)
                exec(compile(self.source, f"<policy:{self.name}:{d}>",  # noqa: S102
                             "exec"), dns)
            hooks[d] = tuple(dns[f] for f in DOMAINS[d])
        self.domains = tuple(d for d in DOMAINS if d in hooks)  # stable order
        self._hooks = hooks
        return self

    # ------------------------------------------------------------------ #
    def implements(self, domain: str) -> bool:
        if not self._hooks:
            self.compile()
        return domain in self._hooks

    def _domain_hooks(self, domain: str) -> Tuple[Callable, ...]:
        if not self._hooks:
            self.compile()
        try:
            return self._hooks[domain]
        except KeyError:
            raise PolicyDomainError(
                f"policy '{self.name}' implements {self.domains}, "
                f"not '{domain}'") from None

    # --- placement domain --------------------------------------------- #
    @property
    def fns(self) -> Tuple[Callable, Callable]:
        """(should_reschedule, schedule) — v1-era accessor, kept stable."""
        return self._domain_hooks("placement")

    def should_reschedule(self, ctx: Ctx) -> bool:
        return bool(self._domain_hooks("placement")[0](ctx))

    def schedule(self, ctx: Ctx) -> Plan:
        return self._domain_hooks("placement")[1](ctx)

    # --- request domain ----------------------------------------------- #
    def request_policy(self) -> Optional[RequestPolicy]:
        """Compiled request-domain hooks, or None for placement-only
        programs (backends then fall back to FIFO admission)."""
        if not self.implements("request"):
            return None
        admit_fn, prioritize_fn = self._hooks["request"]
        preempt = bool((self.genome or {}).get("preempt", False))
        return RequestPolicy(admit_fn, prioritize_fn, preempt=preempt,
                             name=self.name)

    # --- reconfig domain ---------------------------------------------- #
    def reconfig_policy(self) -> Optional["ReconfigPolicy"]:
        """Compiled reconfig-domain hook, or None for programs that leave
        reconfiguration at the backend default (synchronous drain)."""
        if not self.implements("reconfig"):
            return None
        (mode_fn,) = self._hooks["reconfig"]
        mode = (self.genome or {}).get("migration_mode")
        # hand-written sources carry no genome hint: assume they may migrate
        return ReconfigPolicy(mode_fn, name=self.name,
                              may_migrate=(mode != "drain"
                                           if mode is not None else True))

    # --- kv_cache domain ---------------------------------------------- #
    def kv_cache_policy(self) -> Optional["KVCachePolicy"]:
        """Compiled kv_cache-domain hooks, or None for programs that leave
        prefix-cache management at the backend default (admit all, LRU)."""
        if not self.implements("kv_cache"):
            return None
        cache_fn, evict_fn = self._hooks["kv_cache"]
        return KVCachePolicy(cache_fn, evict_fn, name=self.name)

    # --- recovery domain ---------------------------------------------- #
    def recovery_policy(self) -> Optional["RecoveryPolicy"]:
        """Compiled recovery-domain hook + knobs, or None for programs that
        leave failure handling at the pool default (salvage what exports,
        recompute the rest, budget-capped backoff)."""
        if not self.implements("recovery"):
            return None
        (mode_fn,) = self._hooks["recovery"]
        g = self.genome or {}
        d = DEFAULT_GENOME
        return RecoveryPolicy(
            mode_fn, name=self.name,
            retry_budget=int(g.get("retry_budget", d["retry_budget"])),
            backoff_base_s=float(g.get("backoff_base_s",
                                       d["backoff_base_s"])),
            backoff_cap_s=float(g.get("backoff_cap_s", d["backoff_cap_s"])),
            straggler_factor=float(g.get("straggler_factor",
                                         d["straggler_factor"])),
            fail_replan=bool(g.get("fail_replan", d["fail_replan"])),
            degraded_admit_cap=float(g.get("degraded_admit_cap",
                                           d["degraded_admit_cap"])))


# v1 name: every existing call-site (and raw v1 source) keeps working
Policy = PolicyProgram


def parse_genome(source: str) -> Optional[Dict[str, Any]]:
    first = source.lstrip().splitlines()[0] if source.strip() else ""
    if first.startswith(GENOME_PREFIX):
        try:
            return json.loads(first[len(GENOME_PREFIX):])
        except json.JSONDecodeError:
            return None
    return None


# --------------------------------------------------------------------------- #
# genome -> source renderer
# --------------------------------------------------------------------------- #
_TEMPLATE = '''\
{genome_line}
# Auto-rendered serving policy. should_reschedule controls Trade-off (i)
# (rescheduling frequency); schedule controls Trade-offs (ii)+(iii)
# (scheduling thoroughness, reconfiguration aggressiveness).

G = {genome_repr}


def should_reschedule(ctx):
    if ctx.current_plan is None or not ctx.current_plan.groups:
        return True                      # cold start
    if ctx.cluster_changed():
        return True                      # mandatory on cluster transitions
    kind = G["trigger_kind"]
    steps_since = ctx.scratch.get("steps_since_resched", 0)
    if kind == "always":
        return True
    if kind == "periodic":
        return steps_since >= G["min_interval"]
    shift = ctx.workload_shift()
    if kind == "threshold":
        return shift > G["shift_threshold"]
    # hybrid: threshold with cooldown
    return shift > G["shift_threshold"] and steps_since >= G["min_interval"]


def _base_plan(ctx):
    if G["scheduler"] == "greedy":
        return greedy_schedule(ctx, batch_scheme=G["batch_scheme"],
                               heterogeneity_aware=G["heterogeneity_aware"])
    if G["scheduler"] == "bnb":
        return bnb_schedule(ctx, deadline_s=G["time_budget"],
                            batch_scheme=G["batch_scheme"],
                            tp_floor_large=G["tp_floor_large"],
                            intra_node_only=G["intra_node_only"],
                            weighted_obj=G["weighted_obj"],
                            allow_split=G["allow_split"])
    # hybrid: greedy seed, refine with the remaining budget
    g = greedy_schedule(ctx, batch_scheme=G["batch_scheme"],
                        heterogeneity_aware=G["heterogeneity_aware"])
    b = bnb_schedule(ctx, deadline_s=G["time_budget"],
                     batch_scheme=G["batch_scheme"],
                     tp_floor_large=G["tp_floor_large"],
                     intra_node_only=G["intra_node_only"],
                     weighted_obj=G["weighted_obj"],
                     allow_split=G["allow_split"])
    sim = ctx.simulator
    return b if sim.serve_cost(b, ctx.workloads) <= \
        sim.serve_cost(g, ctx.workloads) else g


def schedule(ctx):
    sim = ctx.simulator
    new = _base_plan(ctx)
    if G.get("replica_dp", 1) > 1:
        # widen replicas to (dp, tp) submeshes where devices/batch allow
        new = schedulers.apply_replica_dp(new, ctx, G["replica_dp"])
    if G.get("replica_pp", 1) > 1:
        # deepen replicas to (pp, dp, tp) submeshes where devices/depth
        # allow — pp stages tolerate fragmented free capacity
        new = schedulers.apply_replica_pp(new, ctx, G["replica_pp"],
                                          G.get("stage_balance", "even"))
    old = ctx.current_plan
    if old is None or not old.groups:
        return new
    # Trade-off (iii): reconfiguration-aware plan selection.  Candidates:
    # stay / move fully / per-model partial migration (cost-benefit keep rule).
    cands = [old, new]
    if G["migration_keep_threshold"] > 0.0:
        kept = []
        free = {{g: ctx.cluster.count(g) for g in ctx.cluster.types()}}
        for w in ctx.workloads:
            og = old.for_model(w.model)
            ng = new.for_model(w.model)
            fits = og and all(free.get(g.gpu_type, 0) >= g.devices for g in og)
            if fits:
                gain = (sim.model_latency(old, w) - sim.model_latency(new, w))
                cost = sum(sim.weight_transfer_time(w.model, g.gpu_type)
                           for g in ng)
                if gain < G["migration_keep_threshold"] * cost:
                    for g in og:
                        free[g.gpu_type] -= g.devices
                    kept.extend(og)
                    continue
            for g in ng:
                if free.get(g.gpu_type, 0) >= g.devices:
                    free[g.gpu_type] -= g.devices
                    kept.append(g)
        cands.append(Plan(tuple(kept)))
    best, best_score = None, None
    for p in cands:
        feas, _ = sim.plan_feasible(p, ctx.cluster, ctx.workloads)
        if not feas:
            continue
        score = (sim.serve_cost(p, ctx.workloads)
                 + G["reconfig_penalty"] * sim.reconfig_cost(old, p))
        if best is None or score < best_score:
            best, best_score = p, score
    return best if best is not None else new
'''

# appended verbatim (after placement formatting) when the genome declares the
# request domain; ``r`` is the engine's RequestCtx view — lower score first
_REQUEST_SECTION = '''

# --- request domain (Policy API v2): admission + priority over RequestCtx ---

def admit(r):
    cap = G["admit_load_cap"]
    if cap > 0 and (r.active + r.queue_depth) >= cap * max(r.n_slots, 1):
        return False                     # shed load: hold for a later step
    return True


def prioritize(r):
    kind = G["priority_kind"]
    if kind == "sjf":
        return float(r.prompt_len + r.max_new_tokens)
    if kind == "slo-aware":
        # requests past the TTFT target sort first (most-late first, always
        # negative); on-time requests run shortest-job-first (positive token
        # counts) — SJF throughput with a starvation guard, which orders
        # differently from both fifo and pure sjf
        slack = G["slo_ttft_s"] - r.age_s
        if slack <= 0.0:
            return float(slack)
        return float(r.prompt_len + r.max_new_tokens)
    return -r.age_s                      # fifo: oldest waiting first
'''


# appended when the genome declares the reconfig domain; ``m`` is the pool's
# MigrationCtx view of one in-flight request on a replica being removed
_RECONFIG_SECTION = '''

# --- reconfig domain (Policy API v2): live-migration choice per request -----

def migration_mode(m):
    mode = G["migration_mode"]
    if mode == "migrate" and m.progress < G["migrate_min_progress"]:
        return "recompute"               # little state saved: re-prefill is cheap
    return mode
'''


# appended when the genome declares the kv_cache domain; ``k`` is the engine's
# KVCacheCtx view of one finished prompt (admission) or one retained prefix
# block under page-pool pressure (eviction; higher score evicts first)
_KV_SECTION = '''

# --- kv_cache domain (Policy API v2): prefix-cache admission + eviction -----

def cache_prefix(k):
    return k.prefix_pages >= G["kv_admit_min_pages"]


def evict_priority(k):
    kind = G["kv_evict_kind"]
    if kind == "lfu":
        return -float(k.hits)            # least-reused blocks go first
    if kind == "pin-hot" and k.hits >= G["kv_pin_hits"]:
        return -1e9                      # hot blocks are effectively pinned
    return float(k.idle_s)               # lru: longest-idle blocks go first
'''


# appended when the genome declares the recovery domain; ``f`` is the pool's
# FailureCtx view of one in-flight request on a replica that just died
_RECOVERY_SECTION = '''

# --- recovery domain (Policy API v2): per-request fault handling ------------

def on_failure(f):
    mode = G["recovery_mode"]
    if f.retries >= G["retry_budget"]:
        return "shed"                    # budget spent: stop churning
    if mode == "salvage" and not f.exportable:
        return "recompute"               # no survivor slot / export denied
    return mode
'''


def render_policy(genome: Dict[str, Any], name: str = "rendered") -> PolicyProgram:
    g = dict(DEFAULT_GENOME)
    g.update(genome)
    src = _TEMPLATE.format(
        genome_line=GENOME_PREFIX + json.dumps(g, sort_keys=True),
        genome_repr=repr(g),            # Python-literal dict (json has true/false)
    )
    if "request" in g.get("domains", ()):
        src += _REQUEST_SECTION
    if "reconfig" in g.get("domains", ()):
        src += _RECONFIG_SECTION
    if "kv_cache" in g.get("domains", ()):
        src += _KV_SECTION
    if "recovery" in g.get("domains", ()):
        src += _RECOVERY_SECTION
    return PolicyProgram(source=src, genome=g, name=name)


# --------------------------------------------------------------------------- #
# seed policies (§5.4: diverse starting vocabulary of design patterns)
# --------------------------------------------------------------------------- #
def seed_policies() -> Dict[str, PolicyProgram]:
    seeds = {
        "greedy-reactive": {"scheduler": "greedy", "trigger_kind": "always"},
        "ilp-thorough": {"scheduler": "bnb", "time_budget": 30.0,
                         "batch_scheme": "exhaustive", "allow_split": True,
                         "trigger_kind": "threshold", "shift_threshold": 5.0},
        "hybrid-threshold": {"scheduler": "hybrid", "time_budget": 3.0,
                             "batch_scheme": "sweet",
                             "trigger_kind": "threshold",
                             "shift_threshold": 0.4,
                             "reconfig_penalty": 1.0},
        "conservative-migrator": {"scheduler": "greedy",
                                  "trigger_kind": "hybrid",
                                  "shift_threshold": 0.25, "min_interval": 1,
                                  "reconfig_penalty": 2.0,
                                  "migration_keep_threshold": 1.0},
        # migration extremes (§8.2 baselines) — starting vocabulary for
        # elastic-cluster regimes, not just comparison targets
        "full-migration": {"scheduler": "bnb", "time_budget": 5.0,
                           "batch_scheme": "sweet", "allow_split": True,
                           "trigger_kind": "always"},
        "minimal-migration": {"scheduler": "greedy",
                              "trigger_kind": "threshold",
                              "shift_threshold": 9.9,
                              "migration_keep_threshold": 4.0,
                              "reconfig_penalty": 8.0},
        # request-domain variants: same placement behaviour as the reactive
        # baseline, but the engines' admission order becomes evolvable
        "sjf-request": {"scheduler": "greedy", "trigger_kind": "always",
                        "domains": ["placement", "request"],
                        "priority_kind": "sjf"},
        # a TRUE request-only program: no placement domain at all — it rides
        # alongside whatever placement policy is live.  The analytic rung
        # cannot rank it; the shadow-replay rung can (evaluation ladder)
        "request-only-slo": {"domains": ["request"],
                             "priority_kind": "slo-aware", "slo_ttft_s": 1.0,
                             "admit_load_cap": 6.0},
        "slo-guard": {"scheduler": "greedy", "trigger_kind": "always",
                      "domains": ["placement", "request"],
                      "priority_kind": "slo-aware", "slo_ttft_s": 1.0,
                      "admit_load_cap": 4.0},
        # reconfiguration-overhead extremes (§5.1 trade-off (iii) at request
        # granularity): carry every in-flight slot across plan changes vs
        # block the pool until removed replicas run dry
        "live-migrate": {"scheduler": "greedy", "trigger_kind": "always",
                         "domains": ["placement", "reconfig"],
                         "migration_mode": "migrate"},
        "drain-reconfig": {"scheduler": "greedy", "trigger_kind": "always",
                           "domains": ["placement", "reconfig"],
                           "migration_mode": "drain"},
        # kv_cache-domain variants: prefix-cache management over the paged KV
        # pool becomes evolvable — retain-everything LRU vs selective
        # admission with hot-block pinning (agentic / shared-system-prompt
        # workloads reward very different retention behaviour than uniform
        # traffic, so the mutator has a real axis to explore)
        "kv-lru": {"scheduler": "greedy", "trigger_kind": "always",
                   "domains": ["placement", "kv_cache"],
                   "kv_evict_kind": "lru", "kv_admit_min_pages": 1},
        "kv-prefix-pin": {"scheduler": "greedy", "trigger_kind": "always",
                          "domains": ["placement", "kv_cache"],
                          "kv_evict_kind": "pin-hot", "kv_pin_hits": 2,
                          "kv_admit_min_pages": 2},
        # recovery-domain extremes (unplanned-failure containment): recover
        # hard — salvage live slot state, generous retries, re-plan to heal
        # capacity, quarantine stragglers — vs shed fast: cheap recompute
        # with a tight budget and an admission clamp that keeps the degraded
        # pool responsive at the price of dropped work
        "retry-migrate": {"scheduler": "greedy", "trigger_kind": "always",
                          "domains": ["placement", "recovery"],
                          "recovery_mode": "salvage", "retry_budget": 4,
                          "backoff_base_s": 0.02, "fail_replan": True,
                          "straggler_factor": 3.0},
        "shed-fast": {"scheduler": "greedy", "trigger_kind": "always",
                      "domains": ["placement", "recovery"],
                      "recovery_mode": "recompute", "retry_budget": 1,
                      "backoff_base_s": 0.01, "backoff_cap_s": 0.25,
                      "degraded_admit_cap": 2.0},
    }
    return {k: render_policy(v, name=k) for k, v in seeds.items()}

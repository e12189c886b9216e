"""Mutator interface (§5.4): trade-off-aware policy mutation (port of ``src/repro/core/mutation.py``).

* ``LLMMutator`` — the paper's online operator: formats the Appendix-E
  trade-off-aware prompts (execution-model structure + artifact feedback +
  population context) and calls a user-supplied completion endpoint that
  returns rewritten policy source.  Model-agnostic; unused offline.

* ``StructuredMutator`` — offline default (DESIGN.md §3): the same
  feedback-directed semantics operating on the policy GENOME.  The dominant
  artifact-feedback term selects the mutation axis exactly as the prompts in
  Appendix E instruct the LLM:
    Σt_reconfig dominant  -> damp reconfiguration aggressiveness
    Σt_stale   dominant  -> cheaper scheduling / rarer rescheduling
    Σt_serve   dominant  -> more thoroughness / fresher plans
  plus temperature-controlled random exploration and island crossover.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.policy import DEFAULT_GENOME, Policy, render_policy

TRADEOFF_SYSTEM_PROMPT = """\
You are evolving an LLM-serving PolicyProgram (Policy API v2): a
placement-domain pair should_reschedule(ctx)/schedule(ctx), optionally
joined by request-domain hooks admit(rctx)/prioritize(rctx) that replace
the engines' FIFO admission order.  The end-to-end objective is

  T_total = t_sched(1) + t_serve(1) + sum_i [ t_stale(i) + t_reconfig(i) + t_serve(i) ]

Navigate three coupled trade-offs:
 (i)  rescheduling frequency vs per-interval overhead — frequent rescheduling
      keeps plans fresh but accumulates scheduling+reconfiguration cost;
 (ii) scheduling thoroughness vs stale serving — thorough search yields better
      plans (lower t_serve) but extends the stale window (higher t_stale);
 (iii) reconfiguration aggressiveness vs transition overhead — migrating to the
      global optimum maximises serving efficiency but pays transfer time
      proportional to the moved weight bytes; a new schedule is only worth it
      when the serving gain exceeds the reconfiguration cost.
Refer to ctx.simulator for accurate serve/reconfig estimates.  Modify the
policy source between the EVOLVE markers only.  Return the full new source.
"""


def mutation_prompt(parent_source: str, parent_feedback: Dict,
                    children_feedback: List[Dict],
                    population_context: Dict) -> str:
    """Appendix-E style per-iteration prompt (artifact feedback Table 1)."""
    rows = [f"  parent: {json.dumps(parent_feedback)}"]
    rows += [f"  child{i}: {json.dumps(fb)}" for i, fb in enumerate(children_feedback)]
    return (
        f"{TRADEOFF_SYSTEM_PROMPT}\n"
        f"## Cost breakdown (lower T_total is better)\n" + "\n".join(rows) + "\n"
        f"## Population context\n{json.dumps(population_context)}\n"
        f"## Current policy source\n```python\n{parent_source}\n```\n"
        "Produce an improved policy navigating the dominant cost term."
    )


class Mutator:
    def mutate(self, parent: Policy, parent_feedback: Optional[Dict],
               children_feedback: List[Dict], population_context: Dict,
               rng: random.Random) -> Policy:
        raise NotImplementedError


@dataclass
class LLMMutator(Mutator):
    """Online operator: completion_fn(prompt) -> new policy source."""
    completion_fn: Callable[[str], str]
    name: str = "llm"

    def mutate(self, parent, parent_feedback, children_feedback,
               population_context, rng) -> Policy:
        prompt = mutation_prompt(parent.source, parent_feedback or {},
                                 children_feedback, population_context)
        src = self.completion_fn(prompt)
        if "```python" in src:
            src = src.split("```python", 1)[1].split("```", 1)[0]
        return Policy(source=src, name=f"{parent.name}+llm")


_NUMERIC_STEPS = {
    "time_budget": (0.25, 60.0, 2.0),        # (min, max, multiplicative step)
    "shift_threshold": (0.02, 8.0, 1.6),
    "reconfig_penalty": (0.0, 8.0, 1.7),
    "migration_keep_threshold": (0.0, 4.0, 1.7),
    "min_interval": (1, 5, 2.0),
    # request domain.  admit_load_cap's floor is 1.0 (= outstanding ≤ slots,
    # the strictest sane throttle): bumping the 0.0 "unlimited" default
    # enters at the floor instead of a degenerate near-zero cap
    "admit_load_cap": (1.0, 8.0, 1.5),
    "slo_ttft_s": (0.1, 10.0, 1.6),
    # reconfig domain: how much decode progress a request needs before its
    # slot state is worth carrying instead of recomputing
    "migrate_min_progress": (0.0, 0.9, 1.6),
    # kv_cache domain: prefix-retention admission floor and pinning bar
    "kv_admit_min_pages": (1, 8, 2.0),
    "kv_pin_hits": (1, 16, 2.0),
    # recovery domain: retry effort, backoff shape, straggler sensitivity
    # and the degraded-capacity admission clamp.  straggler_factor's floor
    # is 1.5 (below that every engine looks like a straggler); bumping the
    # 0.0 "off" default enters at the floor like admit_load_cap does
    "retry_budget": (1, 8, 2.0),
    "backoff_base_s": (0.005, 1.0, 2.0),
    "backoff_cap_s": (0.1, 8.0, 2.0),
    "straggler_factor": (1.5, 8.0, 1.6),
    "degraded_admit_cap": (1.0, 8.0, 1.5),
}
_CATEGORICAL = {
    "scheduler": ["greedy", "bnb", "hybrid"],
    "batch_scheme": ["pow2", "sweet", "exhaustive"],
    "trigger_kind": ["always", "threshold", "periodic", "hybrid"],
    "tp_floor_large": [0, 2, 4],
    "replica_dp": [1, 2, 4],
    "replica_pp": [1, 2, 4],
    "stage_balance": ["even", "front-light", "rear-light"],
    "intra_node_only": [False, True],
    "heterogeneity_aware": [True, False],
    "weighted_obj": [False, True],
    "allow_split": [False, True],
    "priority_kind": ["fifo", "sjf", "slo-aware"],   # request domain
    "preempt": [False, True],
    "migration_mode": ["drain", "migrate", "recompute"],   # reconfig domain
    "kv_evict_kind": ["lru", "lfu", "pin-hot"],            # kv_cache domain
    "recovery_mode": ["salvage", "recompute", "shed"],     # recovery domain
    "fail_replan": [False, True],
}
# touching any of these implicitly turns its domain on — a mutation that
# sets priority_kind=sjf (or migration_mode=migrate) on a placement-only
# parent must actually change the rendered program, not silently no-op
_DOMAIN_KEYS = {
    "request": ("priority_kind", "admit_load_cap", "preempt", "slo_ttft_s"),
    "reconfig": ("migration_mode", "migrate_min_progress"),
    "kv_cache": ("kv_evict_kind", "kv_admit_min_pages", "kv_pin_hits"),
    "recovery": ("recovery_mode", "retry_budget", "backoff_base_s",
                 "backoff_cap_s", "straggler_factor", "fail_replan",
                 "degraded_admit_cap"),
}


def _bump(rng: random.Random, val: float, lo: float, hi: float,
          step: float, direction: int) -> float:
    f = step if direction > 0 else 1.0 / step
    new = val * f if val > 0 else (lo if direction < 0 else max(lo, 0.05))
    if isinstance(lo, int) and lo >= 1:
        new = round(new)
    return min(max(new, lo), hi)


@dataclass
class StructuredMutator(Mutator):
    """Feedback-directed genome rewriting — the offline stand-in for the LLM."""
    name: str = "structured"
    explore_prob: float = 0.35

    def mutate(self, parent, parent_feedback, children_feedback,
               population_context, rng) -> Policy:
        g = dict(DEFAULT_GENOME)
        g.update(parent.genome or {})
        fb = parent_feedback or {}
        directed = fb and rng.random() > self.explore_prob

        if directed:
            terms = {
                "stale": fb.get("sum_stale", 0.0),
                "reconfig": fb.get("sum_reconfig", 0.0),
                "serve": fb.get("sum_serve", 0.0),
            }
            total = max(fb.get("T_total", 1.0), 1e-9)
            dom = max(terms, key=terms.get)
            # Appendix-E guidance rendered as genome moves
            if dom == "reconfig" and terms["reconfig"] > 0.02 * total:
                move = rng.choice([
                    ("reconfig_penalty", +1), ("migration_keep_threshold", +1),
                    ("shift_threshold", +1), ("trigger_kind", "hybrid"),
                    # or stop paying for transitions at all: carry the live
                    # KV/SSM slots across the plan change
                    ("migration_mode", "migrate"),
                ])
            elif dom == "stale" and terms["stale"] > 0.02 * total:
                move = rng.choice([
                    ("time_budget", -1), ("scheduler", "greedy"),
                    ("batch_scheme", "pow2"), ("shift_threshold", +1),
                    ("allow_split", False),
                ])
            else:  # serve-dominated: buy plan quality / freshness.  Request
                   # knobs are deliberately absent here: the offline
                   # trace-replay evaluator cannot rank them (request_blend
                   # only acts on measured backend metrics), so directed
                   # exploitation would burn iterations on fitness-neutral
                   # moves — exploration and crossover still reach them
                move = rng.choice([
                    ("time_budget", +1), ("scheduler", rng.choice(["bnb", "hybrid"])),
                    ("batch_scheme", rng.choice(["sweet", "exhaustive"])),
                    ("shift_threshold", -1), ("allow_split", True),
                    ("weighted_obj", True), ("trigger_kind", "threshold"),
                    ("reconfig_penalty", -1), ("migration_keep_threshold", -1),
                ])
            key, d = move
            if key in _NUMERIC_STEPS:
                lo, hi, step = _NUMERIC_STEPS[key]
                g[key] = _bump(rng, float(g[key]), lo, hi, step, d)
            else:
                g[key] = d
            _enable_domain_for(g, key)
        else:
            # exploration: perturb 1–2 random knobs
            for _ in range(rng.randint(1, 2)):
                key = rng.choice(list(_NUMERIC_STEPS) + list(_CATEGORICAL))
                if key in _NUMERIC_STEPS:
                    lo, hi, step = _NUMERIC_STEPS[key]
                    g[key] = _bump(rng, float(g[key]), lo, hi, step,
                                   rng.choice([-1, 1]))
                else:
                    g[key] = rng.choice(_CATEGORICAL[key])
                _enable_domain_for(g, key)

        # occasional crossover with a population elite
        elites = population_context.get("elite_genomes", [])
        if elites and rng.random() < 0.25:
            other = rng.choice(elites)
            for key in rng.sample(list(other), k=max(1, len(other) // 3)):
                # never copy "domains" wholesale: inheriting a placement-only
                # list would silently strip the child's request/reconfig
                # domains while their knobs remain in the genome, inert
                if key in DEFAULT_GENOME and key != "domains":
                    g[key] = other[key]
                    dom = _domain_of_key(key)
                    if dom and dom in other.get("domains", ()):
                        # inheriting a domain knob from an elite implementing
                        # that domain must carry the domain, or it is inert
                        _enable_domain_for(g, key)

        return render_policy(g, name=f"{parent.name}*")


def _domain_of_key(key: str) -> Optional[str]:
    return next((d for d, ks in _DOMAIN_KEYS.items() if key in ks), None)


def _enable_domain_for(g: Dict[str, Any], key: str) -> None:
    dom = _domain_of_key(key)
    if dom is None:
        return
    domains = list(g.get("domains", ["placement"]))
    if dom not in domains:
        domains.append(dom)
    g["domains"] = domains

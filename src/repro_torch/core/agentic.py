"""Agentic request scheduling (§8.3, App. C.2): round-based replay with
online call revelation over a disaggregated prefill/decode pool (port of
``src/repro/core/agentic.py``).

The execution model calibration (§8.3) removes the reconfiguration term:
T_total = Σ_i [SCHED-COST(σ_i) + SERVE-COST(σ_i)]   (Eq. 15)

Policies are (order, assign) heuristics over ready calls; the same genome /
mutation machinery evolves them (Insight 4: the workflow adapts across
serving scenarios by re-calibrating the execution model).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.schedulers import AgenticInstance, agentic_bnb
from repro_torch.traces.workload import AgenticTrace

AGENTIC_DEFAULT_GENOME = {
    "order": "fifo",          # fifo | sjf | longest | slack
    "assign": "rr",           # rr | least_loaded | earliest_finish
    "use_bnb": False,         # exact per-round assignment (MILP-like)
    "bnb_deadline": 1.0,
}


@dataclass
class AgenticPolicy:
    genome: Dict
    name: str = "agentic"

    def order_calls(self, calls: List) -> List:
        kind = self.genome["order"]
        if kind == "sjf":
            return sorted(calls, key=lambda c: c.prefill_len + c.decode_len)
        if kind == "longest":
            return sorted(calls, key=lambda c: -(c.prefill_len + c.decode_len))
        if kind == "slack":
            return sorted(calls, key=lambda c: (c.call_idx, c.prefill_len))
        return list(calls)

    def assign(self, calls: List, pis: List[AgenticInstance],
               dis: List[AgenticInstance]) -> List[Tuple]:
        """Returns [(call, p_idx, d_idx)] in queue order."""
        if self.genome["use_bnb"]:
            a = agentic_bnb(calls, pis, dis,
                            deadline_s=self.genome["bnb_deadline"])
            key = {(c.workflow, c.call_idx): c for c in calls}
            p_idx = {p.name: i for i, p in enumerate(pis)}
            d_idx = {d.name: i for i, d in enumerate(dis)}
            return [(key[x.call_key], p_idx[x.prefill_inst], d_idx[x.decode_inst])
                    for x in sorted(a, key=lambda x: x.priority)]
        ordered = self.order_calls(calls)
        out = []
        p_load = [p.free_at for p in pis]
        d_load = [d.free_at for d in dis]
        for i, c in enumerate(ordered):
            mode = self.genome["assign"]
            if mode == "least_loaded":
                p = min(range(len(pis)), key=lambda j: p_load[j])
                d = min(range(len(dis)), key=lambda j: d_load[j])
            elif mode == "earliest_finish":
                p = min(range(len(pis)),
                        key=lambda j: p_load[j] + c.prefill_len / pis[j].speed_tok_s)
                d = min(range(len(dis)),
                        key=lambda j: max(p_load[p], d_load[j])
                        + c.decode_len / dis[j].speed_tok_s)
            else:  # rr
                p, d = i % len(pis), i % len(dis)
            p_load[p] += c.prefill_len / pis[p].speed_tok_s
            d_load[d] += c.decode_len / dis[d].speed_tok_s
            out.append((c, p, d))
        return out


def make_pool(n_prefill: int = 4, n_decode: int = 4,
              prefill_speed: float = 8000.0, decode_speed: float = 900.0
              ) -> Tuple[List[AgenticInstance], List[AgenticInstance]]:
    pis = [AgenticInstance(f"p{i}", "prefill", prefill_speed * (1 - 0.1 * (i % 2)))
           for i in range(n_prefill)]
    dis = [AgenticInstance(f"d{i}", "decode", decode_speed * (1 - 0.15 * (i % 2)))
           for i in range(n_decode)]
    return pis, dis


@dataclass
class AgenticEvalResult:
    fitness: float
    sum_sched: float
    sum_serve: float
    rounds: int

    @property
    def valid(self) -> bool:
        return self.fitness < float("inf")

    def artifact_feedback(self) -> Dict:
        return {"N": self.rounds, "sum_sched": round(self.sum_sched, 3),
                "sum_stale": 0.0, "sum_reconfig": 0.0,
                "sum_serve": round(self.sum_serve, 3),
                "T_total": round(self.fitness, 3)}


def replay(policy: AgenticPolicy, trace: AgenticTrace,
           pool: Optional[Tuple] = None) -> AgenticEvalResult:
    """Round-based replay: each round schedules the currently-ready call of
    every workflow (online revelation), serves to completion, reveals next."""
    pis, dis = pool or make_pool()
    progress = [0] * len(trace.workflows)            # next call index per wf
    t_sched = t_serve = 0.0
    rounds = 0
    while True:
        ready = [wf[progress[i]] for i, wf in enumerate(trace.workflows)
                 if progress[i] < len(wf)]
        if not ready:
            break
        t0 = time.monotonic()
        assignment = policy.assign(ready, pis, dis)
        t_sched += time.monotonic() - t0
        # simulate this round's queueing
        p_free = [0.0] * len(pis)
        d_free = [0.0] * len(dis)
        mk = 0.0
        for c, p, d in assignment:
            tp = p_free[p] + c.prefill_len / pis[p].speed_tok_s
            p_free[p] = tp
            td = max(tp, d_free[d]) + c.decode_len / dis[d].speed_tok_s
            d_free[d] = td
            mk = max(mk, td)
        t_serve += mk
        for i, wf in enumerate(trace.workflows):
            if progress[i] < len(wf):
                progress[i] += 1
        rounds += 1
    return AgenticEvalResult(t_sched + t_serve, t_sched, t_serve, rounds)


# --------------------------------------------------------------------------- #
# evolution over agentic genomes (same structured-mutation semantics)
# --------------------------------------------------------------------------- #
def evolve_agentic(trace: AgenticTrace, iters: int = 40, seed: int = 0,
                   pool=None) -> Tuple[AgenticPolicy, AgenticEvalResult, List]:
    rng = random.Random(seed)
    cats = {"order": ["fifo", "sjf", "longest", "slack"],
            "assign": ["rr", "least_loaded", "earliest_finish"],
            "use_bnb": [False, True]}
    seeds = [AgenticPolicy(dict(AGENTIC_DEFAULT_GENOME), "fifo-rr"),
             AgenticPolicy(dict(AGENTIC_DEFAULT_GENOME, use_bnb=True,
                                bnb_deadline=1.5), "milp"),
             AgenticPolicy(dict(AGENTIC_DEFAULT_GENOME, order="sjf",
                                assign="earliest_finish"), "sjf-ef")]
    pop = [(p, replay(p, trace, pool)) for p in seeds]
    history = []
    for it in range(iters):
        parent = min(rng.sample(pop, min(3, len(pop))), key=lambda x: x[1].fitness)
        g = dict(parent[0].genome)
        fb = parent[1]
        if fb.sum_sched > 0.3 * fb.fitness and rng.random() < 0.7:
            g["use_bnb"] = False              # sched-dominated → cheapen
        else:
            k = rng.choice(list(cats) + ["bnb_deadline"])
            if k == "bnb_deadline":
                g[k] = max(0.1, g[k] * rng.choice([0.5, 2.0]))
            else:
                g[k] = rng.choice(cats[k])
        child = AgenticPolicy(g, f"g{it}")
        pop.append((child, replay(child, trace, pool)))
        pop = sorted(pop, key=lambda x: x[1].fitness)[:8]
        history.append(pop[0][1].fitness)
    best = pop[0]
    return best[0], best[1], history

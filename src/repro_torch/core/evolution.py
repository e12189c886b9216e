"""Evolutionary synthesis workflow (§5.2, §5.4, §6.1) (port of ``src/repro/core/evolution.py``).

MAP-Elites-inspired program database (cells keyed by behaviour descriptors:
rescheduling count N × scheduling-cost share) combined with island-based
population management; warm-start re-evolution seeds the next cycle with the
previous cycle's elites + their mutations.  Candidate evaluation is
independent across the population → optional thread-pool parallelism.

Since the evaluation ladder, ``run`` is a two-stage funnel: the cheap
analytic rung screens the whole population, then the expensive shadow rung
(when installed) re-ranks only the top-K finalists — plus any candidates the
analytic rung could not score at all (request-only programs).  Shadow-scored
candidates land in MAP-Elites cells extended by a tail-latency descriptor
and compete for ``shadow_best``, which the control plane trusts over the
screen-only best.
"""
from __future__ import annotations

import math
import random
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.evaluator import (EvalResult, Evaluator, NO_PLACEMENT_ERROR)
from repro_torch.core.mutation import Mutator, StructuredMutator
from repro_torch.core.policy import Policy, seed_policies
from repro_torch.core.timeouts import EvolutionClock, EvolutionTimeout
from repro_torch.traces.workload import Trace


@dataclass
class Candidate:
    policy: Policy
    result: EvalResult
    island: int
    iteration: int

    @property
    def fitness(self) -> float:
        return self.result.fitness


def _descriptor(res: EvalResult, trace_len: int) -> Tuple[int, ...]:
    """MAP-Elites cell: (N bucket, scheduling-share bucket) — extended by a
    shadow-derived tail-latency bucket for shadow-scored candidates, so the
    archive keeps behaviourally distinct tail profiles alive instead of
    collapsing them onto the plan-level axes."""
    n_b = min(res.N, trace_len)
    share = res.sum_sched / max(res.fitness, 1e-9)
    s_b = min(int(share * 20), 9)
    if res.backend == "analytic":
        return (n_b, s_b)
    tail = max(res.ttft_p95_s, 1e-4)
    t_b = min(max(int(math.log10(tail) + 4), 0), 8)   # 0.1ms → 0 … ≥10ks → 8
    return (n_b, s_b, t_b)


@dataclass
class EvolutionConfig:
    max_iterations: int = 100
    population_size: int = 50
    n_islands: int = 3
    elite_ratio: float = 0.2
    migrate_every: int = 12
    patience: int = 40                     # stop if no improvement
    evolution_timeout_s: float = 600.0     # evolution-level timeout (§6.1)
    parallel_eval: int = 1                 # §7.3: candidate eval parallelism
    seed: int = 0
    # --- evaluation-ladder funnel (active when a shadow rung is installed) ---
    shadow_top_k: int = 4                  # analytic finalists replayed in shadow
    shadow_budget: int = 8                 # max shadow evals per cycle (incl.
                                           # analytically unrankable candidates)


@dataclass
class EvolutionState:
    """Program database: islands of MAP-Elites cells."""
    cells: List[Dict[Tuple[int, ...], Candidate]] = field(default_factory=list)
    best: Optional[Candidate] = None
    history: List[Tuple[int, float]] = field(default_factory=list)  # (iter, best)
    iterations_run: int = 0
    # evaluation-ladder outcome: shadow-ranked finalists (best first) and the
    # shadow winner.  ``best`` stays the analytic-screen champion — the two
    # rungs score on different terms, so they are never compared directly.
    finalists: List[Candidate] = field(default_factory=list)
    shadow_best: Optional[Candidate] = None
    shadow_evals: int = 0

    def elites(self, island: Optional[int] = None, k: int = 10,
               backend: Optional[str] = None) -> List[Candidate]:
        """Best archived candidates.  ``backend`` restricts the ranking to
        one evaluation rung — analytic and shadow fitness carry different
        terms, so sorting them on one axis is only meaningful per rung."""
        pools = self.cells if island is None else [self.cells[island]]
        cands = [c for pool in pools for c in pool.values()
                 if c.result.valid
                 and (backend is None or c.result.backend == backend)]
        return sorted(cands, key=lambda c: c.fitness)[:k]

    def insert(self, cand: Candidate, trace_len: int,
               update_best: bool = True) -> bool:
        """Insert into its island cell if better; update global best."""
        if not cand.result.valid:
            return False
        cell = _descriptor(cand.result, trace_len)
        pool = self.cells[cand.island]
        prev = pool.get(cell)
        improved_cell = prev is None or cand.fitness < prev.fitness
        if improved_cell:
            pool[cell] = cand
        if update_best and (self.best is None
                            or cand.fitness < self.best.fitness):
            self.best = cand
        return improved_cell


class Evolution:
    """One evolution cycle e_i over a snapshotted trace.

    ``shadow`` is the optional second rung of the evaluation ladder (any
    :class:`~repro_torch.core.evaluator.EvalBackend`); when installed, ``run``
    finishes with a shadow-replay pass over the analytic finalists.
    """

    def __init__(self, evaluator: Evaluator, cfg: EvolutionConfig,
                 mutator: Optional[Mutator] = None, shadow=None):
        self.evaluator = evaluator
        self.cfg = cfg
        self.mutator = mutator or StructuredMutator()
        self.shadow = shadow

    # ------------------------------------------------------------------ #
    def _evaluate(self, policies: List[Policy], trace: Trace,
                  backend=None) -> List[EvalResult]:
        backend = backend if backend is not None else self.evaluator
        if self.cfg.parallel_eval > 1:
            with ThreadPoolExecutor(self.cfg.parallel_eval) as ex:
                return list(ex.map(lambda p: backend.evaluate(p, trace),
                                   policies))
        return [backend.evaluate(p, trace) for p in policies]

    def _population_context(self, state: EvolutionState) -> Dict:
        elites = state.elites(k=6)
        return {
            "best_fitness": state.best.fitness if state.best else None,
            "elite_genomes": [c.policy.genome for c in elites
                              if c.policy.genome],
            "explored": len([c for pool in state.cells for c in pool.values()]),
        }

    # ------------------------------------------------------------------ #
    def run(self, trace: Trace,
            warm_start: Optional[EvolutionState] = None,
            extra_seeds: Optional[List[Policy]] = None) -> EvolutionState:
        cfg = self.cfg
        rng = random.Random(cfg.seed)
        clock = EvolutionClock(cfg.evolution_timeout_s)
        state = EvolutionState(cells=[{} for _ in range(cfg.n_islands)])

        # --- seeding: warm-start elites + their mutations (§6.1), with the
        # stock seed policies kept as insurance against regime shifts where
        # the prior population offers no reusable structure ---
        seeds: List[Policy] = list((extra_seeds or []))
        if warm_start is not None and warm_start.best is not None:
            # analytic-only ranking: the prior cycle's shadow-scored archive
            # entries carry a different fitness scale, and the feedback dict
            # handed to the mutator must match the axis the screen ranks on
            top = warm_start.elites(k=max(3, cfg.population_size // 10),
                                    backend="analytic")
            seeds += [c.policy for c in top]
            for c in top:
                seeds.append(self.mutator.mutate(
                    c.policy, c.result.artifact_feedback(), [], {}, rng))
        seeds += list(seed_policies().values())

        results = self._evaluate(seeds, trace)
        # candidates this rung cannot rank (request-only programs) go to the
        # shadow finalists directly instead of being discarded
        screen_rejected: List[Policy] = []
        for i, (p, r) in enumerate(zip(seeds, results)):
            if (r.error == NO_PLACEMENT_ERROR
                    and all(q.source != p.source for q in screen_rejected)):
                screen_rejected.append(p)
            state.insert(Candidate(p, r, island=i % cfg.n_islands, iteration=0),
                         len(trace))
        if state.best is not None:
            state.history.append((0, state.best.fitness))

        # --- iterations ---
        no_improve = 0
        feedback_children: Dict[str, List[Dict]] = {}
        for it in range(1, cfg.max_iterations + 1):
            try:
                clock.check()
            except EvolutionTimeout:
                break
            island = it % cfg.n_islands
            elites = state.elites(island=island,
                                  k=max(2, int(cfg.population_size
                                               * cfg.elite_ratio)))
            if not elites:
                elites = state.elites(k=4)
            if not elites:
                break
            parent = rng.choice(elites)
            child_fb = feedback_children.get(parent.policy.name, [])
            child_pol = self.mutator.mutate(
                parent.policy, parent.result.artifact_feedback(),
                child_fb[-4:], self._population_context(state), rng)
            child_pol.name = f"i{island}-g{it}"
            res = self._evaluate([child_pol], trace)[0]
            feedback_children.setdefault(parent.policy.name, []).append(
                res.artifact_feedback())
            prev_best = state.best.fitness if state.best else float("inf")
            state.insert(Candidate(child_pol, res, island=island, iteration=it),
                         len(trace))
            state.iterations_run = it
            new_best = state.best.fitness if state.best else float("inf")
            state.history.append((it, new_best))
            no_improve = 0 if new_best < prev_best - 1e-9 else no_improve + 1
            if no_improve >= cfg.patience:
                break
            # island migration: copy global best into a random island
            if it % cfg.migrate_every == 0 and state.best is not None:
                tgt = rng.randrange(cfg.n_islands)
                state.insert(Candidate(state.best.policy, state.best.result,
                                       island=tgt, iteration=it), len(trace))

        # --- stage 2: shadow replay over the funnel's finalists ----------- #
        if self.shadow is not None and cfg.shadow_top_k > 0:
            self._shadow_stage(state, trace, screen_rejected, clock)
        return state

    # ------------------------------------------------------------------ #
    def _shadow_stage(self, state: EvolutionState, trace: Trace,
                      screen_rejected: List[Policy],
                      clock: EvolutionClock) -> None:
        """Second rung: replay the analytic top-K (plus any analytically
        unrankable candidates) through the shadow backend.  Shadow-scored
        candidates enter the archive under the tail-extended descriptor but
        never displace the analytic ``best`` — the control plane compares
        ``shadow_best`` against a shadow-scored incumbent instead."""
        cfg = self.cfg
        finalists = [c.policy for c in state.elites(k=cfg.shadow_top_k,
                                                    backend="analytic")]
        pool: List[Policy] = []
        for p in finalists:
            if all(q.source != p.source for q in pool):
                pool.append(p)
        # the budget caps the analytic finalists; analytically unrankable
        # candidates are always replayed — shadow is their ONLY path to a
        # fitness, so truncating them first would silently disable the
        # ladder's headline feature
        pool = pool[:max(cfg.shadow_budget, 1)]
        for p in screen_rejected:
            if all(q.source != p.source for q in pool):
                pool.append(p)
        if not pool:
            return
        # the cycle timeout covers the whole funnel, not just the analytic
        # loop: stop replaying once the budget is spent (candidates already
        # scored still count)
        results = []
        for p in pool:
            try:
                clock.check()
            except EvolutionTimeout:
                break
            results.append(self._evaluate([p], trace,
                                          backend=self.shadow)[0])
        state.shadow_evals = len(results)
        shadow_cands = [
            Candidate(p, r, island=i % cfg.n_islands,
                      iteration=state.iterations_run + 1)
            for i, (p, r) in enumerate(zip(pool, results))]
        for c in shadow_cands:
            state.insert(c, len(trace), update_best=False)
        state.finalists = sorted((c for c in shadow_cands if c.result.valid),
                                 key=lambda c: c.fitness)
        state.shadow_best = state.finalists[0] if state.finalists else None

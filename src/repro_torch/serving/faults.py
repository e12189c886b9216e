"""Deterministic fault injection for the serving data plane (port of ``src/repro/serving/faults.py``).

The :class:`FaultInjector` replays a seeded schedule of
:class:`~repro_torch.traces.workload.FailureEvent` s against a live
:class:`~repro_torch.serving.pool.EnginePool`:

  * ``kill``     — abrupt replica death via ``pool.fail``; with
                   ``deny_export`` the crash also corrupts slot exports
                   (no salvage possible, only recompute/shed);
  * ``straggle`` — degrade a replica into a straggler by scaling its
                   *recorded* per-step latency (``engine.fault_slowdown``) —
                   no real sleeps, so tests and shadow replay stay fast
                   while the pool's EMA-based detector sees the slowdown;
  * ``restore``  — lift a straggler back to full speed.

Determinism is the contract: the schedule is a pure function of the seed
(:func:`~repro_torch.traces.workload.failure_schedule`), and ``step`` applies
events keyed on a caller-supplied step/interval index — the same seed
against the same request sequence replays the same faults, which is what
lets :class:`~repro_torch.serving.shadow.ShadowReplayEval` evaluate candidate
recovery policies against exactly the faults they will face live.

A kill that would take the LAST replica serving its model is skipped (and
counted): the injector models partial failures the pool can react to, not
total outages with no survivors to react with.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.traces.workload import FailureEvent, failure_schedule

__all__ = ["FaultInjector", "FailureEvent", "failure_schedule"]


@dataclass
class FaultInjector:
    """Replays a failure schedule against an EnginePool, one step at a time.

    ``step(pool, step_idx)`` applies every not-yet-applied event whose
    ``event.step <= step_idx`` (a cursor over the step-sorted schedule, so
    skipped indices — e.g. intervals with no serve call — cannot silently
    drop events).  Engines are addressed by ``engine_idx`` modulo the pool's
    current replica list, so one schedule remains applicable as plans
    resize the pool.
    """
    schedule: Tuple[FailureEvent, ...]
    cursor: int = 0
    kills: int = 0
    straggles: int = 0
    restores: int = 0
    denied: int = 0                  # kills that also denied slot export
    skipped: int = 0                 # kills skipped to keep a survivor
    _dead: set = field(default_factory=set)    # id(engine) already killed

    @classmethod
    def from_seed(cls, seed: int, **kw) -> "FaultInjector":
        return cls(schedule=failure_schedule(seed, **kw))

    @property
    def exhausted(self) -> bool:
        return self.cursor >= len(self.schedule)

    def step(self, pool, step_idx: int) -> int:
        """Apply all due events; returns how many were applied."""
        applied = 0
        while (self.cursor < len(self.schedule)
               and self.schedule[self.cursor].step <= step_idx):
            self._apply(pool, self.schedule[self.cursor])
            self.cursor += 1
            applied += 1
        return applied

    def _apply(self, pool, ev: FailureEvent) -> None:
        engines = pool.engines
        if not engines:
            self.skipped += 1
            return
        eng = engines[ev.engine_idx % len(engines)]
        if ev.kind == "kill":
            group = pool.group_of(eng)
            peers = [e for e in pool.engines_for(group.model) if e is not eng]
            if not peers:
                # never kill the last replica of a model: the recovery path
                # needs a survivor to salvage/requeue onto
                self.skipped += 1
                return
            self._dead.add(id(eng))
            self.kills += 1
            if ev.deny_export:
                self.denied += 1
            pool.fail(eng, deny_export=ev.deny_export, reason="injected-kill")
        elif ev.kind == "straggle":
            eng.fault_slowdown = max(float(ev.magnitude), 1.0)
            self.straggles += 1
        elif ev.kind == "restore":
            eng.fault_slowdown = 1.0
            self.restores += 1

    def export_denied(self, eng) -> bool:
        """True when ``eng`` was killed with export denial (corrupt state)."""
        return id(eng) in self._dead

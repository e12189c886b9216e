"""Multi-level timeout hierarchy (§6.1) (port of ``src/repro/core/timeouts.py``).

* candidate-level: bounds one candidate's schedule() call — degenerate
  LLM-generated candidates are discarded without stalling evolution.
* evolution-level: bounds a whole evolution cycle — the control plane
  delivers an updated policy within predictable latency.

Candidate calls run in a daemon worker thread joined with a deadline; a
timed-out thread is abandoned (cooperative deadlines inside our scheduler
building blocks make runaway threads rare; true isolation would use a
subprocess pool — documented trade-off for the offline build).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple


class CandidateTimeout(Exception):
    pass


class EvolutionTimeout(Exception):
    pass


def run_with_deadline(fn: Callable[[], Any], deadline_s: float
                      ) -> Tuple[Any, float]:
    """Run fn in a worker thread; raise CandidateTimeout past the deadline.

    Returns (result, wall_clock_seconds)."""
    box: dict = {}

    def work():
        t0 = time.monotonic()
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001
            box["error"] = e
        box["dt"] = time.monotonic() - t0

    th = threading.Thread(target=work, daemon=True)
    t0 = time.monotonic()
    th.start()
    th.join(deadline_s)
    if th.is_alive():
        raise CandidateTimeout(f"candidate exceeded {deadline_s:.1f}s")
    if "error" in box:
        raise box["error"]
    return box.get("result"), box.get("dt", time.monotonic() - t0)


@dataclass
class EvolutionClock:
    """Evolution-level budget; check() raises once exhausted."""
    budget_s: float
    t0: float = 0.0

    def __post_init__(self):
        self.t0 = time.monotonic()

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    @property
    def remaining(self) -> float:
        return self.budget_s - self.elapsed

    def check(self) -> None:
        if self.remaining <= 0:
            raise EvolutionTimeout(f"evolution budget {self.budget_s:.0f}s exhausted")

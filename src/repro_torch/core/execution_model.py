"""Measured interval feedback (port of ``src/repro/core/execution_model.py``).

Only :class:`IntervalMetrics` is ported: it is what the backend hands the
data plane after each served interval.  The interval accounting itself
stays with the control plane.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class IntervalMetrics:
    """Measured serving-interval feedback from a real backend.  ``measured``
    is False for simulator-backed intervals."""
    requests: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    ttft_s: float = 0.0              # mean time-to-first-token
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    tpot_s: float = 0.0              # pooled time-per-output-token
    tokens_per_s: float = 0.0
    reconfig_s: float = 0.0          # measured engine-rebuild wall-clock
    simulated_serve_s: float = 0.0
    backlogged: int = 0              # requests no replica could take
    shed: int = 0                    # requests dropped
    measured: bool = True

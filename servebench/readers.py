"""Shared arithmetic of the metric readers.  Each reader file
``<metric>.py`` defines ``read(run) -> float | None`` over a
``harness.Run``; None means it found nothing to read, and the metric is left
out of the run's line."""
from __future__ import annotations

from typing import List, Optional

import devtrace
import traffic
import work


def percentile(values: List[float], q: float) -> Optional[float]:
    return traffic.percentile(values, q) if values else None


def top_mean(values: List[float], share: float) -> Optional[float]:
    """Mean of the largest ``share`` of the values (at least one)."""
    if not values:
        return None
    top = sorted(values)[len(values) - max(int(len(values) * share), 1):]
    return sum(top) / len(top)


def ttft_ms(run) -> List[float]:
    """Every request due in the window: its first token's host time (the
    window's close where it has none) minus its due time, in ms."""
    return [((r.times[0] if r.times else run.t_close) - r.due) * 1e3
            for r in run.reqs.values()]


def gaps_ms(run) -> List[float]:
    """Every gap between consecutive output tokens of a request, in ms."""
    return [(b - a) * 1e3 for r in run.reqs.values() for a, b in zip(r.times, r.times[1:])]


def step_ms(run, admitting: bool) -> Optional[float]:
    """Host wall of the window's steps that admitted (per request admitted)
    or that admitted none (per step), in ms."""
    if admitting:
        steps = [s for s in run.steps if s.admitted]
        n = sum(len(s.admitted) for s in steps)
    else:
        steps = [s for s in run.steps if not s.admitted]
        n = len(steps)
    return sum(s.t1 - s.t0 for s in steps) / n * 1e3 if n else None


def step_flops(run, s) -> float:
    """Useful model FLOPs of one step: its uncached prompt tokens (and the
    head once for each prompt's first token) and its decoding lanes."""
    dims, layer = run.dims, run.layer
    f = sum(work.prefill_flops(layer, dims, start, end) for _, start, end in s.prefill)
    return f + sum(work.token_flops(layer, dims, ctx) + work.head_flops(dims)
                   for ctx in s.decode_ctx)


def mfu(run, steps, seconds: float) -> Optional[float]:
    """Those steps' useful FLOPs over ``seconds`` at the bf16 peak, in %."""
    if not steps or seconds <= 0:
        return None
    flops = sum(step_flops(run, s) for s in steps)
    return flops / (seconds * work.PEAKS["bf16_flops_per_s"]) * 100.0


def roofline(run, bound_s, *kernels: str) -> Optional[float]:
    """Sum of the traced steps' least times (``bound_s(step)``) over the
    device time of the kernels whose names hold any of ``kernels``, in %."""
    if not run.events:
        return None
    t = devtrace.seconds_matching(run.events, *kernels)
    bound = sum(bound_s(s) for s in run.traced_steps())
    return bound / t * 100.0 if t > 0 and bound > 0 else None


def device_idle(run) -> Optional[float]:
    """Share of the traced slice's engine-busy host time with no device
    operation running, in %."""
    busy = run.traced_busy_s()
    if not run.events or busy <= 0:
        return None
    return (1.0 - devtrace.busy_s(run.events) / busy) * 100.0

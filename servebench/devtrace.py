"""Device trace of a run's traced slice: the profiler's raw device events,
their busy union, time by kernel name, and the longest idle gaps.  After
``device_events`` and ``busy_by_group`` of the program's chip smoke run
(the profiler's raw results, not ``prof.events()``, which builds a tree of
every host op first)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Event = Tuple[float, float, str]          # start s, end s, name (device clock)


def start():
    """A profiler recording device activity only (CUPTI), entered."""
    import torch
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof) -> List[Event]:
    """Leave the profiler and return its device events, sorted; the
    ``record_function`` ranges on the device timeline are not device work."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    return sorted((e.start_ns() / 1e9, e.end_ns() / 1e9, e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation())


def busy_intervals(events: Sequence[Event]) -> List[Tuple[float, float]]:
    """The union of the events' intervals, in order."""
    out: List[Tuple[float, float]] = []
    for s, e, _ in events:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_s(events: Sequence[Event]) -> float:
    return sum(e - s for s, e in busy_intervals(events))


def seconds_by_name(events: Sequence[Event]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s, e, name in events:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def seconds_matching(events: Sequence[Event], *parts: str) -> float:
    """Device seconds of the events whose name holds any of ``parts``."""
    return sum(e - s for s, e, name in events
               if any(p in name for p in parts))


def idle_gaps(events: Sequence[Event]) -> List[Tuple[float, float]]:
    """(start, end) of every gap between busy intervals, device clock."""
    iv = busy_intervals(events)
    return [(a[1], b[0]) for a, b in zip(iv, iv[1:]) if b[0] > a[1]]

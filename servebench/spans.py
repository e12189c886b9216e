"""Spans the program records inside its engine (``repro_torch.telemetry``),
put on the device trace's clock, and the arithmetic their metrics read.

A run's record is ``run.spans`` (the program's ``Span`` s, host monotonic
seconds) and ``run.span_clock``: (host, trace) seconds of each marked
stamp (an ``anchor`` or a ``dispatch.launch``) whose device marker's launch
the device trace holds, which put the trace on the spans' clock.  On the
card the trace's clock moved against the host's by milliseconds within a
slice, so one offset a slice is not enough.  The harness does not turn the
recorder on; :func:`recording` does, around the harness's own window, in
the runs this file makes:

    python3 servebench/spans.py --workload <cell> --seed <n> --seconds <s> [--spans 0|1]

runs the cell as ``run.py --trace 1`` does and prints that JSON line with
the span metrics that ``spans.json`` lists for the cell (read by
``metrics/<name>.py``) and, under ``"spans"``, the clocks' drift, the
device idle time by innermost span, the self time by span name, the
counters, and the checks of the spans against the host clock's metrics.
``--spans 0`` makes the same run with the recorder off, for its cost.
"""
from __future__ import annotations

import bisect
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import devtrace

HERE = Path(__file__).resolve().parent
MARKER = "spin_kernel"              # the markers' device kernel (torch.cuda._sleep)
COPIES = ("Memcpy", "Memset")       # device events that are not kernels
OUTSIDE = "outside the engine"
MARKED = ("dispatch.launch",)       # spans that carry a device marker in recorded runs
STAMPED = ("anchor",) + MARKED
SEED = 6                            # marks whose codes and spacing seed the clock's offset
TOL_S = 0.2e-3                      # a mark's offset may move this much from the last,
RATE = 3e-3                         # and this share of the time since it more
PRIOR_S = 0.01                      # a seed this near the wall clock's offset is preferred
CODES = 3                           # repro_torch.telemetry.MARKER_CODES (no import:
                                    # the readers load on a program without it)
GROUP_S = 1e-4                      # a marker's kernels are launched closer than this
SETTLE_S = 0.02                     # between the profiler's start or stop and an anchor


def record(run) -> Optional[list]:
    """The run's spans, or None where the program recorded none."""
    return getattr(run, "spans", None) or None


def nearest(xs: List[float], x: float) -> int:
    """Index of the value of the sorted, non-empty ``xs`` nearest ``x``."""
    k = bisect.bisect_left(xs, x)
    if k == 0 or k == len(xs):
        return min(k, len(xs) - 1)
    return k if xs[k] - x < x - xs[k - 1] else k - 1


def tol(gap: float) -> float:
    """How far a mark's offset may have moved from one ``gap`` s before."""
    return TOL_S + RATE * gap


def seed(stamps: List[float], marks: List[float], codes: List[int],
         prior: Optional[float], after: int = -1) -> Optional[float]:
    """The offset (trace clock − host clock) under which ``marks`` fall on
    stamps past index ``after``, of their codes, whose spacing theirs
    repeats best (each consecutive gap within :func:`tol` of theirs, ties
    to the earliest), within PRIOR_S of ``prior`` where that is given; or
    None."""
    best, best_err = None, 1.0
    for s0 in range(after + 1, len(stamps)):
        off = marks[0] - stamps[s0]
        if s0 % CODES != codes[0] or (prior is not None and abs(off - prior) > PRIOR_S):
            continue
        idx = [nearest(stamps, m - off) for m in marks]
        if len(set(idx)) < len(idx) or any(i % CODES != c for i, c in zip(idx, codes)):
            continue
        err = max((abs((m1 - m0) - (stamps[i1] - stamps[i0])) / tol(m1 - m0) for m0, m1, i0, i1
                   in zip(marks, marks[1:], idx, idx[1:])), default=0.0)
        if err < best_err:
            best, best_err = off, err
    return best


def clock_pairs(run) -> List[Tuple[float, float]]:
    """(host, trace) seconds of each marked stamp whose marker's launch the
    device trace holds.  Both lists are in order, but the trace may lack
    markers (near the profiler's start and stop) and its clock may move
    against the host's by milliseconds within a slice.  So a mark takes the
    stamp its predecessor's offset predicts (within :func:`tol`, and of its code:
    the k-th marked stamp since the record began has code k mod CODES); the
    first mark, and one that misses, seeds the offset again from the codes
    and spacing of the next SEED marks, near the wall clock's offset from
    the host's (``run.span_wall``) if any seed is."""
    stamps = sorted(s.t0 for s in record(run) or () if s.name in STAMPED)
    got = sorted(getattr(run, "span_marks", None) or ())
    if not stamps or not got:
        return []
    marks, codes = [m for m, _ in got], [c for _, c in got]
    prior = getattr(run, "span_wall", None)
    pairs: List[Tuple[float, float]] = []
    off, j, last = None, 0, -1
    while j < len(marks):
        fresh = off is None
        if fresh:
            window = (stamps, marks[j:j + SEED], codes[j:j + SEED])
            off = seed(*window, prior, last)
            if off is None and prior is not None:
                off = seed(*window, None, last)
        if off is not None:
            i = nearest(stamps, marks[j] - off)
            gap = marks[j] - marks[j - 1] if j else 0.0
            if (i > last and i % CODES == codes[j]
                    and abs(stamps[i] - (marks[j] - off)) <= tol(gap)):
                pairs.append((stamps[i], marks[j]))
                off, j, last = marks[j] - stamps[i], j + 1, i
                continue
            off = None
        if fresh:
            j += 1
    return pairs


def to_host(run) -> Optional[Callable[[float], float]]:
    """Trace (device) seconds to host seconds: the offset of the latest
    clock pair at or before the time (the first pair's before it)."""
    pairs = getattr(run, "span_clock", None)
    if not pairs:
        return None
    xs = [x for _, x in pairs]

    def host(x: float) -> float:
        h, m = pairs[max(bisect.bisect_right(xs, x) - 1, 0)]
        return h + (x - m)
    return host


def marker_launches(prof) -> List[Tuple[float, int]]:
    """(host start of its first launch record, seconds on the device
    trace's clock; its code) of each marker in the trace: the launches of
    marker kernels (paired with their device records by correlation id)
    that follow each other within GROUP_S make one marker, of code their
    number less one."""
    from torch.autograd import DeviceType
    evs = list(prof.profiler.kineto_results.events())
    spins = {e.correlation_id() for e in evs
             if e.device_type() == DeviceType.CUDA and MARKER in e.name()} - {0}
    first: Dict[int, float] = {}
    for e in evs:
        c = e.correlation_id()
        if c in spins and e.device_type() != DeviceType.CUDA:
            t = e.start_ns() / 1e9
            first[c] = min(t, first.get(c, t))
    out: List[List] = []
    for t in sorted(first.values()):
        if out and t - out[-1][2] <= GROUP_S:
            out[-1][1] += 1
            out[-1][2] = t
        else:
            out.append([t, 0, t])
    return [(t, code) for t, code, _ in out]


def closed(sp: list, name: str) -> list:
    return [s for s in sp if s.name == name and s.t1 is not None]


def innermost(sp: list) -> List[Tuple[float, float, int]]:
    """The host timeline the spans cover, cut into (start, end, index of the
    innermost span covering it) pieces, in order.  Spans nest."""
    marks = []
    for i, s in enumerate(sp):
        if s.t1 is not None and s.t1 > s.t0:
            marks += [(s.t0, 1, -s.t1, i), (s.t1, 0, 0.0, i)]
    marks.sort()                     # at one time: closes first, then outer opens
    out, stack, last = [], [], 0.0
    for t, opens, _, i in marks:
        if stack and t > last:
            out.append((last, t, stack[-1]))
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        last = t
    return out


def idle_pieces(run) -> Optional[List[Tuple[float, int]]]:
    """Each device idle gap of the traced slice, mapped onto the host clock
    through the anchors and split among the innermost spans covering it:
    (seconds, span index, or -1 where no span covers it)."""
    sp, host = record(run), to_host(run)
    if sp is None or host is None or not run.events:
        return None
    segs, out, j = innermost(sp), [], 0
    for a, b in devtrace.idle_gaps(run.events):
        t, b = host(a), host(b)
        while j < len(segs) and segs[j][1] <= t:
            j += 1
        k = j
        while t < b:
            if k == len(segs) or segs[k][0] >= b:
                out.append((b - t, -1))
                break
            s0, s1, i = segs[k]
            if s0 > t:
                out.append((s0 - t, -1))
                t = s0
            end = min(s1, b)
            out.append((end - t, i))
            t, k = end, k + 1
    return out


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """Device idle seconds of the traced slice by innermost span name."""
    pieces, sp = idle_pieces(run), record(run)
    if pieces is None:
        return None
    out: Dict[str, float] = {}
    for dt, i in pieces:
        name = sp[i].name if i >= 0 else OUTSIDE
        out[name] = out.get(name, 0.0) + dt
    return out


def inside(sp: list, i: int, name: str) -> bool:
    """Span ``i`` is named ``name`` or lies inside one that is."""
    while i >= 0:
        if sp[i].name == name:
            return True
        i = sp[i].parent
    return False


def idle_share_inside(run, name: str) -> Optional[float]:
    """Share of the traced slice's device idle time that falls inside spans
    named ``name``, in %."""
    pieces, sp = idle_pieces(run), record(run)
    total = sum(dt for dt, _ in pieces or ())
    if total <= 0:
        return None
    return sum(dt for dt, i in pieces if inside(sp, i, name)) / total * 100.0


def mean_ms(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) * 1e3 if values else None


def queue_wait_ms(run) -> Optional[float]:
    """Mean, over the requests admitted while recording, of their
    admission's start minus their due time, ms."""
    sp = record(run)
    return mean_ms([s.t0 - run.reqs[s.rid].due for s in closed(sp or [], "engine.admit")
                    if s.rid in run.reqs])


def admit_span_ms(run) -> Optional[float]:
    """Mean ``engine.admit`` span: one request's prefill to its first token, ms."""
    return mean_ms([s.t1 - s.t0 for s in closed(record(run) or [], "engine.admit")])


def decode_dispatch(sp: list, s) -> bool:
    p = sp[s.parent] if s.parent >= 0 else None
    return p is not None and p.name == "engine.dispatch" and (p.attrs or {}).get("kind") == "decode"


def decode_launch_ms(run) -> Optional[float]:
    """Mean ``dispatch.launch`` span of the decode dispatches: the model
    step's ops enqueued by the host, ms."""
    sp = record(run) or []
    return mean_ms([s.t1 - s.t0 for s in closed(sp, "dispatch.launch") if decode_dispatch(sp, s)])


# --------------------------------------------------------------------------- #
# checks of the clock and the spans, and the recorder's cost
# --------------------------------------------------------------------------- #
def first_op_leads(run) -> List[float]:
    """For each decode dispatch, its first device kernel's start on the host
    clock less its ``dispatch.launch`` span's start, s.  A kernel cannot
    start before the host launches it, so on a sound clock none is
    negative.  The first kernel is the earliest that starts after the last
    device-to-host read before the dispatch (which waited for the device)."""
    sp, host = record(run), to_host(run)
    if sp is None or host is None or not run.events:
        return []
    kernels = sorted(host(e[0]) for e in run.events
                     if not any(c in e[2] for c in COPIES + (MARKER,)))
    reads = sorted(s.t1 for s in closed(sp, "engine.readback"))
    out = []
    for s in closed(sp, "dispatch.launch"):
        if not decode_dispatch(sp, s):
            continue
        d = sp[s.parent]
        r = bisect.bisect_left(reads, d.t0)
        lo = reads[r - 1] if r else d.t0
        k = bisect.bisect_right(kernels, lo)
        if k < len(kernels) and kernels[k] <= d.t1:
            out.append(kernels[k] - s.t0)
    return out


def quiet_step_ms(run) -> Optional[float]:
    """Mean ``engine.step`` span of the steps that admitted nothing, ms."""
    return mean_ms([s.t1 - s.t0 for s in closed(record(run) or [], "engine.step")
                    if (s.attrs or {}).get("admitted") == 0])


def spans_per_quiet_step(run) -> Optional[float]:
    """Spans recorded inside the steps that admitted nothing, per step."""
    sp = record(run) or []
    quiet = {i for i, s in enumerate(sp) if s.name == "engine.step"
             and (s.attrs or {}).get("admitted") == 0}
    inner = 0
    for s in sp:
        i = s.parent
        while i >= 0 and i not in quiet:
            i = sp[i].parent
        inner += i >= 0
    return (inner + len(quiet)) / len(quiet) if quiet else None


def dispatch_parts_ms(run, kind: str) -> Optional[Dict[str, float]]:
    """Mean host ms a dispatch of ``kind`` (prefill / decode) spends in all
    and in each part (``kernel.launch``: the launches inside its
    ``dispatch.launch``), and, for decode, the step's readback after it."""
    sp = record(run) or []
    own = {i for i, s in enumerate(sp) if s.name == "engine.dispatch" and s.t1 is not None
           and (s.attrs or {}).get("kind") == kind}
    if not own:
        return None
    parts = dict.fromkeys(("engine.dispatch", "dispatch.inputs", "dispatch.launch",
                           "kernel.launch", "engine.readback"), 0.0)
    steps = {i for i, s in enumerate(sp) if s.name == "engine.step"}
    for i, s in enumerate(sp):
        if s.t1 is None:
            continue
        up = s.parent
        if (i in own or up in own
                or (s.name == "kernel.launch" and up >= 0 and sp[up].parent in own)
                or (kind == "decode" and s.name == "engine.readback" and up in steps)):
            parts[s.name] += s.t1 - s.t0
    return {k: v / len(own) * 1e3 for k, v in parts.items()}


def cost_ns(n: int = 200_000) -> Dict[str, float]:
    """Host ns per span (a begin and an end with one attribute) with the
    recorder on, and per site with it off (the one global read and test),
    each less an empty loop's."""
    from repro_torch import telemetry

    def per(fn) -> float:
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) / n * 1e9

    def empty():
        for _ in range(n):
            pass

    def off():
        for _ in range(n):
            rec = telemetry.REC
            if rec is not None:
                pass

    def on():
        rec, attrs = telemetry.Record(), {"kernel": "rmsnorm"}
        for _ in range(n):
            rec.end(rec.begin("kernel.launch", attrs=attrs))

    base = per(empty)
    return {"on_ns_per_span": per(on) - base, "off_ns_per_site": per(off) - base}


# --------------------------------------------------------------------------- #
# runs with the recorder on
# --------------------------------------------------------------------------- #
@contextmanager
def recording():
    """While inside: the harness's window runs with the program's recorder
    on, from the window's open to its close, each ``dispatch.launch`` span
    and an anchor just after the profiler starts and just before it stops
    carrying a device marker; each run keeps its record (``spans``,
    ``span_counters``), the markers' launch times on the device trace's
    clock (``span_marks``) and the clock pairs (``span_clock``).  Yields
    the list of the runs recorded."""
    import harness
    from repro_torch import telemetry
    serve, start, stop = harness.serve, devtrace.start, devtrace.stop
    runs: list = []
    marks: List[float] = []

    def serve_recorded(drv, run, *args, **kwargs):
        telemetry.enable(MARKED)
        run.span_wall = time.time() - time.monotonic()
        marks.clear()
        try:
            serve(drv, run, *args, **kwargs)
        finally:
            rec = telemetry.disable()
        run.spans, run.span_counters, run.span_marks = rec.spans, rec.counters, list(marks)
        run.span_clock = clock_pairs(run)
        runs.append(run)

    # on the card, markers launched within a few hundred microseconds of
    # the profiler's start or stop were missing from its trace: anchor inside
    def start_anchored():
        prof = start()
        time.sleep(SETTLE_S)
        telemetry.anchor()
        return prof

    def stop_anchored(prof):
        telemetry.anchor()
        time.sleep(SETTLE_S)
        events = stop(prof)
        marks[:] = marker_launches(prof) if events else []
        return events

    harness.serve, devtrace.start, devtrace.stop = serve_recorded, start_anchored, stop_anchored
    try:
        yield runs
    finally:
        harness.serve, devtrace.start, devtrace.stop = serve, start, stop


def metrics_spec() -> dict:
    return json.loads((HERE / "spans.json").read_text())


def report(run) -> dict:
    """What a recorded run shows beyond its metrics."""
    from repro_torch import telemetry
    sp, pairs = record(run) or [], getattr(run, "span_clock", None) or []
    offs = [m - h for h, m in pairs]
    anchors = {s.t0 for s in sp if s.name == "anchor"}
    at_anchors = [m - h for h, m in pairs if h in anchors]
    idle = idle_by_span(run)
    leads = first_op_leads(run)
    return {
        "stamps": sum(s.name in STAMPED for s in sp),
        "markers": len(getattr(run, "span_marks", None) or ()),
        "clock_minus_wall_us": ((offs[0] - run.span_wall) * 1e6
                                if offs and getattr(run, "span_wall", None) else None),
        "clock_pairs": len(pairs),
        "anchor_offsets_paired": len(at_anchors),
        "anchor_offset_change_us": ((at_anchors[-1] - at_anchors[0]) * 1e6
                                    if len(at_anchors) > 1 else None),
        "clock_offset_range_us": (max(offs) - min(offs)) * 1e6 if offs else None,
        "clock_steps_over_tol": sum(abs(b - a) > TOL_S for a, b in zip(offs, offs[1:])),
        "idle_ms_by_innermost_span": None if idle is None else {
            k: v * 1e3 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "ms_by_span": {k: [c, t * 1e3, s * 1e3] for k, (c, t, s) in sorted(
            telemetry.by_name(sp).items(), key=lambda kv: -kv[1][2])},
        "counters": getattr(run, "span_counters", {}),
        "quiet_step_span_ms": quiet_step_ms(run),
        "decode_dispatch_ms": dispatch_parts_ms(run, "decode"),
        "prefill_dispatch_ms": dispatch_parts_ms(run, "prefill"),
        "spans_per_quiet_step": spans_per_quiet_step(run),
        "first_op_lead_us": (None if not leads else
                             {"min": min(leads) * 1e6, "n": len(leads),
                              "negative": sum(v < 0 for v in leads)}),
    }


def execute(workload: str, seed: int, seconds: float, device, overrides: dict = None,
            spans_on: bool = True):
    """``run.execute`` of a traced run, with the recorder on (``spans_on``):
    the result gains the span metrics ``spans.json`` lists for the cell and
    the :func:`report` under ``"spans"``.  Returns (result, stderr lines)."""
    import harness
    import run as bench
    if not spans_on:
        return bench.execute(workload, seed, seconds, True, device, overrides)
    with recording() as runs:
        result, lines = bench.execute(workload, seed, seconds, True, device, overrides)
    [r] = runs
    for m in bench.metric_names(metrics_spec(), workload, "per_layer"):
        v = harness.reader(m["name"])(r)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["spans"] = report(r)
    return result, lines


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import run as bench          # the benchmark's paths and caches, as run.py sets them
    import torch
    if not torch.cuda.is_available():
        print("servebench/spans.py: needs a CUDA card", file=sys.stderr)
        return 2
    result, lines = execute(args.workload, args.seed, args.seconds, torch.device("cuda", 0),
                            spans_on=bool(args.spans))
    if args.spans:
        result["spans"]["cost"] = cost_ns()
    bad = bench.forbidden_modules()
    if bad:
        print(f"servebench/spans.py: the process loaded {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

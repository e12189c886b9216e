"""Spans and counters of the serving path, kept in memory while enabled.

Off by default: every site reads the module global :data:`REC` once and
does nothing more while it is None (no clock read, no allocation).
:func:`enable` starts a :class:`Record`; :func:`disable` stops it and
returns what it holds as a :class:`Trace`.  Nothing is written to disk.

A span is a name, a start and an end on ``time.monotonic()`` (the clock of
``Request.arrival_time`` and ``first_token_time``), the index of the span
open around it (its cause; -1 at the top), the request id where there is
one, and a few attributes.  Sites that already read the clock hand their
stamp to the span.  Counters are named integers.  One thread records at a
time.

Spans recorded (``Engine`` and, by inheritance, the staged and sharded
engines; the pool; the kernel launchers):

- ``engine.step`` (attrs ``admitted``, ``live``): one ``Engine.step``;
- ``engine.admit`` (rid; ``prompt``, ``matched``, ``chunks``): one request's
  admission, prefill to its first token;
- ``engine.prefix_match`` (rid): the prefix index's match and page refs;
- ``engine.dispatch`` (``kind`` prefill / decode, ``chunk``): one model
  dispatch, from the host arrays' assembly to the enqueued argmax;
- ``dispatch.inputs``: the host arrays copied to the device (pageable
  copies, so this also waits for the device's earlier work);
- ``dispatch.launch``: the model step and argmax enqueued;
- ``kernel.launch`` (``kernel``): one ``ctypes`` call of a CUDA kernel;
- ``engine.readback``: the device-to-host read of the produced tokens;
- ``engine.retire`` (rid): page release and prefix insert;
- ``pool.reconfigure``, ``pool.migrate`` (rid), ``pool.drain``: a plan's
  application and its hand-off parts;
- ``anchor``: a host stamp with a device marker (:func:`anchor`); spans
  named in :func:`enable`'s ``marked`` carry one too, so a device trace can
  be put on the record's clock wherever they begin.

Counters: ``dispatch.prefill``, ``dispatch.decode``, ``tokens.prefilled``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

MARKER_CYCLES = 1000          # one marker kernel's spin, in clock cycles
MARKER_CODES = 3              # a marker's code: its index in the record, modulo this


class Span(NamedTuple):
    name: str
    t0: float
    t1: Optional[float]       # None: still open when the record stopped
    parent: int               # index of the enclosing span, -1 at the top
    rid: Optional[int]
    attrs: Optional[dict]


class Trace(NamedTuple):
    """A stopped record: its spans in the order they began, and its counters."""
    spans: List[Span]
    counters: Dict[str, int]


class Record:
    """The spans and counters of one enabled stretch, a list per field (a
    span costs a few appends, no object of its own)."""

    __slots__ = ("names", "t0", "t1", "parent", "rid", "attrs", "counters", "_open",
                 "marked", "marker", "marks")

    def __init__(self, marked: Iterable[str] = ()):
        self.names: List[str] = []
        self.t0: List[float] = []
        self.t1: List[Optional[float]] = []
        self.parent: List[int] = []
        self.rid: List[Optional[int]] = []
        self.attrs: List[Optional[dict]] = []
        self.counters: Dict[str, int] = {}
        self._open = [-1]                  # the open spans' indices, under a -1
        self.marked = frozenset(marked)    # spans that begin with a device marker
        self.marker = device_marker() if self.marked else None
        self.marks = 0                     # markers enqueued so far

    def begin(self, name: str, t0: Optional[float] = None, rid: Optional[int] = None,
              attrs: Optional[dict] = None) -> int:
        """Open a span inside the innermost open one; returns its index.  A
        span named in ``marked`` begins by enqueueing a device marker right
        after its stamp (on a card)."""
        if self.marker is not None and name in self.marked:
            t0 = self.mark()
        i = len(self.names)
        self.names.append(name)
        self.t0.append(time.monotonic() if t0 is None else t0)
        self.t1.append(None)
        self.parent.append(self._open[-1])
        self.rid.append(rid)
        self.attrs.append(attrs)
        self._open.append(i)
        return i

    def end(self, i: int, t1: Optional[float] = None, attrs: Optional[dict] = None) -> None:
        """Close span ``i`` (and any span an exception left open inside it),
        adding ``attrs`` to its attributes."""
        self.t1[i] = time.monotonic() if t1 is None else t1
        if attrs:
            had = self.attrs[i]
            self.attrs[i] = {**had, **attrs} if had else attrs
        opened = self._open
        while opened[-1] >= i:
            opened.pop()

    def mark(self) -> float:
        """Read the host clock, then enqueue the next device marker; returns
        the stamp.  A marker is 1 + (its index mod MARKER_CODES) marker
        kernels back to back, so a trace that lost some markers can still
        tell which is which."""
        t = time.monotonic()
        self.marker(self.marks % MARKER_CODES)
        self.marks += 1
        return t

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


REC: Optional[Record] = None


def enable(marked: Iterable[str] = ()) -> Record:
    """Start a fresh record (dropping one already running); spans named in
    ``marked`` each enqueue a device marker (:func:`anchor`)."""
    global REC
    REC = Record(marked)
    return REC


def disable() -> Optional[Trace]:
    """Stop recording; what the record holds, or None if none was running.
    (A site that still holds the live record may close its span there; the
    trace returned does not change.)"""
    global REC
    rec, REC = REC, None
    if rec is None:
        return None
    return Trace([Span(*f) for f in zip(rec.names, rec.t0, rec.t1, rec.parent,
                                        rec.rid, rec.attrs)], dict(rec.counters))


def device_marker() -> Optional[Callable[[int], None]]:
    """A call that enqueues the marker of a given code on the current
    stream: 1 + code marker kernels (``torch.cuda._sleep``'s
    ``spin_kernel``, which no serving op launches); None without a card."""
    import torch
    if not torch.cuda.is_available():
        return None
    sleep = torch.cuda._sleep

    def marker(code: int) -> None:
        for _ in range(code + 1):
            sleep(MARKER_CYCLES)
    return marker


def anchor() -> Optional[float]:
    """While recording on a CUDA card: read the host clock, enqueue one
    device marker and record the stamp as an ``anchor`` span.  In a device
    trace, the marker's launch record (its host start on the trace's own
    clock) less the stamp is that clock's offset from the record's.
    Returns the stamp, or None (recorder off, or no card)."""
    rec = REC
    if rec is None:
        return None
    if rec.marker is None:
        rec.marker = device_marker()
        if rec.marker is None:
            return None
    t = rec.mark()
    rec.end(rec.begin("anchor", t), t)
    return t


def by_name(spans: List[Span]) -> Dict[str, List[float]]:
    """{name: [count, total s, self s]} over the closed spans; a span's self
    time is its duration less that of its closed children."""
    child = [0.0] * len(spans)
    for s in spans:
        if s.t1 is not None and s.parent >= 0:
            child[s.parent] += s.t1 - s.t0
    out: Dict[str, List[float]] = {}
    for s, c in zip(spans, child):
        if s.t1 is not None:
            row = out.setdefault(s.name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += s.t1 - s.t0
            row[2] += s.t1 - s.t0 - c
    return out


def table(rec: Trace) -> str:
    """Count, total and self ms by span name (most self time first), then
    the counters."""
    rows = sorted(by_name(rec.spans).items(), key=lambda kv: -kv[1][2])
    lines = [f"{'span':<20} {'count':>8} {'total ms':>12} {'self ms':>12}"]
    lines += [f"{n:<20} {c:>8d} {t * 1e3:>12.3f} {s * 1e3:>12.3f}"
              for n, (c, t, s) in rows]
    lines += [f"counter {n} {v}" for n, v in sorted(rec.counters.items())]
    return "\n".join(lines)

"""Runtime-trace construction — every table in Appendix H, verbatim (port of ``src/repro/traces/workload.py``).

A Trace is a sequence of TimestampObservation (the data plane's monitoring
points): per-model workloads + cluster availability.  These drive both the
motivation studies (§3), the case studies (§8) and the end-to-end benchmark
(§7.1 phase profiles).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.plan import ClusterState, ModelSpec, QWEN25_FAMILY, Workload


@dataclass(frozen=True)
class TimestampObservation:
    idx: int
    time: float
    workloads: Tuple[Workload, ...]
    cluster: ClusterState
    # measured backend feedback for the interval that served this timestamp
    # (repro_torch.core.execution_model.IntervalMetrics); None for synthetic traces
    metrics: Optional[object] = None


@dataclass(frozen=True)
class Trace:
    name: str
    observations: Tuple[TimestampObservation, ...]
    models: Tuple[str, ...]

    def __len__(self) -> int:
        return len(self.observations)

    def window(self, start: int, end: int) -> "Trace":
        # reindex from 0 to match SnapshotBuffer.snapshot semantics —
        # consumers keyed on obs.idx must see the same numbering no matter
        # which path built the trace
        obs = tuple(TimestampObservation(i, o.time, o.workloads, o.cluster,
                                         o.metrics)
                    for i, o in enumerate(self.observations[start:end]))
        return Trace(f"{self.name}[{start}:{end}]", obs, self.models)


_M = {s: QWEN25_FAMILY[s].name for s in QWEN25_FAMILY}

# phase profiles (App. H.1): batch / prefill / decode per model size
_HEAVY = {
    "1.5B": (64, 256, 2048), "3B": (64, 256, 1536), "7B": (64, 256, 3072),
    "14B": (384, 512, 8192), "32B": (256, 512, 6144), "72B": (128, 512, 5120),
}
_LIGHT = {
    "1.5B": (960, 256, 4096), "3B": (480, 256, 3072), "7B": (288, 256, 6144),
    "14B": (64, 256, 2048), "32B": (32, 256, 1536), "72B": (16, 256, 1280),
}


def _phase_workloads(phase: str, sizes: Sequence[str],
                     overrides: Optional[Dict[str, Tuple[int, int, int]]] = None
                     ) -> Tuple[Workload, ...]:
    base = _HEAVY if phase == "H" else _LIGHT
    out = []
    for s in sizes:
        b, p, d = (overrides or {}).get(s, base[s])
        out.append(Workload(_M[s], b, p, d))
    return tuple(out)


def _mk(name: str, rows: List[Tuple[Tuple[Workload, ...], ClusterState]],
        models: Sequence[str], dt: float = 1.0) -> Trace:
    obs = tuple(TimestampObservation(i, i * dt, w, c)
                for i, (w, c) in enumerate(rows))
    return Trace(name, obs, tuple(_M[s] for s in models))


def _homog_cluster(n: int = 32, gpu: str = "H100-80G") -> ClusterState:
    return ClusterState(((gpu, n),))


def _hetero_cluster() -> ClusterState:
    """§7 heterogeneous environment: 64 GPUs across four types."""
    return ClusterState((("A100-40G", 20), ("A100-80G", 20),
                         ("H100-80G", 8), ("H20-96G", 16)))


# --------------------------------------------------------------------------- #
# Motivation traces (Tables 8, 9)
# --------------------------------------------------------------------------- #
SIZES6 = ("1.5B", "3B", "7B", "14B", "32B", "72B")


def motivation_trace_left(cluster: Optional[ClusterState] = None) -> Trace:
    c = cluster or _homog_cluster()
    rows = [(_phase_workloads(p, SIZES6), c) for p in ("H", "L", "H")]
    return _mk("motivation-left", rows, SIZES6)


def motivation_trace_right(cluster: Optional[ClusterState] = None) -> Trace:
    c = cluster or _homog_cluster()
    ts1 = {"1.5B": (968, 256, 4096), "3B": (476, 256, 3072)}
    ts3 = {"1.5B": (72, 256, 2048), "14B": (400, 512, 8192)}
    rows = [
        (_phase_workloads("L", SIZES6), c),
        (_phase_workloads("L", SIZES6, ts1), c),
        (_phase_workloads("H", SIZES6), c),
        (_phase_workloads("H", SIZES6, ts3), c),
        (_phase_workloads("H", SIZES6), c),
    ]
    return _mk("motivation-right", rows, SIZES6)


# --------------------------------------------------------------------------- #
# §8.1 workload-fluctuation traces (Tables 10, 11)
# --------------------------------------------------------------------------- #
def stable_workload_trace(cluster: Optional[ClusterState] = None) -> Trace:
    """Table 10: three small models, mostly stable with slight variations.
    §8.1 runs on the Swiss-AI-style heterogeneous cluster."""
    c = cluster or _hetero_cluster()
    b15 = [960, 1008, 952, 960, 968, 956, 962, 958, 1008, 964]
    b3 = [480, 476, 480, 480, 544, 480, 480, 478, 481, 480]
    b7 = [288, 284, 264, 290, 286, 288, 336, 287, 285, 291]
    rows = []
    for i in range(10):
        d15 = 8192 if i == 3 else 4096
        p7 = 512 if i == 6 else 256
        w = (Workload(_M["1.5B"], b15[i], 256, d15),
             Workload(_M["3B"], b3[i], 256, 3072),
             Workload(_M["7B"], b7[i], p7, 6144))
        rows.append((w, c))
    return _mk("stable-workload", rows, ("1.5B", "3B", "7B"))


def volatile_workload_trace(cluster: Optional[ClusterState] = None) -> Trace:
    """Table 11: H/H/H/L/L/L/H/H/H/L with per-ts batch tweaks (§8.1 hetero)."""
    c = cluster or _hetero_cluster()
    phases = ["H", "H", "H", "L", "L", "L", "H", "H", "H", "L"]
    tweaks: Dict[int, Dict[str, Tuple[int, int, int]]] = {
        1: {"1.5B": (80, 256, 2048), "14B": (400, 512, 8192)},
        4: {"1.5B": (1008, 256, 4096), "7B": (336, 256, 6144)},
        6: {"1.5B": (96, 256, 2048), "14B": (416, 512, 8192)},
        8: {"1.5B": (80, 256, 2048), "14B": (400, 512, 8192)},
    }
    rows = [(_phase_workloads(p, SIZES6, tweaks.get(i)), c)
            for i, p in enumerate(phases)]
    return _mk("volatile-workload", rows, SIZES6)


# --------------------------------------------------------------------------- #
# §8.2 elastic cluster traces (Tables 12, 13)
# --------------------------------------------------------------------------- #
_ELASTIC_WORKLOAD = (
    Workload(_M["7B"], 128, 512, 512),
    Workload(_M["14B"], 192, 512, 2048),
    Workload(_M["72B"], 256, 512, 4096),
)


def elastic_cluster_traces() -> Dict[str, Trace]:
    def c(a100: int, h100: int, h200: int) -> ClusterState:
        gpus = []
        if a100:
            gpus.append(("A100-80G", a100))
        if h100:
            gpus.append(("H100-SXM", h100))
        if h200:
            gpus.append(("H200-SXM", h200))
        return ClusterState(tuple(gpus))

    stable = [c(0, 16, 16), c(0, 16, 24), c(0, 24, 24), c(16, 16, 8), c(8, 24, 16)]
    volatile = [c(8, 16, 16), c(0, 8, 24), c(16, 24, 8), c(16, 40, 8), c(8, 24, 16)]
    out = {}
    for name, clusters in (("elastic-stable", stable), ("elastic-volatile", volatile)):
        rows = [(_ELASTIC_WORKLOAD, cl) for cl in clusters]
        out[name] = _mk(name, rows, ("7B", "14B", "72B"))
    return out


# --------------------------------------------------------------------------- #
# fragmented-cluster trace: elastic churn that leaves non-contiguous free
# islands behind (spot preemption / co-tenant checkerboarding), driving the
# pipeline-vs-tensor-parallel capacity benchmark.
# --------------------------------------------------------------------------- #
# Per-window free-island sizes on one 8-device host.  Interleaved releases
# leave the free set as disjoint runs of consecutive device ids: a tp-only
# replica needs its whole submesh inside ONE island, while a pipelined
# replica places each stage submesh on its own island.  The windows are
# deliberately non-monotone and odd-sized (islands appear, merge, shrink).
FRAGMENT_WINDOWS: Tuple[Tuple[int, ...], ...] = (
    (2, 2),        # checkerboard: two 2-islands
    (4, 2),        # a neighbour finishes — one 4-island appears
    (2, 2, 2),     # re-fragmented three ways
    (8,),          # fully defragmented host
    (2, 3),        # odd remainder after a 3-wide release
)


def fragmented_cluster_traces(gpu: str = "H100-80G") -> Dict[str, Trace]:
    """One trace whose per-window device count is the SUM of that window's
    free islands (``FRAGMENT_WINDOWS``); ClusterState cannot express
    adjacency, so consumers that care about placement (the pipeline
    fragmentation benchmark) read the island structure from
    ``FRAGMENT_WINDOWS`` keyed by observation index."""
    wl = (Workload(_M["1.5B"], 8, 64, 64),)
    rows = [(wl, ClusterState(((gpu, sum(win)),)))
            for win in FRAGMENT_WINDOWS]
    return {"fragmented-islands": _mk("fragmented-islands", rows, ("1.5B",))}


# --------------------------------------------------------------------------- #
# §7.1 phase-profile traces (Table 14) — DistServe / HexGen comparisons
# --------------------------------------------------------------------------- #
_SHAREGPT_PHASES = [
    ("prefill-heavy", 1232, 14), ("decode-heavy", 535, 545),
    ("balanced-short", 549, 18), ("stable-mixed", 1094, 290),
    ("stable-mixed", 1101, 292), ("stable-mixed", 1097, 289),
]
_LONGBENCH_PHASES = [
    ("prefill-heavy", 2035, 5), ("prefill-heavy", 2037, 3),
    ("decode-heavy", 1597, 373), ("stable-decode-heavy", 1605, 373),
    ("stable-decode-heavy", 1554, 397), ("stable-decode-heavy", 1582, 387),
]


def sharegpt_longbench_traces(model: str = "qwen2.5-72b",
                              requests_per_phase: Tuple[int, int] = (5120, 1728),
                              cluster: Optional[ClusterState] = None
                              ) -> Dict[str, Trace]:
    c = cluster or _homog_cluster(32)
    out = {}
    for name, phases, n_req in (("sharegpt", _SHAREGPT_PHASES, requests_per_phase[0]),
                                ("longbench", _LONGBENCH_PHASES, requests_per_phase[1])):
        rows = []
        for _, pref, dec in phases:
            rows.append(((Workload(model, max(n_req // 40, 16), pref, max(dec, 4)),), c))
        t = _mk(name, rows, ())
        out[name] = Trace(name, t.observations, (model,))
    return out


# --------------------------------------------------------------------------- #
# SpotServe-style MAF traces (Tables 15, 16)
# --------------------------------------------------------------------------- #
_MAF_CLUSTER_SIZES = [24, 25, 26, 27, 29, 30, 32, 33, 36, 38, 42, 45,
                      48, 51, 54, 55, 60, 63, 62, 64, 61, 62, 60, 57,
                      56, 54, 55, 53, 51, 50, 49, 47, 45, 44, 43]

_MAF1 = [("decode-heavy", 512, 1024), ("mixed", 2048, 256),
         ("prefill-heavy", 4096, 128), ("mixed-stable", 2048, 256)]
_MAF2 = [("prefill-heavy", 4096, 128), ("mixed", 2048, 256),
         ("decode-heavy", 512, 1024), ("mixed-stable", 2048, 256)]


def maf_traces(model: str = "qwen2.5-72b", batch: int = 64) -> Dict[str, Trace]:
    out = {}
    for name, phases in (("maf-1", _MAF1), ("maf-2", _MAF2)):
        rows = []
        n = len(_MAF_CLUSTER_SIZES)
        per_phase = n // len(phases)
        for i, size in enumerate(_MAF_CLUSTER_SIZES):
            ph = phases[min(i // per_phase, len(phases) - 1)]
            _, pref, dec = ph
            rows.append(((Workload(model, batch, pref, dec),),
                         ClusterState((("A100-80G", size),))))
        out[name] = _mk(name, rows, ())
        out[name] = Trace(name, out[name].observations, (model,))
    return out


# --------------------------------------------------------------------------- #
# §8.3 agentic workflow traces (ShareGPT-style, online call revelation)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class AgenticCall:
    workflow: int
    call_idx: int
    prefill_len: int
    decode_len: int


@dataclass(frozen=True)
class AgenticTrace:
    name: str
    workflows: Tuple[Tuple[AgenticCall, ...], ...]   # per-workflow call chains
    slo_scale: float = 3.0

    @property
    def n_calls(self) -> int:
        return sum(len(w) for w in self.workflows)


def shared_prefix_requests(n_requests: int, *, prefix_pool: int = 2,
                           prefix_len: int = 48, suffix_len: int = 8,
                           reuse_ratio: float = 0.75, vocab: int = 100,
                           seed: int = 0) -> List[Tuple[int, List[int]]]:
    """Token-level prompts with a controllable cross-request reuse rate.

    A ``reuse_ratio`` fraction of requests draw their first ``prefix_len``
    tokens from a small pool of shared templates (the system-prompt /
    few-shot-header shape that makes cross-request prefix caching pay) and
    append a unique suffix; the rest are fully unique.  Returns
    ``(template_idx, prompt)`` pairs — ``template_idx`` is -1 for unique
    prompts, so benchmarks can split hit/miss populations when measuring
    TTFT.  Deterministic in ``seed``.
    """
    rng = random.Random(seed)
    templates = [[rng.randint(2, vocab - 1) for _ in range(prefix_len)]
                 for _ in range(max(prefix_pool, 1))]
    out: List[Tuple[int, List[int]]] = []
    for _ in range(n_requests):
        if rng.random() < reuse_ratio:
            t = rng.randrange(len(templates))
            prompt = templates[t] + [rng.randint(2, vocab - 1)
                                     for _ in range(suffix_len)]
        else:
            t = -1
            prompt = [rng.randint(2, vocab - 1)
                      for _ in range(prefix_len + suffix_len)]
        out.append((t, prompt))
    return out


def multi_turn_requests(n_workflows: int, turns: int, *, turn_len: int = 24,
                        vocab: int = 100, seed: int = 0
                        ) -> List[List[List[int]]]:
    """Agentic multi-turn chains (§8.3 shape at token granularity): turn k's
    prompt is turn k-1's full prompt plus a fresh segment, so a prefix cache
    that retains finished requests carries the whole conversation forward
    and each turn re-prefills only its new segment.  Returns one prompt list
    per turn per workflow; deterministic in ``seed``."""
    rng = random.Random(seed)
    out: List[List[List[int]]] = []
    for _ in range(n_workflows):
        hist: List[int] = []
        chain: List[List[int]] = []
        for _ in range(max(turns, 1)):
            hist = hist + [rng.randint(2, vocab - 1)
                           for _ in range(turn_len)]
            chain.append(list(hist))
        out.append(chain)
    return out


# --------------------------------------------------------------------------- #
# unplanned failure events (fault-injection schedules)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class FailureEvent:
    """One unplanned runtime fault, anchored to a serving step/interval.

    Unlike the *planned* cluster transitions in ``elastic_cluster_traces``
    (announced by the trace, handled by reconfiguration), these strike
    mid-serving with no warning: ``kill`` removes a replica abruptly (spot
    preemption / crash), ``straggle`` degrades one into a straggler whose
    every step takes ``magnitude`` times longer (thermal throttling, noisy
    neighbour), ``restore`` lifts the degradation.  ``engine_idx`` indexes
    the pool's deterministic engine order modulo its size, so the same
    schedule names the same victims on every replay.
    """
    step: int
    kind: str                        # "kill" | "straggle" | "restore"
    engine_idx: int
    magnitude: float = 4.0           # straggler per-step latency multiplier
    deny_export: bool = False        # kill: slot exports corrupted/denied


def failure_schedule(seed: int, n_events: int = 4, horizon: int = 16,
                     kill_ratio: float = 0.5, deny_export_rate: float = 0.25,
                     straggle_magnitude: Tuple[float, float] = (2.0, 6.0),
                     ) -> Tuple[FailureEvent, ...]:
    """Deterministic, seedable fault schedule: same seed → same schedule.

    ``kill_ratio`` of the events are abrupt replica kills (a
    ``deny_export_rate`` fraction of those also corrupt the dying replica's
    slot exports, forcing the recompute path); the rest split between
    straggler degradation and restoration.  Events are sorted by step so an
    injector can replay them with a single cursor.
    """
    rng = random.Random(f"faults:{seed}")
    events: List[FailureEvent] = []
    for _ in range(max(n_events, 0)):
        step = rng.randrange(1, max(horizon, 2))
        idx = rng.randrange(16)
        r = rng.random()
        if r < kill_ratio:
            events.append(FailureEvent(
                step, "kill", idx,
                deny_export=rng.random() < deny_export_rate))
        elif r < kill_ratio + (1.0 - kill_ratio) * 0.7:
            lo, hi = straggle_magnitude
            events.append(FailureEvent(
                step, "straggle", idx,
                magnitude=round(rng.uniform(lo, hi), 3)))
        else:
            events.append(FailureEvent(step, "restore", idx))
    return tuple(sorted(events,
                        key=lambda e: (e.step, e.kind, e.engine_idx)))


def agentic_traces(n_workflows: int = 64, seed: int = 0
                   ) -> Dict[str, AgenticTrace]:
    """Two non-overlapping 64-workflow slices with ShareGPT-like length mix."""
    out = {}
    for t_idx, name in enumerate(("agentic-1", "agentic-2")):
        rng = random.Random(seed + 1000 * t_idx)
        wfs = []
        for w in range(n_workflows):
            n_calls = rng.choice([2, 3, 3, 4, 5])
            calls = []
            for ci in range(n_calls):
                pref = int(rng.lognormvariate(5.8, 0.8)) + 32      # ~ShareGPT mix
                dec = int(rng.lognormvariate(4.6, 1.0)) + 8
                calls.append(AgenticCall(w, ci, min(pref, 4096), min(dec, 2048)))
            wfs.append(tuple(calls))
        out[name] = AgenticTrace(name, tuple(wfs))
    return out

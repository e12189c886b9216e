"""The benchmark's harness: builds one cell's system under test from its files,
serves the cell's traffic through it for a fixed window, and keeps the host
records the metric readers (``servebench/metrics/<name>.py``) read.

What runs is the program's data plane as its serve launcher builds it: a
``TorchBackend`` with one replica group (``apply_plan``), requests submitted
to ``backend.pool``, and each busy engine stepped once a round, as
``EnginePool.run_until_drained`` rounds go.  Everything else is read from
outside: each step's host wall, who was admitted, which lanes decoded at
what context, the prefix cache's saved-token counter, and when each token
came back.  Nothing here changes what the program does.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

import devtrace
import judge
import traffic
import weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_SHARE = 0.2           # the traced slice: the window's last share,
TRACE_MAX_S = 10.0          # and at most this long (stopped after the close)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str, spec: Optional[dict] = None):
    """(cell entry, configuration dict, mix dict, check dict or None) of a
    cell named in ``BENCHMARK.json``."""
    spec = spec or bench()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    c = load_json(ROOT / cfg_entry["file"])
    mix = load_json(HERE / "workloads" / f"{cell['traffic']}.json")
    check_path = HERE / "checks" / f"{name}.json"
    check = load_json(check_path) if check_path.exists() else None
    return cell, c, mix, check


def family(c: dict):
    return importlib.import_module(f"families.{c['model_type']}")


def reader(metric: str) -> Callable:
    """``read(run)`` of ``servebench/metrics/<metric>.py``, or, where there
    is none, of the file named by the metric's name before its first dot
    (``mfu.batch`` and ``mfu.open`` read ``mfu.py``)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------------- #
# host records
# --------------------------------------------------------------------------- #
@dataclass
class Step:
    t0: float
    t1: float
    admitted: List[int]                    # rids admitted by this step
    prefill: List[tuple]                   # (rid, first uncached position, prompt length)
    decode_ctx: List[int]                  # keys each decoding lane attended to
    traced: bool = False
    left_busy: bool = True                 # the engine still held requests after it


@dataclass
class Req:
    rid: int
    due: float                             # host clock
    times: List[float] = field(default_factory=list)
    done: bool = False
    prompt: Optional[List[int]] = None
    tokens: Optional[List[int]] = None


@dataclass
class Run:
    """What a run leaves for the readers.  Times are host monotonic seconds;
    ``events`` are the traced slice's device events (device clock)."""
    c: dict
    mix: dict
    dims: dict
    layer: dict
    seconds: float
    setup_s: float = 0.0
    t_open: float = 0.0
    t_close: float = 0.0
    steps: List[Step] = field(default_factory=list)
    reqs: Dict[int, Req] = field(default_factory=dict)
    queue: List[int] = field(default_factory=list)
    engine_busy_s: float = 0.0             # time with >= 1 request in the engine
    prompt_tokens: int = 0                 # prompt tokens of requests admitted
    saved_tokens: int = 0                  # of those, served from the prefix cache
    lateness: List[float] = field(default_factory=list)
    refused: int = 0
    shed: int = 0
    trace_t0: float = 0.0
    trace_t1: float = 0.0
    events: Optional[list] = None
    peak_bytes: int = 0                    # device memory peak, set-up's end to the close
    picked: List[judge.Served] = field(default_factory=list)   # the sample judged

    def traced_steps(self) -> List[Step]:
        return [s for s in self.steps if s.traced]

    def traced_busy_s(self) -> float:
        """Host time in the traced slice with >= 1 request in the engine:
        the traced steps' walls, and the loop's time between two of them
        where the engine held requests throughout."""
        steps = self.traced_steps()
        return sum((b.t0 if b is not None and a.left_busy else a.t1) - a.t0
                   for a, b in zip(steps, steps[1:] + [None]))


# --------------------------------------------------------------------------- #
# the system under test
# --------------------------------------------------------------------------- #
def build(c: dict, mix: dict, seed: int, device):
    """The program's backend with one replica group and the seed's weights."""
    from repro_torch.core.plan import Plan, ReplicaGroup
    from repro_torch.models import lm
    from repro_torch.serving.backend import TorchBackend
    fam = family(c)
    cfg = fam.program_config(c)
    model = lm.LM(cfg, device=device)
    weights.load_program(model, fam.param_groups(c), seed, device)
    plan = mix["plan"]
    backend = TorchBackend(cfg, model, max_seq_len=plan["max_seq_len"],
                           slots_cap=plan["batch"], max_replicas_per_group=1,
                           page_size=plan["page_size"], device=device)
    backend.apply_plan(Plan((ReplicaGroup(cfg.name, "H100-80G", tp=1,
                                          batch=plan["batch"], count=1),)), None)
    return backend


class Stepper:
    """Steps the pool's engines, keeping the host records of a :class:`Run`."""

    def __init__(self, backend, run: Run):
        self.pool = backend.pool
        self.model = backend.cfg.name
        self.run = run
        self.page = run.mix["plan"]["page_size"]
        self.rid = 0
        self.recording = False

    def engines(self):
        return self.pool.engines

    def submit(self, item: traffic.Item, due: float) -> int:
        from repro_torch.serving.engine import Request
        self.rid += 1
        now = time.monotonic()
        req = Request(rid=self.rid, prompt=list(item.prompt),
                      max_new_tokens=item.max_new_tokens, eos_id=-1,
                      arrival_time=due)
        if self.recording:
            self.run.reqs[self.rid] = Req(self.rid, due)
            self.run.lateness.append(now - due)
        if not self.pool.submit(self.model, req):
            self.pool.add_backlog(self.model, req)
            if self.recording:
                self.run.refused += 1
        return self.rid

    def busy(self) -> bool:
        return any(e.waiting or e.active for e in self.engines()) or bool(self.pool.backlog)

    def round(self, traced: bool = False) -> List[int]:
        """One round: every busy engine steps once.  Returns the rids that
        finished in it."""
        self.pool._flush_backlog()
        finished: List[int] = []
        for eng in [e for e in self.engines() if e.waiting or e.active]:
            finished += self._step(eng, traced)
        return finished

    def _step(self, eng, traced: bool) -> List[int]:
        run = self.run
        pre = {st.request.rid: (st.position, len(st.generated))
               for st in eng.active.values()}
        waiting0 = [r.rid for r in eng.waiting]
        saved0, nfin0 = eng.prefix_tokens_saved, len(eng.finished)
        t0 = time.monotonic()
        eng.step()
        t1 = time.monotonic()
        if not self.recording:
            return []
        left = {r.rid for r in eng.waiting}
        admitted = [rid for rid in waiting0 if rid not in left]
        states = {st.request.rid: st for st in
                  list(eng.active.values()) + eng.finished[nfin0:]}
        saved = eng.prefix_tokens_saved - saved0
        lens = {rid: len(states[rid].request.prompt) for rid in admitted if rid in states}
        prefill, total = [], sum(lens.values())
        for rid, n in lens.items():
            m = saved if len(lens) == 1 else int(saved * n / total) // self.page * self.page
            prefill.append((rid, min(m, n - 1), n))
        run.prompt_tokens += total
        run.saved_tokens += saved
        decode_ctx, finished = [], []
        for rid, st in states.items():
            pos, had = pre.get(rid, (None, 0))
            got = len(st.generated) - had
            if pos is not None and got:
                decode_ctx.append(pos + 1)
            elif pos is None and got >= 2:
                decode_ctx.append(len(st.request.prompt) + 1)
            req = run.reqs.get(rid)
            if req is not None:
                req.times.extend([t1] * got)
                if st.done:
                    req.done = True
                    req.prompt = list(st.request.prompt)
                    req.tokens = list(st.generated)
            if st.done:
                finished.append(rid)
        run.steps.append(Step(t0, t1, admitted, prefill, decode_ctx, traced,
                              bool(eng.waiting or eng.active)))
        return finished


# --------------------------------------------------------------------------- #
# the window
# --------------------------------------------------------------------------- #
def prepare(drv: Stepper, run: Run, seed: int, trace: bool):
    """Set-up's serving: the mix's warm-up requests to the end (every prefill
    chunk size and the batch's decode run once; the documents enter the
    prefix cache); with ``trace``, one empty profile, so that the profiler's
    own start-up is not paid in the window; and for a closed loop, every
    client's first request admitted, so that the window opens on the
    loop's steady state.  Returns the closed loop's request stream."""
    mix, vocab = run.mix, run.dims["vocab"]
    for item in traffic.warmup_items(mix, seed, vocab):
        drv.submit(item, time.monotonic())
    while drv.busy():
        drv.round()
    if trace:
        devtrace.stop(devtrace.start())
    if mix["loop"] != "closed":
        return None
    stream = traffic.closed_stream(mix, seed, vocab)
    sent = []
    for _ in range(mix["clients"]):
        item, now = next(stream), time.monotonic()
        sent.append((drv.submit(item, now), item, now))
    while any(e.waiting for e in drv.engines()) or drv.pool.backlog:
        drv.round()
    for rid, item, now in sent:
        run.reqs[rid] = Req(rid, now)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return stream


def serve(drv: Stepper, run: Run, seed: int, trace: bool, t_open: float,
          stream=None) -> None:
    """The measured window: an open loop per the mix, or the closed loop
    that :func:`prepare` started (``stream``)."""
    mix, T = run.mix, run.seconds
    run.t_open = t_open
    t_end = t_open + T
    tr0 = t_end - min(TRACE_SHARE * T, TRACE_MAX_S)
    prof = None
    drv.recording = True
    pending = deque(traffic.open_loop(mix, seed, T, run.dims["vocab"])
                    if mix["loop"] == "open" else ())
    last, was_busy = t_open, True
    while True:
        now = time.monotonic()
        if was_busy:
            run.engine_busy_s += now - last
        last = now
        if trace and prof is None and tr0 <= now < t_end:
            prof, run.trace_t0 = devtrace.start(), time.monotonic()
        if now >= t_end:
            break
        while pending and t_open + pending[0].due_s <= now:
            item = pending.popleft()
            drv.submit(item, t_open + item.due_s)
        run.queue.append(sum(len(e.waiting) for e in drv.engines()) + len(drv.pool.backlog))
        was_busy = drv.busy()
        if was_busy:
            for _ in drv.round(traced=prof is not None):
                if stream is not None:
                    drv.submit(next(stream), time.monotonic())
        else:
            nxt = t_open + pending[0].due_s if pending else t_end
            time.sleep(max(min(nxt, t_end) - time.monotonic(), 0.0))
    run.t_close = time.monotonic()
    for item in pending:                   # due in the window, never sent
        drv.rid += 1
        run.reqs[drv.rid] = Req(drv.rid, t_open + item.due_s)
    if prof is not None:
        run.trace_t1 = time.monotonic()
        run.events = devtrace.stop(prof)
    run.shed = len(drv.pool.shed_requests) + drv.pool.backlog_dropped
    drv.recording = False


def measure(workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, overrides: Optional[dict] = None):
    """One run of a cell up to the reference: build, set up, serve the
    window, draw the sample to judge, free the program.  ``setup_s`` counts
    from ``t_start``; ``overrides`` (tests only) replaces the configuration
    or parts of the mix.  Returns (run, the cell's check or None)."""
    _, c, mix, check = cell_files(workload)
    if overrides:
        c = overrides.get("config", c)
        mix = {**mix, **overrides.get("mix", {})}
    cuda = torch.device(device).type == "cuda"
    backend = build(c, mix, seed, device)
    run = new_run(c, mix, seconds)
    drv = Stepper(backend, run)
    stream = prepare(drv, run, seed, trace)
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    t_open = time.monotonic()
    run.setup_s = t_open - t_start
    serve(drv, run, seed, trace, t_open, stream)
    gc.unfreeze()
    if cuda:
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    run.picked = judge.sample(finished_in_window(run), seed, mix["sample"]["requests"],
                              mix["sample"]["served_tokens"])
    del drv, backend
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run, check


def finished_in_window(run: Run) -> List[judge.Served]:
    return [judge.Served(r.rid, r.prompt, r.tokens)
            for r in run.reqs.values() if r.done and r.tokens]


def new_run(c: dict, mix: dict, seconds: float) -> Run:
    fam = family(c)
    return Run(c, mix, fam.dims(c), fam.layer_params(c), seconds)


def tokens_in_window(run: Run) -> int:
    return sum(len([t for t in r.times if t <= run.t_close]) for r in run.reqs.values())


def window_s(run: Run) -> float:
    return run.t_close - run.t_open


"""The span readers (``spans.py`` and the reader files it serves) on a
hand-built run whose numbers are worked out by hand, the metrics'
entries in ``spans.json``, and a tiny cell run on the CPU with the
recorder on."""
import pytest

import devtrace
import harness
import spans
import tiny
from repro_torch.telemetry import Span

SPEC = harness.bench()
E2E = {m["name"]: m for m in SPEC["end_to_end"]}
ENTRIES = spans.metrics_spec()["per_layer"]


def S(name, t0, t1, parent=-1, rid=None, **attrs):
    return Span(name, t0, t1, parent, rid, attrs or None)


def code(k):
    """The code of the k-th marked stamp's marker."""
    return k % 3


def hand_run():
    """Host clock; the device clock reads 100 s more.

    step 1.0-2.0 admits rid 1 (1.0-1.5: a prefill dispatch 1.0-1.4 with
    inputs 1.0-1.1, launch 1.1-1.4 holding a kernel launch 1.2-1.3, then a
    readback 1.4-1.5), decodes 1.5-1.8 (inputs 1.5-1.6, launch 1.6-1.8) and
    reads back 1.8-2.0; step 2.2-2.6 admits rid 2 (2.2-2.4).  Anchors at
    0.9 and 3.0; they and the two launches carry markers."""
    sp = [S("anchor", 0.9, 0.9),
          S("engine.step", 1.0, 2.0, admitted=1, live=1),
          S("engine.admit", 1.0, 1.5, 1, rid=1),
          S("engine.dispatch", 1.0, 1.4, 2, kind="prefill", chunk=4),
          S("dispatch.inputs", 1.0, 1.1, 3),
          S("dispatch.launch", 1.1, 1.4, 3),
          S("kernel.launch", 1.2, 1.3, 5, kernel="rmsnorm"),
          S("engine.readback", 1.4, 1.5, 2),
          S("engine.dispatch", 1.5, 1.8, 1, kind="decode", chunk=1),
          S("dispatch.inputs", 1.5, 1.6, 8),
          S("dispatch.launch", 1.6, 1.8, 8),
          S("engine.readback", 1.8, 2.0, 1),
          S("engine.step", 2.2, 2.6, admitted=1, live=0),
          S("engine.admit", 2.2, 2.4, 12, rid=2),
          S("anchor", 3.0, 3.0)]
    run = harness.Run({}, {}, {}, {}, 5.0)
    run.reqs = {1: harness.Req(1, 0.5), 2: harness.Req(2, 1.0)}
    run.events = [(100.9, 100.901, "at::cuda::spin_kernel(long)"),
                  (101.15, 101.25, "gemm"), (101.35, 101.45, "rmsnorm"),
                  (101.52, 101.53, "Memcpy HtoD (Pageable -> Device)"),
                  (101.65, 101.7, "decode_split"), (102.3, 102.35, "gemm"),
                  (103.0, 103.001, "at::cuda::spin_kernel(long)")]
    run.spans = sp
    run.span_marks = [(100.9, code(0)), (101.1, code(1)),   # the marked stamps' launches
                      (101.6, code(2)), (103.0, code(3))]
    run.span_clock = spans.clock_pairs(run)
    return run


# the idle gaps on the host clock, split by hand:
# 0.901-1.15: outside 0.099, inputs 0.1, launch 0.05;  1.25-1.35: kernel
# launch 0.05, launch 0.05;  1.45-1.52: readback 0.05, inputs 0.02;  1.53-1.65:
# inputs 0.07, launch 0.05;  1.7-2.3: launch 0.1, readback 0.2, outside 0.2,
# admit 0.1;  2.35-3.0: admit 0.05, step 0.2, outside 0.4
BY_SPAN = {"outside the engine": 0.699, "dispatch.inputs": 0.19, "dispatch.launch": 0.25,
           "kernel.launch": 0.05, "engine.readback": 0.25, "engine.admit": 0.15,
           "engine.step": 0.2}


def test_each_marked_stamp_pairs_with_its_marker():
    run = hand_run()
    assert run.span_clock == pytest.approx([(0.9, 100.9), (1.1, 101.1), (1.6, 101.6),
                                            (3.0, 103.0)])
    del run.span_marks[1]                             # the second marker lost
    assert spans.clock_pairs(run) == pytest.approx([run.span_clock[k] for k in (0, 2, 3)])


def test_a_markers_kernels_make_one_mark_of_their_count():
    class E:
        def __init__(self, t, c, dev):
            self.t, self.c, self.dev = t, c, dev
        def correlation_id(self): return self.c
        def start_ns(self): return int(self.t * 1e9)
        def device_type(self): return DeviceType.CUDA if self.dev else DeviceType.CPU
        def name(self): return "at::cuda::spin_kernel(long)" if self.dev else "cudaLaunchKernel"

    from torch.autograd import DeviceType
    launches = [(1.0, 1), (1.000004, 2), (1.5, 3), (1.500005, 4), (1.50001, 5), (2.0, 6)]
    evs = [E(t, c, False) for t, c in launches] + [E(t + 1e-5, c, True) for t, c in launches]
    prof = type("P", (), {"profiler": type("K", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: evs)})})})
    assert spans.marker_launches(prof) == [(1.0, 1), (1.5, 2), (2.0, 0)]


def decode_like(n=60, lost=(0, 1, 30), jump_at=40, jump=6.6e-3):
    """Marked stamps every ~11 ms (jittered by up to 0.15 ms), the trace's
    clock 100 s ahead and, from the ``jump_at``-th on, ``jump`` s more; the
    trace lacks the ``lost`` markers; each launch 4 us after its stamp."""
    import random
    rng = random.Random(3)
    stamps, t = [], 1.0
    for _ in range(n):
        stamps.append(t)
        t += 0.011 + rng.uniform(-1.5e-4, 1.5e-4)
    run = harness.Run({}, {}, {}, {}, 5.0)
    run.spans = [S("dispatch.launch", h, h + 0.009) for h in stamps]
    run.span_marks = [(h + 100 + 4e-6 + (jump if k >= jump_at else 0.0), code(k))
                      for k, h in enumerate(stamps) if k not in lost]
    return run, stamps


def test_pairs_survive_lost_markers_and_a_jump_of_the_trace_clock():
    run, stamps = decode_like()
    pairs = spans.clock_pairs(run)
    assert [h for h, _ in pairs] == [h for k, h in enumerate(stamps) if k not in (0, 1, 30)]
    run.span_clock = pairs
    host = spans.to_host(run)
    assert host(stamps[10] + 100 + 4e-6 + 0.005) == pytest.approx(stamps[10] + 0.005, abs=1e-9)
    assert host(stamps[45] + 100.0066 + 4e-6 + 0.002) == pytest.approx(stamps[45] + 0.002,
                                                                       abs=1e-9)


def test_pairs_follow_a_clock_drifting_between_distant_marks():
    """Marks ~150 ms apart on a trace clock that gains 2.5 ms a second."""
    import random
    rng, hs = random.Random(1), [1.0]
    for _ in range(79):
        hs.append(hs[-1] + 0.15 + rng.uniform(-0.02, 0.02))
    run = harness.Run({}, {}, {}, {}, 5.0)
    run.spans = [S("dispatch.launch", h, h + 0.1) for h in hs]
    run.span_marks = [(h + 100 + 0.0025 * (h - 1.0), code(k))
                      for k, h in enumerate(hs) if k not in (0, 5)]
    assert [h for h, _ in spans.clock_pairs(run)] == [h for k, h in enumerate(hs)
                                                       if k not in (0, 5)]


def test_no_marks_no_clock():
    run, _ = decode_like()
    run.span_marks = []
    assert spans.clock_pairs(run) == [] and spans.to_host(run) is None


def test_idle_by_innermost_span():
    run = hand_run()
    got = spans.idle_by_span(run)
    assert got == pytest.approx(BY_SPAN)
    assert sum(got.values()) == pytest.approx(devtrace.busy_s(
        [(a, b, "") for a, b in devtrace.idle_gaps(run.events)]))


@pytest.mark.parametrize("metric, want", [
    ("queue_wait_ms.open", (0.5 + 1.2) / 2 * 1e3),
    ("admit_span_ms.open", (0.5 + 0.2) / 2 * 1e3),
    ("admit_span_ms.batch", (0.5 + 0.2) / 2 * 1e3),
    ("decode_launch_ms.open", 0.2 * 1e3),
    ("decode_launch_ms.batch", 0.2 * 1e3),
    ("idle_in_launch.open", (0.25 + 0.05) / sum(BY_SPAN.values()) * 100),
    ("idle_in_launch.batch", (0.25 + 0.05) / sum(BY_SPAN.values()) * 100),
])
def test_readers_on_the_hand_built_run(metric, want):
    assert harness.reader(metric)(hand_run()) == pytest.approx(want)


@pytest.mark.parametrize("entry", ENTRIES, ids=lambda m: m["name"])
def test_readers_find_nothing_in_a_run_without_spans(entry):
    run = hand_run()
    del run.spans, run.span_clock
    assert harness.reader(entry["name"])(run) is None


def test_without_a_clock_only_the_idle_share_is_missing():
    run = hand_run()
    run.span_clock = []
    assert harness.reader("idle_in_launch.open")(run) is None
    assert spans.idle_by_span(run) is None and spans.first_op_leads(run) == []
    assert harness.reader("decode_launch_ms.open")(run) == pytest.approx(200.0)


def test_checks_of_the_clock_and_steps():
    run = hand_run()
    assert spans.first_op_leads(run) == pytest.approx([0.05])   # skips the copy at 1.52
    assert spans.quiet_step_ms(run) is None                     # every step admitted
    assert spans.spans_per_quiet_step(run) is None
    rep = spans.report(run)
    assert rep["stamps"] == rep["markers"] == rep["clock_pairs"] == 4
    assert rep["anchor_offsets_paired"] == 2
    assert rep["anchor_offset_change_us"] == pytest.approx(0.0, abs=1e-6)
    assert rep["ms_by_span"]["engine.step"] == pytest.approx([2, 1400.0, 200.0])
    assert rep["decode_dispatch_ms"] == pytest.approx({
        "engine.dispatch": 300.0, "dispatch.inputs": 100.0, "dispatch.launch": 200.0,
        "kernel.launch": 0.0, "engine.readback": 200.0})
    assert rep["prefill_dispatch_ms"] == pytest.approx({
        "engine.dispatch": 400.0, "dispatch.inputs": 100.0, "dispatch.launch": 300.0,
        "kernel.launch": 100.0, "engine.readback": 0.0})
    assert list(rep["idle_ms_by_innermost_span"])[0] == "outside the engine"


def test_innermost_pieces_cover_the_spans_in_order():
    sp = [S("a", 0.0, 4.0), S("b", 1.0, 2.0, 0), S("c", 2.0, 3.0, 0), S("z", 3.5, 3.5, 0)]
    assert spans.innermost(sp) == [(0.0, 1.0, 0), (1.0, 2.0, 1), (2.0, 3.0, 2), (3.0, 4.0, 0)]


@pytest.mark.parametrize("entry", ENTRIES, ids=lambda m: m["name"])
def test_span_metric_entries_keep_to_the_contract(entry):
    assert set(entry) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert entry["name"] not in {m["name"] for k in ("end_to_end", "per_layer") for m in SPEC[k]}
    assert entry["source"] == "program_span" and entry["better"] in ("lower", "higher")
    assert entry["layer"] in {m["layer"] for m in SPEC["per_layer"]}
    for cell in entry["workloads"]:
        assert cell in E2E[entry["moves"]].get("workloads", [cell])
    assert callable(harness.reader(entry["name"]))


def test_recording_leaves_the_harness_as_it_was():
    before = harness.serve, devtrace.start, devtrace.stop
    with spans.recording() as runs:
        assert harness.serve is not before[0]
    assert (harness.serve, devtrace.start, devtrace.stop) == before and runs == []


@pytest.mark.parametrize("cell", ["mixtral.chat", "minicpm3.docqa"])
def test_a_recorded_run_on_the_cpu_reports_the_span_metrics(cell, monkeypatch):
    monkeypatch.setattr(devtrace, "start", lambda: None)
    monkeypatch.setattr(devtrace, "stop", lambda prof: [])
    result, _ = spans.execute(cell, tiny.SEED, tiny.SECONDS, "cpu", tiny.overrides(cell))
    m = result["metrics"]
    want = {e["name"] for e in ENTRIES if cell in e["workloads"]}
    idle = {n for n in want if n.startswith("idle_in_launch")}
    assert idle and want - idle <= set(m) and not idle & set(m)   # no anchor on the CPU
    suffix = "open" if cell == "mixtral.chat" else "batch"
    assert m[f"admit_span_ms.{suffix}"]["value"] <= m[f"admit_ms.{suffix}"]["value"]
    rep = result["spans"]
    assert rep["quiet_step_span_ms"] <= m[f"decode_step_ms.{suffix}"]["value"]
    assert rep["counters"]["dispatch.decode"] == rep["ms_by_span"]["engine.dispatch"][0] \
        - rep["counters"]["dispatch.prefill"]
    assert rep["clock_pairs"] == 0 and rep["idle_ms_by_innermost_span"] is None

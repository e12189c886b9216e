"""The port's recorder (``repro_torch.telemetry``) and the spans the serving
path records, on reduced configs on the CPU: off records nothing and serves
the same tokens as on, the spans nest and count what the engine counts, the
pool's spans carry its own timers, and ``launch/serve.py --trace`` prints
the table."""
import dataclasses

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_config
from repro_torch.core.plan import Plan, ReplicaGroup, default_stage_cuts
from repro_torch.core.policy import render_policy
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving.backend import make_torch_backend
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.sharded import PipelinedEngine

torch.set_num_threads(1)

# (arch, engine keywords): the paged pool, the contiguous cache in chunks and
# token by token, the SSM state, a two-stage pipeline
KINDS = {
    "paged": ("qwen2-1.5b", {}),
    "contiguous": ("qwen2-1.5b", {"paged": False}),
    "per_token": ("qwen2-1.5b", {"paged": False, "chunked_prefill": False}),
    "ssm": ("mamba2-1.3b", {}),
    "pipelined": ("qwen2-1.5b", {"pp": 2}),
}
SHARED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4]


@pytest.fixture(autouse=True)
def recorder_off():
    telemetry.disable()
    yield
    telemetry.disable()


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen2-1.5b", "mamba2-1.3b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        out[arch] = cfg, lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return out


def engine(models, kind, **kw):
    arch, opts = KINDS[kind]
    cfg, model = models[arch]
    opts = {**opts, **kw}
    pp = opts.pop("pp", None)
    if pp:
        return PipelinedEngine(cfg, model, default_stage_cuts(cfg.n_layers, pp),
                               device="cpu", n_slots=3, max_seq_len=64, **opts)
    return Engine(cfg, model, device="cpu", n_slots=3, max_seq_len=64, **opts)


def requests():
    """Five requests on three slots, so admissions and decode interleave;
    the later ones share the first one's 16-token prefix."""
    prompts = [SHARED, [7, 7, 2], SHARED + [1, 2, 3], SHARED[:18], [4] * 11]
    return [Request(rid=10 + i, prompt=list(p), max_new_tokens=4 + i % 3)
            for i, p in enumerate(prompts)]


def drain(eng, reqs):
    for r in reqs[:3]:
        eng.submit(r)
    eng.step()
    for r in reqs[3:]:
        eng.submit(r)
    return {st.request.rid: list(st.generated) for st in eng.run_until_drained()}


def recorded(models, kind, **kw):
    eng = engine(models, kind, **kw)
    telemetry.enable()
    tokens = drain(eng, requests())
    return eng, tokens, telemetry.disable()


def parent_chain(sp, s):
    out, i = [], s.parent
    while i >= 0:
        out.append(sp[i])
        i = sp[i].parent
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_off_records_nothing_and_on_serves_the_same_tokens(models, kind):
    tokens_off = drain(engine(models, kind), requests())
    assert telemetry.REC is None and telemetry.disable() is None
    _, tokens_on, rec = recorded(models, kind)
    assert tokens_on == tokens_off
    assert rec.spans and all(s.t1 is not None for s in rec.spans)


@pytest.mark.parametrize("kind", list(KINDS))
def test_spans_nest(models, kind):
    _, _, rec = recorded(models, kind)
    sp = rec.spans
    for s in sp:
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1, (s, p)
        names = [p.name for p in parent_chain(sp, s)]
        if s.name.startswith("dispatch."):
            assert names[0] == "engine.dispatch"
        if s.name in ("engine.dispatch", "engine.admit", "engine.readback", "engine.retire"):
            assert "engine.step" in names, (s.name, names)
        if s.name == "engine.step":
            assert names == []
        if s.name in ("engine.admit", "engine.prefix_match", "engine.retire"):
            assert s.rid in {r.rid for r in requests()}
    kinds = {(s.attrs or {}).get("kind") for s in sp if s.name == "engine.dispatch"}
    assert kinds == {"prefill", "decode"}
    staged = kind == "pipelined"
    assert any(s.name == "dispatch.launch" for s in sp) != staged


@pytest.mark.parametrize("kind", list(KINDS))
def test_dispatch_spans_count_what_the_engine_counts(models, kind):
    eng, _, rec = recorded(models, kind)
    sp, c = rec.spans, rec.counters
    dispatches = [s for s in sp if s.name == "engine.dispatch"]
    assert len(dispatches) == eng.dispatches
    assert c["dispatch.prefill"] + c["dispatch.decode"] == eng.dispatches
    assert c["dispatch.decode"] == sum(s.name == "engine.step" and s.attrs["live"] > 0
                                       for s in sp)
    admits = {s.rid: s for s in sp if s.name == "engine.admit"}
    states = {st.request.rid: st for st in eng.finished}
    assert sorted(admits) == sorted(states)
    for rid, st in states.items():
        a = admits[rid].attrs
        assert a["chunks"] == st.prefill_dispatches
        assert a["prompt"] == len(st.request.prompt)
    assert c["tokens.prefilled"] == sum(a.attrs["prompt"] - a.attrs["matched"]
                                        for a in admits.values())
    steps = [s for s in sp if s.name == "engine.step"]
    assert sum(s.attrs["admitted"] for s in steps) == len(admits)


@pytest.mark.parametrize("kind", ["paged", "pipelined"])
def test_tokens_matched_sum_to_prefix_tokens_saved(models, kind):
    eng, _, rec = recorded(models, kind)
    admits = [s for s in rec.spans if s.name == "engine.admit"]
    matched = sum(s.attrs["matched"] for s in admits)
    assert matched == eng.prefix_tokens_saved > 0
    matches = [s for s in rec.spans if s.name == "engine.prefix_match"]
    assert sorted(s.rid for s in matches) == sorted(s.rid for s in admits)


def test_step_span_ends_on_the_health_stamp(models):
    eng = engine(models, "paged")
    telemetry.enable()
    drain(eng, requests())
    eng.submit(Request(rid=99, prompt=[5, 6, 7], max_new_tokens=1))
    eng.step()                           # admits and retires: nothing to decode
    rec = telemetry.disable()
    steps = [s for s in rec.spans if s.name == "engine.step"]
    assert steps[-1].attrs == {"admitted": 1, "live": 0}
    assert all(s.attrs["live"] > 0 for s in steps[:-1])


@pytest.mark.parametrize("mode", ["migrate", "drain"])
def test_pool_spans_carry_the_reconfiguration_timers(mode):
    backend = make_torch_backend("qwen2-1.5b", seed=0, device="cpu", max_seq_len=64,
                                 slots_cap=4, max_replicas_per_group=1)
    model = backend.cfg.name
    backend.apply_plan(Plan((ReplicaGroup(model, "H100-80G", tp=1, batch=4, count=1),)), None)
    if mode != "drain":
        backend.set_reconfig_policy(render_policy(
            {"domains": ["placement", "reconfig"], "migration_mode": mode},
            name=mode).reconfig_policy())
    for r in range(3):
        backend.pool.submit(model, Request(rid=r, prompt=[1 + r, 2, 3, 4, 5], max_new_tokens=6))
    for eng in backend.pool.engines:
        eng.step()
    telemetry.enable()
    diff = backend.pool.reconfigure(
        Plan((ReplicaGroup(model, "H100-80G", tp=1, batch=2, count=1),)))
    rec = telemetry.disable()
    [top] = [s for s in rec.spans if s.name == "pool.reconfigure"]
    assert top.parent == -1 and top.t1 - top.t0 == diff.wall_s
    migrates = [s for s in rec.spans if s.name == "pool.migrate"]
    drains = [s for s in rec.spans if s.name == "pool.drain"]
    assert len(migrates) == (diff.migrated_requests if mode == "migrate" else 0)
    assert sum(s.t1 - s.t0 for s in migrates) == pytest.approx(diff.migrate_wall_s, abs=1e-12)
    assert sum(s.t1 - s.t0 for s in drains) == pytest.approx(diff.drain_wall_s, abs=1e-12)
    assert all(s.parent >= 0 and rec.spans[s.parent] is top for s in migrates + drains)
    if mode == "drain":
        assert drains and diff.drained_requests == 3
        inner = [s for s in rec.spans if s.name == "engine.step"]
        assert inner and all(drains[0] in parent_chain(rec.spans, s) for s in inner)
    else:
        assert diff.migrated_requests == 2 and migrates


def test_serve_trace_prints_the_span_table(capsys):
    assert serve.main(["--device", "cpu", "--requests", "4", "--max-new", "4",
                       "--resize", "--reconfig", "migrate", "--trace"]) == 0
    out = capsys.readouterr().out
    table = out[out.index("span "):].splitlines()
    names = {line.split()[0] for line in table[1:] if not line.startswith("counter")}
    assert {"engine.step", "engine.admit", "engine.dispatch", "dispatch.inputs",
            "dispatch.launch", "engine.readback", "engine.retire",
            "pool.reconfigure", "pool.migrate"} <= names
    assert any(line.startswith("counter dispatch.decode ") for line in table)
    assert telemetry.REC is None


def test_serve_without_trace_prints_no_table(capsys):
    assert serve.main(["--device", "cpu", "--requests", "2", "--max-new", "2"]) == 0
    assert "span " not in capsys.readouterr().out


def test_anchor_records_nothing_off_or_without_a_card(monkeypatch):
    assert telemetry.anchor() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    telemetry.enable(["dispatch.launch"])
    assert telemetry.REC.marker is None and telemetry.anchor() is None
    assert telemetry.disable().spans == []


def test_marked_spans_and_anchors_enqueue_a_marker_after_their_stamp(models, monkeypatch):
    """A counting stand-in for the device marker: every ``dispatch.launch``
    span and every anchor enqueues one, and nothing else does."""
    launched = []
    monkeypatch.setattr(telemetry, "device_marker",
                        lambda: lambda code: launched.append((telemetry.time.monotonic(), code)))
    eng = engine(models, "paged")
    telemetry.enable(["dispatch.launch"])
    t = telemetry.anchor()
    drain(eng, requests())
    rec = telemetry.disable()
    marked = [s for s in rec.spans if s.name in ("anchor", "dispatch.launch")]
    assert marked[0].t0 == t and len(launched) == len(marked) == eng.dispatches + 1
    assert all(s.t0 <= m for s, (m, _) in zip(marked, launched))
    assert all(m < s.t1 for s, (m, _) in zip(marked[1:], launched[1:]))
    assert [c for _, c in launched] == [k % telemetry.MARKER_CODES for k in range(len(marked))]


def test_a_span_an_exception_left_open_is_closed_with_its_parent():
    rec = telemetry.enable()
    outer = rec.begin("outer", 1.0)
    rec.begin("inner", 2.0)              # never ended
    rec.end(outer, 5.0, {"n": 3})
    after = rec.begin("after", 6.0)
    rec.end(after, 7.0)
    out = telemetry.disable()
    assert [tuple(s) for s in out.spans] == [("outer", 1.0, 5.0, -1, None, {"n": 3}),
                                              ("inner", 2.0, None, 0, None, None),
                                              ("after", 6.0, 7.0, -1, None, None)]
    assert telemetry.by_name(out.spans) == {"outer": [1, 4.0, 4.0], "after": [1, 1.0, 1.0]}


def test_self_time_leaves_out_children_and_disable_returns_a_copy():
    rec = telemetry.enable()
    a = rec.begin("a", 0.0, rid=7)
    for t in (1.0, 4.0):
        rec.end(rec.begin("b", t), t + 2.0)
    rec.end(a, 10.0)
    rec.count("n")
    rec.count("n", 4)
    out = telemetry.disable()
    assert telemetry.REC is None
    assert telemetry.by_name(out.spans) == {"a": [1, 10.0, 6.0], "b": [2, 4.0, 4.0]}
    assert out.counters == {"n": 5} and out.spans[0].rid == 7
    rec.end(rec.begin("late", 11.0), 12.0)   # a site that still holds the live record
    assert len(out.spans) == 3
    lines = telemetry.table(out).splitlines()
    assert lines[1].split()[:2] == ["a", "1"] and lines[-1] == "counter n 5"

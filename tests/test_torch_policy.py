"""The port's policy program (``repro_torch.core.policy``, ``schedulers``
and ``plan``), held to the JAX package's copies: every seed policy and
every genome ``launch/serve.py`` renders gives byte-identical source, and
each hook gives the same output on the same context.

The placement hooks run over the reference's roofline simulator (the port
has no simulator yet); each framework's context holds its own plan types.
The schedulers' branch-and-bound searches have wall-clock deadlines, so
they are compared on inputs whose search ends well before the deadline
(``BnBStats.timed_out`` is checked).  The copies are held to the
reference's outputs, not to the load-sensitive quality tests.
"""
import dataclasses
import itertools
import os
import random
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro.core import plan as jplan
from repro.core import policy as jpolicy
from repro.core import schedulers as jsched
from repro.core.simulator import Simulator
from repro.serving.engine import FailureCtx
from repro.serving.engine import MigrationCtx as JMigrationCtx
from repro.serving.engine import RequestCtx as JRequestCtx
from repro.serving.kvcache import KVCacheCtx as JKVCacheCtx
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.core import plan as tplan
from repro_torch.core import policy as tpolicy
from repro_torch.core import schedulers as tsched
from repro_torch.serving.engine import MigrationCtx as TMigrationCtx
from repro_torch.serving.engine import RequestCtx as TRequestCtx
from repro_torch.serving.kvcache import KVCacheCtx as TKVCacheCtx

ROOT = Path(__file__).resolve().parents[1]

# genomes launch/serve.py renders: --priority and --reconfig
SERVE_GENOMES = ([{"domains": ["placement", "request"], "priority_kind": k}
                  for k in ("fifo", "sjf", "slo-aware")]
                 + [{"domains": ["placement", "reconfig"], "migration_mode": m}
                    for m in ("drain", "migrate", "recompute")])
EVERY_DOMAIN = {"domains": ["placement", "request", "reconfig", "kv_cache", "recovery"],
                "scheduler": "hybrid", "time_budget": 5.0, "replica_dp": 2,
                "replica_pp": 2, "stage_balance": "rear-light",
                "priority_kind": "slo-aware", "admit_load_cap": 1.5,
                "migration_mode": "migrate", "migrate_min_progress": 0.3,
                "kv_evict_kind": "pin-hot", "kv_pin_hits": 3,
                "recovery_mode": "salvage", "retry_budget": 2}


def _both(fw_plan, workloads, cluster, current=None, **kw):
    """A Ctx of one framework over the qwen2.5 family and the reference
    simulator built on that framework's model specs and hardware."""
    models = {m.name: m for m in fw_plan.QWEN25_FAMILY.values()}
    sim = Simulator(models, fw_plan.HARDWARE)
    return fw_plan.Ctx(time=0.0, timestamp_idx=0,
                       workloads=[fw_plan.Workload(*w) for w in workloads],
                       cluster=fw_plan.ClusterState(tuple(cluster)),
                       current_plan=current, models=models, hardware=fw_plan.HARDWARE,
                       simulator=sim, **kw)


def _plan_of(fw_plan, groups):
    return fw_plan.Plan(tuple(fw_plan.ReplicaGroup(*g) for g in groups))


def _t(plan):
    """A plan as plain tuples, comparable across frameworks."""
    return None if plan is None else tuple(dataclasses.astuple(g) for g in plan.groups)


# (workloads, cluster) small enough for every search to finish in time
CONTEXTS = [
    ([("qwen2.5-1.5b", 32, 512, 128), ("qwen2.5-7b", 64, 128, 1024)],
     [("H100-80G", 8), ("A100-80G", 4)]),
    ([("qwen2.5-14b", 16, 512, 1024), ("qwen2.5-72b", 8, 128, 128),
      ("qwen2.5-3b", 128, 128, 128)], [("H100-80G", 16), ("H20-96G", 8)]),
    ([("qwen2.5-32b", 48, 512, 512)], [("A100-80G", 8), ("A100-40G", 8)]),
]
OLD_PLAN = [("qwen2.5-1.5b", "H100-80G", 1, 32, 1), ("qwen2.5-7b", "A100-80G", 2, 32, 2)]


def test_plan_helpers_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in tplan.HARDWARE.items()} == \
        {k: dataclasses.astuple(v) for k, v in jplan.HARDWARE.items()}
    for size in ("1.5B", "3B", "7B", "14B", "32B", "72B"):
        a, b = tplan.qwen25(size), jplan.qwen25(size)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert (a.weight_bytes, a.kv_bytes_per_token, a.active_ffn_factor) == \
            (b.weight_bytes, b.kv_bytes_per_token, b.active_ffn_factor)
    from repro.configs import get_config as jget_config
    for arch in tlist_archs():
        assert dataclasses.astuple(tplan.spec_from_config(tget_config(arch))) == \
            dataclasses.astuple(jplan.spec_from_config(jget_config(arch)))
    for n, pp, bal in itertools.product((1, 3, 4, 7, 28, 80), (1, 2, 3, 4, 8),
                                        ("even", "front-light", "rear-light")):
        cuts = tplan.default_stage_cuts(n, pp, bal)
        assert cuts == jplan.default_stage_cuts(n, pp, bal)
        for c in (cuts, (0,) * max(pp - 1, 0), tuple(range(1, pp))):
            assert tplan.valid_stage_cuts(n, pp, c) == jplan.valid_stage_cuts(n, pp, c)
    tc, jc = _both(tplan, *CONTEXTS[1]), _both(jplan, *CONTEXTS[1])
    tc.last_resched_workloads = tc.workloads[:1]
    jc.last_resched_workloads = jc.workloads[:1]
    assert tc.workload_shift() == jc.workload_shift()
    assert tc.cluster.total == jc.cluster.total and tc.cluster.types() == jc.cluster.types()
    p, q = _plan_of(tplan, OLD_PLAN), _plan_of(jplan, OLD_PLAN)
    assert p.placement("qwen2.5-7b") == q.placement("qwen2.5-7b")
    assert p.devices_used() == q.devices_used()


def test_seed_policies_render_byte_identical_source():
    t, j = tpolicy.seed_policies(), jpolicy.seed_policies()
    assert list(t) == list(j) and len(t) == 15
    for name in t:
        assert t[name].source == j[name].source, name
        assert t[name].genome == j[name].genome
        assert t[name].compile().domains == j[name].compile().domains
        assert t[name].api_version == j[name].api_version == 2


@pytest.mark.parametrize("genome", SERVE_GENOMES + [EVERY_DOMAIN, {}],
                         ids=lambda g: "-".join(f"{v}" for v in g.values()) or "default")
def test_rendered_genomes_are_byte_identical(genome):
    t = tpolicy.render_policy(genome, name="g")
    j = jpolicy.render_policy(genome, name="g")
    assert t.source == j.source and t.genome == j.genome
    assert tpolicy.parse_genome(t.source) == jpolicy.parse_genome(j.source)
    assert t.compile().domains == j.compile().domains


def test_hot_path_hooks_give_the_reference_outputs():
    """request, reconfig, kv_cache and recovery hooks of every seed and of
    a program with every domain, over a grid of contexts."""
    progs = [(tpolicy.render_policy(EVERY_DOMAIN), jpolicy.render_policy(EVERY_DOMAIN))]
    ts, js = tpolicy.seed_policies(), jpolicy.seed_policies()
    progs += [(ts[k], js[k]) for k in ts]
    progs += [(tpolicy.render_policy(g), jpolicy.render_policy(g)) for g in SERVE_GENOMES]
    rctx = [dict(rid=1, prompt_len=p, max_new_tokens=n, age_s=a, queue_depth=q,
                 active=act, n_slots=s)
            for p, n, a, q, act, s in itertools.product((3, 200), (4, 64), (0.0, 0.9, 3.5),
                                                        (0, 7), (0, 4), (1, 8))]
    mctx = [dict(rid=1, prompt_len=p, generated=g, remaining=r, position=p + g)
            for p, g, r in itertools.product((5, 100), (0, 3, 40), (0, 12))]
    kctx = [dict(prefix_pages=pp, prompt_len=pl, hits=h, idle_s=i, pool_free=3,
                 pool_total=17)
            for pp, pl, h, i in itertools.product((0, 1, 2, 5), (0, 64), (0, 2, 9),
                                                  (0.0, 4.25))]
    fctx = [FailureCtx(rid=1, prompt_len=9, generated=g, remaining=5, retries=r,
                       exportable=e, survivors=1, free_slots=2, queue_depth=0)
            for g, r, e in itertools.product((0, 7), (0, 1, 2, 5), (True, False))]
    calls = 0
    for tp, jp in progs:
        tp.compile(), jp.compile()
        assert tp.domains == jp.domains
        if "request" in tp.domains:
            a, b = tp.request_policy(), jp.request_policy()
            assert a.preempt == b.preempt
            for c in rctx:
                assert a.admit(TRequestCtx(**c)) == b.admit(JRequestCtx(**c))
                assert a.prioritize(TRequestCtx(**c)) == b.prioritize(JRequestCtx(**c))
                calls += 2
        if "reconfig" in tp.domains:
            a, b = tp.reconfig_policy(), jp.reconfig_policy()
            assert a.may_migrate == b.may_migrate
            for c in mctx:
                assert a.migration_mode(TMigrationCtx(**c)) == b.migration_mode(JMigrationCtx(**c))
                calls += 1
        if "kv_cache" in tp.domains:
            a, b = tp.kv_cache_policy(), jp.kv_cache_policy()
            for c in kctx:
                assert a.cache_prefix(TKVCacheCtx(**c)) == b.cache_prefix(JKVCacheCtx(**c))
                assert a.evict_priority(TKVCacheCtx(**c)) == b.evict_priority(JKVCacheCtx(**c))
                calls += 2
        if "recovery" in tp.domains:
            a, b = tp.recovery_policy(), jp.recovery_policy()
            assert {k: v for k, v in vars(a).items() if k != "mode_fn"} == \
                {k: v for k, v in vars(b).items() if k != "mode_fn"}
            for c in fctx:
                assert a.on_failure(c) == b.on_failure(c)
                calls += 1
        for d in ("request", "reconfig", "kv_cache", "recovery"):
            getter = f"{d}_policy"
            assert (getattr(tp, getter)() is None) == (getattr(jp, getter)() is None)
    assert calls > 1000


@pytest.mark.parametrize("ctx_i", range(len(CONTEXTS)))
@pytest.mark.parametrize("seed", sorted(jpolicy.seed_policies()))
def test_placement_hooks_give_the_reference_plans(seed, ctx_i):
    """``should_reschedule`` and ``schedule`` of each seed on a cold start
    and against a current plan, after a cluster change and a load shift."""
    tp, jp = tpolicy.seed_policies()[seed], jpolicy.seed_policies()[seed]
    if "placement" not in jp.compile().domains:
        with pytest.raises(tpolicy.PolicyDomainError):
            tp.schedule(None)
        return
    ws, cl = CONTEXTS[ctx_i]
    for current in (None, OLD_PLAN):
        for shift in (False, True):
            ctxs = []
            for fw in (tplan, jplan):
                c = _both(fw, ws, cl, None if current is None else _plan_of(fw, current))
                if shift:
                    c.last_resched_workloads = [fw.Workload(w.model, w.batch * 2, w.prefill_len,
                                                            w.decode_len) for w in c.workloads]
                    c.last_resched_cluster = fw.ClusterState((("H100-80G", 1),))
                    c.scratch["steps_since_resched"] = 1
                ctxs.append(c)
            assert tp.should_reschedule(ctxs[0]) == jp.should_reschedule(ctxs[1])
            assert _t(tp.schedule(ctxs[0])) == _t(jp.schedule(ctxs[1]))


@pytest.mark.parametrize("ctx_i", range(len(CONTEXTS)))
def test_schedulers_give_the_reference_plans(ctx_i):
    """greedy, branch-and-bound (searches that end before the deadline),
    the migration baselines and the dp/pp widening post-passes."""
    ws, cl = CONTEXTS[ctx_i]
    tc, jc = _both(tplan, ws, cl), _both(jplan, ws, cl)
    for scheme, het in itertools.product(("pow2", "sweet", "exhaustive"), (True, False)):
        assert _t(tsched.greedy_schedule(tc, batch_scheme=scheme, heterogeneity_aware=het)) == \
            _t(jsched.greedy_schedule(jc, batch_scheme=scheme, heterogeneity_aware=het))
    for scheme, split, weighted, floor in (("pow2", False, False, 0), ("sweet", True, True, 4),
                                           ("exhaustive", False, True, 0)):
        st_t, st_j = tsched.BnBStats(), jsched.BnBStats()
        kw = dict(deadline_s=60.0, batch_scheme=scheme, allow_split=split,
                  weighted_obj=weighted, tp_floor_large=floor)
        a, b = tsched.bnb_schedule(tc, stats=st_t, **kw), jsched.bnb_schedule(jc, stats=st_j, **kw)
        assert not st_t.timed_out and not st_j.timed_out
        assert _t(a) == _t(b) and (st_t.nodes, st_t.pruned) == (st_j.nodes, st_j.pruned)
        for dp in (2, 4):
            assert _t(tsched.apply_replica_dp(a, tc, dp)) == _t(jsched.apply_replica_dp(b, jc, dp))
        for pp, bal in ((2, "even"), (4, "front-light")):
            assert _t(tsched.apply_replica_pp(a, tc, pp, bal)) == \
                _t(jsched.apply_replica_pp(b, jc, pp, bal))
    assert _t(tsched.full_migration(tc, deadline_s=60.0)) == \
        _t(jsched.full_migration(jc, deadline_s=60.0))
    for fw, c in ((tplan, tc), (jplan, jc)):
        c.current_plan = _plan_of(fw, OLD_PLAN)
    assert _t(tsched.minimal_migration(tc)) == _t(jsched.minimal_migration(jc))


def test_agentic_schedulers_give_the_reference_assignments():
    rng = random.Random(0)
    calls = [SimpleNamespace(workflow=i, call_idx=0, prefill_len=rng.randint(64, 512),
                             decode_len=rng.randint(16, 256)) for i in range(6)]
    out = []
    for s in (tsched, jsched):
        insts = lambda: ([s.AgenticInstance(f"p{i}", "prefill", 1000.0) for i in range(2)],
                         [s.AgenticInstance(f"d{i}", "decode", 400.0) for i in range(2)])
        out.append([dataclasses.astuple(a) for a in s.agentic_greedy(calls, *insts())]
                   + [dataclasses.astuple(a) for a in s.agentic_bnb(calls, *insts(),
                                                                    deadline_s=60.0)])
    assert out[0] == out[1]


def test_restricted_namespaces_match_reference():
    for d in (None, "placement", "request", "reconfig", "kv_cache", "recovery"):
        t, j = tpolicy.policy_namespace(d), jpolicy.policy_namespace(d)
        assert sorted(t) == sorted(j) and sorted(t["__builtins__"]) == sorted(j["__builtins__"])
    assert tpolicy.policy_namespace()["greedy_schedule"] is tsched.greedy_schedule
    assert tpolicy.DOMAINS == jpolicy.DOMAINS and tpolicy.DEFAULT_GENOME == jpolicy.DEFAULT_GENOME
    v1 = "def admit(r):\n    return True\n\n\ndef prioritize(r):\n    return 1.0\n"
    t = tpolicy.PolicyProgram(source=v1, name="v1").compile()
    assert t.domains == ("request",) and t.api_version == 1
    with pytest.raises(tpolicy.PolicyDomainError):
        t.schedule(None)
    with pytest.raises(ValueError, match="no known domain"):
        tpolicy.PolicyProgram(source="x = 1\n").compile()


def test_serve_cli_runs_priority_and_reconfig_without_the_reference():
    """``python -m repro_torch.launch.serve --device cpu --priority sjf
    --resize --reconfig migrate`` on the reduced default config, in a
    process that would fail on any import of ``repro`` or ``jax``."""
    guard = ("import sys, runpy\n"
             "class Block:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('repro', 'jax'):\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, Block())\n"
             "sys.argv = ['serve', '--device', 'cpu', '--priority', 'sjf', '--resize',\n"
             "            '--reconfig', 'migrate', '--requests', '4', '--max-new', '4']\n"
             "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", guard], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                            OMP_NUM_THREADS="1"), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "request policy: sjf admission order" in out.stdout
    assert "resize[migrate]" in out.stdout and "migrated=" in out.stdout
    assert "served 4 requests" in out.stdout

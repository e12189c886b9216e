"""The port's failure handling held to the JAX package's on reduced qwen2-1.5b
in f32 with the same weights: seeded fault schedules, ``EnginePool.fail``
with salvage / recompute / shed, retry budgets, straggler quarantine, and
``launch/serve.py --faults`` without the reference.

Both pools run ``chunked_prefill=False`` (one model shape per engine, so
each JAX engine compiles once); greedy tokens do not depend on the chunking.
Every comparison is exact: the same reports, counters and tokens.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.policy import RecoveryPolicy as JRecoveryPolicy
from repro.core.policy import render_policy as jrender_policy
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.faults import FaultInjector as JFaultInjector
from repro.serving.pool import EnginePool as JEnginePool
from repro.traces.workload import failure_schedule as jfailure_schedule
from repro_torch.configs import get_config as tget_config
from repro_torch.core.plan import Plan, ReplicaGroup
from repro_torch.core.policy import RecoveryPolicy as TRecoveryPolicy
from repro_torch.core.policy import render_policy as trender_policy
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.faults import FaultInjector as TFaultInjector
from repro_torch.serving.pool import EnginePool as TEnginePool
from repro_torch.traces.workload import FailureEvent
from repro_torch.traces.workload import failure_schedule as tfailure_schedule

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

# 3 slots a replica, two replicas: a killed replica's two in-flight slots
# meet one free slot on the survivor, so one is salvaged and one recomputed
GROUP = ReplicaGroup("m", "H100-80G", tp=1, batch=3, count=2)
PROMPTS = {0: [5, 9, 11, 4], 1: [7, 3, 8], 2: [2, 6, 10, 12, 3],
           3: [4, 4, 9, 1, 7, 2]}
MAX_NEW = 6


@pytest.fixture(scope="module")
def zoo():
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config("qwen2-1.5b").reduced(), dtype="float32")
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, tcfg, params, model


def _pool(zoo, port, genome=None):
    jcfg, tcfg, params, model = zoo
    if port:
        pool = TEnginePool(lambda g: TEngine(
            tcfg, model, n_slots=max(1, min(g.batch, 3)), max_seq_len=64,
            chunked_prefill=False, device="cpu"))
        render = trender_policy
    else:
        pool = JEnginePool(lambda g: JEngine(
            jcfg, params, n_slots=max(1, min(g.batch, 3)), max_seq_len=64,
            chunked_prefill=False))
        render = jrender_policy
    if callable(genome):                   # a hand-built hook (per package)
        pool.set_recovery_policy(genome(port))
    elif genome is not None:
        pool.set_recovery_policy(render(
            {"domains": ["placement", "recovery"], **genome},
            name="t").recovery_policy())
    pool.reconfigure(Plan((GROUP,)))
    return pool


def _serve(pool, port, injector=None, steps=3, heal=False):
    """Submit PROMPTS, step every engine and apply the injector's events for
    ``steps`` rounds (healing to the plan after each when asked), drain.
    Returns the reports, rid -> whole generated sequence (a continuation's
    earlier-life tokens ride in its prompt), and the shed rids."""
    req_cls = TRequest if port else JRequest
    for rid, p in PROMPTS.items():
        assert pool.submit("m", req_cls(rid=rid, prompt=list(p),
                                        max_new_tokens=MAX_NEW))
    if injector is not None:
        for i in range(steps):
            for eng in pool.engines:
                eng.step()
            injector.step(pool, i)
            if heal:
                pool.reconfigure(Plan((GROUP,)))
    pool.run_until_drained()
    tokens = {s.request.rid: list(s.request.prompt[len(PROMPTS[s.request.rid]):])
              + list(s.generated) for s in pool.finished}
    reports = [dataclasses.astuple(r) for r in pool.failure_log]
    return reports, tokens, sorted(r.rid for r in pool.shed_requests)


def _counters(inj):
    return (inj.kills, inj.skipped, inj.straggles, inj.restores, inj.denied,
            inj.cursor)


@pytest.mark.parametrize("kw", [
    {},
    {"n_events": 3, "horizon": 3, "kill_ratio": 1.0, "deny_export_rate": 0.0},
    {"n_events": 8, "horizon": 5, "kill_ratio": 0.3, "deny_export_rate": 1.0,
     "straggle_magnitude": (1.5, 9.0)},
])
def test_failure_schedule_is_the_reference_schedule(kw):
    for seed in range(20):
        ref = jfailure_schedule(seed, **kw)
        got = tfailure_schedule(seed, **kw)
        assert [dataclasses.astuple(e) for e in got] == \
            [dataclasses.astuple(e) for e in ref]


def test_seeded_kills_give_the_reference_reports_and_exact_tokens(zoo):
    """One seeded schedule, healed after every round: the same reports,
    injector counters and tokens as the JAX pool, no leaked page, and every
    salvaged or recomputed request ends with the tokens of an undisturbed
    run."""
    kw = dict(n_events=3, horizon=3, kill_ratio=1.0, deny_export_rate=0.0)
    genome = {"recovery_mode": "salvage", "retry_budget": 3,
              "backoff_base_s": 0.0}
    out = {}
    for port in (False, True):
        inj = (TFaultInjector if port else JFaultInjector).from_seed(3, **kw)
        pool = _pool(zoo, port, genome)
        out[port] = _serve(pool, port, inj, heal=True) + (_counters(inj),)
    assert out[True] == out[False]
    reports, tokens, shed, counters = out[True]
    assert counters[0] >= 2 and shed == []
    assert all(r[-1] == 0 for r in reports)                  # leaked_pages
    assert sum(r[2] for r in reports) >= 1                   # salvaged
    assert sum(r[3] for r in reports) >= 1                   # recomputed
    undisturbed = _serve(_pool(zoo, True), True)[1]
    assert tokens == undisturbed
    assert all(len(t) == MAX_NEW for t in tokens.values())


def test_denied_export_recomputes_and_a_spent_budget_sheds(zoo):
    """A kill that denies export recomputes every in-flight request; with a
    retry budget of 0 the pool's requeue sheds them (``retry_exhausted``).
    Port and JAX agree."""
    def spent(port):
        cls = TRecoveryPolicy if port else JRecoveryPolicy
        return cls(lambda f: "recompute", retry_budget=0)

    for genome, lost in (({"retry_budget": 3, "backoff_base_s": 0.0}, False),
                         (spent, True)):
        out = {}
        for port in (False, True):
            inj = (TFaultInjector if port else JFaultInjector).from_seed(
                1, n_events=1, horizon=2, kill_ratio=1.0, deny_export_rate=1.0)
            pool = _pool(zoo, port, genome)
            out[port] = _serve(pool, port, inj, steps=2) + (
                _counters(inj), pool.retry_exhausted)
        assert out[True] == out[False]
        (report,), tokens, shed, counters, exhausted = out[True]
        model, reason, salvaged, recomputed, requeued, n_shed, leaked = report
        assert counters[4] == 1 and salvaged == 0 and leaked == 0
        if lost:
            assert recomputed == 0 and n_shed == len(shed) == exhausted >= 1
            assert set(tokens) | set(shed) == set(PROMPTS)
        else:
            assert recomputed >= 1 and n_shed == 0 and shed == []
            assert sorted(tokens) == sorted(PROMPTS)


def test_straggler_quarantine_follows_fault_slowdown(zoo):
    """The recorded step time scales by ``fault_slowdown``: a replica slowed
    200x is quarantined (new work avoids it) and released once restored."""
    _, tcfg, _, model = zoo
    pool = TEnginePool(lambda g: TEngine(tcfg, model, n_slots=3, max_seq_len=64,
                                         chunked_prefill=False, device="cpu"),
                       max_replicas_per_group=3)
    pool.set_recovery_policy(trender_policy(
        {"domains": ["placement", "recovery"], "straggler_factor": 3.0},
        name="t").recovery_policy())
    pool.reconfigure(Plan((ReplicaGroup("m", "H100-80G", 1, 3, 3),)))
    inj = TFaultInjector(schedule=(FailureEvent(0, "straggle", 2,
                                                magnitude=200.0),))
    inj.step(pool, 0)
    slow = pool.engines[2]
    assert slow.fault_slowdown == 200.0 and inj.straggles == 1
    for e in pool.engines:
        e.submit(TRequest(rid=id(e) % 97, prompt=[3, 4, 5], max_new_tokens=40))
    for _ in range(5):
        for e in pool.engines:
            e.step()
        pool._detect_stragglers()
    assert pool.straggler_quarantines == 1
    assert id(slow) in pool._quarantined
    for rid in range(3):
        assert pool.submit("m", TRequest(rid=100 + rid, prompt=[1, 2],
                                         max_new_tokens=1))
    assert all(r.rid < 100 for r in slow.waiting)            # no new work
    slow.fault_slowdown = 1.0                    # restore: the EMA decays
    for _ in range(20):
        for e in pool.engines:
            e.step()
        pool._detect_stragglers()
    assert id(slow) not in pool._quarantined
    pool.run_until_drained()
    assert all(e.release_all_pages() == 0 for e in pool.engines)


def test_serve_cli_runs_faults_without_the_reference():
    """``python -m repro_torch.launch.serve --faults 0 --requests 6 --device
    cpu`` in a process that would fail on any import of ``repro`` or ``jax``:
    the seeded kill is contained with no leaked page and every request is
    served."""
    guard = ("import sys, runpy\n"
             "class Block:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('repro', 'jax'):\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, Block())\n"
             "sys.argv = ['serve', '--faults', '0', '--requests', '6',\n"
             "            '--device', 'cpu']\n"
             "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", guard], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "fault@step1: injected-kill" in out.stdout
    assert "served 6 requests" in out.stdout
    assert "leaked_pages=0" in out.stdout and "kills=1" in out.stdout

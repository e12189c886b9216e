"""The port's injectable clock held to the JAX package's: the pool stamps
arrivals and backoff windows with ``now_fn`` and waits them out with
``wait_fn``, and the engine reads ``_now`` at exactly the reference's three
sites (the request context, admission order and preemption); every other
engine stamp stays on the host clock."""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.plan import Plan as JPlan
from repro.core.plan import ReplicaGroup as JReplicaGroup
from repro.core.policy import RequestPolicy as JRequestPolicy
from repro.core.policy import render_policy as jrender_policy
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.pool import EnginePool as JEnginePool
from repro.serving.shadow import ShadowCosts as JShadowCosts
from repro.serving.shadow import ShadowEngine as JShadowEngine
from repro.serving.shadow import ShadowStats as JShadowStats
from repro_torch.configs import get_config as tget_config
from repro_torch.core.plan import Plan as TPlan
from repro_torch.core.plan import ReplicaGroup as TReplicaGroup
from repro_torch.core.policy import RequestPolicy as TRequestPolicy
from repro_torch.core.policy import render_policy as trender_policy
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.pool import EnginePool as TEnginePool
from repro_torch.serving.shadow import ShadowCosts as TShadowCosts
from repro_torch.serving.shadow import ShadowEngine as TShadowEngine
from repro_torch.serving.shadow import ShadowStats as TShadowStats

torch.set_num_threads(1)

PKG = {
    False: dict(Pool=JEnginePool, Engine=JEngine, Request=JRequest,
                Plan=JPlan, Group=JReplicaGroup, render=jrender_policy,
                RequestPolicy=JRequestPolicy, Shadow=JShadowEngine,
                Costs=JShadowCosts, Stats=JShadowStats),
    True: dict(Pool=TEnginePool, Engine=TEngine, Request=TRequest,
               Plan=TPlan, Group=TReplicaGroup, render=trender_policy,
               RequestPolicy=TRequestPolicy, Shadow=TShadowEngine,
               Costs=TShadowCosts, Stats=TShadowStats),
}


def _virtual_pool(port, genome):
    """A pool of virtually-costed engines on a virtual clock: ``waits``
    records every backoff wait and advances the clock by it."""
    k = PKG[port]
    clock = {"t": 5.0}
    waits = []

    def wait(dt):
        waits.append(dt)
        clock["t"] += dt

    stats = k["Stats"]()
    pool = k["Pool"](lambda g: k["Shadow"](
        g.model, n_slots=g.batch, max_seq_len=64,
        costs=k["Costs"](1e-3, 2e-3, 5e-4), stats=stats),
        now_fn=lambda: clock["t"], wait_fn=wait)
    pool.set_recovery_policy(k["render"](
        {"domains": ["placement", "recovery"], **genome},
        name="t").recovery_policy())
    return pool, clock, waits


@pytest.mark.parametrize("genome", [
    {"recovery_mode": "recompute", "backoff_base_s": 0.05, "backoff_cap_s": 1.0},
    {"recovery_mode": "salvage", "backoff_base_s": 0.3, "backoff_cap_s": 0.4,
     "retry_budget": 2},
])
def test_pool_stamps_and_waits_on_the_injected_clock(genome):
    out = {}
    for port in (False, True):
        k = PKG[port]
        pool, clock, waits = _virtual_pool(port, genome)
        plan = k["Plan"]((k["Group"]("m", "H100-80G", 1, 2, 2),))
        pool.reconfigure(plan)
        for rid in range(5):
            req = k["Request"](rid=rid, prompt=[2 + rid, 3, 4], max_new_tokens=6)
            if not pool.submit("m", req):
                pool.add_backlog("m", req)
            clock["t"] += 0.25
        late = k["Request"](rid=9, prompt=[7, 8], max_new_tokens=3)
        pool.add_backlog("m", late)                   # stamped on entry
        for eng in pool.engines:
            eng.step()
        reports, stamps = [], []
        for i in range(2):                            # kill, heal, kill again
            clock["t"] += 0.125
            reports.append(dataclasses.astuple(pool.fail(pool.engines[0])))
            stamps.append(sorted((r.rid, r.arrival_time, r.not_before,
                                  r.retries) for _, r in pool.backlog))
            if i == 0:
                pool.reconfigure(plan)
        pool.run_until_drained()
        done = sorted((s.request.rid, s.request.arrival_time,
                       s.request.not_before, s.request.retries,
                       len(s.generated) + s.prior_generated)
                      for s in pool.finished)
        out[port] = (reports, stamps, waits, done, clock["t"],
                     sorted(r.rid for r in pool.shed_requests))
    assert out[True] == out[False]
    reports, stamps, waits, done, _, _ = out[True]
    assert any(nb > 0.0 for s in stamps for _, _, nb, _ in s)   # backoff set
    assert waits                                       # ...and waited out
    assert {rid for rid, *_ in done} | set(out[True][-1]) == {0, 1, 2, 3, 4, 9}
    assert dict((rid, arr) for rid, arr, *_ in done).get(9, 6.25) == 6.25


def _engine_now_sites(port, zoo):
    """Serve through an engine whose ``_now`` is a virtual counter; record
    which function read it and what age each hook call saw."""
    k = PKG[port]
    cfg, params = zoo[port]

    class Clocked(k["Engine"]):
        def __init__(self, *a, **kw):
            self.sites = []
            self.vt = 100.0
            super().__init__(*a, **kw)

        def _now(self):
            self.sites.append(sys._getframe(1).f_code.co_name)
            self.vt += 1.0
            return self.vt

    ages = []
    rp = k["RequestPolicy"](lambda r: True,
                            lambda r: ages.append(r.age_s) or float(r.prompt_len),
                            preempt=True)
    kw = dict(n_slots=2, max_seq_len=48, chunked_prefill=False,
              request_policy=rp)
    if port:
        kw["device"] = "cpu"
    eng = Clocked(cfg, params, **kw)
    for rid, plen in ((0, 6), (1, 5), (2, 4), (3, 2)):
        eng.submit(k["Request"](rid=rid, prompt=list(range(1, plen + 1)),
                                max_new_tokens=4, arrival_time=50.0 + rid))
        eng.step()
    ctx = eng.request_ctx_for(k["Request"](rid=7, prompt=[1], arrival_time=90.0))
    reads = len(eng.sites)
    eng.run_until_drained()
    tokens = sorted((d.request.rid, tuple(d.generated)) for d in eng.finished)
    return eng.sites, ages, (ctx.age_s, reads), eng.preemptions, tokens


def test_engine_reads_the_clock_at_the_reference_sites():
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config("qwen2-1.5b").reduced(), dtype="float32")
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    zoo = {False: (jcfg, params), True: (tcfg, model)}
    ref = _engine_now_sites(False, zoo)
    got = _engine_now_sites(True, zoo)
    assert got == ref
    sites, ages, (age, reads), preemptions, _ = got
    assert set(sites) == {"request_ctx_for", "_select_admissions",
                          "_maybe_preempt"}
    assert preemptions >= 1 and ages
    assert age == 100.0 + reads - 90.0      # the context read the virtual clock

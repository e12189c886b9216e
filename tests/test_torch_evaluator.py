"""The port's roofline simulator and analytic rung held to the JAX
package's, compared exactly (``==``): the simulator's costs over the seed
policies' plans, and the ``Evaluator``'s fitness of every seed policy over
the volatile and stable traces.

Measured scheduling time is switched off on both sides
(``sched_time_scale=0.0``) and the candidate timeouts never fire, so
fitness carries no wall time.  On these traces (their own heterogeneous
cluster) every branch-and-bound search ends well before its deadline.
"""
import dataclasses
import itertools

import pytest

from repro.core import evaluator as jev
from repro.core import plan as jplan
from repro.core import policy as jpolicy
from repro.core import simulator as jsim
from repro.serving import backend as jbackend
from repro.serving import shadow as jshadow
from repro.traces import workload as jtraces
from repro_torch.core import evaluator as tev
from repro_torch.core import plan as tplan
from repro_torch.core import policy as tpolicy
from repro_torch.core import simulator as tsim
from repro_torch.serving import backend as tbackend
from repro_torch.serving import shadow as tshadow
from repro_torch.traces import workload as ttraces

FW = {True: (tplan, tsim, tev, tpolicy, tshadow, ttraces, tbackend),
      False: (jplan, jsim, jev, jpolicy, jshadow, jtraces, jbackend)}
TRACES = ("volatile_workload_trace", "stable_workload_trace")
SEEDS = sorted(jpolicy.seed_policies())


def _sim(port):
    plan = FW[port][0]
    models = {m.name: m for m in plan.QWEN25_FAMILY.values()}
    return FW[port][1].Simulator(models, plan.HARDWARE), models, plan.HARDWARE


def _t(plan):
    return None if plan is None else tuple(dataclasses.astuple(g) for g in plan.groups)


def _plan_in(port, plan_t):
    p = FW[port][0]
    return p.Plan(tuple(p.ReplicaGroup(*g) for g in plan_t))


def _result(r):
    """An EvalResult as plain values (records by their accounting terms)."""
    recs = tuple((x.timestamp_idx, x.rescheduled, x.t_sched, x.t_stale,
                  x.t_reconfig, x.t_serve, x.t_request, x.serve_full,
                  x.plan_changed) for x in r.records)
    return (r.fitness, r.N, r.sum_sched, r.sum_stale, r.sum_reconfig,
            r.sum_serve, r.error, r.backend, r.ttft_p95_s, r.backlogged, recs)


def test_simulator_costs_over_the_seed_policies_plans():
    """Every seed's cold-start plan on each trace's first observations,
    costed by both simulators: serve cost, feasibility, per-group latency
    and fit, prefill/decode times and every pairwise reconfiguration."""
    (ts, _, _), (js, _, _) = _sim(True), _sim(False)
    for name in TRACES:
        obs = getattr(ttraces, name)().observations
        plans = []
        for seed in SEEDS:
            pol = tpolicy.seed_policies()[seed]
            if "placement" not in pol.compile().domains:
                continue
            for o in obs[:1]:
                ctx = tev.Evaluator(ts, ts.models, ts.hardware).make_ctx(
                    ttraces.Trace("t", (o,), ()), 0, None, None, None, {})
                plans.append(_t(pol.schedule(ctx)))
        assert len(set(plans)) >= 2
        for pt, o in itertools.product(sorted(set(plans)), obs[:3]):
            a, b = _plan_in(True, pt), _plan_in(False, pt)
            wt = list(o.workloads)
            wj = [jplan.Workload(*dataclasses.astuple(w)) for w in wt]
            cj = jplan.ClusterState(o.cluster.gpus)
            assert ts.serve_cost(a, wt) == js.serve_cost(b, wj)
            assert ts.plan_feasible(a, o.cluster, wt) == js.plan_feasible(b, cj, wj)
            for wa, wb in zip(wt, wj):
                assert ts.model_latency(a, wa) == js.model_latency(b, wb)
            for g in pt:
                model, gpu, tp, batch = g[:4]
                assert ts.group_latency(model, gpu, tp, batch, 256, 1024) == \
                    js.group_latency(model, gpu, tp, batch, 256, 1024)
                assert ts.fits(model, gpu, tp, batch, 2048) == \
                    js.fits(model, gpu, tp, batch, 2048)
                assert ts.weight_transfer_time(model, gpu) == \
                    js.weight_transfer_time(model, gpu)
                z, hw = ts.models[model], ts.hardware[gpu]
                zj, hwj = js.models[model], js.hardware[gpu]
                assert ts.prefill_time(z, hw, tp, batch, 512) == \
                    js.prefill_time(zj, hwj, tp, batch, 512)
                assert ts.decode_time(z, hw, tp, batch, 512, 64) == \
                    js.decode_time(zj, hwj, tp, batch, 512, 64)
        for p, q in itertools.product(sorted(set(plans)), repeat=2):
            assert ts.reconfig_cost(_plan_in(True, p), _plan_in(True, q)) == \
                js.reconfig_cost(_plan_in(False, p), _plan_in(False, q))
        assert ts.reconfig_cost(None, _plan_in(True, plans[0])) == \
            js.reconfig_cost(None, _plan_in(False, plans[0]))


@pytest.mark.parametrize("trace", TRACES)
def test_evaluator_fitness_of_every_seed_policy(trace):
    out = {}
    for port in (True, False):
        sim, models, hw = _sim(port)
        ev = FW[port][2].Evaluator(sim, models, hw, sched_time_scale=0.0,
                                   candidate_timeout_s=1e4)
        tr = getattr(FW[port][5], trace)()
        out[port] = [_result(ev.evaluate(p, tr))
                     for p in FW[port][3].seed_policies().values()]
    assert out[True] == out[False]
    assert sum(r[6] is None for r in out[True]) >= 10      # feasible seeds



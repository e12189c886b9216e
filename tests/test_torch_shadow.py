"""The port's shadow rung held to the JAX package's, all compared exactly
(``==``): ``ShadowReplayEval``'s fitness for each (seed policy, snapshot,
seed), ``SimBackend``'s intervals and the copied ``hlo_analysis`` costing
functions.  The simulator and the analytic rung are held in
``test_torch_evaluator.py``.

Measured scheduling time is switched off on both sides
(``sched_time_scale=0.0``) and the candidate timeouts never fire, so
fitness carries no wall time.  The snapshots are windows of the traces on
their own clusters, where every branch-and-bound search ends well before
its deadline.
"""
import dataclasses
import itertools

import pytest

from repro.core import evaluator as jev
from repro.core import plan as jplan
from repro.core import policy as jpolicy
from repro.core import simulator as jsim
from repro.distributed import hlo_analysis as jhlo
from repro.serving import backend as jbackend
from repro.serving import shadow as jshadow
from repro.traces import workload as jtraces
from repro_torch.core import evaluator as tev
from repro_torch.core import plan as tplan
from repro_torch.core import policy as tpolicy
from repro_torch.core import simulator as tsim
from repro_torch.distributed import hlo_analysis as thlo
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


def _result(r):
    """An EvalResult as plain values (records by their accounting terms)."""
    recs = tuple((x.timestamp_idx, x.rescheduled, x.t_sched, x.t_stale,
                  x.t_reconfig, x.t_serve, x.t_request, x.serve_full,
                  x.plan_changed) for x in r.records)
    return (r.fitness, r.N, r.sum_sched, r.sum_stale, r.sum_reconfig,
            r.sum_serve, r.error, r.backend, r.ttft_p95_s, r.backlogged, recs)


def _snapshot(port, which):
    """A control-plane-sized window (trace, first, length) of a trace on
    its own cluster."""
    tr = FW[port][5]
    name, lo, n = which
    full = getattr(tr, name)()
    return tr.Trace(f"{name}[{lo}:{lo + n}]", full.observations[lo:lo + n],
                    full.models)


@pytest.mark.parametrize("which", [("volatile_workload_trace", 0, 3),
                                   ("stable_workload_trace", 0, 4)])
def test_shadow_replay_fitness_per_policy_snapshot_and_seed(which):
    out = {}
    for port in (True, False):
        sim, models, hw = _sim(port)
        res = []
        for seed in (0, 1):
            ev = FW[port][4].ShadowReplayEval(sim, models, hw, seed=seed,
                                              sched_time_scale=0.0,
                                              candidate_timeout_s=1e4)
            snap = _snapshot(port, which)
            res += [_result(ev.evaluate(p, snap))
                    for p in FW[port][3].seed_policies().values()]
        out[port] = res
    assert out[True] == out[False]
    ok = [r for r in out[True] if r[6] is None]
    assert len(ok) >= 20 and all(r[7] == "shadow" for r in out[True])
    assert len({r[0] for r in ok}) > 4                     # policies differ


def test_sim_backend_intervals():
    out = {}
    for port in (True, False):
        sim, _, _ = _sim(port)
        be = FW[port][6].SimBackend(sim)
        tr = FW[port][5].volatile_workload_trace()
        got = []
        for i, o in enumerate(tr.observations[:4]):
            groups = tuple(FW[port][0].ReplicaGroup(w.model, "H100-80G", 2,
                                                     16 + 8 * i, 1)
                           for w in o.workloads)
            rep = be.apply_plan(FW[port][0].Plan(groups), None)
            m = be.serve_interval(list(o.workloads))
            got.append((rep.wall_s, rep.simulated_s, len(rep.built),
                        len(rep.reused), len(rep.removed),
                        dataclasses.astuple(m)))
        be.set_request_policy(None)
        out[port] = got
    assert out[True] == out[False]
    assert not out[True][0][-1][-1]                        # measured=False


def test_hlo_costing_functions_over_shapes():
    fns = ("tp_fallback_fraction", "effective_tp", "tp_collective_bytes_per_token",
           "fused_paged_supported")
    for (_, z), gname in itertools.product(sorted(tplan.QWEN25_FAMILY.items()),
                                           sorted(tplan.HARDWARE)):
        g = tplan.HARDWARE[gname]
        gj = jplan.HARDWARE[gname]
        zj = next(m for m in jplan.QWEN25_FAMILY.values() if m.name == z.name)
        for tp, pp, batch in itertools.product((1, 2, 3, 4, 8), (1, 2, 4),
                                               (1, 8, 64)):
            for fn in fns:
                assert getattr(thlo, fn)(z, tp) == getattr(jhlo, fn)(zj, tp)
            assert thlo.step_collective_s(z, g, tp, batch, 16) == \
                jhlo.step_collective_s(zj, gj, tp, batch, 16)
            assert thlo.rebuild_cost_s(z, g, tp, pp=pp) == \
                jhlo.rebuild_cost_s(zj, gj, tp, pp=pp)
            assert thlo.pipeline_bubble_fraction(pp, batch) == \
                jhlo.pipeline_bubble_fraction(pp, batch)
            assert thlo.stage_activation_bytes_per_token(z, pp) == \
                jhlo.stage_activation_bytes_per_token(zj, pp)
            assert thlo.stage_handoff_s(z, g, pp, batch, 4) == \
                jhlo.stage_handoff_s(zj, gj, pp, batch, 4)
            assert thlo.unfused_paged_decode_overhead_s(z, g, tp, batch, 256) == \
                jhlo.unfused_paged_decode_overhead_s(zj, gj, tp, batch, 256)
    for arch in ("qwen2-1.5b", "mixtral-8x7b", "minicpm3-4b", "mamba2-1.3b"):
        from repro.configs import get_config as jget
        from repro_torch.configs import get_config as tget
        z, zj = tplan.spec_from_config(tget(arch)), jplan.spec_from_config(jget(arch))
        for tp in (1, 2, 3, 4, 8):
            assert thlo.effective_tp(z, tp) == jhlo.effective_tp(zj, tp)
            assert thlo.fused_paged_supported(z, tp) == jhlo.fused_paged_supported(zj, tp)


def test_shadow_replay_under_a_seeded_fault_schedule():
    """The shadow rung replays one seeded schedule against every candidate
    (kills of a group's last replica are skipped, stragglers slow the
    virtual clock): the seeds get the reference's fitness, which the faults
    move."""
    names = ("greedy-reactive", "retry-migrate", "shed-fast", "live-migrate")
    out = {}
    for port in (True, False):
        sim, models, hw = _sim(port)
        sched = FW[port][5].failure_schedule(3, n_events=6, horizon=3,
                                             kill_ratio=0.6)
        ev = FW[port][4].ShadowReplayEval(sim, models, hw, sched_time_scale=0.0,
                                          candidate_timeout_s=1e4,
                                          fault_schedule=sched)
        snap = _snapshot(port, ("volatile_workload_trace", 0, 3))
        pols = FW[port][3].seed_policies()
        out[port] = [_result(ev.evaluate(pols[n], snap)) for n in names]
        calm = dataclasses.replace(ev, fault_schedule=None)
        out[port].append(_result(calm.evaluate(pols[names[1]], snap)))
    assert out[True] == out[False]
    assert all(r[6] is None for r in out[True])
    assert out[True][1][0] != out[True][-1][0]             # the faults cost

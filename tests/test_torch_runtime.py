"""The port's control plane held to the JAX package's, compared exactly:
``StructuredMutator`` and ``LLMMutator`` children, ``Evolution.run``
history and winner, ``Autopoiesis`` over the shadow backend (published
sources, swaps, commits, rollbacks), ``evolve_agentic``; then the port's own
``DataPlane`` driving a reduced CPU ``TorchBackend``, and
``launch/serve.py --guarded`` without the reference.

Measured scheduling time is switched off (``sched_time_scale=0.0``), no
timeout fires and evaluation is serial, so no wall time enters fitness.
The agentic replay charges its measured ``assign`` time, so both packages'
``agentic`` modules read one virtual clock there.
"""
import dataclasses
import importlib
import os
import random
import subprocess
import sys
from pathlib import Path

import torch

from repro.core import policy as jpolicy
from repro_torch.core import policy as tpolicy
from repro_torch.core.evaluator import Evaluator as TEvaluator
from repro_torch.core.plan import HARDWARE, QWEN25_FAMILY
from repro_torch.core.runtime import DataPlane, PolicyStage, SnapshotBuffer
from repro_torch.core.simulator import Simulator as TSimulator
from repro_torch.serving.backend import (Backend, SimBackend, TorchBackend,
                                         make_torch_backend)
from repro_torch.serving.faults import FaultInjector
from repro_torch.traces import volatile_workload_trace

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _mod(port, name):
    return importlib.import_module(("repro_torch." if port else "repro.") + name)


def _ticket(t):
    return None if t is None else dataclasses.astuple(t)


def test_structured_mutator_children_match_the_reference():
    for name in sorted(jpolicy.seed_policies()):
        for seed in range(4):
            out = []
            for port in (True, False):
                mut = _mod(port, "core.mutation").StructuredMutator()
                parent = _mod(port, "core.policy").seed_policies()[name]
                rng = random.Random(seed)
                fb = {"N": 3, "sum_sched": 4.0 * seed, "sum_stale": 1.0,
                      "sum_reconfig": 2.0, "sum_serve": 9.0, "T_total": 16.0}
                kids = [mut.mutate(parent, fb, [fb], {"best_fitness": 1.0}, rng)
                        for _ in range(3)]
                out.append([(k.name, k.source) for k in kids])
            assert out[0] == out[1], (name, seed)


def test_llm_mutator_with_a_stub_completion_matches_the_reference():
    prompts = {}

    def stub(tag):
        def complete(prompt):
            prompts[tag] = prompt
            return "```python\n" + jpolicy.seed_policies()["sjf-request"].source + "```"
        return complete

    kids = []
    for port in (True, False):
        m = _mod(port, "core.mutation")
        parent = _mod(port, "core.policy").seed_policies()["hybrid-threshold"]
        fb = {"N": 2, "T_total": 5.0}
        kids.append(m.LLMMutator(stub(port)).mutate(
            parent, fb, [{"N": 1}], {"best_fitness": 4.0}, random.Random(0)))
        assert m.mutation_prompt(parent.source, fb, [{"N": 1}],
                                 {"best_fitness": 4.0}) == prompts[port]
    assert prompts[True] == prompts[False]
    assert (kids[0].name, kids[0].source) == (kids[1].name, kids[1].source)
    assert kids[0].compile().domains == ("placement", "request")


def _stable_snapshot(port, n=4):
    tr = _mod(port, "traces.workload").stable_workload_trace()
    return tr.__class__("snap", tr.observations[:n], tr.models)


def _evaluator(port, cls="core.evaluator:Evaluator"):
    plan = _mod(port, "core.plan")
    models = {m.name: m for m in plan.QWEN25_FAMILY.values()}
    sim = _mod(port, "core.simulator").Simulator(models, plan.HARDWARE)
    mod, name = cls.split(":")
    return getattr(_mod(port, mod), name)(sim, models, plan.HARDWARE,
                                          sched_time_scale=0.0,
                                          candidate_timeout_s=1e4)


def test_evolution_history_and_winner_match_the_reference():
    out = []
    for port in (True, False):
        evo = _mod(port, "core.evolution")
        cfg = evo.EvolutionConfig(max_iterations=6, patience=6, seed=3,
                                  evolution_timeout_s=1e5, parallel_eval=1,
                                  shadow_top_k=0)
        state = evo.Evolution(_evaluator(port), cfg).run(_stable_snapshot(port))
        out.append((state.history, state.best.policy.name,
                    state.best.policy.source, state.best.fitness,
                    state.iterations_run,
                    sorted((c.policy.source, c.fitness) for c in state.elites(k=20))))
    assert out[0] == out[1]
    assert len(out[0][0]) == 7 and out[0][3] < float("inf")


def _autopoiesis(port, steps=7):
    rt, sh = _mod(port, "core.runtime"), _mod(port, "serving.shadow")
    ev = _evaluator(port)
    ap = rt.Autopoiesis(
        ev, _mod(port, "core.policy").seed_policies()["greedy-reactive"],
        _mod(port, "core.evolution").EvolutionConfig(
            max_iterations=1, patience=4, evolution_timeout_s=1e5,
            shadow_top_k=3, seed=0),
        window=6, evolve_every=3, backend=sh.ShadowBackend(ev.sim, seed=0),
        shadow=_evaluator(port, "serving.shadow:ShadowReplayEval"))
    published = []
    publish = ap.stage.publish
    ap.stage.publish = lambda p, ticket=None: (
        published.append((p.source, _ticket(ticket))) or publish(p, ticket))
    plan = _mod(port, "core.plan")
    trace = _mod(port, "traces.workload").stable_workload_trace(
        plan.ClusterState((("H100-80G", 16),)))
    log = []
    for i, obs in enumerate(trace.observations[:steps]):
        out = ap.data_plane.step(obs)
        log.append((out["canary"], out["interval_total"], out["rescheduled"]))
        if i > 0 and i % 3 == 0:
            st = ap.control_plane.run_cycle(ap.data_plane.policy)
            log.append((st.history, [(c.policy.source, c.fitness)
                                     for c in st.finalists]))
    ap.stage.publish(_mod(port, "core.policy").Policy(
        source=sh.BAD_REQUEST_SOURCE, name="regressor"),
        ticket=rt.CanaryTicket(intervals=2, max_regression=0.5,
                               policy_name="regressor"))
    for obs in trace.observations[:3]:
        log.append(ap.data_plane.step(obs)["canary"])
    dp, cp = ap.data_plane, ap.control_plane
    return (published, log, dp.swap_count, dp.commits, dp.rollbacks,
            dp.rollback_reasons, cp.cycles, cp.published, dp.acc.T_total)


def test_autopoiesis_over_the_shadow_backend_matches_the_reference():
    got, ref = _autopoiesis(True), _autopoiesis(False)
    assert got == ref
    published, log, swaps, commits, rollbacks, reasons, cycles, *_ = got
    assert cycles == 2 and swaps >= 2 and commits >= 1 and rollbacks >= 1
    assert reasons[-1].startswith("regressor: p95 TTFT")
    assert log[-2]["status"] == "rolled_back"


class _Tick:
    """A virtual ``time`` module: each ``monotonic()`` read advances 1 ms."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 1e-3
        return self.t


def test_evolve_agentic_matches_the_reference(monkeypatch):
    out = []
    for port in (True, False):
        ag = _mod(port, "core.agentic")
        monkeypatch.setattr(ag, "time", _Tick())
        tr = _mod(port, "traces.workload").agentic_traces(n_workflows=5)
        trace = tr[sorted(tr)[0]]
        policy, best, hist = ag.evolve_agentic(trace, iters=12, seed=1,
                                               pool=ag.make_pool(2, 2))
        out.append((policy.genome, policy.name, dataclasses.astuple(best), hist))
    assert out[0] == out[1]
    assert out[0][3] == sorted(out[0][3], reverse=True)


def test_port_data_plane_drives_a_reduced_torch_backend():
    """The port's own loop, no reference: the data plane applies plans to a
    CPU TorchBackend, serves measured intervals while a seeded injector
    kills replicas, and the snapshot buffer records what was measured."""
    models = {m.name: m for m in QWEN25_FAMILY.values()}
    sim = TSimulator(models, HARDWARE)
    backend = make_torch_backend("qwen2-1.5b", device="cpu", max_seq_len=48,
                                 slots_cap=2, max_replicas_per_group=2,
                                 requests_per_model=2, max_new_tokens=3)
    assert isinstance(backend, TorchBackend) and isinstance(backend, Backend)
    assert isinstance(SimBackend(sim), Backend)
    backend.fault_injector = FaultInjector.from_seed(
        0, n_events=2, horizon=2, kill_ratio=1.0, deny_export_rate=0.0)
    buf = SnapshotBuffer()
    dp = DataPlane(TEvaluator(sim, models, HARDWARE, candidate_timeout_s=20.0),
                   tpolicy.seed_policies()["retry-migrate"], PolicyStage(), buf,
                   backend=backend)
    trace = volatile_workload_trace()
    failures = 0
    for obs in trace.observations[:3]:
        out = dp.step(obs)
        m = out["metrics"]
        assert m is not None and m.measured and m.requests > 0
        assert m.shed == 0 and m.backlogged == 0
        failures += out["failures"]
    assert failures == backend.failure_count >= 1
    assert all(r.leaked_pages == 0 for r in backend.pool.failure_log)
    assert dp.acc.records[0].metrics.reconfig_s > 0.0
    assert buf.snapshot(window=4).observations[-1].metrics is out["metrics"]


def test_serve_cli_runs_guarded_without_the_reference():
    """``python -m repro_torch.launch.serve --guarded`` (cut to one control
    cycle) in a process that would fail on any import of ``repro`` or
    ``jax``: the planted regressor is canaried and rolled back."""
    guard = ("import sys, runpy\n"
             "class Block:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('repro', 'jax'):\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, Block())\n"
             "sys.argv = ['serve', '--guarded', '--guarded-steps', '4']\n"
             "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", guard], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "planted regressor: rolled_back" in out.stdout
    assert "rollbacks=1" in out.stdout and "commits=0" in out.stdout
    assert "rollback: regressor: p95 TTFT" in out.stdout

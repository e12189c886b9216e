"""PyTorch port vs the JAX reference, serving level, on reduced qwen2-1.5b in
f32 with the same weights (``params_from_jax``): the port's paged ``Engine``
must produce exactly the JAX ``Engine``'s greedy tokens on the engine and
paged-KV scenarios, and ``TorchBackend`` must plug into the JAX runtime's
``DataPlane`` as a ``Backend``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.evaluator import Evaluator
from repro.core.plan import HARDWARE, QWEN25_FAMILY
from repro.core.policy import seed_policies
from repro.core.runtime import DataPlane, PolicyStage, SnapshotBuffer
from repro.core.simulator import Simulator
from repro.models import lm as jlm
from repro.serving.backend import Backend
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.traces import volatile_workload_trace
from repro.traces.workload import multi_turn_requests, shared_prefix_requests
from repro_torch.configs import get_config as tget_config
from repro_torch.core.plan import Plan, ReplicaGroup
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def zoo():
    jcfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config("qwen2-1.5b").reduced(), dtype="float32")
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, tcfg, params, model


def _engines(zoo, **kw):
    jcfg, tcfg, params, model = zoo
    return JEngine(jcfg, params, **kw), TEngine(tcfg, model, device="cpu", **kw)


def _serve(eng, req_cls, reqs):
    """Submit (rid, prompt, max_new) requests together, drain, tokens by rid."""
    for rid, prompt, max_new in reqs:
        eng.submit(req_cls(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
    return {d.request.rid: d.generated for d in eng.run_until_drained()}


def _serve_one_by_one(eng, req_cls, reqs):
    out = {}
    for rid, prompt, max_new in reqs:
        eng.submit(req_cls(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
        done = eng.run_until_drained()[-1]
        out[rid] = (done.generated, done.prefill_dispatches)
    return out


def test_slot_isolation_matches_reference(zoo):
    solo = [(0, [5, 9, 11], 6)]
    busy = solo + [(r, [r, r + 1], 6) for r in range(1, 4)]
    for reqs in (solo, busy):
        j, t = _engines(zoo, n_slots=4, max_seq_len=48)
        want, got = _serve(j, JRequest, reqs), _serve(t, TRequest, reqs)
        assert got == want
    assert got[0] == _serve(_engines(zoo, n_slots=4, max_seq_len=48)[1],
                            TRequest, solo)[0]


def test_slot_reuse_and_single_token_budget_match_reference(zoo):
    reqs = [(0, [7, 3, 8, 8, 2, 6], 9), (1, [5, 9, 11, 4], 6), (2, [3, 1, 4], 1)]
    j, t = _engines(zoo, n_slots=1, max_seq_len=48)
    want, got = _serve(j, JRequest, reqs), _serve(t, TRequest, reqs)
    assert got == want and len(got[2]) == 1
    done = {d.request.rid: d for d in t.finished}
    assert done[2].position == 3          # no decode write past the budget


def test_truncation_matches_reference(zoo):
    long_prompt = [1 + i % 9 for i in range(100)]
    j, t = _engines(zoo, n_slots=2, max_seq_len=32)
    for eng, req_cls in ((j, JRequest), (t, TRequest)):
        eng.submit(req_cls(rid=0, prompt=list(long_prompt), max_new_tokens=4))
        assert eng.waiting[0].prompt == long_prompt[-28:]
    want, got = j.run_until_drained()[0], t.run_until_drained()[0]
    assert got.generated == want.generated and len(got.generated) == 4
    assert got.position == want.position < t.max_seq_len
    strict = TEngine(zoo[1], zoo[3], n_slots=2, max_seq_len=32,
                     truncate_long_prompts=False, device="cpu")
    with pytest.raises(ValueError, match="exceeds engine limit"):
        strict.submit(TRequest(rid=0, prompt=[1] * 40, max_new_tokens=4))


def test_prefix_hit_matches_reference(zoo):
    shared = [1 + (5 * i) % 19 for i in range(20)]        # 5 full pages
    reqs = [(0, shared + [30], 4), (1, shared + [31], 4)]
    j, t = _engines(zoo, n_slots=2, max_seq_len=48, page_size=4)
    want, got = _serve_one_by_one(j, JRequest, reqs), _serve_one_by_one(t, TRequest, reqs)
    assert got == want                         # tokens AND prefill dispatches
    assert t.prefix_hits == j.prefix_hits == 1
    assert t.prefix_tokens_saved == 20
    cold = TEngine(zoo[1], zoo[3], n_slots=2, max_seq_len=48, page_size=4,
                   prefix_cache=False, device="cpu")
    miss = _serve_one_by_one(cold, TRequest, reqs[1:])[1]
    assert miss[0] == got[1][0] and got[1][1] < miss[1]


def test_multi_turn_chain_matches_reference(zoo):
    [chain] = multi_turn_requests(1, 3, turn_len=12, seed=5)
    reqs = [(i, p, 2) for i, p in enumerate(chain)]
    j, t = _engines(zoo, n_slots=1, max_seq_len=64, page_size=4)
    want, got = _serve_one_by_one(j, JRequest, reqs), _serve_one_by_one(t, TRequest, reqs)
    assert got == want
    assert t.prefix_hits == 2 and t.prefix_tokens_saved >= 2 * 8


def test_eviction_under_page_pressure_matches_reference(zoo):
    pps = -(-48 // 4)
    reqs = [(rid, p, 3) for rid, (_, p) in enumerate(shared_prefix_requests(
        6, prefix_pool=6, prefix_len=20, suffix_len=4, reuse_ratio=1.0, seed=2))]
    j, t = _engines(zoo, n_slots=1, max_seq_len=48, page_size=4,
                    n_pages=1 + 2 * pps)
    want, got = _serve_one_by_one(j, JRequest, reqs), _serve_one_by_one(t, TRequest, reqs)
    assert got == want
    assert t.prefix_evictions == j.prefix_evictions > 0
    assert t.release_all_pages() == 0


def test_torch_backend_is_a_backend_and_serves(zoo):
    _, tcfg, _, model = zoo
    backend = TorchBackend(tcfg, model, max_seq_len=48, slots_cap=2,
                           max_replicas_per_group=1, requests_per_model=1,
                           max_new_tokens=3, device="cpu")
    assert isinstance(backend, Backend)
    w = volatile_workload_trace().observations[0].workloads
    plan = Plan(tuple(ReplicaGroup(x.model, "H100-80G", 1, 2, 1) for x in w))
    rep = backend.apply_plan(plan, None)
    assert rep.changed and rep.wall_s > 0.0
    met = backend.serve_interval(list(w))
    assert met.measured and met.requests == len(w)
    assert met.tokens > 0 and met.tokens_per_s > 0 and met.ttft_s > 0.0
    rep2 = backend.apply_plan(Plan(plan.groups[:1]), None)
    assert not rep2.built and len(rep2.removed) == len(w) - 1
    assert all(e.release_all_pages() == 0 for e in backend.pool.engines)


def test_data_plane_drives_torch_backend(zoo):
    _, tcfg, _, model = zoo
    models = {m.name: m for m in QWEN25_FAMILY.values()}
    sim = Simulator(models, HARDWARE)
    backend = TorchBackend(tcfg, model, max_seq_len=48, slots_cap=2,
                           max_replicas_per_group=1, requests_per_model=1,
                           max_new_tokens=3, device="cpu")
    buf = SnapshotBuffer()
    dp = DataPlane(Evaluator(sim, models, HARDWARE, candidate_timeout_s=20.0),
                   seed_policies()["greedy-reactive"], PolicyStage(), buf,
                   backend=backend)
    for obs in volatile_workload_trace().observations[:2]:
        out = dp.step(obs)
        assert out["metrics"] is not None and out["metrics"].measured
        assert out["metrics"].requests > 0
    assert dp.acc.records[0].metrics.reconfig_s > 0.0
    assert buf.snapshot(window=4).observations[-1].metrics is out["metrics"]


def test_drain_and_recompute_reconfigure(zoo):
    _, tcfg, _, model = zoo
    from repro_torch.core.policy import ReconfigPolicy
    backend = TorchBackend(tcfg, model, max_seq_len=48, slots_cap=4,
                           max_replicas_per_group=1, device="cpu")
    g1 = ReplicaGroup("m", "H100-80G", 1, 4, 1)
    g2 = ReplicaGroup("m", "H100-80G", 1, 2, 1)
    prompts = [[1 + (r + j) % 9 for j in range(10)] for r in range(4)]

    def run(policy, target=g2):
        backend.apply_plan(Plan((g1,)), None)
        backend.set_reconfig_policy(policy)
        for r, p in enumerate(prompts):
            backend.pool.submit("m", TRequest(rid=r, prompt=list(p), max_new_tokens=5))
        backend.pool.engines[0].step()
        rep = backend.apply_plan(Plan((target,)), None)
        backend.pool.run_until_drained()
        # a continuation's prompt carries the tokens of its earlier life
        out = {d.request.rid: d.request.prompt[len(prompts[d.request.rid]):]
               + d.generated for d in backend.pool.finished}
        backend.pool.finished.clear()
        backend.apply_plan(Plan(()), None)
        return rep, out

    rep_d, drained = run(None)
    assert rep_d.drained_requests == 4 and rep_d.recomputed_requests == 0
    rep_r, recomputed = run(ReconfigPolicy(lambda m: "recompute"))
    assert rep_r.recomputed_requests == 4 and rep_r.drained_requests == 0
    assert recomputed == drained          # recompute resumes greedy exactly
    assert all(len(t) == 5 for t in drained.values())
    # a 4-slot target (count 2, capped at one replica) takes all 4 slots
    rep_m, migrated = run(ReconfigPolicy(lambda m: "migrate"),
                          ReplicaGroup("m", "H100-80G", 1, 4, 2))
    assert rep_m.migrated_requests == 4 and rep_m.drained_requests == 0
    assert rep_m.migrate_wall_s > 0.0
    assert migrated == drained            # live migration resumes greedy exactly


def test_serve_main_runs_on_cpu(capsys):
    assert tserve.main(["--device", "cpu", "--requests", "3", "--max-new", "3",
                        "--resize"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "resize[drain]" in out

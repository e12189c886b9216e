"""Live slot migration in the PyTorch port, held to the JAX reference on
reduced configs in f32 with the same weights: the wire format
(``extract_slot`` / ``install_slot`` / ``extract_paged_slot`` /
``install_paged_slot``) round-trips, a JAX ``SlotExport`` installs into the
port's engine and decodes to the JAX tokens and the reverse holds too
(dense paged ↔ contiguous, and mamba2), the ``SlotMigrationError``
refusals, and ``migrate`` reconfiguration of the pool.  Greedy tokens are
compared exactly.

A ``SlotExport`` is rebuilt across frameworks from its request, position
and numpy cache: each engine compares the config it carries with its own.
"""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.policy import render_policy
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import RequestState as JRequestState
from repro.serving.engine import SlotExport as JSlotExport
from repro.serving.pool import EnginePool as JEnginePool
from repro_torch.configs import get_config as tget_config
from repro_torch.core.plan import Plan, ReplicaGroup
from repro_torch.core.policy import ReconfigPolicy
from repro_torch.models import lm as tlm
from repro_torch.serving.backend import measured_interval_metrics
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import RequestState as TRequestState
from repro_torch.serving.engine import SlotExport as TSlotExport
from repro_torch.serving.pool import EnginePool

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

_ZOO = {}


def _zoo(arch="qwen2-1.5b"):
    if arch not in _ZOO:
        jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
        params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
        _ZOO[arch] = (jcfg, tcfg, params, model)
    return _ZOO[arch]


def _teng(arch="qwen2-1.5b", **kw):
    _, tcfg, _, model = _zoo(arch)
    return TEngine(tcfg, model, device="cpu", **kw)


def _jeng(arch="qwen2-1.5b", **kw):
    jcfg, _, params, _ = _zoo(arch)
    return JEngine(jcfg, params, **kw)


def _reference(prompt, max_new, arch="qwen2-1.5b", jax_engine=False):
    """Tokens of the request served undisturbed (by the port, or by JAX)."""
    eng = (_jeng if jax_engine else _teng)(arch, n_slots=2, max_seq_len=64)
    eng.submit((JRequest if jax_engine else TRequest)(
        rid=0, prompt=list(prompt), max_new_tokens=max_new))
    return eng.run_until_drained()[0].generated


PROMPT = [1 + (3 * i) % 17 for i in range(23)]


def _convert(export, req_cls, state_cls, export_cls, cfg):
    """The same export for the other framework: request, state, numpy cache."""
    r, s = export.request, export.state
    req = req_cls(r.rid, list(r.prompt), r.max_new_tokens, r.eos_id,
                  r.arrival_time, first_token_time=r.first_token_time,
                  prior_generated=r.prior_generated)
    orig = req_cls(s.request.rid, list(s.request.prompt), s.request.max_new_tokens,
                   s.request.eos_id, s.request.arrival_time)
    st = state_cls(orig, s.slot, list(s.generated), s.position,
                   first_token_time=s.first_token_time,
                   prefill_dispatches=s.prefill_dispatches,
                   prior_generated=s.prior_generated)
    cache = {k: np.asarray(v) for k, v in export.cache.items()}
    return export_cls(req, st, cfg, cache, export.position)


def _partway(eng, req_cls, prompt=PROMPT, max_new=8):
    eng.submit(req_cls(rid=0, prompt=list(prompt), max_new_tokens=max_new))
    for _ in range(3):
        eng.step()                              # partway through decode
    [export] = eng.export_active()
    assert not eng.active
    return export


def _finish(dst):
    """Drain ``dst``; the finished record of the migrated request (rid 0)."""
    return next(d for d in dst.run_until_drained() if d.request.rid == 0)


# --------------------------------------------------------------------------- #
# wire format
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_extract_slot_wire_format_matches_reference(arch):
    j, t = _jeng(arch, n_slots=2, max_seq_len=48, paged=False), \
        _teng(arch, n_slots=2, max_seq_len=48, paged=False)
    ej, et = _partway(j, JRequest), _partway(t, TRequest)
    assert sorted(et.cache) == sorted(ej.cache) and et.position == ej.position
    for k in ej.cache:
        assert et.cache[k].shape == ej.cache[k].shape, k
        want_dtype = np.int32 if k == "pos" else np.float32
        assert et.cache[k].dtype == want_dtype and ej.cache[k].dtype == want_dtype
        np.testing.assert_allclose(et.cache[k], ej.cache[k], atol=1e-4, rtol=1e-4)


def test_extract_paged_slot_wire_format_matches_reference():
    j, t = _jeng(n_slots=2, max_seq_len=48, page_size=4), \
        _teng(n_slots=2, max_seq_len=48, page_size=4)
    ej, et = _partway(j, JRequest), _partway(t, TRequest)
    assert sorted(et.cache) == sorted(ej.cache) == ["k", "pos", "v"]
    assert np.array_equal(et.cache["pos"], ej.cache["pos"])
    for k in ("k", "v"):
        assert et.cache[k].shape == ej.cache[k].shape
        np.testing.assert_allclose(et.cache[k], ej.cache[k], atol=1e-4, rtol=1e-4)
    assert t.release_all_pages() == 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_extract_install_round_trip(arch):
    _, tcfg, _, model = _zoo(arch)
    cache = tlm.init_cache(tcfg, 3, 32, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(0)
    for v in cache.values():
        if v.dtype != torch.int32:
            v.copy_(torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)))
    if "pos" in cache:
        cache["pos"][:, 1, :9] = torch.arange(9, dtype=torch.int32)
    state = tlm.extract_slot(tcfg, cache, 1)
    assert all(a.dtype in (np.float32, np.int32) for a in state.values())
    # JAX hands bf16 leaves over as ml_dtypes arrays: accepted by dtype name
    as_jax = {k: v if k == "pos" else v.astype(ml_dtypes.bfloat16)
              for k, v in state.items()}
    for slot, st in ((2, state), (0, as_jax)):
        tlm.install_slot(tcfg, cache, slot, st, position=9)
        for k, v in cache.items():
            if k == "pos" or tcfg.family == "ssm":
                assert torch.equal(v[:, slot], v[:, 1]), k
            else:                               # positions ≥ 9 are zeroed
                assert torch.equal(v[:, slot, :9], v[:, 1, :9])
                assert not v[:, slot, 9:].any()


# --------------------------------------------------------------------------- #
# cross-framework hand-off: a JAX export decodes on the port and back
# --------------------------------------------------------------------------- #
DIRECTIONS = [("mamba2-1.3b", False, False), ("qwen2-1.5b", False, False),
              ("qwen2-1.5b", True, False), ("qwen2-1.5b", False, True),
              ("qwen2-1.5b", True, True)]


@pytest.mark.parametrize("arch,src_paged,dst_paged", DIRECTIONS)
def test_jax_export_installs_into_the_port_and_decodes_the_same(arch, src_paged, dst_paged):
    want = _reference(PROMPT, 8, arch, jax_engine=True)
    src = _jeng(arch, n_slots=2, max_seq_len=48, paged=src_paged, page_size=4)
    export = _convert(_partway(src, JRequest), TRequest, TRequestState,
                      TSlotExport, _zoo(arch)[1])
    dst = _teng(arch, n_slots=3, max_seq_len=64, paged=dst_paged, page_size=4)
    dst.submit(TRequest(rid=7, prompt=[2, 3, 4], max_new_tokens=10))
    dst.step()
    assert dst.install_active(export) and export.state.slot != 0
    assert _finish(dst).generated == want
    assert dst.release_all_pages() == 0


@pytest.mark.parametrize("arch,src_paged,dst_paged", DIRECTIONS)
def test_port_export_installs_into_jax_and_decodes_the_same(arch, src_paged, dst_paged):
    want = _reference(PROMPT, 8, arch)
    src = _teng(arch, n_slots=2, max_seq_len=48, paged=src_paged, page_size=4)
    export = _convert(_partway(src, TRequest), JRequest, JRequestState,
                      JSlotExport, _zoo(arch)[0])
    dst = _jeng(arch, n_slots=3, max_seq_len=64, paged=dst_paged, page_size=4)
    dst.submit(JRequest(rid=7, prompt=[2, 3, 4], max_new_tokens=10))
    dst.step()
    assert dst.install_active(export) and export.state.slot != 0
    assert _finish(dst).generated == want


# --------------------------------------------------------------------------- #
# refusals (test_migration.py's, on the port)
# --------------------------------------------------------------------------- #
def test_install_rejects_mismatch_and_recompute_fallback_is_exact():
    _, tcfg, _, model = _zoo()
    want = _reference([5, 9, 11, 4], 6)
    src = _teng(n_slots=1, max_seq_len=64)
    src.submit(TRequest(rid=0, prompt=[5, 9, 11, 4], max_new_tokens=6))
    src.step(); src.step()
    ft0 = next(iter(src.active.values())).first_token_time
    [export] = src.export_active()

    other_cfg = dataclasses.replace(tcfg, n_layers=2)
    other = TEngine(other_cfg, tlm.init_params(other_cfg, device="cpu"),
                    n_slots=2, max_seq_len=64, device="cpu")
    assert not other.install_active(export)     # different architecture
    tiny = _teng(n_slots=2, max_seq_len=4)
    assert not tiny.install_active(export)      # no decode headroom
    assert not tiny.active and not other.active

    dst = _teng(n_slots=2, max_seq_len=64)
    dst.submit(export.request)
    fin = dst.run_until_drained()[0]
    assert list(fin.request.prompt[4:]) + fin.generated == want
    assert fin.prior_generated + len(fin.generated) == 6
    assert fin.first_token_time == ft0
    assert measured_interval_metrics([fin], wall=1.0).tokens == 6


def test_install_refuses_partial_headroom_instead_of_truncating():
    src = _teng(n_slots=1, max_seq_len=64)
    src.submit(TRequest(rid=0, prompt=[1 + i % 9 for i in range(20)],
                        max_new_tokens=20))
    src.step(); src.step()                      # position 22, 17 remaining
    [export] = src.export_active()
    assert export.position + export.request.max_new_tokens == 39
    assert not _teng(n_slots=1, max_seq_len=38).install_active(export)
    roomy = _teng(n_slots=1, max_seq_len=40, paged=False)
    assert roomy.install_active(export)         # budget exactly fits
    fin = roomy.run_until_drained()[0]
    assert fin.prior_generated + len(fin.generated) == 20


def test_lm_install_slot_raises_on_shape_mismatch():
    _, tcfg, _, _ = _zoo()
    cache = tlm.init_cache(tcfg, 2, 32, device="cpu")
    cache["pos"][:, 0, :6] = torch.arange(6, dtype=torch.int32)
    state = tlm.extract_slot(tcfg, cache, 0)
    small = tlm.init_cache(tcfg, 2, 16, device="cpu")
    with pytest.raises(tlm.SlotMigrationError):
        tlm.install_slot(tcfg, small, 0, state, position=20)
    other = dataclasses.replace(tcfg, d_head=8)
    with pytest.raises(tlm.SlotMigrationError):
        tlm.install_slot(other, tlm.init_cache(other, 2, 32, device="cpu"), 0,
                         state, position=4)
    holed = {k: v.copy() for k, v in state.items()}
    holed["pos"][:, 2] = -1                     # a position the request reads
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(tlm.SlotMigrationError, match="lacks positions"):
        tlm.install_slot(tcfg, cache, 1, holed, position=6)
    assert all(torch.equal(cache[k], before[k]) for k in cache)   # untouched
    ssm_cfg = _zoo("mamba2-1.3b")[1]
    with pytest.raises(tlm.SlotMigrationError):
        tlm.install_slot(ssm_cfg, tlm.init_cache(ssm_cfg, 2, 8, device="cpu"),
                         0, state, position=4)


# --------------------------------------------------------------------------- #
# pool-level reconfiguration (test_migration.py's, on the port)
# --------------------------------------------------------------------------- #
G1 = ReplicaGroup("m", "H100-80G", tp=1, batch=2, count=1)
G2 = ReplicaGroup("m", "H100-80G", tp=1, batch=3, count=1)
PROMPTS = {0: [5, 9, 11, 4], 1: [7, 3, 8]}


def _pool(mode="migrate", paged=(None, None), **kw):
    def factory(g):
        return _teng(n_slots=max(1, min(g.batch, 3)), max_seq_len=64,
                     paged=paged[g.batch != 2])
    pool = EnginePool(factory, **kw)
    if mode is not None:
        pool.set_reconfig_policy(ReconfigPolicy(lambda m: mode, name=mode))
    return pool


def _load_and_snapshot(pool):
    for rid, p in PROMPTS.items():
        assert pool.submit("m", TRequest(rid=rid, prompt=list(p), max_new_tokens=6))
    for eng in pool.engines:
        eng.step(); eng.step()
    return {s.request.rid: s.first_token_time
            for e in pool.engines for s in e.active.values()}


def _check_outputs_and_accounting(pool, fts):
    want = {rid: _reference(p, 6) for rid, p in PROMPTS.items()}
    assert sorted(s.request.rid for s in pool.finished) == [0, 1]
    for s in pool.finished:
        rid = s.request.rid
        full = list(s.request.prompt[len(PROMPTS[rid]):]) + list(s.generated)
        assert full == want[rid]
        assert s.prior_generated + len(s.generated) == 6
        assert s.first_token_time == fts[rid]
    assert measured_interval_metrics(pool.finished, wall=1.0).tokens == 12


@pytest.mark.parametrize("paged", [(None, None), (False, None), (None, False)])
def test_reconfigure_migrates_in_flight_requests(paged):
    pool = _pool(paged=paged)
    pool.reconfigure(Plan((G1,)))
    fts = _load_and_snapshot(pool)
    d = pool.reconfigure(Plan((G2,)))
    assert d.migrated_requests == 2
    assert d.drained_requests == 0 and d.recomputed_requests == 0
    assert d.migrate_wall_s > 0.0 and d.drain_wall_s == 0.0
    assert sum(len(e.active) for e in pool.engines) == 2
    pool.run_until_drained()
    _check_outputs_and_accounting(pool, fts)
    assert all(e.release_all_pages() == 0 for e in pool.engines)


def test_migrate_falls_back_to_recompute_on_incompatible_survivor():
    _, tcfg, _, model = _zoo()
    cfg2 = dataclasses.replace(tcfg, n_layers=2)
    model2 = tlm.init_params(cfg2, device="cpu")

    def factory(g):
        if g.batch == 2:
            return TEngine(tcfg, model, n_slots=2, max_seq_len=64, device="cpu")
        return TEngine(cfg2, model2, n_slots=3, max_seq_len=64, device="cpu")
    pool = EnginePool(factory)
    pool.set_reconfig_policy(ReconfigPolicy(lambda m: "migrate"))
    pool.reconfigure(Plan((G1,)))
    pool.submit("m", TRequest(rid=0, prompt=[1 + i % 9 for i in range(30)],
                              max_new_tokens=8))
    eng = pool.engines[0]
    eng.step(); eng.step()
    d = pool.reconfigure(Plan((G2,)))
    assert d.migrated_requests == 0 and d.recomputed_requests == 1
    done = pool.run_until_drained()
    assert len(done) == 1 and done[0].request.rid == 0
    assert done[0].prior_generated + len(done[0].generated) == 8


def test_reconfig_under_load_drops_and_double_counts_nothing():
    pool = _pool(max_replicas_per_group=2)
    pool.reconfigure(Plan((ReplicaGroup("m", "H100-80G", tp=1, batch=2, count=2),)))
    n = 8
    for r in range(n):
        assert pool.submit("m", TRequest(rid=r, prompt=[1 + r % 7, 2, 3],
                                         max_new_tokens=3 + r % 3))
    for eng in pool.engines:
        eng.step()
    d = pool.reconfigure(Plan((G2,)))
    assert d.migrated_requests > 0
    pool.run_until_drained()
    assert sorted(s.request.rid for s in pool.finished) == list(range(n))
    for s in pool.finished:
        assert s.prior_generated + len(s.generated) == 3 + s.request.rid % 3


def _undrainable(pool, request):
    """Serve PROMPT on the pool's G1 replica, then reconfigure to G2, whose
    replica can neither install the slot (a different config) nor take the
    continuation (too short a cache): the migrate falls through to draining
    in place on the paged source."""
    pool.submit("m", request(rid=0, prompt=list(PROMPT), max_new_tokens=8))
    pool.engines[0].step(); pool.engines[0].step()
    return pool.reconfigure


def test_failed_paged_migrate_drains_from_its_own_pages():
    """Reference caveat: the JAX engine releases a paged slot's pages at
    export (``engine.py:655``), so when the migrate falls through to
    draining in place (``pool.py:296-297``) the drain has no pages: its
    next ``_ensure_pages`` raises ``KeyError``.  The port keeps the pages
    until a hand-off succeeds and drains the undisturbed tokens."""
    from repro.core.plan import Plan as JPlan, ReplicaGroup as JGroup
    jcfg, tcfg, params, model = _zoo()
    cfg2 = dataclasses.replace(tcfg, n_layers=2)
    jcfg2 = dataclasses.replace(jcfg, n_layers=2)
    model2 = tlm.init_params(cfg2, device="cpu")
    params2 = jlm.init_params(jcfg2, jax.random.PRNGKey(1))

    pool = EnginePool(lambda g: TEngine(tcfg, model, n_slots=2, max_seq_len=64,
                                        page_size=4, device="cpu")
                      if g.batch == 2 else
                      TEngine(cfg2, model2, n_slots=3, max_seq_len=16, device="cpu"))
    pool.set_reconfig_policy(ReconfigPolicy(lambda m: "migrate"))
    pool.reconfigure(Plan((G1,)))
    d = _undrainable(pool, TRequest)(Plan((G2,)))
    assert d.drained_requests == 1 and d.migrated_requests == 0
    assert pool.finished[0].generated == _reference(PROMPT, 8)
    assert pool.engines[0].release_all_pages() == 0

    jpool = JEnginePool(lambda g: JEngine(jcfg, params, n_slots=2, max_seq_len=64,
                                          page_size=4)
                        if g.batch == 2 else
                        JEngine(jcfg2, params2, n_slots=3, max_seq_len=16))
    jpool.set_reconfig_policy(render_policy(
        {"domains": ["placement", "reconfig"], "migration_mode": "migrate"},
        name="migrate").reconfig_policy())
    plan = lambda g: JPlan((JGroup(g.model, g.gpu_type, tp=g.tp, batch=g.batch,
                                   count=g.count),))
    jpool.reconfigure(plan(G1))
    with pytest.raises(KeyError):
        _undrainable(jpool, JRequest)(plan(G2))

"""Pipelined replicas in the PyTorch port, held to the JAX reference on
reduced configs in f32 with the same weights: the stage helpers
(``slice_stage_params``, ``stage_step``, ``paged_stage_step``,
``concat_stage_states``) compose to the whole step; ``PipelinedEngine``
tokens equal the JAX ``PipelinedEngine``'s and the plain engine's at pp 2/4,
paged and contiguous, for qwen2 and mamba2; bad cuts are refused; a
mid-decode re-cut and pp ↔ plain migrations (port pp → JAX plain and back)
keep the tokens; the staged pools run in lockstep with prefix hits and no
leaked page.  Greedy tokens are compared exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.plan import default_stage_cuts
from repro.models import lm as jlm
from repro.serving import kvcache as jkv
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import RequestState as JRequestState
from repro.serving.engine import SlotExport as JSlotExport
from repro.serving.sharded import PipelinedEngine as JPipelinedEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.launch.mesh import logical_devices
from repro_torch.models import lm as tlm
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import RequestState as TRequestState
from repro_torch.serving.engine import SlotExport as TSlotExport
from repro_torch.serving.sharded import PipelinedEngine, SubmeshAllocator

torch.set_num_threads(1)
MAX_SEQ = 48
NEW = 4
_ZOO = {}


def _zoo(arch="qwen2-1.5b"):
    if arch not in _ZOO:
        jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
        params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
        _ZOO[arch] = (jcfg, tcfg, params, model)
    return _ZOO[arch]


def _prompts(cfg, n=3, length=12):
    v = cfg.vocab_size
    return [[(17 * i + 3 * j) % (v - 1) + 1 for j in range(length)] for i in range(n)]


def _drain(eng, req_cls, prompts, new=NEW):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=list(p), max_new_tokens=new))
    return {d.request.rid: list(d.generated) for d in eng.run_until_drained()}


def _tpipe(arch, pp, **kw):
    _, tcfg, _, model = _zoo(arch)
    return PipelinedEngine(tcfg, model, default_stage_cuts(tcfg.n_layers, pp),
                           device="cpu", **kw)


_PLAIN = {}
CASES = [("qwen2-1.5b", 2, True), ("qwen2-1.5b", 2, False), ("qwen2-1.5b", 4, True),
         ("qwen2-1.5b", 4, False), ("mamba2-1.3b", 2, False), ("mamba2-1.3b", 4, False)]


@pytest.mark.parametrize("arch,pp,paged", CASES)
def test_pipelined_tokens_equal_jax_pipelined_and_plain(arch, pp, paged):
    jcfg, tcfg, params, _ = _zoo(arch)
    prompts = _prompts(tcfg, n=2, length=8)       # one prefill chunk shape to trace
    kw = dict(n_slots=2, max_seq_len=MAX_SEQ, paged=paged, page_size=4)
    cuts = default_stage_cuts(tcfg.n_layers, pp)
    if (arch, paged) not in _PLAIN:                 # shared by the pp 2 and 4 cases
        _PLAIN[arch, paged] = _drain(JEngine(jcfg, params, **kw), JRequest, prompts)
    plain = _PLAIN[arch, paged]
    jpipe = _drain(JPipelinedEngine(jcfg, params, cuts, **kw), JRequest, prompts)
    eng = _tpipe(arch, pp, **kw)
    assert eng.paged == paged and eng.pp == pp and eng.stage_cuts == cuts
    assert (eng.tp, eng.dp) == (1, 1) and len(eng.stages) == pp
    got = _drain(eng, TRequest, prompts)
    assert got == jpipe == plain
    assert eng.release_all_pages() == 0


@pytest.mark.parametrize("arch,paged", [("qwen2-1.5b", True), ("qwen2-1.5b", False),
                                        ("mamba2-1.3b", False)])
def test_stage_steps_compose_to_the_whole_step(arch, paged):
    """The stages' steps chained over cuts (2, 3) give the whole step's
    logits and caches, and the JAX stage steps' logits."""
    jcfg, tcfg, params, model = _zoo(arch)
    L = tcfg.n_layers
    bounds = (0, 1, 3, L)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, tcfg.vocab_size, (2, 5)).astype(np.int32)
    pos2 = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    tt, tp = torch.from_numpy(tokens), torch.from_numpy(pos2)
    if paged:
        page, n_pages = 4, 9
        ptab = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
        act = np.array([True, True])
        whole = tlm.init_paged_cache(tcfg, n_pages, page, device="cpu")
        want, _ = tlm.paged_step(model, tcfg, whole, tt, tp, torch.from_numpy(ptab),
                                 torch.from_numpy(act), page_size=page)
        staged = tlm.init_paged_cache(tcfg, n_pages, page, device="cpu")
        jc = jlm.init_paged_cache(jcfg, n_pages, page, dtype=jax.numpy.float32)
    else:
        whole = tlm.init_cache(tcfg, 2, 16, device="cpu")
        want, _ = tlm.step_with_cache(model, tcfg, whole, tt, tp)
        staged = tlm.init_cache(tcfg, 2, 16, device="cpu")
        jc = jlm.init_cache(jcfg, 2, 16, dtype=jax.numpy.float32)
    x, jx = tt, jax.numpy.asarray(tokens)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        first, last = i == 0, hi == L
        stage = tlm.slice_stage_params(tcfg, model, lo, hi, first, last)
        assert all(a is b for a, b in zip(stage.layers, model.layers[lo:hi]))
        assert (stage.embed is not None) == (first or (last and tcfg.tie_embeddings))
        part = tlm.slice_stage_cache(staged, lo, hi)
        jsp = jlm.slice_stage_params(jcfg, params, lo, hi, first, last)
        jpart = jlm.slice_stage_cache(jc, lo, hi)
        if paged:
            x, _ = tlm.paged_stage_step(stage, tcfg, part, x, tp, torch.from_numpy(ptab),
                                        torch.from_numpy(act), page_size=page,
                                        first=first, last=last)
            jx, _ = jlm.paged_stage_step(jsp, jcfg, jpart, jx, pos2, ptab, act,
                                         page_size=page, first=first, last=last)
        else:
            x, _ = tlm.stage_step(stage, tcfg, part, x, tp, first=first, last=last)
            jx, _ = jlm.stage_step(jsp, jcfg, jpart, jx, pos2, first=first, last=last)
    assert torch.equal(x, want)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-4, rtol=2e-4)
    for (path, a), (_, b) in zip(tlm.leaves(staged), tlm.leaves(whole)):
        assert torch.equal(a, b), path


def test_bad_cuts_and_unsliceable_families_are_refused():
    _, tcfg, _, model = _zoo()
    for cuts in [(0,), (4,), (2, 2), (3, 1), ()]:
        with pytest.raises(ValueError, match="invalid stage cuts"):
            PipelinedEngine(tcfg, model, cuts, device="cpu", n_slots=1, max_seq_len=32)
    alloc = SubmeshAllocator(logical_devices(4, "cpu"))
    with pytest.raises(ValueError, match="stage meshes"):
        PipelinedEngine(tcfg, model, (2,), stage_meshes=alloc.alloc_stages(3, (1, 1)),
                        device="cpu", n_slots=1, max_seq_len=32)
    for arch in ("gemma2-9b", "zamba2-7b", "whisper-tiny"):
        cfg = tget_config(arch).reduced()
        assert not tlm.stage_sliceable(cfg)
        with pytest.raises(ValueError, match="cannot be stage-sliced"):
            PipelinedEngine(cfg, model, (1,), device="cpu")
    for arch in ("qwen2-1.5b", "mamba2-1.3b", "minicpm3-4b", "mixtral-8x7b"):
        assert tlm.stage_sliceable(tget_config(arch)) == jlm.stage_sliceable(get_config(arch))


def _convert(export, req_cls, state_cls, export_cls, cfg):
    """The same export for the other framework: request, state, numpy cache."""
    r, s = export.request, export.state
    req = req_cls(r.rid, list(r.prompt), r.max_new_tokens, r.eos_id, r.arrival_time,
                  first_token_time=r.first_token_time, prior_generated=r.prior_generated)
    orig = req_cls(s.request.rid, list(s.request.prompt), s.request.max_new_tokens,
                   s.request.eos_id, s.request.arrival_time)
    st = state_cls(orig, s.slot, list(s.generated), s.position,
                   first_token_time=s.first_token_time,
                   prefill_dispatches=s.prefill_dispatches, prior_generated=s.prior_generated)
    cache = {k: np.asarray(v) for k, v in export.cache.items()}
    return export_cls(req, st, cfg, cache, export.position)


def _partway(eng, req_cls, prompt, new=8):
    eng.submit(req_cls(rid=0, prompt=list(prompt), max_new_tokens=new))
    for _ in range(3):
        eng.step()
    [export] = eng.export_active()
    assert not eng.active
    return export


def _finish(dst):
    return list(next(d for d in dst.run_until_drained() if d.request.rid == 0).generated)


@pytest.mark.parametrize("paged", [True, False])
def test_mid_decode_recut_and_pp_plain_migrations(paged):
    """pp 2 → pp 4 (re-cut), port pp 2 → JAX plain, JAX plain → port pp 4,
    port plain → port pp 2: each finishes with the undisturbed tokens."""
    jcfg, tcfg, params, model = _zoo()
    prompt = _prompts(tcfg, 1, 10)[0]
    kw = dict(n_slots=1, max_seq_len=MAX_SEQ, paged=paged, page_size=4)
    ref = _drain(JEngine(jcfg, params, **kw), JRequest, [prompt], 8)[0]

    src = _tpipe("qwen2-1.5b", 2, **kw)
    dst = _tpipe("qwen2-1.5b", 4, **kw)
    assert dst.install_active(_partway(src, TRequest, prompt))
    assert _finish(dst) == ref
    assert src.release_all_pages() == 0 and dst.release_all_pages() == 0

    exp = _partway(_tpipe("qwen2-1.5b", 2, **kw), TRequest, prompt)
    jdst = JEngine(jcfg, params, **kw)
    assert jdst.install_active(_convert(exp, JRequest, JRequestState, JSlotExport, jcfg))
    assert _finish(jdst) == ref

    jexp = _partway(JEngine(jcfg, params, **kw), JRequest, prompt)
    tdst = _tpipe("qwen2-1.5b", 4, **kw)
    assert tdst.install_active(_convert(jexp, TRequest, TRequestState, TSlotExport, tcfg))
    assert _finish(tdst) == ref

    texp = _partway(TEngine(tcfg, model, device="cpu", **kw), TRequest, prompt)
    pdst = _tpipe("qwen2-1.5b", 2, **kw)
    assert pdst.install_active(texp)
    assert _finish(pdst) == ref and pdst.release_all_pages() == 0


def test_pipelined_export_equals_the_plain_wire_format():
    jcfg, tcfg, params, model = _zoo()
    prompt = _prompts(tcfg, 1, 10)[0]
    for paged in (True, False):
        kw = dict(n_slots=1, max_seq_len=MAX_SEQ, paged=paged, page_size=4)
        a = _partway(_tpipe("qwen2-1.5b", 4, **kw), TRequest, prompt)
        b = _partway(TEngine(tcfg, model, device="cpu", **kw), TRequest, prompt)
        assert sorted(a.cache) == sorted(b.cache) and a.position == b.position
        assert np.array_equal(a.cache["pos"], b.cache["pos"])
        for k in ("k", "v"):       # micro-chunked prefill: same up to f32 order
            assert a.cache[k].shape == b.cache[k].shape and a.cache[k].dtype == np.float32
            np.testing.assert_allclose(a.cache[k], b.cache[k], atol=1e-5, rtol=1e-5)
    parts = [{"k": np.full((n, 2), n)} for n in (1, 2, 3)]
    assert tlm.concat_stage_states(parts)["k"].shape == (6, 2)


def test_staged_pools_run_in_lockstep_like_the_reference():
    stages = [(0, 1), (1, 3), (3, 4)]
    tp, jp = tkv.StagedPagePool(9, stages), jkv.StagedPagePool(9, stages)
    ti, ji = tkv.StagedPrefixIndex(4, stages), jkv.StagedPrefixIndex(4, stages)
    seq = [(tp.alloc(), jp.alloc()) for _ in range(5)]
    assert [a for a, _ in seq] == [b for _, b in seq]
    for pool in (tp, jp):
        pool.ref(2)
        pool.unref(3)
    assert (tp.free_pages, tp.used_pages, tp.refcount(2)) == \
        (jp.free_pages, jp.used_pages, jp.refcount(2))
    assert [p.layers for p in tp.stage_pools] == stages
    prompt = list(range(1, 13))
    assert [n.page for n in ti.insert(prompt, [1, 2], 0.0)] == \
        [n.page for n in ji.insert(prompt, [1, 2], 0.0)]
    assert ti.match(prompt, 1.0) == ji.match(prompt, 1.0) == ([1, 2], 8)
    assert (ti.hits, ti.nodes, ti.tokens_matched) == (ji.hits, ji.nodes, ji.tokens_matched)
    for idx in (ti, ji):
        (leaf,) = idx.leaves()
        assert idx.remove(leaf) == 2
    assert all(t.nodes == 1 for t in ti.stage_tries)


def test_pipelined_paged_prefix_hits_and_no_leaked_pages():
    jcfg, tcfg, params, _ = _zoo()
    prompts = _prompts(tcfg, 2)
    prompts = [prompts[0][:8] + p[8:] for p in prompts]
    kw = dict(n_slots=2, max_seq_len=MAX_SEQ, page_size=4)
    ref = _drain(JEngine(jcfg, params, paged=False, n_slots=2, max_seq_len=MAX_SEQ),
                 JRequest, prompts)
    eng = _tpipe("qwen2-1.5b", 2, **kw)
    assert isinstance(eng.page_pool, tkv.StagedPagePool)
    assert isinstance(eng.prefix_index, tkv.StagedPrefixIndex)
    assert _drain(eng, TRequest, prompts) == ref
    assert _drain(eng, TRequest, prompts) == ref
    assert eng.prefix_index.hits >= 1
    pools = eng.page_pool.stage_pools
    assert all(p._free == pools[0]._free for p in pools)
    assert eng.release_all_pages() == 0
    # the per-stage pools are layer slices of one pool: no copy on one device
    kp0, kp1 = eng.cache[0]["kp"], eng.cache[1]["kp"]
    assert kp0.shape[0] == kp1.shape[0] == 2
    assert kp0.untyped_storage().data_ptr() == kp1.untyped_storage().data_ptr()

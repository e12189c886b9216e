"""Multi-head latent attention in the PyTorch port, held to the JAX
reference on reduced ``minicpm3-4b`` in f32 with the same weights:
``mla_fwd`` in both modes and ``paged_mla_fwd`` within 2e-5, the ``ckv``
and ``ckvp`` cache layouts, the contiguous step within 1e-4, the
contiguous engine's greedy tokens, and slot migration of the latent cache
between the port and JAX, contiguous and paged both ways (greedy tokens
exact)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import RequestState as JRequestState
from repro.serving.engine import SlotExport as JSlotExport
from repro_torch.configs import get_config as tget_config
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import RequestState as TRequestState
from repro_torch.serving.engine import SlotExport as TSlotExport

ARCH = "minicpm3-4b"
LAYER_TOL = 2e-5
LOGIT_TOL = 1e-4
PAGE = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs files in parallel workers: one intra-op thread each,
    restored when the module is done."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def zoo():
    jcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config(ARCH).reduced(), dtype="float32")
    params = jlm.init_params(jcfg, jax.random.PRNGKey(4))
    model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, model


def _layer(zoo, l=1):
    jcfg, tcfg, params, model = zoo
    return jax.tree.map(lambda t: t[l], params["layers"]["attn"]), model.layers[l].attn


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def test_mla_weights_are_the_jax_layout(zoo):
    jcfg, tcfg, params, model = zoo
    jp, tp = _layer(zoo)
    assert sorted(jp) == sorted(n for n, _ in tp.named_parameters())
    for name, w in tp.named_parameters():
        assert tuple(w.shape) == jp[name].shape
        np.testing.assert_array_equal(w.numpy(), np.asarray(jp[name]))


def test_init_params_scales_follow_init_mla():
    """``init_params`` draws each MLA matrix uniform ±1/√d_in, as
    ``init_mla`` does (d_in is the first axis of the (d_in, d_out) layout)."""
    cfg = tget_config(ARCH).reduced()
    model = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    want = {"wq_a": d, "wq_b": m.q_lora_rank, "wkv_a": d, "wk_b": m.kv_lora_rank,
            "wv_b": m.kv_lora_rank, "wo": H * m.v_head_dim}
    for name, w in model.layers[0].attn.named_parameters():
        bound = want[name] ** -0.5
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound


def test_mla_fwd_full_sequence_matches_reference(zoo):
    jcfg, tcfg = zoo[:2]
    jp, tp = _layer(zoo)
    B, S = 2, 11
    x = np.random.default_rng(0).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want, _ = jlayers.mla_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = tlayers.mla_fwd(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got.numpy(), want)


@pytest.mark.parametrize("C", [5, 1])
def test_mla_fwd_cache_mode_matches_reference(zoo, C):
    """Rows at different offsets of a cache that already holds earlier
    positions; the last row is inactive and keeps its buffers."""
    jcfg, tcfg = zoo[:2]
    jp, tp = _layer(zoo)
    m = jcfg.mla
    rng = np.random.default_rng(C)
    B, S_max, w = 3, 24, m.kv_lora_rank + m.qk_rope_head_dim
    start = np.array([7, 0, 12], np.int32)
    active = np.array([True, True, False])
    ckv = np.zeros((B, S_max, w), np.float32)
    kpos = np.full((B, S_max), -1, np.int32)
    for b, s0 in enumerate(start):
        ckv[b, :s0] = rng.standard_normal((s0, w))
        kpos[b, :s0] = np.arange(s0)
    x = rng.standard_normal((B, C, jcfg.d_model)).astype(np.float32)
    pos = (start[:, None] + np.arange(C)).astype(np.int32)
    want, (jckv, jkpos) = jlayers.mla_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                          kv_cache=jnp.asarray(ckv),
                                          cache_positions=jnp.asarray(kpos))
    tckv, tkpos = torch.from_numpy(ckv.copy()), torch.from_numpy(kpos.copy())
    got = tlayers.mla_fwd(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                          kv_cache=(tckv, tkpos), active=torch.from_numpy(active))
    _close(got.numpy()[active], np.asarray(want)[active])
    _close(tckv.numpy()[active], np.asarray(jckv)[active])
    np.testing.assert_array_equal(tkpos.numpy()[active], np.asarray(jkpos)[active])
    np.testing.assert_array_equal(tckv.numpy()[~active], ckv[~active])
    np.testing.assert_array_equal(tkpos.numpy()[~active], kpos[~active])


@pytest.mark.parametrize("C", [5, 1])
def test_paged_mla_fwd_matches_reference(zoo, C):
    """A scattered page table, lanes at different lengths, the inactive
    lane's writes in the trash page: outputs and the pool (trash page
    aside) equal."""
    jcfg, tcfg = zoo[:2]
    jp, tp = _layer(zoo)
    m = jcfg.mla
    rng = np.random.default_rng(10 + C)
    B, n_ptab, n_pages = 3, 6, 1 + 3 * 6
    w = m.kv_lora_rank + m.qk_rope_head_dim
    ptab = (1 + rng.permutation(n_pages - 1)).reshape(B, n_ptab).astype(np.int32)
    active = np.array([True, False, True])
    ptab[1] = 0
    ckvp = rng.standard_normal((n_pages, PAGE, w)).astype(np.float32)
    start = np.array([9, 0, 14], np.int32)
    pos2 = (start[:, None] + np.arange(C)).astype(np.int32)
    lens = np.where(active, pos2[:, -1] + 1, 0).astype(np.int32)
    phys = np.take_along_axis(ptab, pos2 // PAGE, axis=1)
    widx = np.where(active[:, None], phys * PAGE + pos2 % PAGE,
                    np.arange(C)[None] % PAGE).astype(np.int32)
    x = rng.standard_normal((B, C, jcfg.d_model)).astype(np.float32)
    want, jpool = jlayers.paged_mla_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos2),
                                        jnp.asarray(ckvp), jnp.asarray(ptab),
                                        jnp.asarray(lens), jnp.asarray(widx))
    tpool = torch.from_numpy(ckvp.copy())
    got = tlayers.paged_mla_fwd(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos2),
                                tpool, torch.from_numpy(ptab), torch.from_numpy(lens),
                                torch.from_numpy(widx.reshape(-1)).long())
    _close(got.numpy()[active], np.asarray(want)[active])
    _close(tpool.numpy()[1:], np.asarray(jpool)[1:])


def test_cache_layouts_match_reference(zoo):
    jcfg, tcfg = zoo[:2]
    jc = jlm.init_cache(jcfg, 3, 40, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, 3, 40, dtype=torch.float32, device="cpu")
    jp = jlm.init_paged_cache(jcfg, 9, PAGE, dtype=jnp.float32)
    tp = tlm.init_paged_cache(tcfg, 9, PAGE, dtype=torch.float32, device="cpu")
    assert sorted(tc) == sorted(jc) == ["ckv", "pos"] and list(tp) == list(jp) == ["ckvp"]
    for t, j in ((tc, jc), (tp, jp)):
        for k in j:
            assert tuple(t[k].shape) == j[k].shape
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_step_with_cache_matches_reference(zoo):
    """A 9-token chunk on two rows, then 4 decode steps with the second row
    left out (JAX: the step, then ``mask_cache_update``); logits within
    1e-4, the cache equal."""
    jcfg, tcfg, params, model = zoo
    rng = np.random.default_rng(3)
    B = 2
    jc = jlm.init_cache(jcfg, B, 20, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, B, 20, dtype=torch.float32, device="cpu")
    tokens = rng.integers(1, jcfg.vocab_size, size=(B, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (B, 9)).copy()
    write = None
    for step in range(5):
        jl, jc2 = jlm.step_with_cache(params, jcfg, jc, jnp.asarray(tokens), jnp.asarray(pos))
        act = np.array([True, step == 0])
        jc = jlm.mask_cache_update(jcfg, jc, jc2, jnp.asarray(act))
        with torch.inference_mode():
            tl, tc = tlm.step_with_cache(model, tcfg, tc, torch.from_numpy(tokens),
                                         torch.from_numpy(pos), write=write)
        _close(tl.numpy()[act], np.asarray(jl)[act], LOGIT_TOL)
        for k in jc:
            _close(tc[k].numpy(), np.asarray(jc[k]), LOGIT_TOL)
        tokens = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
        pos = pos[:, -1:] + 1
        write = torch.tensor([0])


def test_contiguous_engine_tokens_match_reference(zoo):
    jcfg, tcfg, params, model = zoo
    prompts = {0: [5, 9, 11, 2, 7], 1: [1 + (3 * i) % 17 for i in range(23)],
               2: [40 + (5 * j) % 150 for j in range(13)]}

    def serve(eng, req):
        for rid, p in prompts.items():
            eng.submit(req(rid=rid, prompt=list(p), max_new_tokens=6))
        return {d.request.rid: (d.generated, d.prefill_dispatches)
                for d in eng.run_until_drained()}

    want = serve(JEngine(jcfg, params, n_slots=2, max_seq_len=48, paged=False), JRequest)
    assert serve(TEngine(tcfg, model, n_slots=2, max_seq_len=48, paged=False,
                         device="cpu"), TRequest) == want


# --------------------------------------------------------------------------- #
# migration of the latent cache
# --------------------------------------------------------------------------- #
PROMPT = [1 + (3 * i) % 17 for i in range(23)]


def _engine(zoo, framework, paged, **kw):
    jcfg, tcfg, params, model = zoo
    if framework == "jax":
        return JEngine(jcfg, params, paged=paged, page_size=PAGE, **kw)
    return TEngine(tcfg, model, paged=paged, page_size=PAGE, device="cpu", **kw)


def _convert(export, to, zoo):
    """The same export for the other framework: request, state, numpy cache."""
    req_cls, state_cls, export_cls, cfg = (
        (JRequest, JRequestState, JSlotExport, zoo[0]) if to == "jax" else
        (TRequest, TRequestState, TSlotExport, zoo[1]))
    r, s = export.request, export.state
    req = req_cls(r.rid, list(r.prompt), r.max_new_tokens, r.eos_id, r.arrival_time,
                  first_token_time=r.first_token_time, prior_generated=r.prior_generated)
    orig = req_cls(s.request.rid, list(s.request.prompt), s.request.max_new_tokens,
                   s.request.eos_id, s.request.arrival_time)
    st = state_cls(orig, s.slot, list(s.generated), s.position,
                   first_token_time=s.first_token_time,
                   prefill_dispatches=s.prefill_dispatches,
                   prior_generated=s.prior_generated)
    return export_cls(req, st, cfg, {k: np.asarray(v) for k, v in export.cache.items()},
                      export.position)


# (source framework, source paged, target framework, target paged)
MOVES = [("torch", True, "torch", False), ("torch", False, "torch", True),
         ("torch", True, "jax", False), ("torch", False, "jax", True),
         ("jax", True, "torch", False), ("jax", False, "torch", True)]


@pytest.mark.parametrize("src_fw,src_paged,dst_fw,dst_paged", MOVES)
def test_migrated_latent_slot_decodes_the_undisturbed_tokens(zoo, src_fw, src_paged,
                                                             dst_fw, dst_paged):
    """A request 3 steps into decode moves, its ``ckv``/``pos`` state in
    the wire format, into a slot other than 0 of a busy target; it
    finishes with the tokens the source would have produced."""
    ref = _engine(zoo, src_fw, src_paged, n_slots=2, max_seq_len=48)
    req = JRequest if src_fw == "jax" else TRequest
    ref.submit(req(rid=0, prompt=list(PROMPT), max_new_tokens=8))
    want = ref.run_until_drained()[0].generated

    src = _engine(zoo, src_fw, src_paged, n_slots=2, max_seq_len=48)
    src.submit(req(rid=0, prompt=list(PROMPT), max_new_tokens=8))
    for _ in range(3):
        src.step()
    [export] = src.export_active()
    assert sorted(export.cache) == ["ckv", "pos"]
    if dst_fw != src_fw:
        export = _convert(export, dst_fw, zoo)
    dst = _engine(zoo, dst_fw, dst_paged, n_slots=3, max_seq_len=64)
    dst.submit((JRequest if dst_fw == "jax" else TRequest)(
        rid=7, prompt=[2, 3, 4], max_new_tokens=10))
    dst.step()
    assert dst.install_active(export) and export.state.slot != 0
    got = next(d for d in dst.run_until_drained() if d.request.rid == 0).generated
    assert got == want
    if dst_fw == "torch" and dst_paged:
        assert dst.release_all_pages() == 0


def test_latent_install_refuses_a_state_with_a_hole(zoo):
    _, tcfg, _, _ = zoo
    cache = tlm.init_cache(tcfg, 2, 32, device="cpu")
    m = tcfg.mla
    L, w = tcfg.n_layers, m.kv_lora_rank + m.qk_rope_head_dim
    pos = np.where(np.arange(32) < 9, np.arange(32), -1).astype(np.int32)
    pos[4] = -1
    state = {"ckv": np.ones((L, 32, w), np.float32),
             "pos": np.broadcast_to(pos, (L, 32)).copy()}
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(tlm.SlotMigrationError, match="lacks positions"):
        tlm.install_slot(tcfg, cache, 1, state, position=9)
    assert all(torch.equal(cache[k], before[k]) for k in cache)

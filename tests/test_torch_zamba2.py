"""zamba2-7b in the port, held to the JAX reference at ``.reduced()`` (5
block slots: 2 groups of one Mamba-2 layer and the shared attention block,
then one tail layer) in f32 with the JAX weights (``params_from_jax`` of
``init_params(cfg, PRNGKey(21))``).

The cache nests the groups' conv/SSM state under ``groups`` with two stack
axes (G, per_group), gives each group's application of the shared block
its own K/V buffer (``attn_*``) and keeps the tail's state under ``tail``.
Checked: configs, parameter names, the cache layout, full-sequence and
``step_with_cache`` logits within 1e-4, the in-place slot wipe and masked
step against the JAX ``reset_slots`` / ``mask_cache_update``, the
contiguous engine's greedy tokens and prefill dispatches equal to the JAX
engine's, and slot migration port → JAX and JAX → port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import RequestState as JRequestState
from repro.serving.engine import SlotExport as JSlotExport
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import RequestState as TRequestState
from repro_torch.serving.engine import SlotExport as TSlotExport

ARCH = "zamba2-7b"
LOGIT_TOL = 1e-4
PROMPTS = {0: [5, 9, 11, 2, 7], 1: [1 + (3 * i) % 17 for i in range(23)],
           2: [1 + (5 * i) % 31 for i in range(37)]}

_ZOO = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs files in parallel workers: one intra-op thread each,
    restored when the module is done."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _zoo():
    if not _ZOO:
        jcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
        tcfg = dataclasses.replace(tget_config(ARCH).reduced(), dtype="float32")
        params = jlm.init_params(jcfg, jax.random.PRNGKey(21))
        model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
        _ZOO.update(jcfg=jcfg, tcfg=tcfg, params=params, model=model)
    return _ZOO["jcfg"], _ZOO["tcfg"], _ZOO["params"], _ZOO["model"]


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _flat(cache):
    """{"groups/conv": leaf, …} of a (nested) cache, numpy leaves."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[k] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


def test_config_matches_reference_full_and_reduced():
    assert ARCH in list_archs()
    full_j, full_t = get_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert dataclasses.asdict(full_j.reduced()) == dataclasses.asdict(full_t.reduced())
    assert not tlm.pageable(full_t) and tlm.rolling_rows(full_t, 4096) is None
    assert tlm._hybrid_shape(full_t) == (13, 5, 3)
    assert tlm._hybrid_shape(full_t.reduced()) == (2, 1, 1)


def test_params_from_jax_names_mirror_the_groups():
    """``mamba_groups.{g}.{i}`` ↔ ``mamba_groups/…[g, i]``,
    ``mamba_tail.{i}`` ↔ ``mamba_tail/…[i]``, ``shared_attn`` unstacked;
    ``init_params`` builds the same names."""
    _, tcfg, params, model = _zoo()
    g = params["mamba_groups"]
    np.testing.assert_array_equal(model.mamba_groups[1][0].mixer.in_proj.w.numpy(),
                                  np.asarray(g["mixer"]["in_proj"]["w"][1, 0]))
    np.testing.assert_array_equal(model.mamba_groups[0][0].mixer.dt_bias.numpy(),
                                  np.asarray(g["mixer"]["dt_bias"][0, 0]))
    np.testing.assert_array_equal(model.mamba_tail[0].ln.scale.numpy(),
                                  np.asarray(params["mamba_tail"]["ln"]["scale"][0]))
    np.testing.assert_array_equal(model.shared_attn.attn.wk.numpy(),
                                  np.asarray(params["shared_attn"]["attn"]["wk"]))
    fresh = tlm.init_params(tcfg, device="cpu")
    assert ({n for n, _ in fresh.named_parameters()}
            == {n for n, _ in model.named_parameters()})
    s = tcfg.ssm
    torch.testing.assert_close(fresh.mamba_tail[0].mixer.A_log,
                               torch.log(torch.arange(1.0, s.n_heads(tcfg.d_model) + 1)))


def test_init_cache_keys_and_shapes_match_reference():
    jcfg, tcfg, _, _ = _zoo()
    jc = jlm.init_cache(jcfg, 3, 40, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, 3, 40, dtype=torch.float32, device="cpu")
    conv = tlm.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    want, got, back = _flat(jc), _flat(tc), _flat(conv)
    assert sorted(got) == sorted(want) == sorted(back)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k])
        assert np.array_equal(back[k], got[k])
    assert got["groups/ssm"].shape[:3] == (2, 1, 3) and got["attn_k"].shape[:3] == (2, 3, 40)


def test_full_sequence_logits_match_reference():
    """32 tokens: two of the reduced config's SSD chunks (the reference's
    full-sequence scan takes whole chunks)."""
    jcfg, tcfg, params, model = _zoo()
    toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    want = jlm.forward(params, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        got = tlm.forward(model, tcfg, torch.from_numpy(toks))
    _close(got, want)


def test_step_with_cache_matches_reference():
    """Two rows: chunks of 16 and 4 (the scan with carried state), then 6
    decode steps with the second row left out (JAX:
    ``mask_cache_update``).  Logits within 1e-4; every leaf equal."""
    jcfg, tcfg, params, model = _zoo()
    rng = np.random.default_rng(5)
    B, S = 2, 48
    jc = jlm.init_cache(jcfg, B, S, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    prompt = rng.integers(1, jcfg.vocab_size, size=(B, 20)).astype(np.int32)
    chunks = [np.arange(16), np.arange(16, 20)]
    write, tokens = None, None
    for i in range(len(chunks) + 6):
        if i < len(chunks):
            pos = np.broadcast_to(chunks[i].astype(np.int32), (B, len(chunks[i]))).copy()
            tokens = prompt[:, chunks[i]]
            act = np.array([True, True])
        else:
            pos = pos[:, -1:] + 1
            write, act = torch.tensor([0]), np.array([True, False])
        jl, jc2 = jlm.step_with_cache(params, jcfg, jc, jnp.asarray(tokens), jnp.asarray(pos))
        jc = jlm.mask_cache_update(jcfg, jc, jc2, jnp.asarray(act))
        with torch.inference_mode():
            tl, tc = tlm.step_with_cache(model, tcfg, tc, torch.from_numpy(tokens),
                                         torch.from_numpy(pos), write=write)
        _close(tl.numpy()[act], np.asarray(jl)[act])
        if i >= len(chunks) - 1:
            tokens = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    want, got = _flat(jc), _flat(tc)
    assert int(got["attn_pos"].max()) == 25
    for k in want:
        _close(got[k], want[k])


def test_masked_rows_step_and_wipe_match_reset_and_mask():
    """``step_with_cache(write=…)`` and ``wipe_slots_`` on the nested cache
    give the cache of the JAX ``reset_slots`` → step →
    ``mask_cache_update`` sequence; the port's own JAX-semantics
    ``reset_slots`` / ``mask_cache_update`` agree."""
    jcfg, tcfg, params, model = _zoo()
    B, C = 3, 16
    rng = np.random.default_rng(7)
    jc = jlm.init_cache(jcfg, B, 48, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, B, 48, dtype=torch.float32, device="cpu")
    toks = rng.integers(1, tcfg.vocab_size, size=(B, C)).astype(np.int32)
    pos = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    _, jc = jlm.prefill_step(params, jcfg, jc, jnp.asarray(toks), jnp.asarray(pos))
    with torch.no_grad():
        tlm.prefill_step(model, tcfg, tc, torch.from_numpy(toks), torch.from_numpy(pos))
    reset, active = np.array([False, True, False]), np.array([True, True, False])
    toks = rng.integers(1, tcfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos1 = np.array([[C], [0], [C]], np.int32)
    jr = jlm.reset_slots(jcfg, jc, jnp.asarray(reset))
    _, jn = jlm.step_with_cache(params, jcfg, jr, jnp.asarray(toks), jnp.asarray(pos1))
    jm = jlm.mask_cache_update(jcfg, jr, jn, jnp.asarray(active))
    clone = lambda c: tlm.map_leaves(lambda p, t: t.clone(), c)
    pure = tlm.reset_slots(tcfg, clone(tc), torch.from_numpy(reset))
    pure_old = clone(pure)
    with torch.no_grad():
        tlm.wipe_slots_(tc, [1])
        tlm.step_with_cache(model, tcfg, tc, torch.from_numpy(toks), torch.from_numpy(pos1),
                            write=torch.from_numpy(np.flatnonzero(active)))
        tlm.step_with_cache(model, tcfg, pure, torch.from_numpy(toks), torch.from_numpy(pos1))
    pure = tlm.mask_cache_update(tcfg, pure_old, pure, torch.from_numpy(active))
    want = _flat(jm)
    for got in (_flat(tc), _flat(pure)):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])


def _serve(eng, req_cls, max_new=8):
    for rid, p in PROMPTS.items():
        eng.submit(req_cls(rid=rid, prompt=list(p), max_new_tokens=max_new))
    return {d.request.rid: (d.generated, d.prefill_dispatches)
            for d in eng.run_until_drained()}


def test_contiguous_engine_matches_reference_tokens_and_dispatches():
    """Prompts of 5, 23 and 37 tokens on 2 slots: chunks follow the SSD
    rule (chunk 16 in the reduced config), tokens exact and prefill
    dispatches equal to the JAX engine's."""
    jcfg, tcfg, params, model = _zoo()
    jeng = JEngine(jcfg, params, n_slots=2, max_seq_len=64, paged=False)
    teng = TEngine(tcfg, model, n_slots=2, max_seq_len=64, device="cpu")
    assert not teng.paged and teng._rolling_limit is None
    assert teng._chunk_sizes == jeng._chunk_sizes == (64, 32, 16, 8, 4, 2, 1)
    want, got = _serve(jeng, JRequest), _serve(teng, TRequest)
    assert got == want
    assert [got[r][1] for r in range(3)] == [2, 4, 3]          # 4+1, 16+4+2+1, 32+4+1


def _convert(export, to):
    """The same export for the other framework: request, state, numpy cache
    (nested dicts kept)."""
    jcfg, tcfg = _zoo()[:2]
    req_cls, state_cls, export_cls, cfg = (
        (JRequest, JRequestState, JSlotExport, jcfg) if to == "jax" else
        (TRequest, TRequestState, TSlotExport, tcfg))
    r, s = export.request, export.state
    req = req_cls(r.rid, list(r.prompt), r.max_new_tokens, r.eos_id, r.arrival_time,
                  first_token_time=r.first_token_time, prior_generated=r.prior_generated)
    orig = req_cls(s.request.rid, list(s.request.prompt), s.request.max_new_tokens,
                   s.request.eos_id, s.request.arrival_time)
    st = state_cls(orig, s.slot, list(s.generated), s.position,
                   first_token_time=s.first_token_time,
                   prefill_dispatches=s.prefill_dispatches, prior_generated=s.prior_generated)
    return export_cls(req, st, cfg, jax.tree.map(np.asarray, export.cache), export.position)


def _engine(fw, **kw):
    jcfg, tcfg, params, model = _zoo()
    if fw == "jax":
        return JEngine(jcfg, params, paged=False, **kw)
    return TEngine(tcfg, model, device="cpu", **kw)


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_migration_between_frameworks_decodes_the_undisturbed_tokens(src, dst):
    """A request 3 steps into decode moves, with its groups' and tail's
    recurrent state and its per-group K/V, into slot 1 of a busy target of
    another ``max_seq_len``; it finishes with the undisturbed tokens."""
    req = lambda fw, **kw: (JRequest if fw == "jax" else TRequest)(**kw)
    ref = _engine(src, n_slots=2, max_seq_len=48)
    ref.submit(req(src, rid=0, prompt=list(PROMPTS[1]), max_new_tokens=8))
    want = ref.run_until_drained()[0].generated
    eng = _engine(src, n_slots=2, max_seq_len=48)
    eng.submit(req(src, rid=0, prompt=list(PROMPTS[1]), max_new_tokens=8))
    for _ in range(3):
        eng.step()
    [export] = eng.export_active()
    assert export.position == 26 and sorted(export.cache["groups"]) == ["conv", "ssm"]
    export = _convert(export, dst)
    tgt = _engine(dst, n_slots=3, max_seq_len=64)
    tgt.submit(req(dst, rid=7, prompt=[2, 3, 4], max_new_tokens=10))
    tgt.step()
    assert tgt.install_active(export) and export.state.slot != 0
    got = next(d for d in tgt.run_until_drained() if d.request.rid == 0).generated
    assert got == want


def test_incompatible_state_is_refused_untouched():
    """A state without the tail's stack, or whose group state has another
    shape, raises ``SlotMigrationError`` with the cache as it was, though
    its attention buffers would have fit."""
    _, tcfg, _, model = _zoo()
    eng = _engine("torch", n_slots=2, max_seq_len=48)
    eng.submit(TRequest(rid=0, prompt=list(PROMPTS[1]), max_new_tokens=8))
    eng.step()
    state = tlm.extract_slot(tcfg, eng.cache, 0)
    target = tlm.init_cache(tcfg, 2, 48, device="cpu")
    before = _flat(target)
    no_tail = {k: v for k, v in state.items() if k != "tail"}
    with pytest.raises(tlm.SlotMigrationError, match="tail"):
        tlm.install_slot(tcfg, target, 1, no_tail, 24)
    bad = dict(state, groups={"conv": state["groups"]["conv"][:1, :, :1],
                              "ssm": state["groups"]["ssm"]})
    with pytest.raises(tlm.SlotMigrationError, match="state shape"):
        tlm.install_slot(tcfg, target, 1, bad, 24)
    after = _flat(target)
    assert all(np.array_equal(after[k], before[k]) for k in before)
    tlm.install_slot(tcfg, target, 1, state, 24)
    assert np.array_equal(_flat(target)["groups/ssm"][:, :, 1], state["groups"]["ssm"])


def test_serve_main_runs_zamba2_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                        "--max-new", "3", "--prompt-len", "20", "--resize"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} served 3 requests" in out and "resize[drain]" in out

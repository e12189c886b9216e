"""whisper-tiny in the port, held to the JAX reference at ``.reduced()``
(2 encoder and 4 decoder layers, d 64, 8 frames) in f32 with the JAX
weights (``params_from_jax`` of ``init_params(cfg, PRNGKey(21))``).

Checked: the config and registry, parameter names, the cache layout
(``k/v/pos`` and the cross-attention's ``xk/xv``), ``forward`` with frame
embeddings and the encoder within 1e-4, ``decode_step`` on a cache whose
``xk``/``xv`` the encoder filled (as ``tests/test_models.py`` fills it),
the contiguous engine's greedy tokens and prefill dispatches equal to the
JAX engine's (both serve with zero cross state), slot migration JAX → port
and port → JAX, the paged pool's refusal, and the plain flash attention
at ``causal=False`` against the Pallas kernel in interpret mode.

The JAX encoder passes ``causal=False`` to ``attention_fwd``, whose
full-sequence mode builds the causal mask regardless; the port's encoder
is causal too, and ``test_encoder_is_causal_like_the_reference`` pins it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs import list_archs as jlist_archs
from repro.kernels.flash_attention import ops as jfa
from repro.models import lm as jlm
from repro.models.layers import attention_fwd as jattention_fwd
from repro.models.layers import rmsnorm as jrmsnorm
from repro.models.layers import swiglu as jswiglu
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import RequestState as JRequestState
from repro.serving.engine import SlotExport as JSlotExport
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import RequestState as TRequestState
from repro_torch.serving.engine import SlotExport as TSlotExport

ARCH = "whisper-tiny"
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


def _frames(B: int, seed: int = 0) -> np.ndarray:
    jcfg = _zoo()[0]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, jcfg.n_frames, jcfg.d_model)).astype(np.float32)


def _jax_encoder(params, cfg, frames):
    """The encoder as ``tests/test_models.py`` runs it by hand."""
    enc = frames + params["enc_pos"][None].astype(jnp.float32)
    fpos = jnp.broadcast_to(jnp.arange(enc.shape[1], dtype=jnp.int32)[None], enc.shape[:2])
    h = enc
    for i in range(cfg.n_encoder_layers):
        lp = jax.tree.map(lambda t: t[i], params["enc_layers"])
        o, _ = jattention_fwd(lp["attn"], cfg, jrmsnorm(h, lp["ln1"]["scale"], cfg.norm_eps),
                              fpos, None, causal=False)
        h = h + o
        h = h + jswiglu(lp["ffn"], jrmsnorm(h, lp["ln2"]["scale"], cfg.norm_eps))
    return jrmsnorm(h, params["enc_norm"]["scale"], cfg.norm_eps)


def _jax_fill_cross(params, cfg, cache, enc_out):
    B, F, _ = enc_out.shape
    shape = (B, F, cfg.n_kv_heads, cfg.d_head)
    xks, xvs = [], []
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda t: t[i], params["layers"])
        xks.append((enc_out @ lp["xattn"]["wk"]).reshape(shape))
        xvs.append((enc_out @ lp["xattn"]["wv"]).reshape(shape))
    return dict(cache, xk=jnp.stack(xks), xv=jnp.stack(xvs))


def test_config_matches_reference_full_and_reduced():
    assert ARCH in list_archs()
    assert sorted(list_archs()) == sorted(jlist_archs())
    full_j, full_t = get_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert dataclasses.asdict(full_j.reduced()) == dataclasses.asdict(full_t.reduced())
    assert (full_t.family, full_t.n_layers, full_t.n_encoder_layers, full_t.d_model,
            full_t.n_heads, full_t.n_kv_heads, full_t.d_head, full_t.d_ff,
            full_t.vocab_size, full_t.n_frames) == ("audio", 4, 4, 384, 6, 6, 64, 1536,
                                                    51865, 1500)
    assert full_t.tie_embeddings and not tlm.pageable(full_t)
    assert tlm.ring_window(full_t) is None


def test_params_from_jax_names_mirror_the_encoder_and_cross_attention():
    """``enc_pos``, ``enc_layers.{l}`` ↔ ``enc_layers/…[l]``, ``enc_norm``,
    and each decoder layer's ``ln_x``/``xattn``; the head is tied."""
    _, tcfg, params, model = _zoo()
    assert len(model.enc_layers) == tcfg.n_encoder_layers == 2
    assert len(model.layers) == tcfg.n_layers == 4
    np.testing.assert_array_equal(model.enc_pos.numpy(), np.asarray(params["enc_pos"]))
    np.testing.assert_array_equal(model.enc_layers[1].attn.wk.numpy(),
                                  np.asarray(params["enc_layers"]["attn"]["wk"][1]))
    np.testing.assert_array_equal(model.enc_norm.scale.numpy(),
                                  np.asarray(params["enc_norm"]["scale"]))
    np.testing.assert_array_equal(model.layers[2].xattn.wv.numpy(),
                                  np.asarray(params["layers"]["xattn"]["wv"][2]))
    np.testing.assert_array_equal(model.layers[3].ln_x.scale.numpy(),
                                  np.asarray(params["layers"]["ln_x"]["scale"][3]))
    assert not hasattr(model, "lm_head") and not hasattr(model.enc_layers[0], "xattn")
    names = {n for n, _ in tlm.init_params(tcfg, device="cpu").named_parameters()}
    assert names == {n for n, _ in model.named_parameters()}


def test_init_cache_keys_and_shapes_match_reference():
    jcfg, tcfg, _, _ = _zoo()
    jc = jlm.init_cache(jcfg, 3, 24, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, 3, 24, dtype=torch.float32, device="cpu")
    conv = tlm.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    assert sorted(tc) == sorted(jc) == sorted(conv) == ["k", "pos", "v", "xk", "xv"]
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and tc[k].dtype == conv[k].dtype
        assert torch.equal(conv[k], tc[k])
    assert tuple(tc["xk"].shape) == (4, 3, 8, 4, 16) and not tc["xk"].any()


def test_forward_with_frames_matches_reference():
    """Two rows of 11 tokens over 8 frames each: encoder, self- and
    cross-attention, tied head; logits within 1e-4, and the encoder output
    against the hand-run JAX encoder."""
    jcfg, tcfg, params, model = _zoo()
    toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    frames = _frames(2)
    want = jlm.forward(params, jcfg, jnp.asarray(toks), frames=jnp.asarray(frames))
    with torch.inference_mode():
        got = tlm.forward(model, tcfg, torch.from_numpy(toks), frames=torch.from_numpy(frames))
        enc = tlm.encode(model, tcfg, torch.from_numpy(frames))
    _close(got, want)
    _close(enc, _jax_encoder(params, jcfg, jnp.asarray(frames)))
    with pytest.raises(ValueError, match="frame embeddings"):
        tlm.forward(model, tcfg, torch.from_numpy(toks))


def test_encoder_is_causal_like_the_reference():
    """Changing the last frame leaves the first frames' encoder output as
    it was, in both frameworks."""
    jcfg, tcfg, params, model = _zoo()
    a = _frames(1, seed=2)
    b = a.copy()
    b[:, -1] += 1.0
    ja, jb = (np.asarray(_jax_encoder(params, jcfg, jnp.asarray(f))) for f in (a, b))
    with torch.inference_mode():
        ta, tb = (tlm.encode(model, tcfg, torch.from_numpy(f)).numpy() for f in (a, b))
    np.testing.assert_array_equal(ja[:, :-1], jb[:, :-1])
    np.testing.assert_array_equal(ta[:, :-1], tb[:, :-1])
    assert np.abs(ta[:, -1] - tb[:, -1]).max() > 1e-3


def test_decode_on_an_encoder_filled_cache_matches_reference():
    """Two rows, xk/xv filled from the encoder as ``tests/test_models.py``
    fills them: a 6-token prefill chunk (cross-attention through flash
    attention), then 8 decode steps (through the decode) with the second
    row left out of the last four (JAX: ``mask_cache_update``).  Logits of
    the rows kept within 1e-4; the caches equal."""
    jcfg, tcfg, params, model = _zoo()
    rng = np.random.default_rng(5)
    B, S = 2, 24
    frames = _frames(B, seed=3)
    jc = _jax_fill_cross(params, jcfg, jlm.init_cache(jcfg, B, S, dtype=jnp.float32),
                         _jax_encoder(params, jcfg, jnp.asarray(frames)))
    tc = tlm.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        tlm.fill_cross_cache(model, tcfg, tc, tlm.encode(model, tcfg, torch.from_numpy(frames)))
    _close(tc["xk"].numpy(), jc["xk"], 1e-5)
    _close(tc["xv"].numpy(), jc["xv"], 1e-5)
    tokens = rng.integers(1, jcfg.vocab_size, size=(B, 6)).astype(np.int32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (B, 6)).copy()
    write, act = None, np.array([True, True])
    for step in range(9):
        if step == 5:
            write, act = torch.tensor([0]), np.array([True, False])
        jl, jc2 = jlm.step_with_cache(params, jcfg, jc, jnp.asarray(tokens), jnp.asarray(pos))
        jc = jlm.mask_cache_update(jcfg, jc, jc2, jnp.asarray(act))
        with torch.inference_mode():
            tl, tc = tlm.step_with_cache(model, tcfg, tc, torch.from_numpy(tokens),
                                         torch.from_numpy(pos), write=write)
        _close(tl.numpy()[act], np.asarray(jl)[act])
        tokens = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
        pos = pos[:, -1:] + 1
    for k in jc:
        _close(tc[k].numpy(), jc[k])


def test_decode_step_matches_reference_from_position_zero():
    """``decode_step`` token by token from an empty self-attention cache
    (``tests/test_models.py``'s loop) on one encoder-filled row."""
    jcfg, tcfg, params, model = _zoo()
    frames = _frames(1, seed=4)
    jc = _jax_fill_cross(params, jcfg, jlm.init_cache(jcfg, 1, 16, dtype=jnp.float32),
                         _jax_encoder(params, jcfg, jnp.asarray(frames)))
    tc = tlm.init_cache(tcfg, 1, 16, dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(6).integers(1, jcfg.vocab_size, size=(1, 10)).astype(np.int32)
    with torch.inference_mode():
        tlm.fill_cross_cache(model, tcfg, tc, tlm.encode(model, tcfg, torch.from_numpy(frames)))
        for i in range(10):
            jl, jc = jlm.decode_step(params, jcfg, jc, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.array([i], jnp.int32))
            tl, tc = tlm.decode_step(model, tcfg, tc, torch.from_numpy(toks[:, i:i + 1]),
                                     torch.tensor([i]))
            _close(tl.numpy(), jl)
    full = jlm.forward(params, jcfg, jnp.asarray(toks), frames=jnp.asarray(frames))
    _close(tl.numpy()[:, 0], np.asarray(full)[:, -1])


def test_cross_attention_of_an_idle_lane_is_zero():
    """``kv_len`` 0 writes zeros through both plain versions (prefill chunk
    and decode), so only the projection's zero reaches the residual."""
    _, tcfg, _, model = _zoo()
    rng = np.random.default_rng(7)
    xk, xv = (torch.from_numpy(rng.standard_normal((2, 8, 4, 16)).astype(np.float32))
              for _ in range(2))
    kl = torch.tensor([8, 0], dtype=torch.int32)
    p = model.layers[0].xattn
    for C in (1, 5):
        x = torch.from_numpy(rng.standard_normal((2, C, tcfg.d_model)).astype(np.float32))
        out = tlayers.cross_attention_fwd(p, tcfg, x, xk, xv, kl)
        full = tlayers.cross_attention_fwd(p, tcfg, x, xk, xv)
        assert not out[1].any()
        torch.testing.assert_close(out[0], full[0], atol=1e-6, rtol=1e-6)


def _serve(eng, req_cls, max_new=8):
    for rid, p in PROMPTS.items():
        eng.submit(req_cls(rid=rid, prompt=list(p), max_new_tokens=max_new))
    return {d.request.rid: (d.generated, d.prefill_dispatches)
            for d in eng.run_until_drained()}


def test_contiguous_engine_matches_reference_tokens_and_dispatches():
    """Prompts of 5, 23 and 37 tokens on 2 slots: both engines serve with
    the zero cross state ``init_cache`` gives (no encoder run per request);
    tokens exact and prefill dispatches equal to the JAX engine's; the
    cross state stays zero."""
    jcfg, tcfg, params, model = _zoo()
    jeng = JEngine(jcfg, params, n_slots=2, max_seq_len=48)
    teng = TEngine(tcfg, model, n_slots=2, max_seq_len=48, device="cpu")
    assert not teng.paged and not jeng.paged
    assert teng._chunk_sizes == jeng._chunk_sizes
    want, got = _serve(jeng, JRequest), _serve(teng, TRequest)
    assert got == want
    assert [got[r][1] for r in range(3)] == [2, 4, 3]        # 4+1, 16+4+2+1, 32+4+1
    assert not teng.cache["xk"].any() and not teng.cache["xv"].any()
    assert teng.dispatches == jeng.dispatches


def test_paged_pool_is_refused_like_the_reference():
    jcfg, tcfg, params, model = _zoo()
    for make in (lambda: JEngine(jcfg, params, n_slots=2, max_seq_len=48, paged=True),
                 lambda: TEngine(tcfg, model, n_slots=2, max_seq_len=48, paged=True,
                                 device="cpu")):
        with pytest.raises(ValueError, match="cannot use the paged"):
            make()
    with pytest.raises(ValueError, match="not pageable"):
        tlm.init_paged_cache(tcfg, 9, 4, device="cpu")


def _convert(export, to):
    """The same export for the other framework: request, state, numpy cache."""
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
    return export_cls(req, st, cfg, {k: np.asarray(v) for k, v in export.cache.items()},
                      export.position)


def _engine(fw, **kw):
    jcfg, tcfg, params, model = _zoo()
    if fw == "jax":
        return JEngine(jcfg, params, paged=False, **kw)
    return TEngine(tcfg, model, device="cpu", **kw)


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_migration_between_frameworks_decodes_the_undisturbed_tokens(src, dst):
    """A request partway through decode moves into slot 1 of a busy target
    of another ``max_seq_len`` and finishes with the tokens it would have
    had undisturbed; its ``xk``/``xv`` travel whole."""
    req = JRequest if src == "jax" else TRequest
    ref = _engine(src, n_slots=2, max_seq_len=48)
    ref.submit(req(rid=0, prompt=list(PROMPTS[1]), max_new_tokens=8))
    want = ref.run_until_drained()[0].generated
    eng = _engine(src, n_slots=2, max_seq_len=48)
    eng.submit(req(rid=0, prompt=list(PROMPTS[1]), max_new_tokens=8))
    for _ in range(4):
        eng.step()
    [export] = eng.export_active()
    assert export.position == 27 and export.cache["xk"].shape == (4, 8, 4, 16)
    export = _convert(export, dst)
    tgt = _engine(dst, n_slots=3, max_seq_len=64)
    tgt.submit((JRequest if dst == "jax" else TRequest)(rid=7, prompt=[2, 3, 4],
                                                        max_new_tokens=10))
    tgt.step()
    assert tgt.install_active(export) and export.state.slot != 0
    got = next(d for d in tgt.run_until_drained() if d.request.rid == 0).generated
    assert got == want


def test_install_slot_copies_the_cross_state_whole():
    """A slot state with nonzero ``xk``/``xv`` lands in the target slot
    exactly, leaving the other slots; a state of another frame count is
    refused with the cache untouched."""
    _, tcfg, _, _ = _zoo()
    src = tlm.init_cache(tcfg, 2, 16, device="cpu")
    rng = np.random.default_rng(8)
    for k in ("k", "v", "xk", "xv"):
        src[k].copy_(torch.from_numpy(rng.standard_normal(tuple(src[k].shape))
                                      .astype(np.float32)))
    src["pos"][:, 1, :5] = torch.arange(5, dtype=torch.int32)
    state = tlm.extract_slot(tcfg, src, 1)
    dst = tlm.init_cache(tcfg, 3, 24, device="cpu")
    tlm.install_slot(tcfg, dst, 2, state, 5)
    assert torch.equal(dst["xk"][:, 2], src["xk"][:, 1])
    assert torch.equal(dst["xv"][:, 2], src["xv"][:, 1])
    assert not dst["xk"][:, :2].any()
    assert torch.equal(dst["k"][:, 2, :5], src["k"][:, 1, :5])
    before = {k: v.clone() for k, v in dst.items()}
    bad = dict(state, xk=state["xk"][:, :4])
    with pytest.raises(tlm.SlotMigrationError, match="state shape"):
        tlm.install_slot(tcfg, dst, 0, bad, 5)
    assert all(torch.equal(dst[k], before[k]) for k in dst)
    wiped = tlm.reset_slots(tcfg, src, torch.tensor([False, True]))
    assert not wiped["xk"][:, 1].any() and torch.equal(wiped["xk"][:, 0], src["xk"][:, 0])
    assert (wiped["pos"][:, 1] == -1).all()
    tlm.wipe_slots_(src, [1])
    assert all(torch.equal(src[k], wiped[k]) for k in src)


@pytest.mark.parametrize("Sq,Sk,H,Hkv,D", [(16, 150, 4, 4, 64), (64, 97, 6, 6, 64),
                                           (32, 200, 4, 2, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_noncausal_kv_len_matches_pallas(Sq, Sk, H, Hkv, D, dtype):
    """The cross-attention's call: ``causal=False`` with Sq ≠ Sk, Sk not a
    multiple of 64 and a per-lane ``kv_len`` — one lane at Sk, one at 0,
    one partway.  Each active lane against the Pallas kernel in interpret
    mode on its first ``kv_len`` keys; the idle lane writes zeros."""
    rng = np.random.default_rng(9)
    to = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    q = torch.from_numpy(rng.standard_normal((3, Sq, H, D)).astype(np.float32)).to(to)
    k, v = (torch.from_numpy(rng.standard_normal((3, Sk, Hkv, D)).astype(np.float32)).to(to)
            for _ in range(2))
    kl = [Sk, 0, Sk - 37]
    got = tfa.flash_attention(q, k, v, causal=False, kv_len=torch.tensor(kl, dtype=torch.int32))
    assert not got[1].float().any()
    for b in (0, 2):
        n = kl[b]
        j = lambda t: jnp.asarray(t[b:b + 1].float().numpy()).astype(jnp.dtype(dtype))
        want = jfa.flash_attention(j(q), j(k[:, :n]), j(v[:, :n]), causal=False,
                                   block_q=Sq, block_k=n, interpret=True)
        np.testing.assert_allclose(got[b:b + 1].float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_serve_main_runs_whisper_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                        "--max-new", "3", "--prompt-len", "20", "--resize"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} served 3 requests" in out and "resize[drain]" in out

"""gemma2-9b in the port, held to the JAX reference at ``.reduced()`` (two
local/global layer pairs, window 16, softcaps 50 and 30) in f32 with the
JAX weights (``params_from_jax`` of ``init_params(cfg, PRNGKey(20))``).

The local layers keep a rolling ring of ``min(window, seq_len)`` rows
(``loc_*``), the global layers a plain buffer (``glob_*``).  Prompts of 23
and 37 tokens cross the 16-row ring: the engine prefills in chunks while
the prefix fits it, then one token at a time, as the JAX engine does.
Checked: configs, parameter names, the cache layout, full-sequence and
``step_with_cache`` logits within 1e-4, the contiguous engine's greedy
tokens and prefill dispatches equal to the JAX engine's, and slot
migration port → JAX and JAX → port, with the refusal when the target's
local ring is too short.
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

ARCH = "gemma2-9b"
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
        params = jlm.init_params(jcfg, jax.random.PRNGKey(20))
        model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
        _ZOO.update(jcfg=jcfg, tcfg=tcfg, params=params, model=model)
    return _ZOO["jcfg"], _ZOO["tcfg"], _ZOO["params"], _ZOO["model"]


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def test_config_matches_reference_full_and_reduced():
    assert ARCH in list_archs()
    full_j, full_t = get_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert dataclasses.asdict(full_j.reduced()) == dataclasses.asdict(full_t.reduced())
    assert not tlm.pageable(full_t) and tlm.ring_window(full_t) is None
    assert tlm.rolling_rows(full_t, 8192) == 4096 and tlm.rolling_rows(full_t, 1024) == 1024
    assert full_t.attn_logit_softcap == 50.0 and full_t.final_logit_softcap == 30.0


def test_params_from_jax_names_mirror_the_pairs():
    """``layer_pairs.{i}.{j}`` ↔ ``layer_pairs/…[i, j]``, j = 0 local, 1
    global; the embedding is tied (no ``lm_head``)."""
    _, tcfg, params, model = _zoo()
    pairs = params["layer_pairs"]
    assert len(model.layer_pairs) == tcfg.n_layers // 2 == 2
    np.testing.assert_array_equal(model.layer_pairs[1][0].attn.wq.numpy(),
                                  np.asarray(pairs["attn"]["wq"][1, 0]))
    np.testing.assert_array_equal(model.layer_pairs[0][1].ffn.w_down.numpy(),
                                  np.asarray(pairs["ffn"]["w_down"][0, 1]))
    np.testing.assert_array_equal(model.layer_pairs[1][1].ln2.scale.numpy(),
                                  np.asarray(pairs["ln2"]["scale"][1, 1]))
    assert not hasattr(model, "lm_head") and not hasattr(model, "layers")
    names = {n for n, _ in tlm.init_params(tcfg, device="cpu").named_parameters()}
    assert names == {n for n, _ in model.named_parameters()}


def test_init_cache_keys_and_shapes_match_reference():
    jcfg, tcfg, _, _ = _zoo()
    for seq_len in (12, 48):
        jc = jlm.init_cache(jcfg, 3, seq_len, dtype=jnp.float32)
        tc = tlm.init_cache(tcfg, 3, seq_len, dtype=torch.float32, device="cpu")
        conv = tlm.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
        assert sorted(tc) == sorted(jc) == sorted(conv)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape and tc[k].dtype == conv[k].dtype
            assert torch.equal(conv[k], tc[k])
        assert tc["loc_k"].shape[2] == min(16, seq_len) and tc["glob_k"].shape[2] == seq_len


def test_full_sequence_logits_match_reference():
    """37 tokens: the local layers' window of 16 binds, the softcaps and the
    embedding's √d scale apply."""
    jcfg, tcfg, params, model = _zoo()
    toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, size=(2, 37)).astype(np.int32)
    want = jlm.forward(params, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        got = tlm.forward(model, tcfg, torch.from_numpy(toks))
    _close(got, want)


def test_step_with_cache_across_the_local_ring_matches_reference():
    """Two rows: a 16-token chunk fills the local ring, 7 single tokens
    cross it (the engine's rule), then 6 decode steps with the second row
    left out (JAX: ``mask_cache_update``).  Logits within 1e-4; both
    buffers' K/V and positions equal."""
    jcfg, tcfg, params, model = _zoo()
    rng = np.random.default_rng(5)
    B, S = 2, 48
    jc = jlm.init_cache(jcfg, B, S, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    prompt = rng.integers(1, jcfg.vocab_size, size=(B, 23)).astype(np.int32)
    chunks = [np.arange(16)] + [np.array([p]) for p in range(16, 23)]
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
    assert int(tc["loc_pos"].max()) == 28 and int(tc["glob_pos"].max()) == 28
    for k in jc:
        _close(tc[k].numpy(), jc[k])


def _serve(eng, req_cls, max_new=8):
    for rid, p in PROMPTS.items():
        eng.submit(req_cls(rid=rid, prompt=list(p), max_new_tokens=max_new))
    return {d.request.rid: (d.generated, d.prefill_dispatches)
            for d in eng.run_until_drained()}


def test_contiguous_engine_matches_reference_tokens_and_dispatches():
    """Prompts of 5, 23 and 37 tokens: chunks of up to 16 while the prefix
    fits the local ring, then one token at a time; tokens exact and
    prefill dispatches equal to the JAX engine's."""
    jcfg, tcfg, params, model = _zoo()
    jeng = JEngine(jcfg, params, n_slots=2, max_seq_len=48, paged=False)
    teng = TEngine(tcfg, model, n_slots=2, max_seq_len=48, device="cpu")
    assert not teng.paged
    assert teng._chunk_sizes == jeng._chunk_sizes == (16, 8, 4, 2, 1)
    assert teng._rolling_limit == jeng._rolling_limit == 16
    want, got = _serve(jeng, JRequest), _serve(teng, TRequest)
    assert got == want
    assert [got[r][1] for r in range(3)] == [2, 1 + 7, 1 + 21]


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


def _partway(fw):
    eng = _engine(fw, n_slots=2, max_seq_len=48)
    eng.submit((JRequest if fw == "jax" else TRequest)(rid=0, prompt=list(PROMPTS[1]),
                                                       max_new_tokens=8))
    for _ in range(3):
        eng.step()                     # position 26: the local ring has wrapped
    [export] = eng.export_active()
    return export


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_migration_between_frameworks_decodes_the_undisturbed_tokens(src, dst):
    """A request past its local ring moves into slot 1 of a busy target of
    another ``max_seq_len`` (the ring keeps 16 rows, the global buffer
    grows) and finishes with the tokens it would have had undisturbed."""
    ref = _engine(src, n_slots=2, max_seq_len=48)
    ref.submit((JRequest if src == "jax" else TRequest)(rid=0, prompt=list(PROMPTS[1]),
                                                        max_new_tokens=8))
    want = ref.run_until_drained()[0].generated
    export = _partway(src)
    assert export.position == 26 and export.cache["loc_k"].shape[1] == 16
    export = _convert(export, dst)
    eng = _engine(dst, n_slots=3, max_seq_len=64)
    eng.submit((JRequest if dst == "jax" else TRequest)(rid=7, prompt=[2, 3, 4],
                                                        max_new_tokens=10))
    eng.step()
    assert eng.install_active(export) and export.state.slot != 0
    got = next(d for d in eng.run_until_drained() if d.request.rid == 0).generated
    assert got == want


def test_too_short_local_ring_and_holes_are_refused_untouched():
    """A target whose local ring holds 8 rows cannot keep the 15 earlier
    positions the window of 16 still sees; a state whose global buffer
    lacks position 20 cannot fill the rows the kernels read.  Both raise
    ``SlotMigrationError`` with the whole cache as it was (the local ring
    of the second state would have fit: nothing is written before every
    buffer is checked), and the engine declines the install."""
    _, tcfg = _zoo()[:2]
    export = _partway("torch")
    short = tlm.init_cache(tcfg, 2, 8, device="cpu")
    assert short["loc_k"].shape[2] == 8
    before = {k: v.clone() for k, v in short.items()}
    with pytest.raises(tlm.SlotMigrationError, match="cannot hold the positions"):
        tlm.install_slot(tcfg, short, 1, export.cache, export.position)
    assert all(torch.equal(short[k], before[k]) for k in short)

    holed = dict(export.cache, glob_pos=export.cache["glob_pos"].copy())
    holed["glob_pos"][:, 20] = -1
    eng = _engine("torch", n_slots=2, max_seq_len=48)
    before = {k: v.clone() for k, v in eng.cache.items()}
    with pytest.raises(tlm.SlotMigrationError, match="lacks positions"):
        tlm.install_slot(tcfg, eng.cache, 1, holed, export.position)
    assert all(torch.equal(eng.cache[k], before[k]) for k in before)
    export.cache = holed
    assert not eng.install_active(export) and not eng.active


def test_serve_main_runs_gemma2_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                        "--max-new", "3", "--prompt-len", "20", "--resize"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} served 3 requests" in out and "resize[drain]" in out

"""The rolling sliding-window ring of the port's contiguous cache, held to
the JAX reference on reduced ``mixtral-8x7b`` and ``mixtral-8x22b``
(window 16, so the ring holds 16 rows) in f32 with the same weights.

A 23-token prompt crosses the ring during prefill and decode wraps it:
``step_with_cache`` logits within 1e-4 of JAX's, the contiguous engine's
tokens and prefill dispatch counts equal to the JAX contiguous engine's
(the same chunk rule), and ring installs JAX → port, port → JAX,
ring → paged and paged → ring decoding the undisturbed tokens.  A target
ring too short for the still-visible positions, or a state with a hole
where the kernels read, is refused with the cache left untouched.
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
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import RequestState as TRequestState
from repro_torch.serving.engine import SlotExport as TSlotExport

ARCHS = ["mixtral-8x7b", "mixtral-8x22b"]
LOGIT_TOL = 1e-4
PAGE = 4
PROMPT = [1 + (3 * i) % 17 for i in range(23)]

_ZOO = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs files in parallel workers: one intra-op thread each,
    restored when the module is done."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _zoo(arch):
    if arch not in _ZOO:
        jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
        params = jlm.init_params(jcfg, jax.random.PRNGKey(8))
        model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
        _ZOO[arch] = (jcfg, tcfg, params, model)
    return _ZOO[arch]


def _engine(arch, framework, paged, **kw):
    jcfg, tcfg, params, model = _zoo(arch)
    if framework == "jax":
        return JEngine(jcfg, params, paged=paged, page_size=PAGE, **kw)
    return TEngine(tcfg, model, paged=paged, page_size=PAGE, device="cpu", **kw)


def _req(framework):
    return JRequest if framework == "jax" else TRequest


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_cache_is_the_reference_layout(arch):
    jcfg, tcfg = _zoo(arch)[:2]
    assert tlm.ring_window(tcfg) == 16 and tlm.cache_seq_len(tcfg, 48) == 16
    jc = jlm.init_cache(jcfg, 2, 48, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, 2, 48, dtype=torch.float32, device="cpu")
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and tc[k].shape[2] == 16


@pytest.mark.parametrize("arch", ARCHS)
def test_step_with_cache_across_the_ring_matches_reference(arch):
    """Two rows: a 16-token chunk fills the ring, 7 single tokens cross its
    boundary (the engine's rule), then 6 decode steps wrap it again with
    the second row left out (JAX: ``mask_cache_update``).  Logits within
    1e-4, the ring's K/V and positions equal."""
    jcfg, tcfg, params, model = _zoo(arch)
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
        np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        if i >= len(chunks) - 1:
            tokens = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert int(tc["pos"].max()) == 28 and int((tc["pos"][:, 0] >= 13).sum()) == 16 * tcfg.n_layers
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_engine_matches_reference_tokens_and_dispatches(arch):
    """Prompts of 5, 23 and 37 tokens on a contiguous engine: chunks of up
    to 16 while the prefix fits the ring, then one token at a time, as the
    JAX engine does; tokens and prefill dispatches equal."""
    prompts = {0: [5, 9, 11, 2, 7], 1: list(PROMPT), 2: [1 + (3 * i) % 17 for i in range(37)]}

    def serve(eng):
        for rid, p in prompts.items():
            eng.submit(_req("torch" if isinstance(eng, TEngine) else "jax")(
                rid=rid, prompt=list(p), max_new_tokens=8))
        return {d.request.rid: (d.generated, d.prefill_dispatches)
                for d in eng.run_until_drained()}

    jeng = _engine(arch, "jax", False, n_slots=2, max_seq_len=48)
    teng = _engine(arch, "torch", False, n_slots=2, max_seq_len=48)
    assert teng._chunk_sizes == jeng._chunk_sizes == (16, 8, 4, 2, 1)
    assert teng._rolling_limit == jeng._rolling_limit == 16
    want, got = serve(jeng), serve(teng)
    assert got == want
    assert [got[r][1] for r in range(3)] == [2, 1 + 7, 1 + 21]


def _convert(export, to, arch):
    """The same export for the other framework: request, state, numpy cache."""
    jcfg, tcfg = _zoo(arch)[:2]
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
                   prefill_dispatches=s.prefill_dispatches,
                   prior_generated=s.prior_generated)
    return export_cls(req, st, cfg, {k: np.asarray(v) for k, v in export.cache.items()},
                      export.position)


def _partway(eng, framework):
    eng.submit(_req(framework)(rid=0, prompt=list(PROMPT), max_new_tokens=8))
    for _ in range(3):
        eng.step()                     # position 26: the ring has wrapped
    [export] = eng.export_active()
    return export


# (source framework, source paged, target framework, target paged)
MOVES = [("jax", False, "torch", False), ("torch", False, "jax", False),
         ("torch", False, "torch", True), ("torch", True, "torch", False)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("src_fw,src_paged,dst_fw,dst_paged", MOVES)
def test_ring_install_decodes_the_undisturbed_tokens(arch, src_fw, src_paged,
                                                     dst_fw, dst_paged):
    """A request past its ring moves into slot 1 of a busy target (whose
    ring is 16 rows at ``max_seq_len`` 64 as at 48); it finishes with the
    undisturbed tokens.  A paged source carries every position, and only
    those inside the window survive into the ring; a ring source carries
    the last 16, enough for the paged target's window."""
    ref = _engine(arch, src_fw, src_paged, n_slots=2, max_seq_len=48)
    ref.submit(_req(src_fw)(rid=0, prompt=list(PROMPT), max_new_tokens=8))
    want = ref.run_until_drained()[0].generated
    export = _partway(_engine(arch, src_fw, src_paged, n_slots=2, max_seq_len=48), src_fw)
    assert export.position == 26
    if dst_fw != src_fw:
        export = _convert(export, dst_fw, arch)
    dst = _engine(arch, dst_fw, dst_paged, n_slots=3, max_seq_len=64)
    dst.submit(_req(dst_fw)(rid=7, prompt=[2, 3, 4], max_new_tokens=10))
    dst.step()
    assert dst.install_active(export) and export.state.slot != 0
    got = next(d for d in dst.run_until_drained() if d.request.rid == 0).generated
    assert got == want
    if dst_fw == "torch" and dst_paged:
        assert dst.release_all_pages() == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_too_short_ring_and_holes_are_refused_untouched(arch):
    """An 8-row ring cannot hold the 15 earlier positions a window of 16
    still sees; a state that lacks one of the last 16 positions cannot
    fill the rows the decode kernel reads.  Both raise
    ``SlotMigrationError`` and leave the target cache as it was; the engine
    then declines the install."""
    _, tcfg = _zoo(arch)[:2]
    export = _partway(_engine(arch, "torch", False, n_slots=2, max_seq_len=48), "torch")
    short = tlm.init_cache(tcfg, 2, 8, device="cpu")
    assert short["k"].shape[2] == 8
    before = {k: v.clone() for k, v in short.items()}
    with pytest.raises(tlm.SlotMigrationError, match="cannot hold the positions"):
        tlm.install_slot(tcfg, short, 1, export.cache, export.position)
    assert all(torch.equal(short[k], before[k]) for k in short)

    holed = dict(export.cache, pos=export.cache["pos"].copy())
    holed["pos"][:, 20 % 16] = -1                   # position 20, still visible
    ring = tlm.init_cache(tcfg, 2, 48, device="cpu")
    before = {k: v.clone() for k, v in ring.items()}
    with pytest.raises(tlm.SlotMigrationError):
        tlm.install_slot(tcfg, ring, 1, holed, export.position)
    assert all(torch.equal(ring[k], before[k]) for k in ring)
    dst = _engine(arch, "torch", False, n_slots=2, max_seq_len=48)
    export.cache = holed
    assert not dst.install_active(export) and not dst.active

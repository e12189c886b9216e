"""PyTorch port vs the JAX reference on the contiguous per-slot cache path:
the contiguous flash-decode plain version vs the Pallas kernel, the
contiguous ``attention_fwd``, the cache functions (``step_with_cache``,
``reset_slots``, ``mask_cache_update``) and the contiguous ``Engine`` on
reduced ``qwen2-1.5b`` (``paged=False``) and ``mamba2-1.3b`` in f32 with
the JAX weights.  Tolerances: 2e-5 f32 / 2e-2 bf16 for kernels and one
layer, 1e-4 for whole-model logits, greedy tokens exact."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.flash_decode import ops as jfd
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode import ops as tfd
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4
ARCHS = ("qwen2-1.5b", "mamba2-1.3b")


def _pair(a: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(b), torch.from_numpy(b.view(np.uint16).copy()).view(torch.bfloat16)
    a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("B,S,H,Hkv,D,bk", [(2, 1024, 4, 2, 64, 256),
                                            (1, 2048, 8, 8, 128, 512),
                                            (3, 512, 4, 1, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas(B, S, H, Hkv, D, bk, dtype):
    """``test_kernels.py``'s shapes; lane 0 has ``kv_len = 0`` and must be
    zeros in both (the TPU kernel's flush)."""
    rng = np.random.default_rng(S + B)
    jq, tq = _pair(rng.standard_normal((B, H, D)), dtype)
    jk, tk = _pair(rng.standard_normal((B, S, Hkv, D)), dtype)
    jv, tv = _pair(rng.standard_normal((B, S, Hkv, D)), dtype)
    kl = rng.integers(1, S + 1, size=B).astype(np.int32)
    kl[0] = 0
    want = np.asarray(jfd.flash_decode(jq, jk, jv, jnp.asarray(kl), block_k=bk,
                                       interpret=True), np.float32)
    got = tfd.flash_decode(tq, tk, tv, torch.from_numpy(kl))
    assert got.dtype == tq.dtype and got.shape == (B, H, D)
    assert not got[0].any() and not want[0].any()
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_flash_decode_kernel_refuses_cpu_tensors():
    q, k = torch.zeros(2, 4, 16), torch.zeros(2, 32, 2, 16)
    kl = torch.ones(2, dtype=torch.int32)
    before = fd_kernel.contig_launches
    with pytest.raises(ValueError, match="CUDA"):
        fd_kernel.flash_decode(q, k, k, kl)
    assert fd_kernel.contig_launches == before and fd_kernel._contig_fn is None
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.flash_decode(q.to("meta"), k.to("meta"), k.to("meta"), kl.to("meta"))


# --------------------------------------------------------------------------- #
# models
# --------------------------------------------------------------------------- #
_ZOO = {}


def _zoo(arch):
    if arch not in _ZOO:
        jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
        params = jlm.init_params(jcfg, jax.random.PRNGKey(2))
        model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
        _ZOO[arch] = (jcfg, tcfg, params, model)
    return _ZOO[arch]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("C", [1, 8])
def test_attention_fwd_with_cache_matches_reference(C):
    """A chunk of C tokens at positions p0.. of rows whose buffers hold
    positions < p0; row 1 is inactive: its buffer is untouched and the
    active rows match the JAX mask ``_attn_mask & (kpos >= 0)``."""
    jcfg, tcfg, params, model = _zoo("qwen2-1.5b")
    jp = jax.tree.map(lambda t: t[1], params["layers"]["attn"])
    tp = model.layers[1].attn
    rng = np.random.default_rng(C)
    B, S, Hkv, D = 3, 32, tcfg.n_kv_heads, tcfg.d_head
    p0 = np.array([5, 9, 20], np.int32)
    K = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    V = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kpos = np.where(np.arange(S)[None] < p0[:, None], np.arange(S)[None], -1).astype(np.int32)
    x = rng.standard_normal((B, C, tcfg.d_model)).astype(np.float32)
    pos = (p0[:, None] + np.arange(C, dtype=np.int32)[None]).astype(np.int32)
    out_j, (Kj, Vj, _) = jlayers.attention_fwd(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), None,
        kv_cache=(jnp.asarray(K), jnp.asarray(V)), cache_positions=jnp.asarray(kpos))
    Kt, Vt = torch.from_numpy(K.copy()), torch.from_numpy(V.copy())
    active = torch.tensor([True, False, True])
    with torch.no_grad():
        out_t = tlayers.attention_fwd(tp, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(pos).long(), None,
                                      kv_cache=(Kt, Vt), active=active)
    for b in (0, 2):
        _close(out_t[b], np.asarray(out_j)[b], TOL["float32"])
        _close(Kt[b], np.asarray(Kj)[b], TOL["float32"])
        _close(Vt[b], np.asarray(Vj)[b], TOL["float32"])
    assert torch.equal(Kt[1], torch.from_numpy(K[1])) and not out_t[1].any()


def test_attention_fwd_full_sequence_matches_reference():
    jcfg, tcfg, params, model = _zoo("qwen2-1.5b")
    jp = jax.tree.map(lambda t: t[0], params["layers"]["attn"])
    x = np.random.default_rng(0).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    want, _ = jlayers.attention_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), None)
    with torch.no_grad():
        got = tlayers.attention_fwd(model.layers[0].attn, tcfg, torch.from_numpy(x),
                                    torch.from_numpy(pos).long(), None)
    _close(got, want, TOL["float32"])


def test_step_with_cache_matches_reference_qwen2():
    jcfg, tcfg, params, model = _zoo("qwen2-1.5b")
    B = 3
    rng = np.random.default_rng(6)
    jc = jlm.init_cache(jcfg, B, 64, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, B, 64, dtype=torch.float32, device="cpu")
    off = 0
    for C in (16, 8, 1, 1, 1):
        toks = rng.integers(1, tcfg.vocab_size, size=(B, C)).astype(np.int32)
        pos = np.broadcast_to(np.arange(off, off + C, dtype=np.int32), (B, C)).copy()
        lj, jc = jlm.prefill_step(params, jcfg, jc, jnp.asarray(toks), jnp.asarray(pos))
        with torch.no_grad():
            lt, tc = tlm.prefill_step(model, tcfg, tc, torch.from_numpy(toks),
                                      torch.from_numpy(pos))
        _close(lt, lj, LOGIT_TOL)
        assert (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).all()
        for k in ("k", "v"):
            _close(tc[k], jc[k], LOGIT_TOL)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        off += C
    with torch.no_grad():
        lt, _ = tlm.decode_step(model, tcfg, tc, torch.ones((B, 1), dtype=torch.int32),
                                torch.full((B,), off, dtype=torch.int32))
    lj, _ = jlm.decode_step(params, jcfg, jc, jnp.ones((B, 1), jnp.int32),
                            jnp.full((B,), off, jnp.int32))
    _close(lt, lj, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_rows_step_and_wipe_match_reset_and_mask(arch):
    """``step_with_cache(write=…)`` and ``wipe_slots_`` give the cache of the
    JAX ``reset_slots`` → step → ``mask_cache_update`` sequence, and the
    port's own JAX-semantics ``reset_slots``/``mask_cache_update`` agree."""
    jcfg, tcfg, params, model = _zoo(arch)
    B, C = 3, 16
    rng = np.random.default_rng(7)
    jc = jlm.init_cache(jcfg, B, 48, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, B, 48, dtype=torch.float32, device="cpu")
    toks = rng.integers(1, tcfg.vocab_size, size=(B, C)).astype(np.int32)
    pos = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    _, jc = jlm.prefill_step(params, jcfg, jc, jnp.asarray(toks), jnp.asarray(pos))
    with torch.no_grad():
        tlm.prefill_step(model, tcfg, tc, torch.from_numpy(toks), torch.from_numpy(pos))
    reset = np.array([False, True, False])
    active = np.array([True, True, False])
    toks = rng.integers(1, tcfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos1 = np.array([[C], [0], [C]], np.int32)
    jr = jlm.reset_slots(jcfg, jc, jnp.asarray(reset))
    _, jn = jlm.step_with_cache(params, jcfg, jr, jnp.asarray(toks), jnp.asarray(pos1))
    jm = jlm.mask_cache_update(jcfg, jr, jn, jnp.asarray(active))
    pure = tlm.reset_slots(tcfg, {k: v.clone() for k, v in tc.items()},
                           torch.from_numpy(reset))
    pure_old = {k: v.clone() for k, v in pure.items()}
    with torch.no_grad():
        tlm.wipe_slots_(tc, [1])
        tlm.step_with_cache(model, tcfg, tc, torch.from_numpy(toks),
                            torch.from_numpy(pos1),
                            write=torch.from_numpy(np.flatnonzero(active)))
        tlm.step_with_cache(model, tcfg, pure, torch.from_numpy(toks),
                            torch.from_numpy(pos1))
    pure = tlm.mask_cache_update(tcfg, pure_old, pure, torch.from_numpy(active))
    for k in jm:
        _close(tc[k], jm[k], LOGIT_TOL)
        _close(pure[k], jm[k], LOGIT_TOL)


def test_init_cache_layouts_match_reference():
    for arch in ARCHS:
        jcfg, tcfg, _, _ = _zoo(arch)
        jc = jlm.init_cache(jcfg, 3, 40, dtype=jnp.float32)
        tc = tlm.init_cache(tcfg, 3, 40, dtype=torch.float32, device="cpu")
        conv = tlm.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
        assert sorted(jc) == sorted(tc) == sorted(conv)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape
            assert tc[k].dtype == conv[k].dtype
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k]))
            assert torch.equal(conv[k], tc[k])
    assert tlm.cache_seq_len(dataclasses.replace(tcfg, sliding_window=16), 40) == 16


# --------------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------------- #
def _engines(arch, **kw):
    jcfg, tcfg, params, model = _zoo(arch)
    return (JEngine(jcfg, params, paged=False, **kw),
            TEngine(tcfg, model, paged=False, device="cpu", **kw))


def _serve(eng, req_cls, reqs, one_by_one=False):
    out = {}
    for rid, prompt, max_new in reqs:
        eng.submit(req_cls(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
        if one_by_one:
            d = eng.run_until_drained()[-1]
            out[rid] = (d.generated, d.prefill_dispatches, d.position)
    if not one_by_one:
        out = {d.request.rid: d.generated for d in eng.run_until_drained()}
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_slot_isolation_matches_reference(arch):
    solo = [(0, [5, 9, 11, 2, 7], 6)]
    busy = solo + [(r, [r, r + 1, 3] * r, 6) for r in range(1, 4)]
    for reqs in (solo, busy):
        j, t = _engines(arch, n_slots=4, max_seq_len=48)
        assert t._chunk_sizes == j._chunk_sizes
        want, got = _serve(j, JRequest, reqs), _serve(t, TRequest, reqs)
        assert got == want
    assert t.prefix_hits == 0 and t.release_all_pages() == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_slot_reuse_after_a_longer_occupant_matches_reference(arch):
    """One slot: a 37-token occupant then shorter ones.  Stale keys past the
    new occupant's kv_len and the old recurrent state must not leak."""
    reqs = [(0, [1 + (7 * i) % 13 for i in range(37)], 5),
            (1, [5, 9, 11, 4], 6), (2, [3, 1, 4], 1), (3, [8, 2], 4)]
    j, t = _engines(arch, n_slots=1, max_seq_len=64)
    want = _serve(j, JRequest, reqs, one_by_one=True)
    got = _serve(t, TRequest, reqs, one_by_one=True)
    assert got == want
    fresh = _serve(_engines(arch, n_slots=1, max_seq_len=64)[1], TRequest,
                   reqs[1:2], one_by_one=True)
    assert fresh[1] == got[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_truncation_matches_reference(arch):
    long_prompt = [1 + i % 9 for i in range(100)]
    j, t = _engines(arch, n_slots=2, max_seq_len=40)
    for eng, req_cls in ((j, JRequest), (t, TRequest)):
        eng.submit(req_cls(rid=0, prompt=list(long_prompt), max_new_tokens=4))
        assert eng.waiting[0].prompt == long_prompt[-36:]
    want, got = j.run_until_drained()[0], t.run_until_drained()[0]
    assert got.generated == want.generated and len(got.generated) == 4
    assert got.position == want.position < t.max_seq_len


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_per_token_prefill_matches_reference(arch):
    reqs = [(0, [4, 8, 15, 16, 23, 42], 4), (1, [7, 7, 1], 3)]
    j, t = _engines(arch, n_slots=2, max_seq_len=32, chunked_prefill=False)
    assert _serve(t, TRequest, reqs, one_by_one=True) == \
        _serve(j, JRequest, reqs, one_by_one=True)


def test_chunk_sizes_follow_the_ssd_rule():
    jcfg, tcfg, params, model = _zoo("mamba2-1.3b")
    for chunk, cap in ((16, 64), (48, 128), (8, 4)):
        jc = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk_size=chunk))
        tc = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk_size=chunk))
        j = JEngine(jc, params, n_slots=1, max_seq_len=16, max_prefill_chunk=cap)
        t = TEngine(tc, model, n_slots=1, max_seq_len=16, max_prefill_chunk=cap,
                    device="cpu")
        assert t._chunk_sizes == j._chunk_sizes
        assert not t.paged and not j.paged
    with pytest.raises(ValueError, match="paged"):
        TEngine(tcfg, model, paged=True, device="cpu")

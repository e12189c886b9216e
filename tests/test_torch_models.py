"""PyTorch port vs the JAX reference, model level, on reduced qwen2-1.5b in
f32: RoPE, the plain sdpa, paged attention (prefill chunk and decode) and
the whole paged step.  The port gets the JAX weights through
``params_from_jax``.  Tolerance: 2e-5 for single layers, 1e-4 for
whole-model logits (f32 rounding differences between XLA's and PyTorch's CPU
kernels accumulate over the layers), greedy tokens exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget_config
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

PAGE = 4
N_PAGES = 24
LAYER_TOL = 2e-5
LOGIT_TOL = 1e-4


def _cfgs():
    jcfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config("qwen2-1.5b").reduced(), dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    params = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, params)
    model = tlm.params_from_jax(tcfg, np_params, device="cpu")
    return jcfg, tcfg, params, model


def test_configs_match_reference():
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    full_j, full_t = get_config("qwen2-1.5b"), tget_config("qwen2-1.5b")
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)


def test_params_from_jax_is_a_plain_copy(models):
    jcfg, tcfg, params, model = models
    np.testing.assert_array_equal(model.embed.numpy(), np.asarray(params["embed"]))
    np.testing.assert_array_equal(model.layers[2].attn.wq.numpy(),
                                  np.asarray(params["layers"]["attn"]["wq"][2]))
    np.testing.assert_array_equal(model.layers[1].ffn.w_down.numpy(),
                                  np.asarray(params["layers"]["ffn"]["w_down"][1]))


def test_init_params_distributions():
    _, tcfg = _cfgs()
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    d, dff = tcfg.d_model, tcfg.d_ff
    for name, bound in [("embed", d ** -0.5), ("layers.0.attn.wq", d ** -0.5),
                        ("layers.0.attn.wo", (tcfg.n_heads * tcfg.d_head) ** -0.5),
                        ("layers.3.ffn.w_down", dff ** -0.5)]:
        w = dict(model.named_parameters())[name]
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert float(model.layers[0].attn.bq.abs().sum()) == 0.0
    assert float(model.final_norm.scale.abs().sum()) == 0.0
    again = tlm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(model.layers[1].attn.wk, again.layers[1].attn.wk)
    # expert tensors (E, d_in, d_out) draw with 1/√d_in, as init_moe does
    moe = dataclasses.replace(tget_config("mixtral-8x7b").reduced(), dtype="float32")
    model = tlm.init_params(moe, torch.Generator().manual_seed(0), device="cpu")
    d, dff = moe.d_model, moe.d_ff
    for name, bound in [("layers.0.ffn.router", d ** -0.5),
                        ("layers.1.ffn.w_gate", d ** -0.5),
                        ("layers.2.ffn.w_up", d ** -0.5),
                        ("layers.3.ffn.w_down", dff ** -0.5)]:
        w = dict(model.named_parameters())[name]
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 2048, size=(2, 5)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_TOL,
                               rtol=LAYER_TOL)


def test_sdpa_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(3, 9, dtype=np.int32), (2, 6))
    kpos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    jm = jlayers._attn_mask(jnp.asarray(qpos), jnp.asarray(kpos), 4)
    tm = tlayers.attn_mask(torch.from_numpy(qpos.copy()),
                           torch.from_numpy(kpos.copy()), 4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = jlayers.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, 30.0)
    got = tlayers.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), tm, 30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_TOL,
                               rtol=LAYER_TOL)


def _lanes(rng, B, n_ptab):
    """Disjoint page tables per lane (page 0 = trash stays unmapped)."""
    perm = rng.permutation(np.arange(1, N_PAGES))[:B * n_ptab]
    return perm.reshape(B, n_ptab).astype(np.int32)


@pytest.mark.parametrize("C", [8, 1])
def test_paged_attention_fwd_matches_reference(models, C):
    jcfg, tcfg, params, model = models
    rng = np.random.default_rng(10 + C)
    B, n_ptab = 3, 5
    Hkv, D = jcfg.n_kv_heads, jcfg.d_head
    x = rng.standard_normal((B, C, jcfg.d_model)).astype(np.float32)
    ptab = _lanes(rng, B, n_ptab)
    start = np.array([0, 7, 11], np.int32)
    pos2 = (start[:, None] + np.arange(C, dtype=np.int32)[None]).astype(np.int32)
    lens = (pos2[:, -1] + 1).astype(np.int32)
    phys = np.take_along_axis(ptab, pos2 // PAGE, axis=1)
    widx = (phys * PAGE + pos2 % PAGE).astype(np.int32)
    kp = rng.standard_normal((N_PAGES, PAGE, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((N_PAGES, PAGE, Hkv, D)).astype(np.float32)

    lp = jax.tree.map(lambda t: t[1], params["layers"])
    jout, (jkp, jvp) = jlayers.paged_attention_fwd(
        lp["attn"], jcfg, jnp.asarray(x), jnp.asarray(pos2), None,
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ptab), jnp.asarray(lens),
        jnp.asarray(widx))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout = tlayers.paged_attention_fwd(
        model.layers[1].attn, tcfg, torch.from_numpy(x),
        torch.from_numpy(pos2).long(), None, tkp, tvp, torch.from_numpy(ptab),
        torch.from_numpy(lens), torch.from_numpy(widx.reshape(-1)).long())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), atol=LAYER_TOL)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), atol=LAYER_TOL)


def test_paged_attention_fwd_window_and_empty_lane_match_reference(models):
    """A C = 8 chunk with a sliding window (6) and an inactive lane (kv_len 0,
    its writes diverted to the trash page 0, as ``paged_step`` does): the
    port's attention reads the pools through ``ptab``; the active lanes'
    outputs and every mapped page equal JAX's gather + sdpa."""
    jcfg, tcfg, params, model = models
    rng = np.random.default_rng(21)
    B, C, n_ptab, window = 3, 8, 5, 6
    Hkv, D = jcfg.n_kv_heads, jcfg.d_head
    x = rng.standard_normal((B, C, jcfg.d_model)).astype(np.float32)
    ptab = _lanes(rng, B, n_ptab)
    active = np.array([True, False, True])
    start = np.array([5, 0, 10], np.int32)
    pos2 = (start[:, None] + np.arange(C, dtype=np.int32)[None]).astype(np.int32)
    lens = np.where(active, pos2[:, -1] + 1, 0).astype(np.int32)
    phys = np.take_along_axis(ptab, pos2 // PAGE, axis=1)
    widx = np.where(active[:, None], phys * PAGE + pos2 % PAGE,
                    np.arange(C)[None] % PAGE).astype(np.int32)
    kp = rng.standard_normal((N_PAGES, PAGE, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((N_PAGES, PAGE, Hkv, D)).astype(np.float32)

    lp = jax.tree.map(lambda t: t[0], params["layers"])
    jout, (jkp, jvp) = jlayers.paged_attention_fwd(
        lp["attn"], jcfg, jnp.asarray(x), jnp.asarray(pos2), window,
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ptab), jnp.asarray(lens),
        jnp.asarray(widx))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout = tlayers.paged_attention_fwd(
        model.layers[0].attn, tcfg, torch.from_numpy(x),
        torch.from_numpy(pos2).long(), window, tkp, tvp, torch.from_numpy(ptab),
        torch.from_numpy(lens), torch.from_numpy(widx.reshape(-1)).long())
    np.testing.assert_allclose(tout.numpy()[active], np.asarray(jout)[active],
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    # page 0 takes the inactive lane's duplicate writes in either order
    np.testing.assert_allclose(tkp.numpy()[1:], np.asarray(jkp)[1:], atol=LAYER_TOL)
    np.testing.assert_allclose(tvp.numpy()[1:], np.asarray(jvp)[1:], atol=LAYER_TOL)


def test_paged_step_prefill_then_decode_matches_reference(models):
    """One prefill chunk then 4 decode steps over 4 lanes, lane 2 inactive
    throughout; logits of active lanes within 1e-4, greedy tokens exact."""
    jcfg, tcfg, params, model = models
    rng = np.random.default_rng(7)
    B, C, n_ptab = 4, 8, 4
    active = np.array([True, True, False, True])
    ptab = _lanes(rng, B, n_ptab)
    ptab[2] = 0                                    # inactive lane: unmapped
    jcache = jlm.init_paged_cache(jcfg, N_PAGES, PAGE, dtype=jnp.float32)
    tcache = tlm.paged_cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                        device="cpu")
    tokens = rng.integers(1, jcfg.vocab_size, size=(B, C)).astype(np.int32)
    pos2 = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    for step in range(5):
        jl, jcache = jlm.paged_step(params, jcfg, jcache, jnp.asarray(tokens),
                                    jnp.asarray(pos2), jnp.asarray(ptab),
                                    jnp.asarray(active), page_size=PAGE)
        tl, tcache = tlm.paged_step(model, tcfg, tcache, torch.from_numpy(tokens),
                                    torch.from_numpy(pos2), torch.from_numpy(ptab),
                                    torch.from_numpy(active), page_size=PAGE)
        jl, tl = np.asarray(jl), tl.numpy()
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl[active], jl[active], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        jtok = jl[:, -1].argmax(-1)
        np.testing.assert_array_equal(tl[active, -1].argmax(-1), jtok[active])
        if step == 0:
            last = tlm.paged_step(model, tcfg, {k: v.clone() for k, v in tcache.items()},
                                  torch.from_numpy(tokens), torch.from_numpy(pos2),
                                  torch.from_numpy(ptab), torch.from_numpy(active),
                                  page_size=PAGE, last_only=True)[0]
            np.testing.assert_allclose(last.numpy(), tl[:, -1:], atol=1e-6)
        tokens = jtok[:, None].astype(np.int32)
        pos2 = (pos2[:, -1:] + 1).astype(np.int32)
    np.testing.assert_allclose(tcache["kp"].numpy()[:, 1:],
                               np.asarray(jcache["kp"])[:, 1:], atol=LAYER_TOL)

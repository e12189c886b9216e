"""PyTorch port vs the JAX reference, MoE slice, on reduced mixtral-8x7b in
f32 with the same weights: the grouped SwiGLU's plain version against the
JAX ``moe_gmm`` op (Pallas in interpret mode) and its reference, the router
gates, the dense mix and the capacity dispatch, the paged step and the
serving engine under both ``moe_impl`` settings.

Tolerances: 3e-4 for ``moe_gmm`` (``tests/test_kernels.py``), 2e-5 for
single layers, 1e-4 for whole-model logits, greedy tokens exact.  JAX reads
``moe_impl`` when a step is traced, so every JAX engine is built and run
inside its own ``flags.scoped``; the port reads it on every call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.moe_gmm import ops as jmoe_ops
from repro.models import flags as jflags
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs
from repro_torch.core.plan import Plan, ReplicaGroup
from repro_torch.core.policy import ReconfigPolicy
from repro_torch.kernels.moe_gmm import ops as tmoe_ops
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.launch import serve as tserve
from repro_torch.models import flags as tflags
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

ARCH = "mixtral-8x7b"
GMM_TOL = 3e-4
LAYER_TOL = 2e-5
LOGIT_TOL = 1e-4
PAGE = 4
IMPLS = ("dense", "dispatch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs files in parallel workers: one intra-op thread each,
    restored when the module is done."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs():
    jcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config(ARCH).reduced(), dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def zoo():
    jcfg, tcfg = _cfgs()
    params = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, tcfg, params, model


def _layer(zoo, l=1):
    jcfg, tcfg, params, model = zoo
    return jax.tree.map(lambda t: t[l], params["layers"]["ffn"]), model.layers[l].ffn


def test_mixtral_config_matches_reference_and_is_served():
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(tget_config(ARCH))
    assert ARCH in list_archs()
    assert (tcfg.n_experts, tcfg.top_k, tcfg.sliding_window) == (4, 2, 16)
    assert tlm.pageable(tcfg) and tlm.paged_window(tcfg) == 16
    assert tflags.get_flag("moe_impl") == jflags.get_flag("moe_impl")


def test_flags_scoped_restores():
    before = tflags.get_flag("moe_impl")
    with tflags.scoped(moe_impl="dispatch"):
        assert tflags.get_flag("moe_impl") == "dispatch"
    assert tflags.get_flag("moe_impl") == before
    with pytest.raises(KeyError):
        tflags.set_flag("attn_impl", "xla")


def _gmm_inputs(rng, E, C, D, F, shared=False):
    x = rng.standard_normal((1 if shared else E, C, D)).astype(np.float32) * 0.3
    w = [rng.standard_normal(s).astype(np.float32) * 0.05
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, w


def test_moe_gmm_plain_matches_jax_kernel_and_reference():
    """At ``tests/test_kernels.py``'s first shape: the Pallas kernel in
    interpret mode and the JAX reference against the port's plain version."""
    E, C, D, F = 4, 128, 64, 256
    x, w = _gmm_inputs(np.random.default_rng(0), E, C, D, F)
    jx, jw = jnp.asarray(x), [jnp.asarray(a) for a in w]
    got = tmoe_ops.moe_gmm(torch.from_numpy(x), *map(torch.from_numpy, w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmoe_ops.moe_gmm(jx, *jw, block_f=128)),
                               atol=GMM_TOL, rtol=GMM_TOL)
    np.testing.assert_allclose(got, np.asarray(jmoe_ops.reference(jx, *jw)),
                               atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("C,shared", [(5, False), (3, True), (1, True)])
def test_moe_gmm_plain_ragged_c_and_shared_x(C, shared):
    """Any C, and x as an expanded view with expert stride 0."""
    E, D, F = 3, 64, 128
    x, w = _gmm_inputs(np.random.default_rng(C), E, C, D, F, shared)
    tx = torch.from_numpy(x)
    if shared:
        tx = tx.expand(E, C, D)
        assert tx.stride(0) == 0
    got = tmoe_ops.moe_gmm(tx, *map(torch.from_numpy, w))
    want = jmoe_ops.reference(jnp.broadcast_to(jnp.asarray(x), (E, C, D)),
                              *map(jnp.asarray, w))
    assert got.shape == (E, C, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    np.testing.assert_array_equal(got.numpy(), moe_gmm_ref(tx.contiguous(), *map(
        torch.from_numpy, w)).numpy())


# (B, S): prefill rows, and the decode shape S = 1, B > 1 (one row of B tokens)
SHAPES = [(2, 16), (6, 1)]


@pytest.mark.parametrize("B,S", SHAPES)
def test_moe_gates_and_dense_mix_match_reference(zoo, B, S):
    jcfg, tcfg = zoo[:2]
    jp, tp = _layer(zoo)
    x = np.random.default_rng(B).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jg = np.asarray(jlayers.moe_gates(jp, jcfg, jnp.asarray(x)))
    tg = tlayers.moe_gates(tp, tcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tg, jg, atol=LAYER_TOL, rtol=LAYER_TOL)
    assert ((tg > 0).sum(-1) == tcfg.top_k).all()
    np.testing.assert_allclose(tg.sum(-1), 1.0, atol=1e-6)
    want = jlayers.moe_dense_mix(jp, jcfg, jnp.asarray(x))
    got = tlayers.moe_dense_mix(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_TOL,
                               rtol=LAYER_TOL)


def _dropped(cfg, top_i: np.ndarray, C: int) -> int:
    """(token, k) pairs beyond an expert's capacity, per row, in flattened
    order (the JAX rule, recomputed with numpy)."""
    n = 0
    for row in top_i.reshape(top_i.shape[0], -1):
        counts = np.zeros(cfg.n_experts, int)
        for e in row:
            n += counts[e] >= C
            counts[e] += 1
    return n


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("factor", [1.25, 4.0])
def test_moe_dispatch_matches_reference(zoo, B, S, factor):
    """Capacity factor 1.25 drops pairs (and so differs from the dense mix),
    4.0 drops none (and equals it).  The tokens share a component, so the
    router favours some experts, as trained routers do."""
    jcfg, tcfg = zoo[:2]
    jp, tp = _layer(zoo)
    rng = np.random.default_rng(B)
    x = (rng.standard_normal((B, S, jcfg.d_model))
         + 1.5 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    want = np.asarray(jlayers.moe_dispatch(jp, jcfg, jnp.asarray(x), factor))
    got = tlayers.moe_dispatch(tp, tcfg, torch.from_numpy(x), factor).numpy()
    np.testing.assert_allclose(got, want, atol=LAYER_TOL, rtol=LAYER_TOL)
    rows, toks = (1, B) if S == 1 else (B, S)
    C = max(int(np.ceil(toks * tcfg.top_k / tcfg.n_experts * factor)), 1)
    _, top_i, _ = tlayers._route(tp, tcfg, torch.from_numpy(x).reshape(rows, toks, -1))
    dropped = _dropped(tcfg, top_i.numpy(), C)
    dense = tlayers.moe_dense_mix(tp, tcfg, torch.from_numpy(x)).numpy()
    if factor == 4.0:
        assert dropped == 0
        np.testing.assert_allclose(got, dense, atol=LAYER_TOL, rtol=LAYER_TOL)
    else:
        assert dropped > 0 and not np.allclose(got, dense, atol=1e-3)


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_step_prefill_then_decode_matches_reference(zoo, impl):
    """Two prefill chunks (16 + 8, past the reduced window of 16) then 3
    decode steps over 4 lanes, the last one inactive; active logits within
    1e-4, greedy tokens exact.

    A decode step's dispatch row holds every lane, inactive ones too, and
    an inactive lane's hidden state differs between the JAX gather path
    (mean of fully masked rows) and the paged kernels (zeros).  Its (token,
    k) pairs claim capacity in slot order, so only an inactive lane placed
    after the active ones leaves their routing comparable."""
    jcfg, tcfg, params, model = zoo
    rng = np.random.default_rng(11)
    B, n_ptab, n_pages = 4, 8, 33
    active = np.array([True, True, True, False])
    ptab = (1 + rng.permutation(n_pages - 1)[:B * n_ptab]).reshape(B, n_ptab)
    ptab = ptab.astype(np.int32)
    ptab[3] = 0
    jcache = jlm.init_paged_cache(jcfg, n_pages, PAGE, dtype=jnp.float32)
    tcache = tlm.paged_cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    chunks = [np.arange(0, 16), np.arange(16, 24)] + [np.array([p]) for p in range(24, 27)]
    tokens = rng.integers(1, jcfg.vocab_size, size=(B, 16)).astype(np.int32)
    with jflags.scoped(moe_impl=impl), tflags.scoped(moe_impl=impl):
        for pos in chunks:
            pos2 = np.broadcast_to(pos.astype(np.int32), (B, len(pos))).copy()
            jl, jcache = jlm.paged_step(params, jcfg, jcache, jnp.asarray(tokens),
                                        jnp.asarray(pos2), jnp.asarray(ptab),
                                        jnp.asarray(active), page_size=PAGE)
            tl, tcache = tlm.paged_step(model, tcfg, tcache, torch.from_numpy(tokens),
                                        torch.from_numpy(pos2), torch.from_numpy(ptab),
                                        torch.from_numpy(active), page_size=PAGE)
            jl, tl = np.asarray(jl), tl.numpy()
            np.testing.assert_allclose(tl[active], jl[active], atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
            jtok = jl[:, -1].argmax(-1)
            np.testing.assert_array_equal(tl[active, -1].argmax(-1), jtok[active])
            nxt = 8 if len(pos) == 16 else 1
            tokens = (rng.integers(1, jcfg.vocab_size, size=(B, nxt)) if nxt > 1
                      else jtok[:, None]).astype(np.int32)


PREFIX = [3 + (7 * j) % 200 for j in range(20)]
PROMPTS = {0: PREFIX + [11, 12, 13, 14],
           1: PREFIX + [21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32],
           2: [40 + (5 * j) % 150 for j in range(28)]}


def _serve(eng, req_cls, max_new=6):
    """Request 0 alone (its prefix is then indexed), then 1 and 2 together."""
    out = {}
    for wave in ([0], [1, 2]):
        for rid in wave:
            eng.submit(req_cls(rid=rid, prompt=list(PROMPTS[rid]), max_new_tokens=max_new))
        out.update({d.request.rid: d.generated for d in eng.run_until_drained()})
    return out


def test_engine_greedy_tokens_match_reference_under_both_impls(zoo):
    """Prompts longer than the window, one shared prefix (a prefix hit),
    4 slots; each JAX engine built and run inside its own scope."""
    jcfg, tcfg, params, model = zoo
    got = {}
    for impl in IMPLS:
        with jflags.scoped(moe_impl=impl):
            want = _serve(JEngine(jcfg, params, n_slots=4, max_seq_len=64), JRequest)
        with tflags.scoped(moe_impl=impl):
            teng = TEngine(tcfg, model, n_slots=4, max_seq_len=64, device="cpu")
            got[impl] = _serve(teng, TRequest)
        assert got[impl] == want, impl
        assert teng.prefix_hits > 0
        assert all(len(t) == 6 for t in got[impl].values())
    assert got["dense"] != got["dispatch"]      # capacity drops change tokens


def test_backend_serves_mixtral_through_drain_and_migrate_resizes(zoo):
    """TorchBackend on the paged pool, 4 → 2 slots with 3 requests in
    flight: a drain resize, and a migrate resize (2 migrated, the third
    recomputed), give the dense mix's undisturbed tokens — the dense mix
    does not depend on the batch.  Under dispatch the decode row's capacity
    does, so there every request only has to finish its budget."""
    _, tcfg, _, model = zoo
    backend = TorchBackend(tcfg, model, max_seq_len=64, slots_cap=4,
                           max_replicas_per_group=1, device="cpu")
    g4 = ReplicaGroup("m", "H100-80G", 1, 4, 1)
    g2 = ReplicaGroup("m", "H100-80G", 1, 2, 1)

    def run(policy):
        backend.apply_plan(Plan((g4,)), None)
        backend.set_reconfig_policy(policy)
        for rid, p in PROMPTS.items():
            assert backend.pool.submit("m", TRequest(rid=rid, prompt=list(p),
                                                     max_new_tokens=5))
        eng = backend.pool.engines[0]
        assert eng.paged
        eng.step()                  # admits all three, first tokens
        eng.step()
        rep = backend.apply_plan(Plan((g2,)), None)
        backend.pool.run_until_drained()
        out = {d.request.rid: d.request.prompt[len(PROMPTS[d.request.rid]):]
               + d.generated for d in backend.pool.finished}
        assert all(e.release_all_pages() == 0 for e in backend.pool.engines)
        backend.pool.finished.clear()
        backend.apply_plan(Plan(()), None)
        return rep, out

    with tflags.scoped(moe_impl="dense"):
        want = _serve(TEngine(tcfg, model, n_slots=4, max_seq_len=64, device="cpu"),
                      TRequest, 5)
        rep_d, drained = run(None)
        rep_m, migrated = run(ReconfigPolicy(lambda m: "migrate"))
    assert rep_d.drained_requests == 3
    assert rep_m.migrated_requests == 2 and rep_m.recomputed_requests == 1
    assert drained == migrated == want
    with tflags.scoped(moe_impl="dispatch"):
        rep, out = run(ReconfigPolicy(lambda m: "migrate"))
    assert rep.migrated_requests == 2 and rep.recomputed_requests == 1
    assert sorted(out) == sorted(PROMPTS) and all(len(t) == 5 for t in out.values())


@pytest.mark.parametrize("impl", IMPLS)
def test_serve_main_runs_mixtral_on_cpu(capsys, impl):
    with tflags.scoped(moe_impl=impl):
        assert tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                            "--max-new", "3", "--prompt-len", "20", "--resize"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} served 3 requests" in out and "resize[drain]" in out

"""PyTorch port vs the JAX reference for the configs that joined the
registry with the MLA and ring slice: ``qwen1.5-110b`` (dense, QKV bias),
``mixtral-8x22b`` (MoE, window), ``chameleon-34b`` (family ``vlm``) and
``minicpm3-4b`` (MLA), each at ``.reduced()`` in f32 with the JAX weights
(``params_from_jax`` of ``init_params(cfg, PRNGKey(seed))``).

Checked for each: the port's config equals the reference's, full and
reduced; the full-sequence logits and a paged prefill-then-decode are
within 1e-4 of JAX's; the paged engine's greedy tokens equal the JAX
engine's, exactly.
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
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest

ARCHS = ["qwen1.5-110b", "mixtral-8x22b", "chameleon-34b", "minicpm3-4b"]
LOGIT_TOL = 1e-4
PAGE = 4

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
        params = jlm.init_params(jcfg, jax.random.PRNGKey(ARCHS.index(arch)))
        model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
        _ZOO[arch] = (jcfg, tcfg, params, model)
    return _ZOO[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_full_and_reduced(arch):
    assert arch in list_archs()
    full_j, full_t = get_config(arch), tget_config(arch)
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert dataclasses.asdict(full_j.reduced()) == dataclasses.asdict(full_t.reduced())
    assert tlm.pageable(full_t) == jlm.pageable(full_j)
    assert tlm.paged_window(full_t) == jlm.paged_window(full_j)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_sequence_logits_match_reference(arch):
    jcfg, tcfg, params, model = _zoo(arch)
    toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, size=(2, 23))
    toks = toks.astype(np.int32)
    want = np.asarray(jlm.forward(params, jcfg, jnp.asarray(toks)))
    with torch.inference_mode():
        got = tlm.forward(model, tcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_step_prefill_then_decode_matches_reference(arch):
    """Chunks of 16 and 8 (past the reduced window of 16 where there is
    one), then 3 decode steps over 3 lanes, the last one inactive: active
    logits within 1e-4, greedy tokens exact, and the pools equal."""
    jcfg, tcfg, params, model = _zoo(arch)
    rng = np.random.default_rng(2)
    B, n_ptab, n_pages = 3, 8, 1 + 3 * 8
    active = np.array([True, True, False])
    ptab = (1 + rng.permutation(n_pages - 1)).reshape(B, n_ptab).astype(np.int32)
    ptab[2] = 0
    jcache = jlm.init_paged_cache(jcfg, n_pages, PAGE, dtype=jnp.float32)
    tcache = tlm.paged_cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    assert sorted(tcache) == sorted(jcache)
    chunks = [np.arange(0, 16), np.arange(16, 24)] + [np.array([p]) for p in range(24, 27)]
    tokens = rng.integers(1, jcfg.vocab_size, size=(B, 16)).astype(np.int32)
    for pos in chunks:
        pos2 = np.broadcast_to(pos.astype(np.int32), (B, len(pos))).copy()
        jl, jcache = jlm.paged_step(params, jcfg, jcache, jnp.asarray(tokens),
                                    jnp.asarray(pos2), jnp.asarray(ptab),
                                    jnp.asarray(active), page_size=PAGE)
        with torch.inference_mode():
            tl, tcache = tlm.paged_step(model, tcfg, tcache, torch.from_numpy(tokens),
                                        torch.from_numpy(pos2), torch.from_numpy(ptab),
                                        torch.from_numpy(active), page_size=PAGE)
        jl, tl = np.asarray(jl), tl.numpy()
        np.testing.assert_allclose(tl[active], jl[active], atol=LOGIT_TOL, rtol=LOGIT_TOL)
        jtok = jl[:, -1].argmax(-1)
        np.testing.assert_array_equal(tl[active, -1].argmax(-1), jtok[active])
        nxt = 8 if len(pos) == 16 else 1
        tokens = (rng.integers(1, jcfg.vocab_size, size=(B, nxt)) if nxt > 1
                  else jtok[:, None]).astype(np.int32)
    for k in jcache:            # the trash page (0) takes the inactive lane's writes
        np.testing.assert_allclose(tcache[k][:, 1:].numpy(), np.asarray(jcache[k])[:, 1:],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


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
        out.update({d.request.rid: (d.generated, d.prefill_dispatches)
                    for d in eng.run_until_drained()})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_greedy_tokens_match_reference(arch):
    """Prompts of 24–32 tokens (past the reduced window where there is
    one), a shared 20-token prefix (a prefix hit), 4 slots, page 4."""
    jcfg, tcfg, params, model = _zoo(arch)
    want = _serve(JEngine(jcfg, params, n_slots=4, max_seq_len=64, page_size=PAGE),
                  JRequest)
    teng = TEngine(tcfg, model, n_slots=4, max_seq_len=64, page_size=PAGE, device="cpu")
    assert teng.paged
    assert _serve(teng, TRequest) == want
    assert teng.prefix_hits > 0
    assert teng.release_all_pages() == 0


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mixtral-8x22b"])
def test_serve_main_runs_new_archs_on_cpu(capsys, arch):
    assert tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                        "--max-new", "3", "--prompt-len", "20", "--resize"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch} served 3 requests" in out and "resize[drain]" in out

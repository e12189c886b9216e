"""Gradients of the PyTorch port against the JAX reference, in f32 on the
CPU: the explicit backward of the RMSNorm, flash-attention, ``moe_gmm`` and
SSD-scan ops against ``jax.grad`` of the JAX package's plain versions (2e-5;
``moe_gmm`` and the SSD scan also in bf16, 2e-2 of each leaf's largest
magnitude), and the whole model's ``zoo.loss_fn`` and every parameter's
gradient against ``jax.value_and_grad`` of the reference's (loss 1e-5, each leaf within
1e-4 of its largest magnitude: f32 rounding differs between XLA's and
PyTorch's CPU kernels and accumulates over the layers).  The port gets the
JAX weights through ``params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_fa
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rms
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import lm as tlm
from repro_torch.models import zoo as tzoo

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

TOL = 2e-5
LOSS_TOL = 1e-5
LEAF_TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


# --------------------------------------------------------------------------- #
# the two autograd wrappers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 130), (16, 1536)])
def test_rmsnorm_backward_matches_jax_grad(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jdx, jds = jax.grad(lambda a, b: jnp.sum(jax_rms(a, b) * g), argnums=(0, 1))(x, s)
    xt = torch.tensor(x, requires_grad=True)
    st = torch.tensor(s, requires_grad=True)
    y = rms_ops.rmsnorm(xt, st)
    assert type(y.grad_fn).__name__ == "_RMSNormBackward"
    y.backward(torch.from_numpy(g))
    _close(xt.grad, jdx)
    _close(st.grad, jds)
    _close(y.detach(), jax_rms(x, s))


FA_CASES = {   # (Sq, Sk, causal, window, softcap, q scale)
    "causal": (16, 16, True, None, None, 1.0),
    "non_causal": (16, 16, False, None, None, 1.0),
    "window": (16, 16, True, 5, None, 1.0),
    "softcap": (16, 16, True, None, 50.0, 12.0),
    "softcap_window": (16, 16, True, 6, 50.0, 12.0),
    "end_aligned": (8, 12, True, None, None, 1.0),
    "non_causal_end_aligned": (8, 12, False, None, 50.0, 12.0),
}


@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_backward_matches_jax_grad(case):
    """dq, dk, dv of the port's op (GQA over un-repeated K/V, H 4 / Hkv 2)
    against ``jax.grad`` of the JAX plain version over head-repeated K/V."""
    Sq, Sk, causal, window, cap, qs = FA_CASES[case]
    B, H, Hkv, D = 2, 4, 2, 16
    rng = np.random.default_rng(1)
    q = (qs * rng.standard_normal((B, Sq, H, D))).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    rep = H // Hkv

    def f(q, k, v):
        out = jax_fa(q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
                     causal=causal, window=window, softcap=cap)
        return jnp.sum(out * do)

    jdq, jdk, jdv = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa_ops.flash_attention(qt, kt, vt, causal=causal, window=window, softcap=cap)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    _close(qt.grad, jdq)
    _close(kt.grad, jdk)
    _close(vt.grad, jdv)


def test_flash_attention_backward_equals_autograd_of_the_plain_version():
    """The hand-derived gradient against PyTorch's autograd through the
    plain version (the card's phase 3 holds the CUDA forward the same way)."""
    rng = np.random.default_rng(2)
    B, S, H, Hkv, D = 2, 24, 6, 2, 32
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
            for _ in range(2))
    for window, cap in ((None, None), (7, 50.0)):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = fa_ops.flash_attention_ref(*ins, True, window, cap)
        want = torch.autograd.grad(ref, ins, do)
        got = fa_ops.flash_attention_backward(q, k, v, do, True, window, cap)
        for g, w in zip(got, want):
            _close(g, w)


def test_ops_without_grad_run_the_forward_as_before():
    """With no gradient required (serving), the ops return the plain
    forward with no autograd node; ``kv_len`` and a page table still work."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(np.float32))
    kl = torch.tensor([8, 5], dtype=torch.int32)
    out = fa_ops.flash_attention(q, k, k, kv_len=kl)
    assert out.grad_fn is None
    torch.testing.assert_close(out, fa_ops.flash_attention_ref(q, k, k, kv_len=kl),
                               rtol=0, atol=0)
    x, s = torch.randn(3, 16), torch.zeros(16, requires_grad=True)
    with torch.no_grad():
        assert rms_ops.rmsnorm(x, s).grad_fn is None
    with torch.inference_mode():
        assert fa_ops.flash_attention(q.requires_grad_(True), k, k).grad_fn is None


def test_flash_attention_grad_refuses_kv_len_and_page_tables():
    q = torch.zeros(2, 4, 4, 16, requires_grad=True)
    k = torch.zeros(2, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="kv_len or a page table"):
        fa_ops.flash_attention(q, k, k, kv_len=torch.tensor([8, 5], dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="kv_len or a page table"):
        fa_ops.flash_attention(q, k[:1, :4], k[:1, :4],
                               ptab=torch.zeros(2, 2, dtype=torch.int32))


MOE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaf_close(got, want, tol, what=""):
    """|got − want| within ``tol`` of the leaf's largest magnitude."""
    g = got.detach().float().numpy()
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-12)
    err = float(np.abs(g - w).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("shared", [False, True], ids=["packed", "stride0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_backward_matches_jax_grad(dtype, shared):
    """dx, dWg, dWu, dWd of the port's op against ``jax.vjp`` of the JAX
    plain version on the same inputs, with a plain (E, C, D) ``x`` (a packed
    dispatch buffer) or one copy of the tokens expanded over the experts
    (stride 0, the dense mix): there dx is summed over the experts by
    ``expand``'s backward, as JAX's is by the broadcast's."""
    from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe
    E, C, D, F = 3, 10, 32, 48
    rng = np.random.default_rng(10)
    xs = rng.standard_normal((1 if shared else E, C, D)).astype(np.float32)
    ws = [(rng.standard_normal(sh) / np.sqrt(sh[1])).astype(np.float32)
          for sh in ((E, D, F), (E, D, F), (E, F, D))]
    dy = rng.standard_normal((E, C, D)).astype(np.float32)
    jdt = JDT[dtype]
    jx = jnp.asarray(xs, jdt)
    jw = [jnp.asarray(w, jdt) for w in ws]
    f = (lambda x, *w: jax_moe(jnp.broadcast_to(x, (E, C, D)), *w)) if shared else jax_moe
    jy, vjp = jax.vjp(f, jx, *jw)
    want = vjp(jnp.asarray(dy, jdt))
    tx = torch.tensor(xs, dtype=TDT[dtype], requires_grad=True)
    tw = [torch.tensor(w, dtype=TDT[dtype], requires_grad=True) for w in ws]
    xin = tx.expand(E, C, D) if shared else tx
    y = moe_ops.moe_gmm(xin, *tw)
    assert type(y.grad_fn).__name__ == "_MoEGMMBackward"
    y.backward(torch.tensor(dy, dtype=TDT[dtype]))
    tol = MOE_TOL[dtype]
    _leaf_close(y, np.asarray(jy, np.float32), tol, "y")
    for name, got, w in zip(("x", "w_gate", "w_up", "w_down"), [tx] + tw, want):
        assert got.grad.dtype == TDT[dtype]
        _leaf_close(got.grad, np.asarray(w, np.float32), tol, name)


SSD_CASES = {   # (s, chunk, initial state, cotangent on the final state)
    "state_dfinal_s16_c4": (16, 4, True, True),
    "state_s12_c6": (12, 6, True, False),
    "no_state_s16_c4": (16, 4, False, False),
    "no_state_dfinal_s12_c6": (12, 6, False, True),
}


def _ssd_inputs(s, b=2, h=3, p=4, n=5, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, h)).astype(np.float32)
    B = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    C = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dfin = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, st, dy, dfin


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_scan_backward_matches_jax_grad(case):
    """The gradients of x, dt, A, B, C and the initial state through the
    port's op against ``jax.vjp`` of the reference's ``ssd_chunked`` in
    f32, with and without a carried state and a cotangent on the final
    state (none: the port's backward gets no final-state gradient at all,
    as in training, where the state is not read)."""
    from repro.models.ssd import ssd_chunked
    s, chunk, with_state, with_dfin = SSD_CASES[case]
    x, dt, A, B, C, st, dy, dfin = _ssd_inputs(s)
    if not with_dfin:
        dfin = np.zeros_like(dfin)
    args = [x, dt, A, B, C] + ([st] if with_state else [])
    (jy, jfin), vjp = jax.vjp(
        lambda *a: ssd_chunked(*a[:5], chunk, a[5] if with_state else None), *args)
    want = vjp((jnp.asarray(dy), jnp.asarray(dfin)))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, fin = ssd_ops.ssd_scan(*ts[:5], chunk, ts[5] if with_state else None)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    if with_dfin:
        torch.autograd.backward([y, fin], [torch.from_numpy(dy), torch.from_numpy(dfin)])
    else:
        y.backward(torch.from_numpy(dy))
    _leaf_close(y, jy, TOL, "y")
    _leaf_close(fin, jfin, TOL, "final_state")
    for name, t, w in zip(("x", "dt", "A", "B", "C", "initial_state"), ts, want):
        _leaf_close(t.grad, w, TOL, name)


def test_ssd_scan_backward_matches_jax_grad_in_bf16():
    """x, B, C and the state in bf16 (dt and A f32, as the model feeds
    them): the port's plain version computes in f32 and rounds its outputs,
    the reference rounds inside; each gradient within 2e-2 of its leaf's
    largest magnitude, in the input's dtype."""
    from repro.models.ssd import ssd_chunked
    x, dt, A, B, C, st, dy, dfin = _ssd_inputs(16, seed=12)
    low = lambda a: jnp.asarray(a, jnp.bfloat16)
    args = [low(x), dt, A, low(B), low(C), low(st)]
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a[:5], 8, a[5]), *args)
    want = vjp((low(dy), low(dfin)))
    ts = [torch.tensor(np.asarray(a, np.float32), dtype=d, requires_grad=True)
          for a, d in zip(args, (torch.bfloat16, torch.float32, torch.float32,
                                 torch.bfloat16, torch.bfloat16, torch.bfloat16))]
    y, fin = ssd_ops.ssd_scan(*ts[:5], 8, ts[5])
    torch.autograd.backward([y, fin], [torch.tensor(dy, dtype=torch.bfloat16),
                                       torch.tensor(dfin, dtype=torch.bfloat16)])
    for name, t, w in zip(("x", "dt", "A", "B", "C", "initial_state"), ts, want):
        assert t.grad.dtype == t.dtype
        _leaf_close(t.grad, np.asarray(w, np.float32), 2e-2, name)


def test_moe_and_ssd_ops_route_through_their_function_only_with_grad():
    """With an input that requires grad the two ops return their Function's
    node on the CPU (the backward the card runs); under ``no_grad`` or with
    no such input they return the plain forward, equal bit for bit and with
    no node.  A gradient needs ``s`` divisible by the chunk."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    ws = [torch.from_numpy(0.2 * rng.standard_normal(sh).astype(np.float32))
          for sh in ((2, 16, 8), (2, 16, 8), (2, 8, 16))]
    plain = moe_ops.moe_gmm_ref(x, *ws)
    got = moe_ops.moe_gmm(x, *ws)
    assert got.grad_fn is None and torch.equal(got, plain)
    wg = ws[0].clone().requires_grad_(True)
    with torch.no_grad():
        got = moe_ops.moe_gmm(x, wg, *ws[1:])
    assert got.grad_fn is None and torch.equal(got, plain)
    got = moe_ops.moe_gmm(x, wg, *ws[1:])
    assert type(got.grad_fn).__name__ == "_MoEGMMBackward" and torch.equal(got, plain)
    got.sum().backward()
    assert float(wg.grad.abs().sum()) > 0

    xs, dt, A, B, C, st, _, _ = (torch.from_numpy(a) for a in _ssd_inputs(8))
    plain = ssd_ops.ssd_scan_ref(xs, dt, A, B, C, 4, st)
    out = ssd_ops.ssd_scan(xs, dt, A, B, C, 4, st)
    assert all(o.grad_fn is None for o in out)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    At = A.clone().requires_grad_(True)
    with torch.inference_mode():
        assert ssd_ops.ssd_scan(xs, dt, At, B, C, 4, st)[0].grad_fn is None
    y, fin = ssd_ops.ssd_scan(xs, dt, At, B, C, 4, st)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    assert torch.equal(y, plain[0]) and torch.equal(fin, plain[1])
    with pytest.raises(ValueError, match="divisible by chunk"):
        ssd_ops.ssd_scan(xs, dt, At, B, C, 3, st)


# --------------------------------------------------------------------------- #
# the whole model: loss_fn and every gradient
# --------------------------------------------------------------------------- #
ARCHS = ["qwen2-1.5b", "chameleon-34b", "gemma2-9b", "minicpm3-4b", "whisper-tiny",
         "mixtral-8x7b", "mamba2-1.3b", "zamba2-7b"]


def _pair(arch):
    jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
    params = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, tlm.params_from_jax(tcfg, np_params, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    _check_loss_and_every_gradient(arch)


def test_mixtral_dispatch_loss_and_every_gradient_match_jax():
    """Reduced mixtral under the capacity dispatch on both sides (the
    packed buffer through ``index_add_`` into the op's Function, the
    reference's scatter einsums)."""
    from repro.models import flags as jflags
    from repro_torch.models import flags as tflags
    with jflags.scoped(moe_impl="dispatch"), tflags.scoped(moe_impl="dispatch"):
        _check_loss_and_every_gradient("mixtral-8x7b")


def _check_loss_and_every_gradient(arch):
    jcfg, tcfg, params, model = _pair(arch)
    rng = np.random.default_rng(6)
    B, S = 2, 12
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jbatch = {"tokens": tokens, "labels": labels}
    if jcfg.is_encoder_decoder:
        jbatch["frames"] = rng.standard_normal((B, jcfg.n_frames, jcfg.d_model)
                                               ).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(jzoo.loss_fn)(params, jcfg, jbatch)
    want = tlm.named_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))

    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss = tzoo.loss_fn(model, tcfg, {k: torch.from_numpy(v) for k, v in jbatch.items()})
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= LEAF_TOL * scale, (name, err, scale)


def test_train_step_updates_the_model_like_jax():
    """``make_train_step`` (no accumulation) against the reference's."""
    from repro.training import optim as jopt
    from repro_torch.training import optim as topt
    jcfg, tcfg, params, model = _pair("qwen2-1.5b")
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
             for k in ("tokens", "labels")}
    opt = dict(lr=1e-2, warmup_steps=2, weight_decay=0.1)
    jstep = jzoo.make_train_step(jcfg, jopt.AdamWConfig(**opt))
    jloss, jparams, jstate = jstep(params, jopt.init_state(params), batch)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    tstep = tzoo.make_train_step(tcfg, topt.AdamWConfig(**opt))
    tloss, tstate = tstep(model, topt.init_state(named),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL and int(tstate["step"]) == 1
    want = tlm.named_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    lr1 = opt["lr"] / opt["warmup_steps"]       # the first step's learning rate
    for name, p in named.items():
        # Adam's first step is sign-like: a tiny gradient may flip, 2·lr
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2 * lr1, rtol=0)


def test_prefill_and_serve_steps_match_jax():
    jcfg, tcfg, params, model = _pair("qwen2-1.5b")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    jl = jzoo.make_prefill_step(jcfg)(params, {"tokens": tokens})
    tl = tzoo.make_prefill_step(tcfg)(model, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl, 1e-4)
    jcache = jlm.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    tcache = tlm.init_cache(tcfg, 2, 16, device="cpu")
    tok = tokens[:, :1]
    pos = np.zeros((2,), np.int32)
    for _ in range(3):
        jn, jcache = jzoo.make_serve_step(jcfg)(params, jcache, tok, pos)
        tn, tcache = tzoo.make_serve_step(tcfg)(model, tcache, torch.tensor(tok),
                                               torch.tensor(pos))
        assert tn.dtype == torch.int32
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        tok, pos = np.array(jn)[:, None], pos + 1


def test_step_fn_for_picks_the_step_of_the_kind():
    cfg = tget_config("qwen2-1.5b").reduced()
    kinds = {k: tzoo.step_fn_for(cfg, type("Shape", (), {"kind": k})()).__name__
             for k in ("train", "prefill", "decode")}
    assert kinds == {"train": "train_step", "prefill": "prefill_step",
                     "decode": "serve_step"}

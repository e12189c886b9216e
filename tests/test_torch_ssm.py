"""PyTorch port vs the JAX reference on the SSM path: the SSD scan's plain
version vs the Pallas ``ssd_scan_kernel`` (interpret mode) and vs
``ssd_chunked`` with carried state, the Mamba-2 block's three branches,
and reduced ``mamba2-1.3b`` end to end (full-sequence forward and
``step_with_cache``) in f32 with the JAX weights (``params_from_jax``).

Tolerances: 2e-5 for the scan and one block (the scan's f32 reordering
against the Pallas kernel stays far inside it, so ``test_kernels.py``'s
looser 2e-4 / 2e-3 is not needed), 1e-4 for whole-model logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro.models import lm as jlm
from repro.models import ssd as jssd
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as tssd_ops
from repro_torch.models import lm as tlm
from repro_torch.models import ssd as tssd

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

TOL = 2e-5
LOGIT_TOL = 1e-4


def _scan_inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, 1, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, 1, n)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((b, h, p, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C, st


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,n,ck", [(2, 256, 4, 32, 16, 64),
                                          (1, 128, 8, 64, 32, 32),
                                          (2, 64, 2, 16, 8, 16)])
def test_ssd_scan_plain_matches_pallas(b, s, h, p, n, ck):
    x, dt, A, B, C, _ = _scan_inputs(b, s, h, p, n)
    want = ssd_scan_kernel(*_j(x, dt, A, B, C), chunk=ck, interpret=True)
    y, fin = tssd_ops.ssd_scan(*_t(x, dt, A, B, C), ck)
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s,ck", [(64, 16), (64, 64), (256, 64)])
def test_ssd_scan_plain_matches_ssd_chunked_with_state(s, ck):
    x, dt, A, B, C, st = _scan_inputs(2, s, 3, 16, 8, seed=1)
    yj, fj = jssd.ssd_chunked(*_j(x, dt, A, B, C), ck,
                              initial_state=jnp.asarray(st))
    y, fin = tssd_ops.ssd_scan(*_t(x, dt, A, B, C), ck,
                               initial_state=torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(fj), atol=TOL, rtol=TOL)


def test_ssd_scan_halves_chained_through_the_state_equal_the_whole():
    x, dt, A, B, C, st = _scan_inputs(2, 128, 3, 16, 8, seed=2)
    xs, dts, Bs, Cs = _t(x, dt, B, C)
    At, st0 = _t(A, st)
    whole, fin = tssd_ops.ssd_scan(xs, dts, At, Bs, Cs, 32, initial_state=st0)
    y1, mid = tssd_ops.ssd_scan(xs[:, :64], dts[:, :64], At, Bs[:, :64],
                                Cs[:, :64], 32, initial_state=st0)
    y2, fin2 = tssd_ops.ssd_scan(xs[:, 64:], dts[:, 64:], At, Bs[:, 64:],
                                 Cs[:, 64:], 16, initial_state=mid)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), whole, atol=TOL, rtol=TOL)
    torch.testing.assert_close(fin2, fin, atol=TOL, rtol=TOL)


def test_ssd_scan_checks_chunk_and_kernel_refuses_cpu_tensors():
    x, dt, A, B, C = _t(*_scan_inputs(1, 48, 2, 64, 128)[:5])
    with pytest.raises(ValueError, match="not divisible"):
        tssd_ops.ssd_scan(x, dt, A, B, C, 32)
    before = ssd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(x, dt, A, B, C)
    assert ssd_kernel.launches == before and ssd_kernel._fn is None
    with pytest.raises(ValueError, match="unsupported device"):
        tssd_ops.ssd_scan(x.to("meta"), dt.to("meta"), A.to("meta"),
                          B.to("meta"), C.to("meta"), 16)


# --------------------------------------------------------------------------- #
# the Mamba-2 block and the model
# --------------------------------------------------------------------------- #
def _cfgs():
    jcfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config("mamba2-1.3b").reduced(), dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    params = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, tcfg, params, model


def test_config_matches_reference():
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    full_j, full_t = get_config("mamba2-1.3b"), tget_config("mamba2-1.3b")
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert abs(full_t.param_count() - 1.344e9) < 0.01e9


def test_params_from_jax_names_mirror_the_pytree(models):
    jcfg, tcfg, params, model = models
    mixer = params["layers"]["mixer"]
    np.testing.assert_array_equal(model.layers[1].mixer.in_proj.w.numpy(),
                                  np.asarray(mixer["in_proj"]["w"][1]))
    np.testing.assert_array_equal(model.layers[2].mixer.dt_bias.numpy(),
                                  np.asarray(mixer["dt_bias"][2]))
    np.testing.assert_array_equal(model.layers[0].ln.scale.numpy(),
                                  np.asarray(params["layers"]["ln"]["scale"][0]))


def test_init_params_follow_init_mamba2():
    _, tcfg = _cfgs()
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    s = tcfg.ssm
    nh, di = s.n_heads(tcfg.d_model), s.d_inner(tcfg.d_model)
    mix = model.layers[0].mixer
    torch.testing.assert_close(mix.A_log, torch.log(torch.arange(1.0, nh + 1)))
    assert torch.equal(mix.D, torch.ones(nh))
    dt = torch.nn.functional.softplus(mix.dt_bias)
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert float(mix.dt_bias.std()) > 0.0                    # drawn, not constant
    bound = s.d_conv ** -0.5
    assert float(mix.conv_w.abs().max()) <= bound and float(mix.conv_w.abs().max()) > 0.9 * bound
    assert float(mix.out_proj.w.abs().max()) <= di ** -0.5
    assert not mix.conv_b.any() and not mix.norm_scale.any()
    assert float(model.layers[1].mixer.dt_bias[0]) != float(mix.dt_bias[0])


def _block(models, layer=1):
    jcfg, tcfg, params, model = models
    jp = jax.tree.map(lambda t: t[layer], params["layers"]["mixer"])
    return jcfg, tcfg, jp, model.layers[layer].mixer


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def test_mamba2_fresh_sequence_matches_reference(models):
    jcfg, tcfg, jp, mix = _block(models)
    x = np.random.default_rng(0).standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    yj, (cj, sj) = jssd.mamba2_fwd(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        y, (c, s) = tssd.mamba2_fwd(mix, tcfg, torch.from_numpy(x))
    _close(y, yj)
    _close(c, cj)
    _close(s, sj)


@pytest.mark.parametrize("S", [16, 32, 2])
def test_mamba2_chunked_continuation_matches_reference(models, S):
    jcfg, tcfg, jp, mix = _block(models)
    rng = np.random.default_rng(S)
    s = tcfg.ssm
    conv_dim = s.d_inner(tcfg.d_model) + 2 * s.d_state
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    conv = (rng.standard_normal((2, s.d_conv - 1, conv_dim)) * 0.5).astype(np.float32)
    st = (rng.standard_normal((2, s.n_heads(tcfg.d_model), s.head_dim, s.d_state))
          * 0.3).astype(np.float32)
    yj, (cj, sj) = jssd.mamba2_fwd(jp, jcfg, jnp.asarray(x),
                                   (jnp.asarray(conv), jnp.asarray(st)))
    with torch.no_grad():
        y, (c, s2) = tssd.mamba2_fwd(mix, tcfg, torch.from_numpy(x),
                                     (torch.from_numpy(conv), torch.from_numpy(st)))
    _close(y, yj)
    _close(c, cj)
    _close(s2, sj)


def test_mamba2_recurrent_step_matches_reference(models):
    jcfg, tcfg, jp, mix = _block(models)
    rng = np.random.default_rng(9)
    s = tcfg.ssm
    conv_dim = s.d_inner(tcfg.d_model) + 2 * s.d_state
    state = ((rng.standard_normal((3, s.d_conv - 1, conv_dim)) * 0.5).astype(np.float32),
             (rng.standard_normal((3, s.n_heads(tcfg.d_model), s.head_dim, s.d_state))
              * 0.3).astype(np.float32))
    for step in range(3):
        x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
        yj, sj = jssd.mamba2_fwd(jp, jcfg, jnp.asarray(x), tuple(map(jnp.asarray, state)))
        with torch.no_grad():
            y, st = tssd.mamba2_fwd(mix, tcfg, torch.from_numpy(x),
                                    tuple(map(torch.from_numpy, state)))
        _close(y, yj)
        _close(st[0], sj[0])
        _close(st[1], sj[1])
        state = tuple(np.array(a) for a in sj)


def test_forward_matches_reference(models):
    jcfg, tcfg, params, model = models
    toks = np.random.default_rng(1).integers(1, tcfg.vocab_size, size=(2, 48)).astype(np.int32)
    want = jlm.forward(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got = tlm.forward(model, tcfg, torch.from_numpy(toks))
    _close(got, want, LOGIT_TOL)


def test_step_with_cache_matches_reference(models):
    """Chunks of 16 and 32 (the reduced SSD chunk is 16), then decode steps:
    logits, greedy tokens and the carried conv/SSM state track JAX."""
    jcfg, tcfg, params, model = models
    B = 3
    rng = np.random.default_rng(4)
    jc = jlm.init_cache(jcfg, B, 96, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, B, 96, dtype=torch.float32, device="cpu")
    off = 0
    for C in (16, 32, 1, 1, 1):
        toks = rng.integers(1, tcfg.vocab_size, size=(B, C)).astype(np.int32)
        pos = np.broadcast_to(np.arange(off, off + C, dtype=np.int32), (B, C)).copy()
        lj, jc = jlm.step_with_cache(params, jcfg, jc, jnp.asarray(toks), jnp.asarray(pos))
        with torch.no_grad():
            lt, tc = tlm.step_with_cache(model, tcfg, tc, torch.from_numpy(toks),
                                         torch.from_numpy(pos))
        _close(lt, lj, LOGIT_TOL)
        assert (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).all()
        for k in ("conv", "ssm"):
            _close(tc[k], jc[k], LOGIT_TOL)
        off += C

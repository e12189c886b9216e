"""f32 master weights of the port's training against the JAX reference, on
the CPU, for the config's own bf16: the reference keeps every parameter in
f32 and casts it at use, so the port's AdamW updates f32 masters and writes
their rounding into its bf16 model.  An update under half a bf16 step moves
the masters as it moves the reference's parameters; over a few steps from
the same f32 weights over the same batches (the port's own ``batch_at``,
no monkeypatch) the masters move as the reference's parameters (the same
mean step to 10%, the same direction on ≥ 90% of elements) and the losses
stay within 2e-2 (bf16 forwards); checkpoints hold the
masters as f32 leaves, equal bit for bit after a round trip through either
package, and a run resumes across packages."""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro.training import checkpoint as jck
from repro.training import data as jdata
from repro.training import optim as jopt
from repro.training import trainer as jtrainer
from repro_torch.configs import get_config as tget_config
from repro_torch.models import lm as tlm
from repro_torch.models import zoo as tzoo
from repro_torch.training import data as tdata
from repro_torch.training import optim as topt
from repro_torch.training import trainer as ttrainer

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

ARCH = "qwen2-1.5b"
JCFG = get_config(ARCH).reduced()          # bf16, the config's own type
TCFG = tget_config(ARCH).reduced()
OPT = dict(lr=5e-3, warmup_steps=5, weight_decay=0.1)
JDCFG = jdata.DataConfig(vocab_size=JCFG.vocab_size, seq_len=32, global_batch=8, seed=3)
TDCFG = tdata.DataConfig(vocab_size=TCFG.vocab_size, seq_len=32, global_batch=8, seed=3)
LOSS_TOL = 2e-2
STEPS = 6


def _jax_params(seed=0):
    return jlm.init_params(JCFG, jax.random.PRNGKey(seed))


def _named(tree):
    return tlm.named_from_jax(TCFG, jax.tree.map(np.asarray, tree))


def _port(params):
    """The port's bf16 model and its f32 masters from the reference's f32
    parameters."""
    np_params = jax.tree.map(np.asarray, params)
    return tlm.params_from_jax(TCFG, np_params, device="cpu"), _named(params)


def _jax_train(steps, d, opt, microbatches=2, params=None):
    tcfg = jtrainer.TrainConfig(steps=steps, microbatches=microbatches, ckpt_every=3,
                                ckpt_dir=str(d), opt=jopt.AdamWConfig(**opt))
    return jtrainer.train(JCFG, tcfg, JDCFG, params=_jax_params() if params is None
                          else params)


def _port_train(steps, d, opt, microbatches=2, fresh=False):
    model, masters = _port(_jax_params(9 if fresh else 0))
    tcfg = ttrainer.TrainConfig(steps=steps, microbatches=microbatches, ckpt_every=3,
                                ckpt_dir=None if d is None else str(d),
                                opt=topt.AdamWConfig(**opt))
    report = ttrainer.train(TCFG, tcfg, TDCFG, params=model,
                            masters=None if fresh else masters, device="cpu")
    return report, model


def _ckpt(d, step):
    like = (_jax_params(), jopt.init_state(_jax_params()))
    (p, st), _, _ = jck.restore(d, like, step=step)
    return p, st


def _leaves(d, step):
    path = d / f"step_{step}"
    n = len(list(path.glob("*.npy")))
    return [np.load(path / f"{i}.npy") for i in range(n)]


def _assert_moved_alike(name, start, want, got):
    """The masters moved from ``start`` as the reference's parameters did:
    the same mean step to 10% and the same direction on ≥ 90% of elements."""
    dw, dg = want - start, got - start
    mean_w, mean_g = float(np.abs(dw).mean()), float(np.abs(dg).mean())
    assert abs(mean_g - mean_w) <= 0.1 * mean_w, (name, mean_g, mean_w)
    assert float(np.mean(np.sign(dg) == np.sign(dw))) >= 0.9, name


def test_small_updates_move_the_masters_as_the_reference_params(tmp_path):
    """lr 1e-5: every update is far below half a bf16 step of the weight
    matrices (≈ 4e-4 at |w| ≈ 0.1), so a bf16 matrix updated in place would
    hardly move.  The reference's f32 parameters move after 3 steps; the port's
    masters move the same way (the same mean step, the same direction on
    nearly every element) and the model holds their rounding."""
    opt = dict(lr=1e-5, warmup_steps=1, weight_decay=0.0)
    _jax_train(3, tmp_path / "jax", opt, microbatches=1)
    start = _named(_jax_params())
    jp, _ = _ckpt(tmp_path / "jax", 3)
    want = _named(jp)
    report, model = _port_train(3, tmp_path / "port", opt, microbatches=1)
    assert report.skipped_nan == 0
    pp, _ = _ckpt(tmp_path / "port", 3)
    got = _named(pp)
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      torch.from_numpy(np.array(got[k])).to(p.dtype).float().numpy())
        if p.dim() < 2:      # zero-initialised biases and f32 norm scales: no claim
            continue
        assert float(np.abs(want[k] - start[k]).mean()) > 0.5 * 3e-5, k   # it moved
        _assert_moved_alike(k, start[k], want[k], got[k])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The reference's loop in bf16: 6 steps, 2 microbatches, checkpoints at
    3 and 6."""
    d = tmp_path_factory.mktemp("jax_bf16")
    return _jax_train(STEPS, d, OPT), d


def test_masters_follow_the_reference_over_six_steps(jax_run, tmp_path):
    jreport, jdir = jax_run
    report, model = _port_train(STEPS, tmp_path, OPT)
    assert report.steps_done == STEPS and report.skipped_nan == 0
    np.testing.assert_allclose(report.losses, jreport.losses, atol=LOSS_TOL, rtol=0)
    want, got = _named(_ckpt(jdir, STEPS)[0]), _named(_ckpt(tmp_path, STEPS)[0])
    start = _named(_jax_params())
    for k, p in model.named_parameters():
        # a key bias adds q·b to every score of a query, which the softmax
        # drops: its gradient is rounding alone, and its direction no claim
        if not k.endswith("attn.bk"):
            _assert_moved_alike(k, start[k], want[k], got[k])
        np.testing.assert_array_equal(                 # the model: the masters' rounding
            p.detach().float().numpy(),
            torch.from_numpy(np.array(got[k])).to(p.dtype).float().numpy())
    held = report.held_bytes
    n = sum(p.numel() for p in model.parameters())
    assert held["masters"] == held["m"] == held["v"] == 4 * n
    assert held["working_copy"] == 2 * sum(p.numel() for p in model.parameters()
                                           if p.dtype == torch.bfloat16)
    assert held["step"] == 4 and held["batch"] == 2 * 4 * 8 * 32


def test_jax_checkpoint_restores_into_the_masters_bit_for_bit(jax_run, tmp_path):
    """The port resumes the reference's step-3 checkpoint: its masters are
    the f32 leaves (written back unchanged) and the model gets their
    rounding; it then runs on to 6 over the same batches."""
    jreport, jdir = jax_run
    shutil.copytree(jdir / "step_3", tmp_path / "step_3")
    (tmp_path / "LATEST").write_text("3")
    report, model = _port_train(3, tmp_path, OPT, fresh=True)
    assert report.resumed_from == 3 and report.losses == []
    for got, want in zip(_leaves(tmp_path, 3), _leaves(jdir, 3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    masters = _named(_ckpt(jdir, 3)[0])
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), torch.from_numpy(np.array(masters[k])).to(p.dtype)), k
    report, _ = _port_train(STEPS, tmp_path, OPT, fresh=True)
    assert report.resumed_from == 3
    np.testing.assert_allclose(report.losses, jreport.losses[3:], atol=LOSS_TOL, rtol=0)


def test_port_checkpoint_restores_into_jax_bit_for_bit(jax_run, tmp_path):
    """The port's step-3 checkpoint holds f32 parameter leaves; the
    reference restores it and writes it back bit for bit, then runs on to 6
    over the same batches (no monkeypatch on either side)."""
    jreport, _ = jax_run
    report, _ = _port_train(3, tmp_path / "port", OPT)
    np.testing.assert_allclose(report.losses, jreport.losses[:3], atol=LOSS_TOL, rtol=0)
    written = _leaves(tmp_path / "port", 3)
    jleaves = jax.tree.leaves((_jax_params(), jopt.init_state(_jax_params())))
    assert [w.dtype for w in written] == [np.asarray(x).dtype for x in jleaves]
    assert all(w.dtype == np.float32 for w in written[:len(jax.tree.leaves(_jax_params()))])
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    resumed = _jax_train(3, tmp_path / "jax", OPT, params=_jax_params(7))
    assert resumed.resumed_from == 3 and resumed.losses == []
    for got, want in zip(_leaves(tmp_path / "jax", 3), written):
        np.testing.assert_array_equal(got, want)
    resumed = _jax_train(STEPS, tmp_path / "jax", OPT, params=_jax_params(7))
    assert resumed.resumed_from == 3
    np.testing.assert_allclose(resumed.losses, jreport.losses[3:], atol=LOSS_TOL, rtol=0)


def test_zoo_train_step_updates_the_masters_like_jax():
    """``make_train_step`` with masters against the reference's
    ``train_step(params f32, …)`` at an lr whose update is under half a
    bf16 step: the masters move as the reference's parameters."""
    from repro.models import zoo as jzoo
    opt = dict(lr=1e-5, warmup_steps=1, weight_decay=0.0)
    params = _jax_params(2)
    batch = {k: np.asarray(v) for k, v in jdata.batch_at(JDCFG, 0).items()}
    jloss, jparams, _ = jax.jit(jzoo.make_train_step(JCFG, jopt.AdamWConfig(**opt)))(
        params, jopt.init_state(params), batch)
    model, masters = _port(params)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    masters = topt.init_masters(named, masters)
    start = {k: m.detach().clone() for k, m in masters.items()}
    tloss, state = tzoo.make_train_step(TCFG, topt.AdamWConfig(**opt))(
        model, topt.init_state(masters), {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        masters)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL and int(state["step"]) == 1
    want = _named(jparams)
    for k, p in named.items():
        assert masters[k].dtype == torch.float32
        np.testing.assert_allclose(masters[k].detach().numpy(), want[k], atol=2 * opt["lr"], rtol=0)
        if p.dtype == torch.bfloat16:
            moved = float((masters[k].detach() - start[k]).abs().mean())
            assert abs(moved - float(np.abs(want[k] - start[k].numpy()).mean())) <= 0.1 * moved
            assert torch.equal(p.detach(), masters[k].to(p.dtype))


def test_a_step_without_masters_refuses_a_bf16_model():
    """Without masters only f32 parameters can be their own: a bf16 model's
    step raises instead of writing its update straight into bf16, and
    leaves the model untouched."""
    model, _ = _port(_jax_params(4))
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    before = {k: p.detach().clone() for k, p in named.items()}
    batch = {k: v.to(torch.int32) for k, v in tdata.batch_at(TDCFG, 0).items()}
    opt = topt.AdamWConfig(**OPT)
    for step in (tzoo.make_train_step(TCFG, opt),
                 ttrainer.make_accum_train_step(TCFG, opt, 2)):
        with pytest.raises(ValueError, match="not f32"):
            step(model, topt.init_state(named), batch)
    assert all(torch.equal(p.detach(), before[k]) for k, p in named.items())

"""Training of the PyTorch port against the JAX reference, on the CPU:
AdamW (f32 and bf16 parameters), the accumulated train step and its NaN
guard, the loop over JAX's own batches, the data pipeline, checkpoints
either package resumes, the JAX parameter layout, gradient compression over
logical devices, and the training CLI without the reference.  Reduced
configs in f32 unless a test says otherwise; the port gets the JAX weights
through ``params_from_jax``.  Tolerances: loss 1e-5 for one step and 1e-4
over a run; parameters after n steps within 2·Σ lr_t (Adam's first steps
are sign-like, so a tiny gradient can flip); moments within 1e-4 of the
leaf's largest magnitude."""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.distributed import compression as jcomp
from repro.launch.mesh import make_mesh_compat
from repro.models import lm as jlm
from repro.training import checkpoint as jck
from repro.training import data as jdata
from repro.training import optim as jopt
from repro.training import trainer as jtrainer
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed import compression as tcomp
from repro_torch.launch.mesh import Mesh, logical_devices
from repro_torch.models import lm as tlm
from repro_torch.training import checkpoint as tck
from repro_torch.training import data as tdata
from repro_torch.training import optim as topt
from repro_torch.training import trainer as ttrainer

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-1.5b"
JCFG = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
TCFG = dataclasses.replace(tget_config(ARCH).reduced(), dtype="float32")
OPT = dict(lr=5e-3, warmup_steps=5, weight_decay=0.1)
JDCFG = jdata.DataConfig(vocab_size=JCFG.vocab_size, seq_len=32, global_batch=8)
TDCFG = tdata.DataConfig(vocab_size=TCFG.vocab_size, seq_len=32, global_batch=8)
STEPS = 6
LOSS_TOL = 1e-4


def _jax_params(seed=0):
    return jlm.init_params(JCFG, jax.random.PRNGKey(seed))


def _port_model(params):
    return tlm.params_from_jax(TCFG, jax.tree.map(np.asarray, params), device="cpu")


def _named(tree):
    return tlm.named_from_jax(TCFG, jax.tree.map(np.asarray, tree))


def _jax_batch(cfg, step):
    """JAX's batch of ``step`` as the port's ``batch_at`` returns it."""
    return {k: torch.from_numpy(np.array(v)).long()
            for k, v in jdata.batch_at(JDCFG, step).items()}


def _lr_sum(steps):
    return sum(OPT["lr"] * min(s / OPT["warmup_steps"], 1.0) for s in range(1, steps + 1))


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
def _opt_case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (16, 8), "final_norm": (8,), "w": (8, 12)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (0.5 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jp = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, jnp.dtype(dtype).name))
          for k, v in params.items()}
    return jp, tp, grads


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x).astype(np.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_apply_updates_matches_jax_over_three_steps(dtype):
    cfg_kw = dict(lr=0.05, warmup_steps=2, weight_decay=0.1, grad_clip=1.0)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jp, tp, grads = _opt_case(dtype)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    assert all(m.dtype == torch.float32 for m in ts["m"].values())
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for g in grads:        # norms of 2–3: the clip binds on every step
        jg = {k: jnp.asarray(v, dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(tp[k].dtype)
              for k, v in jg.items()}
        np.testing.assert_allclose(float(topt.global_norm(tg)),
                                   float(jopt.global_norm(jg)), rtol=1e-6)
        jp, js = jopt.apply_updates(jcfg, jp, jg, js)
        tp, ts = topt.apply_updates(tcfg, tp, tg, ts)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in tp:
        assert tp[k].dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]), atol=1e-6)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]), atol=1e-6)
        if dtype == jnp.float32:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6)
        else:   # cast back once from f32, as the reference does: equal in bf16
            np.testing.assert_array_equal(_f32(tp[k]), _f32(jp[k]))


def test_bf16_update_in_place_would_round_elsewhere():
    """The trap the port avoids: the update rounded to bf16 and added in
    place lands on other bf16 values than the reference's single cast-back
    from f32."""
    cfg = topt.AdamWConfig(lr=0.05, warmup_steps=1, weight_decay=0.1)
    jp, tp, grads = _opt_case(jnp.bfloat16, seed=1)
    jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in grads[0].items()}
    jp2, _ = jopt.apply_updates(jopt.AdamWConfig(lr=0.05, warmup_steps=1,
                                                 weight_decay=0.1),
                                jp, jg, jopt.init_state(jp))
    tg = {k: torch.from_numpy(np.asarray(v).astype(np.float32)).bfloat16()
          for k, v in jg.items()}
    tp2, _ = topt.apply_updates(cfg, tp, tg, topt.init_state(tp))
    clip = min(1.0, 1.0 / (float(topt.global_norm(tg)) + 1e-9))
    differ = 0
    for k, p in tp.items():
        np.testing.assert_array_equal(_f32(tp2[k]), _f32(jp2[k]))
        g = tg[k].float() * clip
        adam = g / (torch.sqrt(g * g) + cfg.eps)      # m̂ / √v̂ after one step
        wd = torch.tensor(0.1, dtype=torch.bfloat16) * p
        in_place = p.clone().add_((-cfg.lr * (adam + wd)).bfloat16())
        differ += int((in_place.float() != tp2[k].float()).sum())
    assert differ > 0


def test_schedule_warms_up_from_the_incremented_step():
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=4)
    got = [float(topt._schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(6)]
    want = [float(jopt._schedule(jopt.AdamWConfig(lr=1e-2, warmup_steps=4),
                                 jnp.asarray(s, jnp.int32))) for s in range(6)]
    np.testing.assert_allclose(got, want, rtol=1e-7)
    p = {"w": torch.ones(3)}
    _, st = topt.apply_updates(cfg, p, {"w": torch.ones(3)}, topt.init_state(p))
    assert int(st["step"]) == 1          # the first update already moves (lr/4)


# --------------------------------------------------------------------------- #
# the accumulated train step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("microbatches", [1, 2])
def test_accum_train_step_matches_jax(microbatches):
    params = _jax_params(1)
    jstep = jax.jit(jtrainer.make_accum_train_step(JCFG, jopt.AdamWConfig(**OPT),
                                                   microbatches))
    jbatch = jdata.batch_at(JDCFG, 3)
    jloss, jp, js, jok = jstep(params, jopt.init_state(params), jbatch)
    model = _port_model(params)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    tstep = ttrainer.make_accum_train_step(TCFG, topt.AdamWConfig(**OPT), microbatches)
    tloss, ts, tok = tstep(model, topt.init_state(named), _jax_batch(TDCFG, 3))
    assert bool(tok) and bool(jok)
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    assert int(ts["step"]) == int(js["step"]) == 1
    want_p, want_m, want_v = _named(jp), _named(js["m"]), _named(js["v"])
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k],
                                   atol=2 * _lr_sum(1), rtol=0)
        for got, want in ((ts["m"][k], want_m[k]), (ts["v"][k], want_v[k])):
            scale = max(float(np.abs(want).max()), 1e-12)
            assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale, k


def test_accum_step_splits_rows_and_averages_in_f32():
    """Two microbatches give the mean of the two halves' gradients, summed
    in f32 buffers: the update equals one step on the averaged gradient."""
    model = tlm.init_params(TCFG, torch.Generator().manual_seed(2), device="cpu")
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    batch = tdata.batch_at(TDCFG, 0)
    from repro_torch.models import zoo
    halves = [{k: v[i * 4:(i + 1) * 4] for k, v in batch.items()} for i in range(2)]
    grads = [torch.autograd.grad(zoo.loss_fn(model, TCFG, h), list(named.values()))
             for h in halves]
    mean = {k: (a.float() + b.float()) / 2 for k, a, b in zip(named, *grads)}
    want, _ = topt.apply_updates(topt.AdamWConfig(**OPT), named, mean,
                                 topt.init_state(named))
    step = ttrainer.make_accum_train_step(TCFG, topt.AdamWConfig(**OPT), 2)
    loss, st, ok = step(model, topt.init_state(named), batch)
    assert bool(ok) and loss.dtype == torch.float32
    for k, p in named.items():
        torch.testing.assert_close(p.detach(), want[k], rtol=0, atol=1e-7)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_nan_guard_keeps_params_and_state(microbatches):
    """Poisoned parameters: the step is skipped as the reference skips it,
    parameters, moments and the step counter unchanged."""
    params = jax.tree.map(lambda x: x * jnp.nan, _jax_params(0))
    jstep = jax.jit(jtrainer.make_accum_train_step(JCFG, jopt.AdamWConfig(**OPT),
                                                   microbatches))
    _, jp, js, jok = jstep(params, jopt.init_state(params), jdata.batch_at(JDCFG, 0))
    model = _port_model(params)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    state = topt.init_state(named)
    step = ttrainer.make_accum_train_step(TCFG, topt.AdamWConfig(**OPT), microbatches)
    loss, st, ok = step(model, state, _jax_batch(TDCFG, 0))
    assert not bool(ok) and not bool(jok) and not np.isfinite(float(loss))
    assert st is state and int(st["step"]) == int(js["step"]) == 0
    assert all(float(m.abs().sum()) == 0 for m in st["m"].values())
    assert all(bool(torch.isnan(p).all()) for p in named.values())
    assert all(bool(jnp.isnan(x).all()) for x in jax.tree.leaves(jp))


# --------------------------------------------------------------------------- #
# the loop, checkpoints and resume across packages
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The reference's loop: 6 steps, 2 microbatches, checkpoints at 3 and 6."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    tcfg = jtrainer.TrainConfig(steps=STEPS, microbatches=2, ckpt_every=3,
                                ckpt_dir=str(d), opt=jopt.AdamWConfig(**OPT))
    report = jtrainer.train(JCFG, tcfg, JDCFG, params=_jax_params(0))
    return report, d


def _port_train(monkeypatch, steps, ckpt_dir=None, model=None):
    monkeypatch.setattr(tdata, "batch_at", _jax_batch)
    tcfg = ttrainer.TrainConfig(steps=steps, microbatches=2, ckpt_every=3,
                                ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
                                opt=topt.AdamWConfig(**OPT))
    model = _port_model(_jax_params(0)) if model is None else model
    return ttrainer.train(TCFG, tcfg, TDCFG, params=model, device="cpu"), model


def _ckpt_params(d, step):
    like = (_jax_params(0), jopt.init_state(_jax_params(0)))
    (p, st), _, _ = jck.restore(d, like, step=step)
    return p, st


def test_train_matches_jax_over_six_steps(jax_run, monkeypatch):
    jreport, jdir = jax_run
    report, model = _port_train(monkeypatch, STEPS)
    assert report.steps_done == STEPS and report.skipped_nan == 0
    np.testing.assert_allclose(report.losses, jreport.losses, atol=LOSS_TOL, rtol=0)
    jp, _ = _ckpt_params(jdir, STEPS)
    want = _named(jp)
    for k, p in model.named_parameters():
        assert p.requires_grad
        np.testing.assert_allclose(p.detach().numpy(), want[k],
                                   atol=2 * _lr_sum(STEPS), rtol=0)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-1.3b", "zamba2-7b"])
def test_train_matches_jax_over_three_steps_for_the_moe_ssm_and_hybrid_families(
        arch, tmp_path):
    """Reduced mixtral (dense mix), mamba2 and zamba2 in f32 trained for 3
    steps of 2 microbatches by both loops, each on its own threefry batches
    (equal bit for bit: no ``batch_at`` monkeypatch), from the same weights:
    losses within 1e-4; each leaf's update over the 3 steps, p − p0, within
    1e-3 of the reference's in norm (‖Δp − Δp_ref‖ ≤ 1e-3·‖Δp_ref‖; a wrong
    third update alone would leave a gap near a third of it) and of the same
    sign at 99% of its entries or more.  On the card these steps run
    ``moe_gmm`` and the SSD scan through their autograd Functions, whose
    backwards are the ops that run here."""
    jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
    jd = jdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4)
    td = tdata.DataConfig(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4)
    steps = 3
    params = jlm.init_params(jcfg, jax.random.PRNGKey(2))
    p0 = tlm.named_from_jax(tcfg, jax.tree.map(np.asarray, params))
    jrep = jtrainer.train(jcfg, jtrainer.TrainConfig(
        steps=steps, microbatches=2, ckpt_every=steps, ckpt_dir=str(tmp_path),
        opt=jopt.AdamWConfig(**OPT)), jd, params=params)
    model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    rep = ttrainer.train(tcfg, ttrainer.TrainConfig(
        steps=steps, microbatches=2, opt=topt.AdamWConfig(**OPT)), td, params=model,
        device="cpu")
    assert rep.steps_done == steps and rep.skipped_nan == 0
    np.testing.assert_allclose(rep.losses, jrep.losses, atol=LOSS_TOL, rtol=0)
    (jp, _), _, _ = jck.restore(tmp_path, (params, jopt.init_state(params)), step=steps)
    want = tlm.named_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k, p in got.items():
        du, du_ref = p.detach().numpy() - p0[k], want[k] - p0[k]
        assert np.linalg.norm(du - du_ref) <= 1e-3 * np.linalg.norm(du_ref), k
        assert float(np.mean(np.sign(du) == np.sign(du_ref))) >= 0.99, k


def test_port_resumes_a_jax_checkpoint(jax_run, monkeypatch, tmp_path):
    jreport, jdir = jax_run
    shutil.copytree(jdir / "step_3", tmp_path / "step_3")
    (tmp_path / "LATEST").write_text("3")
    fresh = tlm.init_params(TCFG, torch.Generator().manual_seed(9), device="cpu")
    report, model = _port_train(monkeypatch, STEPS, tmp_path, model=fresh)
    assert report.resumed_from == 3 and report.steps_done == STEPS
    np.testing.assert_allclose(report.losses, jreport.losses[3:], atol=LOSS_TOL, rtol=0)
    assert tck.latest_step(tmp_path) == STEPS


def test_jax_resumes_a_port_checkpoint(jax_run, monkeypatch, tmp_path):
    jreport, _ = jax_run
    report, _ = _port_train(monkeypatch, 3, tmp_path)
    assert tck.latest_step(tmp_path) == 3
    np.testing.assert_allclose(report.losses, jreport.losses[:3], atol=LOSS_TOL, rtol=0)
    # the port's checkpoint holds the reference's leaves in its order
    jp, js = _ckpt_params(tmp_path, 3)
    assert int(js["step"]) == 3
    tcfg = jtrainer.TrainConfig(steps=STEPS, microbatches=2, ckpt_every=3,
                                ckpt_dir=str(tmp_path), opt=jopt.AdamWConfig(**OPT))
    resumed = jtrainer.train(JCFG, tcfg, JDCFG, params=_jax_params(7))
    assert resumed.resumed_from == 3
    np.testing.assert_allclose(resumed.losses, jreport.losses[3:], atol=LOSS_TOL, rtol=0)


def test_resume_continues_bit_for_bit(tmp_path):
    """3 steps, then a run to 6 that resumes: its steps equal an
    uninterrupted 6-step run's exactly (the port's own data)."""
    tcfg = lambda d, n: ttrainer.TrainConfig(steps=n, microbatches=2, ckpt_dir=d,
                                             opt=topt.AdamWConfig(**OPT))
    whole = ttrainer.train(TCFG, tcfg(None, STEPS), TDCFG, seed=3, device="cpu")
    first = ttrainer.train(TCFG, tcfg(str(tmp_path), 3), TDCFG, seed=3, device="cpu")
    rest = ttrainer.train(TCFG, tcfg(str(tmp_path), STEPS), TDCFG, seed=4, device="cpu")
    assert first.losses == whole.losses[:3]
    assert rest.resumed_from == 3 and rest.losses == whole.losses[3:]


def test_loss_decreases():
    """As ``tests/test_training.py::test_loss_decreases``, in the config's
    own bf16 on the port's data."""
    cfg = tget_config(ARCH).reduced()
    dcfg = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    r = ttrainer.train(cfg, ttrainer.TrainConfig(
        steps=50, microbatches=2,
        opt=topt.AdamWConfig(lr=5e-3, warmup_steps=5, weight_decay=0.0)),
        dcfg, device="cpu")
    assert r.losses[-1] < r.losses[0] - 0.8
    assert r.skipped_nan == 0


def test_train_runs_on_the_card_unless_told_otherwise():
    """``device=None`` means the card (no card: RuntimeError, as every entry
    point); a model trains where it lies, and another device is refused."""
    model = tlm.init_params(TCFG, device="cpu")
    with pytest.raises((RuntimeError, ValueError), match="no CUDA device|lies on cpu"):
        ttrainer.train(TCFG, ttrainer.TrainConfig(steps=1), params=model, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrainer.train(TCFG, ttrainer.TrainConfig(steps=1))


# --------------------------------------------------------------------------- #
# the JAX parameter layout
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b", "zamba2-7b", "whisper-tiny",
                                  "mixtral-8x7b", "minicpm3-4b", "mamba2-1.3b"])
def test_params_to_jax_inverts_the_name_map(arch):
    jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
    params = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(2)))
    model = tlm.params_from_jax(tcfg, params, device="cpu")
    named = {k: p.detach() for k, p in model.named_parameters()}
    tree = tlm.params_to_jax(tcfg, named, convert=lambda t: t.numpy())
    got, want = jax.tree_util.tree_flatten_with_path(tree)[0], \
        jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the trainer's checkpoint tree has the reference's leaves and shapes
    state = topt.init_state(named)
    leaves = tck._flatten(ttrainer.state_tree(tcfg, named, state))
    jleaves = jax.tree.leaves((params, jopt.init_state(params)))
    assert [tuple(x.shape) for x in leaves] == [tuple(x.shape) for x in jleaves]


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def test_checkpoint_atomicity_crash_sim(tmp_path):
    """A leftover .tmp dir (simulated crash) never becomes the restore point."""
    tree = {"w": torch.ones(4)}
    tck.save(tmp_path, 5, tree)
    broken = tmp_path / "step_9.tmp"
    broken.mkdir()
    (broken / "0.npy").write_bytes(b"garbage")
    assert tck.latest_step(tmp_path) == 5
    restored, step, _ = tck.restore(tmp_path, tree)
    assert step == 5 and torch.equal(restored["w"], tree["w"])
    (tmp_path / "LATEST").write_text("not a step")
    assert tck.latest_step(tmp_path) is None


def test_checkpoint_shape_and_count_validation(tmp_path):
    tck.save(tmp_path, 1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        tck.restore(tmp_path, {"w": torch.ones(5)})
    with pytest.raises(ValueError, match="leaf count"):
        tck.restore(tmp_path, {"w": torch.ones(4), "b": torch.ones(1)})
    with pytest.raises(FileNotFoundError):
        tck.restore(tmp_path / "none", {"w": torch.ones(4)})


def test_async_checkpointer_gc(tmp_path):
    acp = tck.AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        acp.save(s, {"w": torch.full((2,), float(s))})
    acp.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    restored, step, _ = tck.restore(tmp_path, {"w": torch.zeros(2)})
    assert step == 4 and float(restored["w"][0]) == 4.0


def test_checkpoint_layout_reads_in_both_packages(tmp_path):
    """Leaves in ``tree_flatten`` order (dict keys sorted), bf16 written as
    f32 and cast back to the target's dtype, extra carried; a JAX-written
    tree restores in the port and the reverse."""
    tree = ({"b": torch.arange(3, dtype=torch.int32), "a": torch.ones(2, 2).bfloat16()},
            {"step": torch.tensor(7, dtype=torch.int32), "m": [torch.zeros(1)]})
    tck.save(tmp_path / "t", 2, tree, extra={"loss": 1.5})
    jtree, step, extra = jck.restore(tmp_path / "t", (
        {"a": jnp.zeros((2, 2), jnp.float32), "b": jnp.zeros(3, jnp.int32)},
        {"m": [jnp.zeros(1)], "step": jnp.zeros((), jnp.int32)}))
    assert step == 2 and extra == {"loss": 1.5}
    np.testing.assert_array_equal(np.asarray(jtree[0]["b"]), [0, 1, 2])
    assert int(jtree[1]["step"]) == 7 and float(jtree[0]["a"][1, 1]) == 1.0
    back, _, _ = tck.restore(tmp_path / "t", tree)
    assert back[0]["a"].dtype == torch.bfloat16 and int(back[1]["step"]) == 7
    jck.save(tmp_path / "j", 4, {"z": jnp.full((3,), 2.0), "y": jnp.arange(2.0)})
    got, _, _ = tck.restore(tmp_path / "j", {"y": torch.zeros(2, device="meta"),
                                             "z": torch.zeros(3, dtype=torch.float64)})
    assert got["z"].dtype == torch.float64 and got["y"].tolist() == [0.0, 1.0]


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
def test_data_pipeline_deterministic_and_resumable():
    b1, b2 = tdata.batch_at(TDCFG, 17), tdata.batch_at(TDCFG, 17)
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"], b2["labels"])
    s = tdata.stream(TDCFG, start_step=17)
    assert torch.equal(next(s)["tokens"], b1["tokens"])
    assert torch.equal(next(s)["tokens"], tdata.batch_at(TDCFG, 18)["tokens"])
    assert not torch.equal(tdata.batch_at(TDCFG, 18)["tokens"], b1["tokens"])
    other = dataclasses.replace(TDCFG, seed=1)
    assert not torch.equal(tdata.batch_at(other, 17)["tokens"], b1["tokens"])
    assert b1["tokens"].shape == (8, 32) and b1["tokens"].dtype == torch.int64
    with pytest.raises(ValueError):
        tdata.batch_at(TDCFG, -1)


def test_data_is_the_reference_language():
    """Labels are the tokens shifted by one; the LCG ``(31·t + 7) mod V``
    holds where neither token was replaced (≈ 0.95²), 5% noise."""
    cfg = tdata.DataConfig(vocab_size=256, seq_len=128, global_batch=64)
    b = tdata.batch_at(cfg, 0)
    t, l = b["tokens"], b["labels"]
    assert torch.equal(t[:, 1:], l[:, :-1])
    assert int(t.min()) >= 0 and int(t.max()) < 256
    follows = float(((31 * t + 7) % 256 == l).float().mean())
    assert 0.88 < follows < 0.925
    jb = jdata.batch_at(jdata.DataConfig(vocab_size=256, seq_len=128, global_batch=64), 0)
    jfollows = float(np.mean((31 * np.asarray(jb["tokens"]) + 7) % 256
                             == np.asarray(jb["labels"])))
    assert abs(follows - jfollows) < 0.02


# --------------------------------------------------------------------------- #
# gradient compression
# --------------------------------------------------------------------------- #
def test_quantize_int8_matches_jax():
    x = np.linspace(-1.0, 1.0, 64, dtype=np.float32) ** 3
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    err = (tcomp.dequantize_int8(tq, ts) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(ts) * 0.5 + 1e-6


def test_compressed_allreduce_one_replica_matches_jax():
    mesh = make_mesh_compat((1,), ("data",))
    tmesh = Mesh(logical_devices(1, "cpu"), ("data",))
    rng = np.random.default_rng(0)
    g = {"w": (0.3 + 0.01 * rng.standard_normal((1, 8, 8))).astype(np.float32),
         "b": rng.standard_normal((1, 5)).astype(np.float32)}
    jred, je = jcomp.compressed_allreduce({k: jnp.asarray(v) for k, v in g.items()},
                                          mesh, "data")
    tred, te = tcomp.compressed_allreduce({k: torch.from_numpy(v) for k, v in g.items()},
                                          tmesh, "data")
    jred2, _ = jcomp.compressed_allreduce({k: jnp.asarray(v) for k, v in g.items()},
                                          mesh, "data", error_state=je)
    tred2, _ = tcomp.compressed_allreduce({k: torch.from_numpy(v) for k, v in g.items()},
                                          tmesh, "data", error_state=te)
    for k in g:
        assert tred[k].shape == g[k].shape[1:] and te[k].shape == g[k].shape
        for got, want in ((tred[k], jred[k]), (te[k], je[k]), (tred2[k], jred2[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def _np_allreduce(g, e):
    """A numpy restatement: per replica, quantize the corrected row, keep
    its residual, average the dequantized rows."""
    deq, new_e = [], []
    for gi, ei in zip(g, e):
        c = gi.astype(np.float32) + ei
        s = np.float32(np.abs(c).max() + np.float32(1e-12)) / np.float32(127.0)
        q = np.clip(np.round(c / s), -127, 127).astype(np.int8)
        d = q.astype(np.float32) * s
        deq.append(d)
        new_e.append(c - d)
    return sum(deq) / np.float32(len(g)), np.stack(new_e)


def test_compressed_allreduce_four_logical_devices_matches_numpy():
    mesh = Mesh(np.array(logical_devices(4, "cpu"), dtype=object).reshape(4, 1),
                ("data", "model"))
    rng = np.random.default_rng(1)
    g = {"layers": {"w": rng.standard_normal((4, 6, 7)).astype(np.float32)},
         "embed": (0.01 * rng.standard_normal((4, 9))).astype(np.float32)}
    e_np = {"w": np.zeros((4, 6, 7), np.float32), "embed": np.zeros((4, 9), np.float32)}
    tg = {"layers": {"w": torch.from_numpy(g["layers"]["w"])},
          "embed": torch.from_numpy(g["embed"]).bfloat16()}
    red, err = tcomp.compressed_allreduce(tg, mesh, "data")
    red2, _ = tcomp.compressed_allreduce(tg, mesh, "data", error_state=err)
    for got, got2, gs, e, key in ((red["layers"]["w"], red2["layers"]["w"], g["layers"]["w"],
                                   err["layers"]["w"], "w"),
                                  (red["embed"], red2["embed"],
                                   tg["embed"].float().numpy(), err["embed"], "embed")):
        want, want_e = _np_allreduce(gs, e_np[key])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        np.testing.assert_allclose(e.numpy(), want_e, atol=1e-6)
        want2, _ = _np_allreduce(gs, want_e)
        np.testing.assert_allclose(got2.numpy(), want2, atol=1e-6)
        # error feedback: two rounds' mean is closer to the exact mean
        exact = gs.mean(0)
        two = (got.numpy() + got2.numpy()) / 2
        assert np.abs(two - exact).max() <= np.abs(got.numpy() - exact).max() + 1e-9
    with pytest.raises(ValueError, match="replicas"):
        tcomp.compressed_allreduce({"w": torch.zeros(3, 2)}, mesh, "data")


# --------------------------------------------------------------------------- #
# the CLI, without the reference
# --------------------------------------------------------------------------- #
def test_train_cli_runs_without_the_reference(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --steps 3`` in a
    process that would fail on any import of ``repro`` or ``jax``; a second
    run with ``--ckpt-dir`` resumes from the first's checkpoint."""
    guard = ("import sys, runpy\n"
             "class Block:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('repro', 'jax'):\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, Block())\n"
             "sys.argv = ['train'] + sys.argv[1:]\n"
             "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    outs = []
    for steps in (3, 5):
        out = subprocess.run([sys.executable, "-c", guard, "--device", "cpu", "--steps",
                              str(steps), "--seq-len", "32", "--ckpt-dir", str(tmp_path)],
                             capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        outs.append(out.stdout)
    assert "step     0 loss" in outs[0] and "done: 3 steps" in outs[0]
    assert "nan-skips 0" in outs[0] and "resumed=None" in outs[0]
    assert "done: 5 steps" in outs[1] and "resumed=3" in outs[1]
    assert tck.latest_step(tmp_path) == 5


def test_train_cli_trains_mamba2_without_the_reference():
    """``launch.train --arch mamba2-1.3b --device cpu`` (the reduced ssm
    family, through the SSD scan's Function) in a process that would fail
    on any import of ``repro`` or ``jax``."""
    guard = ("import sys, runpy\n"
             "class Block:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('repro', 'jax'):\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, Block())\n"
             "sys.argv = ['train'] + sys.argv[1:]\n"
             "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", guard, "--arch", "mamba2-1.3b",
                          "--device", "cpu", "--steps", "3", "--seq-len", "32"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step     0 loss" in out.stdout and "done: 3 steps" in out.stdout
    assert "nan-skips 0" in out.stdout

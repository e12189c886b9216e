"""The ``remat`` flag of the PyTorch port against the JAX reference, in f32
on the CPU: under "full", "dots" and "none" the loss and every parameter's
gradient of ``zoo.loss_fn`` equal ``jax.value_and_grad`` of the reference's
(``test_torch_grad.py``'s tolerances: loss 1e-5, each leaf within 1e-4 of
its largest magnitude), and the port's "full" and "dots" gradients equal
its "none" ones to f32 rounding, for the dense, local/global pair, hybrid,
ssm and encoder-decoder families.  The reference's remat changes what it
keeps, not what it computes, so its gradients are taken once per family,
under "none".  The recompute is counted through the RMSNorm,
flash-attention, ``moe_gmm`` and SSD-scan forwards (the launches the card's
smoke test gates), and serving never reaches ``torch.utils.checkpoint``."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import flags as jflags
from repro.models import lm as jlm
from repro.models import zoo as jzoo
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import flags as tflags
from repro_torch.models import lm as tlm
from repro_torch.models import zoo as tzoo

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

LOSS_TOL = 1e-5
LEAF_TOL = 1e-4
POLICIES = ("full", "dots", "none")
ARCHS = ("qwen2-1.5b", "gemma2-9b", "zamba2-7b", "mamba2-1.3b", "whisper-tiny")


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """Configs, the reference's weights, the port's model from them and a
    batch (built once per arch: the model's weights are never updated)."""
    jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
    params = jlm.init_params(jcfg, jax.random.PRNGKey(11))
    model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    rng = np.random.default_rng(12)
    B, S = 2, 12
    batch = {k: rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if jcfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((B, jcfg.n_frames, jcfg.d_model)
                                              ).astype(np.float32)
    return jcfg, tcfg, params, model, batch


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    """The reference's loss and gradients (under names of the port's
    parameters), traced under "none"."""
    jcfg, tcfg, params, _, batch = _pair(arch)
    with jflags.scoped(remat="none"):      # traced here, under the flag
        jloss, jgrads = jax.jit(jax.value_and_grad(jzoo.loss_fn),
                                static_argnums=1)(params, jcfg, batch)
    return float(jloss), tlm.named_from_jax(tcfg, jax.tree.map(np.asarray, jgrads))


@functools.lru_cache(maxsize=None)
def _port_grads(arch, remat):
    _, tcfg, _, model, batch = _pair(arch)
    named = dict(model.named_parameters())
    with tflags.scoped(remat=remat):
        loss = tzoo.loss_fn(model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_under_the_same_flag(arch, remat):
    jloss, want = _jax_grads(arch)
    loss, grads = _port_grads(arch, remat)
    assert abs(loss - jloss) <= LOSS_TOL
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g.numpy() - w).max()) <= LEAF_TOL * scale, (name, remat)
    if remat != "none":         # the recompute gives the kept activations' gradients
        base_loss, base = _port_grads(arch, "none")
        assert loss == base_loss
        for name, g in grads.items():
            scale = max(float(base[name].abs().max()), 1e-12)
            assert float((g - base[name]).abs().max()) <= 1e-6 * scale, (name, remat)


def _count_forwards(monkeypatch, ops=None):
    ops = {"rmsnorm": rms_ops, "flash_attention": fa_ops} if ops is None else ops
    counts = {name: 0 for name in ops}

    def counted(name, fn):
        def wrapper(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapper
    for name, mod in ops.items():
        monkeypatch.setattr(mod, "_forward", counted(name, mod._forward))
    return counts


@pytest.mark.parametrize("remat", POLICIES)
def test_recompute_runs_each_layer_forward_again(remat, monkeypatch):
    """A dense model's step: the forward runs 2L+1 RMSNorms and L flash
    attentions; under "full" and "dots" the backward runs every layer's
    again (2L and L more; the final norm is outside the units), under
    "none" nothing runs again.  Per microbatch, these are the counts the
    card's smoke test gates on its RMSNorm and flash-attention launches."""
    tcfg = dataclasses.replace(tget_config("qwen2-1.5b").reduced(), dtype="float32")
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = {k: torch.randint(0, tcfg.vocab_size, (2, 8)) for k in ("tokens", "labels")}
    counts = _count_forwards(monkeypatch)
    L = tcfg.n_layers
    with tflags.scoped(remat=remat):
        loss = tzoo.loss_fn(model, tcfg, batch)
        assert counts == {"rmsnorm": 2 * L + 1, "flash_attention": L}
        torch.autograd.grad(loss, list(model.parameters()))
    again = 0 if remat == "none" else 1
    assert counts == {"rmsnorm": (2 + 2 * again) * L + 1,
                      "flash_attention": (1 + again) * L}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-1.3b", "zamba2-7b"])
def test_recompute_runs_the_moe_and_scan_forwards_again(arch, monkeypatch):
    """The moe, ssm and hybrid families under "full": each remat unit's
    forward runs again in the backward, the ``moe_gmm`` and SSD-scan
    Functions' forwards with it, so a microbatch runs every kernel of a
    unit twice and the final norm once.  With M Mamba layers, G shared
    blocks (zamba2's groups) and L decoder layers: RMSNorm 2·(2M + 2G + 2L)
    + 1, flash attention 2·(G + L), ``moe_gmm`` 2·L (mixtral, either MoE
    implementation), the SSD scan 2·M.  These are the counts the card's
    smoke test gates on those launches, per microbatch."""
    tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = {k: torch.randint(0, tcfg.vocab_size, (2, 16)) for k in ("tokens", "labels")}
    counts = _count_forwards(monkeypatch, {"rmsnorm": rms_ops, "flash_attention": fa_ops,
                                           "moe_gmm": moe_ops, "ssd_scan": ssd_ops})
    if tcfg.family == "hybrid":
        G, per, tail = tlm._hybrid_shape(tcfg)
        M, L = G * per + tail, 0
    else:
        G, M, L = 0, (tcfg.n_layers if tcfg.family == "ssm" else 0), \
            (tcfg.n_layers if tcfg.family == "moe" else 0)
    want = {"rmsnorm": 2 * (2 * M + 2 * G + 2 * L) + 1, "flash_attention": 2 * (G + L),
            "moe_gmm": 2 * L, "ssd_scan": 2 * M}
    impls = ("dense", "dispatch") if tcfg.family == "moe" else ("dense",)
    for impl in impls:
        for k in counts:
            counts[k] = 0
        with tflags.scoped(remat="full", moe_impl=impl):
            loss = tzoo.loss_fn(model, tcfg, batch)
            torch.autograd.grad(loss, list(model.parameters()))
        assert counts == want, (impl, counts, want)


def test_serving_never_reaches_checkpoint(monkeypatch):
    """Prefill and decode steps, and a forward under ``no_grad``, run as
    before under every policy: ``torch.utils.checkpoint`` is not called."""
    def refuse(*a, **kw):
        raise AssertionError("checkpoint called while serving")
    monkeypatch.setattr(tlm.ckpt, "checkpoint", refuse)
    tcfg = dataclasses.replace(tget_config("qwen2-1.5b").reduced(), dtype="float32")
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (2, 6))
    for remat in POLICIES:
        with tflags.scoped(remat=remat):
            tzoo.make_prefill_step(tcfg)(model, {"tokens": tokens})
            cache = tlm.init_cache(tcfg, 2, 16, device="cpu")
            tzoo.make_serve_step(tcfg)(model, cache, tokens[:, :1],
                                       torch.zeros(2, dtype=torch.int32))
            with torch.no_grad():
                tlm.forward(model, tcfg, tokens)
    with tflags.scoped(remat="full"), pytest.raises(AssertionError, match="serving"):
        tlm.forward(model, tcfg, tokens)          # with grad: the wrapper acts


def test_remat_flag_defaults_to_the_reference():
    assert tflags.get_flag("remat") == jflags.get_flag("remat") == "full"

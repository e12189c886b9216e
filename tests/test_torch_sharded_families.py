"""Sharded replicas of every family in the PyTorch port on 8 logical CPU
devices, held to the JAX reference on reduced configs in f32 with the same
weights: ``ShardedEngine`` of mamba2 (ssm), zamba2 (hybrid), minicpm3 (MLA,
paged and contiguous), gemma2 (local/global pairs) and whisper
(encoder-decoder) at tp 2, tp 4 and dp 2 × tp 2 against the JAX plain
engine, with the reference's policy, specs and fallbacks and the bytes each
logical device holds; ``fsdp`` mode (qwen2 and whisper at tp 8) with the
lanes split over the devices and not; pp 2 × tp 2 of mamba2 and minicpm3
against the JAX ``PipelinedEngine``; cross-TP migration of mamba2 and
zamba2 in flight with JAX engines on either side; and the Mamba-2 shard
step against the unsharded ``mamba2_fwd``.  Greedy tokens are compared
exactly.
"""
import dataclasses
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.distributed import sharding as jsh
from repro.models import lm as jlm
from repro.serving import sharded as jsharded
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import RequestState as JRequestState
from repro.serving.engine import SlotExport as JSlotExport
from repro.serving.sharded import PipelinedEngine as JPipelinedEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.core.plan import default_stage_cuts
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import logical_devices
from repro_torch.models import lm as tlm
from repro_torch.models import ssd
from repro_torch.models.layers import rmsnorm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import RequestState as TRequestState
from repro_torch.serving.engine import SlotExport as TSlotExport
from repro_torch.serving.sharded import PipelinedEngine, ShardedEngine, SubmeshAllocator

torch.set_num_threads(1)
MAX_SEQ = 48
NEW = 4
_ZOO, _REF = {}, {}


def _zoo(arch):
    if arch not in _ZOO:
        jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
        params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
        _ZOO[arch] = (jcfg, tcfg, params, model)
    return _ZOO[arch]


def _alloc(n=8):
    return SubmeshAllocator(logical_devices(n, "cpu"))


def _prompts(cfg, n=3, length=8):
    v = cfg.vocab_size
    return [[(13 * i + 5 * j) % (v - 1) + 1 for j in range(length)] for i in range(n)]


def _drain(eng, req_cls, prompts, new=NEW):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=list(p), max_new_tokens=new))
    return {d.request.rid: list(d.generated) for d in eng.run_until_drained()}


def _reference(arch, paged, slots=2):
    """The JAX plain engine's tokens, once per (arch, path, slots), and the
    drained engine (its steps compiled)."""
    key = (arch, paged, slots)
    if key not in _REF:
        jcfg, tcfg, params, _ = _zoo(arch)
        eng = JEngine(jcfg, params, n_slots=slots, max_seq_len=MAX_SEQ, paged=paged,
                      page_size=4)
        _REF[key] = (_drain(eng, JRequest, _prompts(tcfg)), eng)
    return _REF[key]


class StubMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _check_decision(eng, jcfg, params, shape, paged):
    """Policy, parameter specs and fallbacks equal what the reference's
    ShardedEngine records for this mesh shape."""
    pol = dataclasses.replace(jsh.make_policy(StubMesh(shape), jcfg), fsdp_axis=None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jd = jsh.sharding_decision(jcfg, pol, params)
    reason = jsharded.fused_paged_unsupported_reason(jcfg, shape["model"]) if paged else None
    if reason is not None:
        axis = pol.tp_axis if reason == "kv_heads" else ""
        path = "paged_kernel" if reason == "kv_heads" else f"paged_kernel:{reason}"
        jd.fallbacks.append(jsh.FallbackRecord(path, 3, jcfg.n_kv_heads, axis, shape["model"]))
    tpol = eng.sharding_policy
    assert (tpol.mode, tpol.ep, tpol.fsdp_axis, tpol.tp_size, tpol.batch_axes) == \
        (pol.mode, pol.ep, pol.fsdp_axis, pol.tp_size, pol.batch_axes)
    got = {k: tuple(v) for k, v in sh.spec_leaves(eng.decision.param_specs).items()}
    want = {".".join(str(k.key) for k in kp): tuple(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(
                jd.param_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert got == want
    assert [tuple(vars(f).values()) for f in eng.decision.fallbacks] == \
        [tuple(vars(f).values()) for f in jd.fallbacks]


FAMILIES = [("mamba2-1.3b", False), ("zamba2-7b", False), ("minicpm3-4b", True),
            ("minicpm3-4b", False), ("gemma2-9b", False), ("whisper-tiny", False)]


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("arch,paged", FAMILIES)
def test_family_tokens_and_decision_equal_the_reference(arch, paged, shape):
    """tp 2, tp 4 (gemma2's 2 KV heads replicate there) and dp 2 × tp 2 with
    the 2 slots split over data: tokens equal the JAX plain engine's, the
    decision the reference's, no page leaks and the submesh returns."""
    jcfg, tcfg, params, model = _zoo(arch)
    ref = _reference(arch, paged)[0]
    alloc = _alloc()
    eng = ShardedEngine(tcfg, model, alloc.alloc(shape), allocator=alloc, n_slots=2,
                        max_seq_len=MAX_SEQ, paged=paged, page_size=4)
    _check_decision(eng, jcfg, params, {"data": shape[0], "model": shape[1]}, paged)
    group = eng.stages[0]
    assert group.lane_split == (shape[0] == 2) and not group.fsdp
    assert group.kv_split == (tcfg.n_kv_heads % shape[1] == 0)
    assert _drain(eng, TRequest, _prompts(tcfg)) == ref
    if paged:
        assert eng.release_all_pages() == 0
    eng.release_devices()
    assert alloc.free_devices == 8


def _weight_bytes(eng, model):
    """Bytes one logical device holds of the weights under the layout: each
    leaf whole, or its 1/tp slice where the spec splits it."""
    specs = sh.spec_leaves(eng.decision.param_specs)
    n = 0
    for path, shape in sh.spec_leaves(sh.jax_layout(model)).items():
        n += int(np.prod(shape)) * 4 // (eng.tp if "model" in specs[path] else 1)
    return n


@pytest.mark.parametrize("arch,paged", [("mamba2-1.3b", False), ("zamba2-7b", False),
                                        ("minicpm3-4b", True), ("minicpm3-4b", False),
                                        ("whisper-tiny", False)])
def test_bytes_per_logical_device_follow_the_layout(arch, paged):
    """tp 2: conv channels and ssm heads split, MLA's latent rows split on
    the contiguous path and its latent pool whole, whisper's K/V split by
    heads and its ``xk``/``xv`` whole."""
    _, tcfg, _, model = _zoo(arch)
    alloc = _alloc()
    eng = ShardedEngine(tcfg, model, alloc.alloc((1, 2)), allocator=alloc, n_slots=2,
                        max_seq_len=MAX_SEQ, paged=paged, page_size=4)
    meta = (tlm.init_paged_cache(tcfg, eng.page_pool.n_pages, 4, device="meta") if paged
            else tlm.init_cache(tcfg, 2, MAX_SEQ, device="meta"))
    split = {"conv": True, "ssm": True, "ckv": True, "pos": arch == "minicpm3-4b",
             "k": True, "v": True, "attn_k": True, "attn_v": True, "attn_pos": False,
             "xk": False, "xv": False, "ckvp": False}
    cache = sum(t.numel() * 4 // (2 if split[p[-1]] else 1) for p, t in tlm.leaves(meta))
    per = eng.bytes_per_device()
    assert set(per) == {0, 1} and set(per.values()) == {_weight_bytes(eng, model) + cache}
    c0 = eng.stages[0].caches[0][0]
    for path, t in tlm.leaves(meta):
        leaf = c0
        for k in path:
            leaf = leaf[k]
        assert leaf.numel() * (2 if split[path[-1]] else 1) == t.numel(), path
    eng.release_devices()


@pytest.mark.parametrize("arch,slots", [("qwen2-1.5b", 8), ("qwen2-1.5b", 2),
                                        ("whisper-tiny", 8), ("whisper-tiny", 2)])
def test_fsdp_at_tp8_equals_the_reference(arch, slots):
    """tp 8 does not divide 4 query heads: ``fsdp`` mode.  Each device holds
    its slices of the weights and gathers a block's whole weights before it
    runs it; 8 slots split one lane a device, 2 do not split (every device
    computes every lane)."""
    jcfg, tcfg, params, model = _zoo(arch)
    paged = tlm.pageable(tcfg)
    ref = _reference(arch, paged, slots)[0]
    alloc = _alloc()
    eng = ShardedEngine(tcfg, model, alloc.alloc((1, 8)), allocator=alloc, n_slots=slots,
                        max_seq_len=MAX_SEQ, paged=paged, page_size=4)
    _check_decision(eng, jcfg, params, {"data": 1, "model": 8}, paged)
    group = eng.stages[0]
    assert group.fsdp and group.tp == 1 and group.dp == 8
    assert group.lane_split == (slots == 8)
    assert [b - a for a, b in group.lanes] == [1 if slots == 8 else slots] * 8
    per = eng.bytes_per_device()
    meta = (tlm.init_paged_cache(tcfg, eng.page_pool.n_pages, 4, device="meta") if paged
            else tlm.init_cache(tcfg, slots, MAX_SEQ, device="meta"))
    cache = sum(t.numel() * 4 for _, t in tlm.leaves(meta))   # whole heads
    if slots == 8 and not paged:                                # one lane a device
        cache //= slots
    assert set(per.values()) == {_weight_bytes(eng, model) + cache}
    assert _drain(eng, TRequest, _prompts(tcfg)) == ref
    if paged:
        assert eng.release_all_pages() == 0
    eng.release_devices()


@pytest.mark.parametrize("arch,paged", [("mamba2-1.3b", False), ("minicpm3-4b", True),
                                        ("minicpm3-4b", False)])
def test_pp2_tp2_equals_the_jax_pipelined_engine(arch, paged):
    """Two stages of two shards each: mamba2's layers, and minicpm3's on
    the paged pool and on a contiguous ``ckv`` split by sequence."""
    jcfg, tcfg, params, model = _zoo(arch)
    kw = dict(n_slots=2, max_seq_len=MAX_SEQ, paged=paged, page_size=4)
    cuts = default_stage_cuts(tcfg.n_layers, 2)
    want = _drain(JPipelinedEngine(jcfg, params, cuts, **kw), JRequest, _prompts(tcfg))
    assert want == _reference(arch, paged)[0]
    alloc = _alloc()
    eng = PipelinedEngine(tcfg, model, cuts, stage_meshes=alloc.alloc_stages(2, (1, 2)),
                          allocator=alloc, **kw)
    assert (eng.pp, eng.tp) == (2, 2)
    assert all(type(st).__name__ == "ShardGroup" for st in eng.stages)
    assert _drain(eng, TRequest, _prompts(tcfg)) == want
    if paged:
        assert eng.release_all_pages() == 0
    eng.release_devices()
    assert alloc.free_devices == 8


def _convert(export, arch, to):
    """The same export for the other framework (nested caches kept)."""
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
                   prefill_dispatches=s.prefill_dispatches, prior_generated=s.prior_generated)
    return export_cls(req, st, cfg, jax.tree.map(np.asarray, export.cache), export.position)


def _partway(eng, req_cls, prompt, new=8):
    eng.submit(req_cls(rid=0, prompt=list(prompt), max_new_tokens=new))
    for _ in range(3):
        eng.step()
    [export] = eng.export_active()
    return export


def _finish(dst):
    """The tokens of the last request 0 ``dst`` finished."""
    return list([d for d in dst.run_until_drained() if d.request.rid == 0][-1].generated)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_cross_tp_migration_in_flight(arch):
    """A request 3 steps into decode on a JAX engine moves → tp 2 → tp 4 →
    tp 2 → the plain port engine, one step on each, its conv channels, ssm
    heads (and zamba2's K/V) gathered and re-split, into a busy target's
    second slot; another moves tp 4 → the JAX engine.  Each finishes with
    the tokens of the request served undisturbed."""
    jcfg, tcfg, params, model = _zoo(arch)
    prompt = _prompts(tcfg, 1, 10)[0]
    kw = dict(n_slots=2, max_seq_len=MAX_SEQ, paged=False)
    ref = _drain(TEngine(tcfg, model, device="cpu", **kw), TRequest, [prompt], 8)[0]
    alloc = _alloc()
    jeng = _reference(arch, False)[1]
    exp = _convert(_partway(jeng, JRequest, prompt), arch, "torch")
    for shape in ((1, 2), (1, 4), (1, 2)):
        eng = ShardedEngine(tcfg, model, alloc.alloc(shape), allocator=alloc, **kw)
        eng.submit(TRequest(rid=5, prompt=[3, 4, 5], max_new_tokens=3))
        eng.step()
        assert eng.install_active(exp) and exp.state.slot == 1
        eng.step()
        exp = next(e for e in eng.export_active() if e.request.rid == 0)
        eng.release_devices()
    plain = TEngine(tcfg, model, device="cpu", **kw)
    assert plain.install_active(exp) and _finish(plain) == ref
    src = ShardedEngine(tcfg, model, alloc.alloc((1, 4)), allocator=alloc, **kw)
    exp = _partway(src, TRequest, prompt)
    src.release_devices()
    assert jeng.install_active(_convert(exp, arch, "jax")) and _finish(jeng) == ref
    assert alloc.free_devices == 8


@pytest.mark.parametrize("tp", [2, 4])
def test_mamba2_shard_step_equals_mamba2_fwd(tp):
    """One Mamba-2 layer of a tp-``tp`` group from a carried random state,
    for a chunked prefill (S 5 and 32) and the S = 1 step: the layer output
    and the gathered conv and ssm states equal the unsharded layer's."""
    _, tcfg, _, model = _zoo("mamba2-1.3b")
    alloc = _alloc()
    eng = ShardedEngine(tcfg, model, alloc.alloc((1, tp)), allocator=alloc, n_slots=2,
                        max_seq_len=MAX_SEQ, paged=False)
    group, layer, block = eng.stages[0], model.layers[1], eng.stages[0].blocks[1]
    gen = torch.Generator().manual_seed(tp)
    for S in (5, 32, 1):
        x = torch.randn(2, S, tcfg.d_model, generator=gen)
        conv = torch.randn(tuple(group._meta_cache(0)["conv"].shape[1:]), generator=gen)
        state = torch.randn(tuple(group._meta_cache(0)["ssm"].shape[1:]), generator=gen)
        want, (wconv, wstate) = ssd.mamba2_fwd(layer.mixer, tcfg,
                                               rmsnorm(x, layer.ln.scale, tcfg.norm_eps),
                                               (conv, state))
        for s, c in enumerate(group.caches[0]):
            c["conv"][1].copy_(group._part(("conv",), conv[None], s)[0])
            c["ssm"][1].copy_(group._part(("ssm",), state[None], s)[0])
        ws, sp = group._blk(0, block.get)
        ctx = SimpleNamespace(lo=0, hi=2, writes=None)
        xs = group._mamba(0, ws, sp, [x] * tp, ctx, block)
        for got in xs:
            torch.testing.assert_close(got, x + want, atol=2e-5, rtol=2e-5)
        for key, w in (("conv", wconv), ("ssm", wstate)):
            full = group._full((key,), [c[key][1:2] for c in group.caches[0]])[0]
            torch.testing.assert_close(full, w, atol=2e-5, rtol=2e-5)
    eng.release_devices()


_XREF = {}


def _cross_reference():
    """Random ``xk``/``xv`` (as an encoder would fill them) in a 2-slot
    cache, and the JAX logits of a 6-token prefill chunk, then three decode
    steps, the third with lane 1 idle (``mask_cache_update``)."""
    if not _XREF:
        jcfg, tcfg, params, _ = _zoo("whisper-tiny")
        rng = np.random.default_rng(7)
        jc = jlm.init_cache(jcfg, 2, MAX_SEQ, dtype=np.float32)
        xk, xv = (rng.standard_normal(jc["xk"].shape).astype(np.float32) for _ in range(2))
        jc = dict(jc, xk=xk, xv=xv)
        toks = rng.integers(1, tcfg.vocab_size, size=(2, 6)).astype(np.int32)
        pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
        steps = []
        for i in range(4):
            act = np.array([True, i < 3])
            jl, jc2 = jlm.step_with_cache(params, jcfg, jc, toks, pos)
            jc = jlm.mask_cache_update(jcfg, jc, jc2, act)
            steps.append((toks, pos, act, np.asarray(jl)))
            toks = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
            pos = pos[:, -1:] + 1
        _XREF.update(xk=xk, xv=xv, steps=steps)
    return _XREF


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2), (1, 8)])
def test_whisper_cross_attention_on_a_filled_cache_equals_the_reference(shape):
    """The engines above serve whisper with zero cross state, where
    cross-attention gives 0 whatever heads it reads.  Here every shard's
    cache gets the same random ``xk``/``xv`` for its lanes and the group's
    logits hold to JAX ``step_with_cache`` within 1e-4 (the tolerance of
    ``tests/test_torch_whisper.py``): tp 2 (KV heads 2 a shard) and tp 4
    (1) read their heads through the row table, dp 2 × tp 2 splits the
    lanes, tp 8 is fsdp (the whole view)."""
    _, tcfg, _, model = _zoo("whisper-tiny")
    ref = _cross_reference()
    alloc = _alloc()
    eng = ShardedEngine(tcfg, model, alloc.alloc(shape), allocator=alloc, n_slots=2,
                        max_seq_len=MAX_SEQ, paged=False)
    group = eng.stages[0]
    assert group.fsdp == (shape[1] == 8)
    for row, (a, b) in zip(group.caches, group.lanes):
        for c in row:
            c["xk"].copy_(torch.from_numpy(ref["xk"][:, a:b]))
            c["xv"].copy_(torch.from_numpy(ref["xv"][:, a:b]))
    with torch.inference_mode():
        for toks, pos, act, want in ref["steps"]:
            write = None if act.all() else torch.from_numpy(np.flatnonzero(act))
            got = group.step_contig(torch.from_numpy(toks), torch.from_numpy(pos), None,
                                    write, last_only=False)
            np.testing.assert_allclose(got.numpy()[act], want[act], atol=1e-4, rtol=1e-4)
    eng.release_devices()

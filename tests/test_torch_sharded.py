"""Sharded replicas in the PyTorch port on 8 logical CPU devices, held to
the JAX reference on reduced configs in f32 with the same weights:
``ShardedEngine`` at tp 2/4 and dp 2 × tp 2 (paged and contiguous) against
the JAX plain engine, its policy and decision against the reference's rules;
expert parallelism (mixtral) against the dense mix; the head-sharded paged
decode's plain path per shard against the Pallas kernel in interpret mode,
and the KV-head row tables of the replicated-pool fallback; cross-TP
migration with JAX engines on either side; pool failover onto a survivor of
another TP degree; ``TorchBackend`` with and without an allocator; the
families the port does not shard; and ``repro_torch.launch.sharded_check``.
Greedy tokens are compared exactly.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.distributed import sharding as jsh
from repro.kernels.flash_decode import ops as jfd
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving import sharded as jsharded
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import RequestState as JRequestState
from repro.serving.engine import SlotExport as JSlotExport
from repro_torch.configs import get_config as tget_config
from repro_torch.core.plan import Plan, ReplicaGroup, Workload
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.expert_parallel import ep_moe_mix
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.flash_decode.ref import flash_decode_ref, paged_flash_decode_ref
from repro_torch.launch import sharded_check
from repro_torch.launch.mesh import logical_devices
from repro_torch.models import flags
from repro_torch.models import lm as tlm
from repro_torch.models.layers import moe_dense_mix
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import RequestState as TRequestState
from repro_torch.serving.engine import SlotExport as TSlotExport
from repro_torch.serving.pool import EnginePool
from repro_torch.serving.sharded import (PipelinedEngine, ShardedEngine, SubmeshAllocator,
                                         engine_for_group, sharded_unsupported_reason)

torch.set_num_threads(1)
MAX_SEQ = 48
NEW = 6
_ZOO = {}


def _zoo(arch="qwen2-1.5b"):
    if arch not in _ZOO:
        jcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tcfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
        params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
        _ZOO[arch] = (jcfg, tcfg, params, model)
    return _ZOO[arch]


def _alloc(n=8):
    return SubmeshAllocator(logical_devices(n, "cpu"))


def _prompts(cfg, n=3, length=12):
    v = cfg.vocab_size
    return [[(17 * i + 3 * j) % (v - 1) + 1 for j in range(length)] for i in range(n)]


def _drain(eng, req_cls, prompts, new=NEW):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=list(p), max_new_tokens=new))
    return {d.request.rid: list(d.generated) for d in eng.run_until_drained()}


class StubMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _reference_decision(jcfg, params, shape, paged):
    """What the reference's ShardedEngine records for this mesh shape: its
    serving policy's decision plus the paged-kernel fallback."""
    pol = dataclasses.replace(jsh.make_policy(StubMesh(shape), jcfg), fsdp_axis=None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d = jsh.sharding_decision(jcfg, pol, params)
    reason = jsharded.fused_paged_unsupported_reason(jcfg, shape["model"]) if paged else None
    if reason == "kv_heads":
        d.fallbacks.append(jsh.FallbackRecord("paged_kernel", 3, jcfg.n_kv_heads,
                                              pol.tp_axis, shape["model"]))
    return pol, d


CASES = [((1, 2), 2, True), ((1, 4), 2, True), ((2, 2), 2, True), ((2, 2), 3, True),
         ((1, 2), 2, False), ((1, 4), 2, False), ((2, 2), 2, False), ((2, 2), 3, False)]


@pytest.mark.parametrize("shape,slots,paged", CASES)
def test_sharded_tokens_and_decision_equal_the_reference(shape, slots, paged):
    """tp 2, tp 4 (KV heads 2 replicate) and dp 2 × tp 2 with the lanes split
    over data (2 slots) or computed by every data row (3 slots)."""
    jcfg, tcfg, params, model = _zoo()
    prompts = _prompts(tcfg)
    kw = dict(n_slots=slots, max_seq_len=MAX_SEQ, paged=paged, page_size=4)
    ref = _drain(JEngine(jcfg, params, **kw), JRequest, prompts)
    alloc = _alloc()
    eng = ShardedEngine(tcfg, model, alloc.alloc(shape), allocator=alloc, **kw)
    jpol, jd = _reference_decision(jcfg, params, {"data": shape[0], "model": shape[1]}, paged)
    pol = eng.sharding_policy
    assert (pol.mode, pol.ep, pol.fsdp_axis, pol.tp_size, pol.batch_axes) == \
        (jpol.mode, jpol.ep, jpol.fsdp_axis, jpol.tp_size, jpol.batch_axes)
    got_specs = {k: tuple(v) for k, v in sh.spec_leaves(eng.decision.param_specs).items()}
    want_specs = {".".join(str(k.key) for k in kp): tuple(v) for kp, v in
                  jax.tree_util.tree_flatten_with_path(
                      jd.param_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert got_specs == want_specs
    assert [tuple(vars(f).values()) for f in eng.decision.fallbacks] == \
        [tuple(vars(f).values()) for f in jd.fallbacks]
    assert eng.decision.tp_fallback_fraction == jd.tp_fallback_fraction
    assert eng.paged_kernel_fused == (paged and shape[1] == 2)
    group = eng.stages[0]
    assert group.kv_split == (shape[1] == 2)
    assert group.lane_split == (shape[0] > 1 and slots % shape[0] == 0)
    assert _drain(eng, TRequest, prompts) == ref
    assert eng.release_all_pages() == 0
    eng.release_devices()
    eng.release_devices()
    assert alloc.free_devices == 8


def _expected_bytes(eng, model, tcfg):
    """Bytes one logical device holds under the layout: each leaf whole, or
    its 1/tp slice where the spec splits it, plus its cache."""
    tp = eng.tp
    specs = sh.spec_leaves(eng.decision.param_specs)
    n = 0
    for path, shape in sh.spec_leaves(sh.jax_layout(model)).items():
        elems = int(np.prod(shape))
        split = "model" in specs[path]
        n += elems * 4 // (tp if split else 1)
    return n


def test_bytes_per_logical_device_follow_the_layout():
    _, tcfg, _, model = _zoo()
    alloc = _alloc()
    for shape in ((1, 2), (1, 4)):
        eng = ShardedEngine(tcfg, model, alloc.alloc(shape), allocator=alloc,
                            n_slots=2, max_seq_len=MAX_SEQ, page_size=4)
        per = eng.bytes_per_device()
        assert len(per) == shape[1]
        pool = 2 * tcfg.n_layers * eng.page_pool.n_pages * 4 * tcfg.d_head * 4
        pool = pool * (tcfg.n_kv_heads // shape[1] if shape[1] == 2 else tcfg.n_kv_heads)
        want = _expected_bytes(eng, model, tcfg) + pool
        assert set(per.values()) == {want}
        eng.release_devices()


@pytest.mark.parametrize("tp", [2, 4])
def test_expert_parallel_mixtral_equals_the_dense_mix(tp):
    jcfg, tcfg, params, model = _zoo("mixtral-8x7b")
    prompts = _prompts(tcfg)
    kw = dict(n_slots=2, max_seq_len=MAX_SEQ)
    ref = _drain(JEngine(jcfg, params, **kw), JRequest, prompts)
    alloc = _alloc()
    eng = ShardedEngine(tcfg, model, alloc.alloc((1, tp)), allocator=alloc, **kw)
    assert eng.sharding_policy.ep and eng.stages[0].ep and eng._ep_flag is not None
    w = eng.stages[0].weights[0]
    assert [x.layers[0].ffn.w_gate.shape[0] for x in w] == [tcfg.n_experts // tp] * tp
    assert _drain(eng, TRequest, prompts) == ref
    eng.release_devices()

    layer = model.layers[0].ffn
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, tcfg.d_model))
                         .astype(np.float32))
    mesh = _alloc().alloc((1, tp))
    dense = moe_dense_mix(layer, tcfg, x)
    torch.testing.assert_close(ep_moe_mix(layer, tcfg, x, mesh), dense, atol=1e-5, rtol=1e-5)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["ffn"])
    jdense = jlayers.moe_dense_mix(jp, jcfg, jax.numpy.asarray(x.numpy()))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=1e-5, rtol=1e-5)
    toks = torch.tensor([[3, 7, 11, 5]])
    want = tlm.forward(model, tcfg, toks)
    with flags.scoped(ep_shard={"mesh": mesh, "axis": "model"}):
        torch.testing.assert_close(tlm.forward(model, tcfg, toks), want, atol=1e-5, rtol=1e-5)
    bad = _alloc().alloc((1, 3))
    with pytest.raises(ValueError, match="not divisible by expert-parallel degree 3"):
        ep_moe_mix(layer, tcfg, x, bad)


def _decode_inputs(B=3, H=8, Hkv=4, D=64, page=16, P=16, n_ptab=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    ptab = rng.permutation(np.arange(1, P))[:B * n_ptab].reshape(B, n_ptab).astype(np.int32)
    lens = np.array([5, 0, 61][:B], np.int32)
    return q, kp, vp, ptab, lens


@pytest.mark.parametrize("tp,window", [(1, None), (2, None), (4, None), (2, 24), (4, 24)])
def test_sharded_paged_decode_equals_the_pallas_kernel(tp, window):
    """Each shard's plain decode over its KV-head slice, concatenated along
    heads, against the Pallas kernel in interpret mode; and the
    ``paged_shard`` route of the paged step."""
    q, kp, vp, ptab, lens = _decode_inputs()
    want = np.asarray(jfd.paged_flash_decode(q, kp, vp, ptab, lens, window=window,
                                             interpret=True))
    mesh = _alloc().alloc((1, tp))
    t = [torch.from_numpy(a) for a in (q, kp, vp, ptab, lens)]
    got = fd.sharded_paged_flash_decode(*t, mesh, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    local = kp.shape[2] // tp
    shards = [torch.from_numpy(a[:, :, s * local:(s + 1) * local].copy())
              for a in (kp, vp) for s in range(tp)]
    got2 = fd.sharded_paged_flash_decode(t[0], shards[:tp], shards[tp:], t[3], t[4], mesh,
                                         window=window)
    assert torch.equal(got, got2)


def test_sharded_paged_decode_refuses_indivisible_heads_and_routes_by_flag():
    q, kp, vp, ptab, lens = (torch.from_numpy(a) for a in _decode_inputs())
    with pytest.raises(ValueError, match="n_kv_heads=4 not divisible by tp=8"):
        fd.sharded_paged_flash_decode(q, kp, vp, ptab, lens, _alloc().alloc((1, 8)))
    _, tcfg, _, model = _zoo()
    toks = torch.tensor([[5], [9]])
    pos = torch.tensor([[3], [6]])
    ptab2 = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    act = torch.tensor([True, True])
    out = []
    for flag in (None, {"mesh": _alloc().alloc((1, 2)), "axis": "model"}):
        cache = tlm.init_paged_cache(tcfg, 6, 4, device="cpu")
        for c in cache.values():
            c.normal_(generator=torch.Generator().manual_seed(2))
        with flags.scoped(paged_shard=flag):
            out.append(tlm.paged_step(model, tcfg, cache, toks, pos, ptab2, act,
                                      page_size=4)[0])
    torch.testing.assert_close(out[0], out[1], atol=1e-5, rtol=1e-5)


def test_kv_head_row_tables_read_one_head_of_a_replicated_cache():
    """The fallback's page-size-1 views: decode and flash attention over
    one KV head through the row tables equal the plain versions on that
    head's slice, paged and contiguous."""
    q, kp, vp, ptab, lens = (torch.from_numpy(a) for a in _decode_inputs())
    page, Hkv = kp.shape[1], kp.shape[2]
    G = q.shape[1] // Hkv
    for h in range(Hkv):
        qh = q[:, h * G:h * G + 3].contiguous()
        rows = fd.kv_head_rows(ptab, page, Hkv, h)
        got = fd.paged_flash_decode(qh, fd.head_view(kp), fd.head_view(vp), rows, lens, 24)
        want = paged_flash_decode_ref(qh, kp[:, :, h:h + 1].contiguous(),
                                      vp[:, :, h:h + 1].contiguous(), ptab, lens, 24)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        qc = torch.randn(3, 4, 3, q.shape[2], generator=torch.Generator().manual_seed(h))
        kl = torch.tensor([9, 4, 60], dtype=torch.int32)
        got = fa.flash_attention(qc, fd.head_view(kp), fd.head_view(vp), causal=True,
                                 kv_len=kl, ptab=rows)
        want = flash_attention_ref(qc, kp[:, :, h:h + 1].contiguous(),
                                   vp[:, :, h:h + 1].contiguous(), causal=True,
                                   kv_len=kl, ptab=ptab)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    K = torch.randn(3, 20, Hkv, q.shape[2])
    V = torch.randn(3, 20, Hkv, q.shape[2])
    kl = torch.tensor([20, 0, 7], dtype=torch.int32)
    for h in range(Hkv):
        rows = fd.contiguous_kv_head_rows(3, 20, Hkv, h, "cpu")
        qh = q[:, :2].contiguous()
        got = fd.paged_flash_decode(qh, fd.head_view(K), fd.head_view(V), rows, kl)
        want = flash_decode_ref(qh, K[:, :, h:h + 1], V[:, :, h:h + 1], kl)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def _convert(export, req_cls, state_cls, export_cls, cfg):
    r, s = export.request, export.state
    req = req_cls(r.rid, list(r.prompt), r.max_new_tokens, r.eos_id, r.arrival_time,
                  first_token_time=r.first_token_time, prior_generated=r.prior_generated)
    orig = req_cls(s.request.rid, list(s.request.prompt), s.request.max_new_tokens,
                   s.request.eos_id, s.request.arrival_time)
    st = state_cls(orig, s.slot, list(s.generated), s.position,
                   first_token_time=s.first_token_time,
                   prefill_dispatches=s.prefill_dispatches, prior_generated=s.prior_generated)
    cache = {k: np.asarray(v) for k, v in export.cache.items()}
    return export_cls(req, st, cfg, cache, export.position)


def _partway(eng, req_cls, prompt, new=8):
    eng.submit(req_cls(rid=0, prompt=list(prompt), max_new_tokens=new))
    for _ in range(3):
        eng.step()
    [export] = eng.export_active()
    return export


def _finish(dst):
    return list(next(d for d in dst.run_until_drained() if d.request.rid == 0).generated)


@pytest.mark.parametrize("paged", [True, False])
def test_cross_tp_migration_with_jax_engines_on_either_side(paged):
    jcfg, tcfg, params, model = _zoo()
    prompt = _prompts(tcfg, 1, 10)[0]
    kw = dict(n_slots=1, max_seq_len=MAX_SEQ, paged=paged, page_size=4)
    ref = _drain(JEngine(jcfg, params, **kw), JRequest, [prompt], 8)[0]
    alloc = _alloc()
    jexp = _partway(JEngine(jcfg, params, **kw), JRequest, prompt)
    dst = ShardedEngine(tcfg, model, alloc.alloc((1, 2)), allocator=alloc, **kw)
    assert dst.install_active(_convert(jexp, TRequest, TRequestState, TSlotExport, tcfg))
    assert _finish(dst) == ref and dst.release_all_pages() == 0
    dst.release_devices()
    for shape in ((1, 4), (2, 2)):
        src = ShardedEngine(tcfg, model, alloc.alloc(shape), allocator=alloc, **kw)
        exp = _partway(src, TRequest, prompt)
        assert src.release_all_pages() == 0
        src.release_devices()
        jdst = JEngine(jcfg, params, **kw)
        assert jdst.install_active(_convert(exp, JRequest, JRequestState, JSlotExport, jcfg))
        assert _finish(jdst) == ref
    src = ShardedEngine(tcfg, model, alloc.alloc((1, 2)), allocator=alloc, **kw)
    exp = _partway(src, TRequest, prompt)
    dst = ShardedEngine(tcfg, model, alloc.alloc((1, 4)), allocator=alloc, **kw)
    assert dst.install_active(exp) and _finish(dst) == ref
    bad = dict(exp.cache, k=exp.cache["k"][:, :, :1])
    assert not dst.install_active(dataclasses.replace(exp, cache=bad))


@pytest.mark.parametrize("survivor_tp", [1, 4])
def test_pool_failover_salvages_onto_another_tp_degree(survivor_tp):
    _, tcfg, _, model = _zoo()
    alloc = _alloc()
    pool = EnginePool(lambda g: engine_for_group(tcfg, model, g, alloc, n_slots=2,
                                                 max_seq_len=MAX_SEQ, device="cpu"),
                      max_replicas_per_group=1)
    g_tp2 = ReplicaGroup("m", "H100-80G", 2, 2, 1)
    g_other = ReplicaGroup("m", "H100-80G", survivor_tp, 2, 1)
    pool.reconfigure(Plan((g_tp2, g_other)))
    (victim,) = pool._replicas[g_tp2]
    (other,) = pool._replicas[g_other]
    assert isinstance(victim, ShardedEngine)
    assert isinstance(other, ShardedEngine) == (survivor_tp > 1)
    free = alloc.free_devices
    prompt = _prompts(tcfg, 1, 10)[0]
    ref = _drain(TEngine(tcfg, model, n_slots=1, max_seq_len=MAX_SEQ, device="cpu"),
                 TRequest, [prompt], 8)[0]
    victim.submit(TRequest(rid=0, prompt=list(prompt), max_new_tokens=8))
    for _ in range(3):
        victim.step()
    report = pool.fail(victim, reason="injected")
    assert report.salvaged == 1 and alloc.free_devices == free + 2
    assert list(pool.run_until_drained()[-1].generated) == ref


def test_torch_backend_with_and_without_an_allocator():
    _, tcfg, _, model = _zoo()
    tp2 = ReplicaGroup("m", "H100-80G", 2, 2, 1)
    pp2 = ReplicaGroup("m", "H100-80G", 1, 2, 1, pp=2)
    plain = TorchBackend(tcfg, model, device="cpu")
    assert plain.allocator is None
    plain.apply_plan(Plan((tp2, pp2)), None)
    assert type(plain.pool._replicas[tp2][0]) is TEngine
    assert isinstance(plain.pool._replicas[pp2][0], PipelinedEngine)
    assert plain.pool._replicas[pp2][0].stage_meshes is None

    be = TorchBackend(tcfg, model, device="cpu", devices=logical_devices(8, "cpu"))
    assert be.allocator.total_devices == 8
    rep = be.apply_plan(Plan((tp2, pp2)), None)
    assert set(rep.built) == {tp2, pp2}
    assert isinstance(be.pool._replicas[tp2][0], ShardedEngine)
    pipe = be.pool._replicas[pp2][0]
    assert isinstance(pipe, PipelinedEngine) and len(pipe.stage_meshes) == 2
    assert be.allocator.free_devices == 4
    met = be.serve_interval([Workload("m", 1, 256, 512)])
    assert met.measured and met.requests == be.requests_per_model
    wide = ReplicaGroup("m", "H100-80G", 2, 2, 1, dp=4)       # 8 devices: short
    be.apply_plan(Plan((tp2, pp2, wide)), None)
    assert type(be.pool._replicas[wide][0]) is TEngine and be.allocator.shortfalls == 1
    be.apply_plan(Plan((tp2,)), None)
    assert be.allocator.free_devices == 6
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        be.apply_plan(Plan((ReplicaGroup("m", "H100-80G", 8, 2, 1),)), None)
    assert be.allocator.free_devices == 8


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "minicpm3-4b", "gemma2-9b",
                                  "zamba2-7b", "whisper-tiny"])
def test_unsharded_families_raise(arch):
    cfg = tget_config(arch).reduced()
    assert sharded_unsupported_reason(cfg, 2) is not None
    model = tlm.init_params(cfg, device="cpu")
    alloc = _alloc(4)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        ShardedEngine(cfg, model, alloc.alloc((1, 2)), allocator=alloc, n_slots=1,
                      max_seq_len=32)
    alloc = _alloc(4)
    with pytest.raises(NotImplementedError, match="not sharded by the port"):
        engine_for_group(cfg, model, ReplicaGroup("m", "H100-80G", 2, 1, 1), alloc,
                         n_slots=1, max_seq_len=32, device="cpu")
    assert alloc.free_devices == 4
    if tlm.stage_sliceable(cfg):      # pp without tp serves every sliceable family
        eng = engine_for_group(cfg, model, ReplicaGroup("m", "H100-80G", 1, 1, 1, pp=2),
                               alloc, n_slots=1, max_seq_len=32, device="cpu")
        assert isinstance(eng, PipelinedEngine) and alloc.free_devices == 2
    for arch_ok in ("qwen2-1.5b", "qwen1.5-110b", "chameleon-34b", "mixtral-8x22b"):
        assert sharded_unsupported_reason(tget_config(arch_ok), 4) is None
    assert "n_heads=12" in sharded_unsupported_reason(tget_config("qwen2-1.5b"), 8)


def test_sharded_check_runs_every_check():
    assert sharded_check.main(["--device", "cpu"]) == 0

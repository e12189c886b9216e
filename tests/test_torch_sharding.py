"""The PyTorch port's sharding rules, logical meshes and submesh allocator,
held to the JAX reference: ``param_pspecs`` (over the port's parameters in
the JAX layout, shapes only), ``cache_pspecs``, ``paged_cache_pspecs``,
``_batch_entry``, ``make_policy`` and ``sharding_decision`` (fallback
records, ``tp_fallback_fraction``, ``effective_tp``) for all ten configs at
tp 1/2/4/8, with the reference on the stub mesh ``tests/test_sharding.py``
uses; ``SubmeshAllocator`` placements on the same alloc/release sequences
over fake devices, fragmentation included; ``carve_submeshes``.
"""
import random
import warnings
from dataclasses import dataclass

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.serving import sharded as jsharded
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.serving import sharded as tsharded

torch.set_num_threads(1)
TPS = (1, 2, 4, 8)


class StubMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@dataclass(frozen=True)
class FakeDevice:
    id: int


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {".".join(str(getattr(k, "key", k)) for k in kp): tuple(v) for kp, v in flat}


def _port_leaves(tree):
    return {k: tuple(v) for k, v in sh.spec_leaves(tree).items()}


def _records(decision):
    return [(f.path, f.axis_index, f.dim, f.axis, f.axis_size) for f in decision.fallbacks]


def _port_mesh(shape):
    n = int(np.prod(list(shape.values())))
    grid = np.empty(n, dtype=object)
    grid[:] = tmesh.logical_devices(n, "cpu")
    return tmesh.Mesh(grid.reshape(tuple(shape.values())), tuple(shape))


_SDS = {}


def _param_sds(arch):
    if arch not in _SDS:
        _SDS[arch] = jax.eval_shape(
            lambda: jlm.init_params(jget_config(arch), jax.random.PRNGKey(0)))
    return _SDS[arch]


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_and_decisions_equal_the_reference(arch):
    """Every parameter's spec and every fallback record, in the reference's
    order, at tp 1/2/4/8, for the policy ``make_policy`` picks and for the
    serving policy (``fsdp_axis=None``)."""
    import dataclasses
    jcfg, tcfg = jget_config(arch), get_config(arch)
    sds, meta = _param_sds(arch), lm.LM(tcfg, device="meta")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for tp in TPS:
            for data in (1, 2):
                shape = {"data": data, "model": tp}
                jp = jsh.make_policy(StubMesh(shape), jcfg)
                tp_ = sh.make_policy(_port_mesh(shape), tcfg)
                assert (tp_.mode, tp_.ep, tp_.batch_axes, tp_.tp_size) == \
                    (jp.mode, jp.ep, jp.batch_axes, jp.tp_size)
                assert sh._tp_compatible(tcfg, tp) == jsh._tp_compatible(jcfg, tp)
                for fs in ("data", None):
                    jd = jsh.sharding_decision(jcfg, dataclasses.replace(jp, fsdp_axis=fs), sds)
                    td = sh.sharding_decision(tcfg, dataclasses.replace(tp_, fsdp_axis=fs), meta)
                    assert _port_leaves(td.param_specs) == _jax_leaves(jd.param_specs)
                    assert _records(td) == _records(jd)
                    assert td.tp_fallback_fraction == jd.tp_fallback_fraction
                    assert td.effective_tp == jd.effective_tp
                    assert (td.mode, td.tp_requested, td.ep) == (jd.mode, jd.tp_requested, jd.ep)


def test_jax_layout_matches_the_reference_pytree():
    for arch in list_archs():
        flat = jax.tree_util.tree_flatten_with_path(_param_sds(arch))[0]
        want = {".".join(str(k.key) for k in kp): tuple(v.shape) for kp, v in flat}
        got = {}

        def walk(node, prefix):
            for k, v in node.items():
                key = f"{prefix}.{k}" if prefix else k
                walk(v, key) if isinstance(v, dict) else got.__setitem__(key, v)
        walk(sh.jax_layout(lm.LM(get_config(arch), device="meta")), "")
        assert got == want, arch


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_the_reference(arch):
    """Contiguous and paged cache specs of the port's own caches (full
    widths, 4 slots of 16 positions, 5 pages) against the reference's on
    its cache shapes."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, 4, 16))
    tc = lm.init_cache(tcfg, 4, 16, dtype=torch.float32, device="cpu")
    paged = lm.pageable(tcfg)
    if paged:
        jpc = jax.eval_shape(lambda: jlm.init_paged_cache(jcfg, 5, 16))
        tpc = lm.init_paged_cache(tcfg, 5, 16, dtype=torch.float32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for tp in TPS:
            for data in (1, 2, 4):
                shape = {"data": data, "model": tp}
                jp = jsh.make_policy(StubMesh(shape), jcfg)
                tp_ = sh.make_policy(_port_mesh(shape), tcfg)
                assert _port_leaves(sh.cache_pspecs(tcfg, tp_, tc)) == \
                    _jax_leaves(jsh.cache_pspecs(jcfg, jp, jc))
                if paged:
                    assert _port_leaves(sh.paged_cache_pspecs(tcfg, tp_, tpc)) == \
                        _jax_leaves(jsh.paged_cache_pspecs(jcfg, jp, jpc))


def test_batch_entry_activation_flags_and_batch_specs_equal_the_reference():
    shapes = [{"data": 1, "model": 2}, {"data": 2, "model": 4}, {"data": 4, "model": 1},
              {"pod": 2, "data": 2, "model": 2}]
    for shape in shapes:
        for mode in ("tp", "fsdp"):
            for rep in (False, True):
                batch = ("pod", "data") if "pod" in shape else ("data",)
                jp = jsh.ShardingPolicy(StubMesh(shape), mode=mode, batch_axes=batch,
                                        replicate_batch=rep)
                tp_ = sh.ShardingPolicy(StubMesh(shape), mode=mode, batch_axes=batch,
                                        replicate_batch=rep)
                for B in range(1, 17):
                    for ign in (False, True):
                        assert sh._batch_entry(tp_, B, ign) == jsh._batch_entry(jp, B, ign)
                    for S in (1, 8, 12):
                        assert sh.activation_shard_flags(tp_, B, S) == \
                            jsh.activation_shard_flags(jp, B, S)
                bt = {"tokens": (6, 3), "pos": (8,)}
                jb = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, np.int32), bt,
                                  is_leaf=lambda x: isinstance(x, tuple))
                assert _port_leaves(sh.batch_pspecs(None, tp_, bt)) == \
                    _jax_leaves(jsh.batch_pspecs(None, jp, jb))


@pytest.mark.filterwarnings("ignore")
def test_sanitize_pad_and_opt_specs_equal_the_reference():
    mesh = StubMesh({"data": 16, "model": 16})
    for shape, spec in [((50280, 2048), ("model", "data")), ((32768, 2048), ("model", "data")),
                        ((6, 8, 4), (None, ("data", "model"), "model"))]:
        assert tuple(sh._sanitize(mesh, shape, spec)) == tuple(jsh._sanitize(mesh, shape, spec))
    assert sh._pad((3, 4, 5), ("a",)) == jsh._pad((3, 4, 5), ("a",))
    cfg, jcfg = get_config("mixtral-8x7b"), jget_config("mixtral-8x7b")
    opt = {"m": {"layers": {"ffn": {"w_gate": (32, 8, 4096, 14336)}}},
           "v": {"embed": (32000, 4096)}, "step": ()}
    jopt = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, np.float32), opt,
                        is_leaf=lambda x: isinstance(x, tuple))
    pol, jpol = (m.make_policy(StubMesh({"data": 2, "model": 4}), c)
                 for m, c in ((sh, cfg), (jsh, jcfg)))
    assert _port_leaves(sh.opt_pspecs(cfg, pol, opt)) == _jax_leaves(jsh.opt_pspecs(jcfg, jpol, jopt))


def test_fused_paged_and_sharded_support_reasons():
    """``fused_paged_unsupported_reason`` gives the reference's outputs for
    every config and tp; the port shards exactly the GQA decoder families
    whose query heads tp divides."""
    for arch in list_archs():
        for tp in TPS:
            assert tsharded.fused_paged_unsupported_reason(get_config(arch), tp) == \
                jsharded.fused_paged_unsupported_reason(jget_config(arch), tp)
            cfg = get_config(arch)
            ok = (cfg.family in ("dense", "vlm", "moe") and cfg.mla is None
                  and not cfg.local_global_every and not cfg.is_encoder_decoder
                  and cfg.n_heads % tp == 0)
            assert (tsharded.sharded_unsupported_reason(cfg, tp) is None) == ok


def test_fallback_warns_once_and_partial_fallback_keeps_the_degree():
    cfg = get_config("qwen2-1.5b")
    pol = sh.ShardingPolicy(StubMesh({"data": 2, "model": 4}), mode="tp")
    params = {"unitA": {"attn": {"wq": (64, 6), "wo": (8, 64)}}}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        d = sh.sharding_decision(cfg, pol, params)
        d2 = sh.sharding_decision(cfg, pol, params)
    assert _records(d) == _records(d2) == [("unitA.attn.wq", 1, 6, "model", 4)]
    assert len([x for x in w if issubclass(x.category, sh.ShardingFallback)]) == 1
    assert 0.0 < d.tp_fallback_fraction < 1.0 and d.effective_tp == 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        full = sh.sharding_decision(cfg, pol, {"unitB": {"attn": {"wq": (6, 6)}}})
    assert full.tp_fallback_fraction == 1.0 and full.effective_tp == 1


# --------------------------------------------------------------------------- #
# meshes and the submesh allocator
# --------------------------------------------------------------------------- #
def _fake_factory(grid, axes):
    return {"ids": [d.id for d in np.asarray(grid).flatten()],
            "shape": tuple(np.asarray(grid).shape), "axes": tuple(axes)}


def _ops(seed, n_devices):
    rng = random.Random(seed)
    ops = []
    for _ in range(40):
        kind = rng.choice(["alloc", "alloc", "stages", "release", "release"])
        if kind == "alloc":
            ops.append(("alloc", rng.choice([(1, 1), (1, 2), (2, 1), (1, 4), (2, 2), (1, 3)])))
        elif kind == "stages":
            ops.append(("stages", rng.choice([2, 3, 4]), rng.choice([(1, 1), (1, 2)])))
        else:
            ops.append(("release", rng.randrange(8)))
    return ops


def _replay(mod, ops, n_devices):
    alloc = mod.SubmeshAllocator([FakeDevice(i) for i in range(n_devices)],
                                 mesh_factory=_fake_factory)
    held, trace = [], []
    for op in ops:
        if op[0] == "alloc":
            m = alloc.try_alloc(op[1])
            trace.append(None if m is None else (m["ids"], m["shape"], m["axes"]))
            if m is not None:
                held.append(m)
        elif op[0] == "stages":
            ms = alloc.try_alloc_stages(op[1], op[2])
            trace.append(None if ms is None else [m["ids"] for m in ms])
            held.extend(ms or [])
        elif held:
            alloc.release(held.pop(op[1] % len(held)))
        trace.append(([[d.id for d in f] for f in alloc.fragments()],
                      alloc.free_devices, alloc.total_devices,
                      alloc.can_alloc((1, 4)), alloc.can_alloc_stages(2, (1, 2))))
    with pytest.raises(mod.SubmeshOversubscribed):
        alloc.alloc((1, n_devices + 1))
    with pytest.raises(mod.SubmeshOversubscribed):
        alloc.alloc_stages(n_devices, (1, 2))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_submesh_allocator_placements_equal_the_reference(seed):
    """Same alloc / stage-alloc / release sequences over fake devices: the
    same device ids in the same grids, the same fragments and counts."""
    ops = _ops(seed, 8)
    assert _replay(tsharded, ops, 8) == _replay(jsharded, ops, 8)


def test_fragmented_free_set_gathers_instead_of_failing():
    for mod in (tsharded, jsharded):
        alloc = mod.SubmeshAllocator([FakeDevice(i) for i in range(8)],
                                     mesh_factory=_fake_factory)
        holds = [alloc.alloc((1, 2)) for _ in range(4)]
        alloc.release(holds[1])
        alloc.release(holds[3])
        assert [[d.id for d in f] for f in alloc.fragments()] == [[2, 3], [6, 7]]
        assert alloc.alloc((1, 4))["ids"] == [2, 3, 6, 7]
        alloc.release(holds[1])              # foreign / already released: no-op
        assert alloc.free_devices == 0


def test_port_allocator_over_logical_devices_carves_meshes():
    devs = tmesh.logical_devices(8, "cpu")
    alloc = tsharded.SubmeshAllocator(devs)
    m = alloc.alloc((2, 2))
    assert isinstance(m, tmesh.Mesh) and m.shape == {"data": 2, "model": 2}
    assert [d.id for d in m.devices.flatten()] == [0, 1, 2, 3]
    assert m.axis_devices("model") == [torch.device("cpu")] * 2
    stages = alloc.alloc_stages(2, (1, 2))
    assert [m_.shape for m_ in stages] == [{"data": 1, "model": 2}] * 2
    for x in [m, *stages]:
        alloc.release(x)
    assert alloc.free_devices == alloc.total_devices == 8


def test_carve_submeshes_and_mesh_constructors():
    devs = np.empty(8, dtype=object)
    devs[:] = [FakeDevice(i) for i in (3, 1, 0, 2, 7, 5, 4, 6)]

    class Src:
        devices = devs.reshape(2, 4)
    for shapes in ([(1, 2), (2, 2)], [(2, 1, 2), (1, 2)], [(8,)], [(1, 1)] * 8):
        ref = jmesh.carve_submeshes(Src, shapes)
        got = tmesh.carve_submeshes(Src, shapes)
        assert [dict(m.shape) for m in got] == [dict(m.shape) for m in ref]
        assert [m.axis_names for m in got] == [tuple(m.axis_names) for m in ref]
        assert [[d.id for d in m.devices.flatten()] for m in got] == \
            [[d.id for d in m.devices.flatten()] for m in ref]
    with pytest.raises(ValueError, match="need 9 devices"):
        tmesh.carve_submeshes(Src, [(3, 3)])
    for multi in (False, True):
        prod = tmesh.make_production_mesh(multi_pod=multi)
        want = ({"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16})
        assert prod.shape == want and prod.devices.flat[0].device is None
    host = tmesh.make_host_mesh(2, tmesh.logical_devices(8, "cpu"))
    assert host.shape == {"data": 4, "model": 2}
    assert [d.id for d in tmesh.logical_devices(3, "cpu")] == [0, 1, 2]

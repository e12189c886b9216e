"""The port's dry run against the JAX reference, on the CPU and on shapes
only: the input shapes, ``shape_applicable`` and ``all_cells``; every input
spec's name, shape and dtype for the ten full configs × four shapes; the
``step_shardings`` placement trees leaf by leaf on the stub meshes
``tests/test_sharding.py`` uses; the HLO text parser on HLO that JAX
compiles here (a scan and a nested scan) and on ``tests/test_hlo_analysis.py``'s
canned module; ``RooflineTerms`` under the reference's constants; the CLI
over every cell and in a process that blocks ``jax``/``repro`` imports; and
a train cell's argument bytes against what the trainer holds."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.distributed import hlo_analysis as jhlo
from repro.distributed import sharding as jsh
from repro.models import zoo as jzoo
from repro_torch import configs as tconfigs
from repro_torch.distributed import hlo_analysis as thlo
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import LogicalDevice, Mesh
from repro_torch.models import flags as tflags
from repro_torch.models import zoo as tzoo
from repro_torch.training import data as tdata
from repro_torch.training import optim as topt
from repro_torch.training import trainer as ttrainer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
STUB_SHAPES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 2, "model": 4})


class StubMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _port_mesh(shape):
    n = int(np.prod(list(shape.values())))
    grid = np.array([LogicalDevice(i, None) for i in range(n)], dtype=object)
    return Mesh(grid.reshape(tuple(shape.values())), tuple(shape))


def _jax_leaves(tree, leaf):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp), v)
            for kp, v in flat]


def _port_leaves(tree, path=()):
    if isinstance(tree, (torch.Tensor, sh.PartitionSpec)):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k], path + (k,))]
    return [x for i, t in enumerate(tree) for x in _port_leaves(t, path + (str(i),))]


# --------------------------------------------------------------------------- #
# shapes and cells
# --------------------------------------------------------------------------- #
def test_shapes_and_cells_equal_the_reference():
    assert tconfigs.ALL_SHAPES == tuple(
        tconfigs.ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)
        for s in jconfigs.ALL_SHAPES)
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for arch in tconfigs.list_archs():
        for s in jconfigs.ALL_SHAPES:
            assert tconfigs.shape_applicable(tconfigs.get_config(arch),
                                             tconfigs.SHAPES[s.name]) == \
                jconfigs.shape_applicable(jconfigs.get_config(arch), s)
    cells = tconfigs.all_cells()
    assert len(cells) == 40 and cells == jconfigs.all_cells()
    # the registry's own order stays the port's
    assert tconfigs.list_archs()[0] == "qwen2-1.5b"


# --------------------------------------------------------------------------- #
# input specs and placements
# --------------------------------------------------------------------------- #
def _spec_list(specs):
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _port_leaves(specs)]


def _jax_spec_list(specs):
    return [(p, tuple(s.shape), str(s.dtype))
            for p, s in _jax_leaves(specs, lambda x: isinstance(x, jax.ShapeDtypeStruct))]


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_input_specs_equal_the_reference(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for s in jconfigs.ALL_SHAPES:
        got = tzoo.input_specs(tcfg, tconfigs.SHAPES[s.name])
        assert all(t.device.type == "meta" for _, t in _port_leaves(got))
        assert _spec_list(got) == _jax_spec_list(jzoo.input_specs(jcfg, s)), s.name


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_step_shardings_equal_the_reference(arch, monkeypatch):
    """In and out placement trees of every shape on the three stub meshes,
    leaf by leaf (the reference's ``NamedSharding`` replaced by its spec:
    a stub mesh is no device mesh)."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    is_spec = lambda x: isinstance(x, JP)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for s in jconfigs.ALL_SHAPES:
            jspecs = jzoo.input_specs(jcfg, s)
            tspecs = tzoo.input_specs(tcfg, tconfigs.SHAPES[s.name])
            for shape in STUB_SHAPES:
                for rb in (False, True):
                    jp = dataclasses.replace(jsh.make_policy(StubMesh(shape), jcfg),
                                             replicate_batch=rb)
                    tp = dataclasses.replace(sh.make_policy(_port_mesh(shape), tcfg),
                                             replicate_batch=rb)
                    want = jsh.step_shardings(jcfg, s, jp, jspecs)
                    got = sh.step_shardings(tcfg, tconfigs.SHAPES[s.name], tp, tspecs)
                    assert [(p, tuple(v)) for p, v in _port_leaves(got)] == \
                        [(p, tuple(v)) for p, v in _jax_leaves(want, is_spec)], \
                        (s.name, shape, rb)
                    assert sh.activation_shard_flags(tp, s.global_batch, s.seq_len) == \
                        jsh.activation_shard_flags(jp, s.global_batch, s.seq_len)


def test_shard_shape_and_bytes():
    mesh = _port_mesh({"data": 2, "model": 4})
    P = sh.PartitionSpec
    assert sh.shard_shape(mesh, (8, 12, 5), P("data", "model")) == (4, 3, 5)
    assert sh.shard_shape(mesh, (8, 12), P(("data", "model"), None)) == (1, 12)
    tree = {"a": torch.empty((8, 12), dtype=torch.bfloat16, device="meta"),
            "b": (torch.empty((), dtype=torch.int32, device="meta"),)}
    specs = {"a": P(None, "model"), "b": (P(),)}
    assert sh.shard_bytes(mesh, tree, specs) == 8 * 3 * 2 + 4


# --------------------------------------------------------------------------- #
# the HLO parser and the roofline terms
# --------------------------------------------------------------------------- #
def _jax_hlo():
    def f(x, w):
        def inner(c, _):
            return jnp.tanh(c @ w), None

        def outer(c, _):
            c, _ = jax.lax.scan(inner, c, None, length=3)
            return c, None
        y, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=5)
        z, _ = jax.lax.scan(outer, y, None, length=4)
        return (z @ w.T).sum()
    x = jnp.ones((8, 16), jnp.float32)
    w = jnp.ones((16, 16), jnp.float32)
    return jax.jit(f).lower(x, w).compile().as_text()


def _canned():
    spec = importlib.util.spec_from_file_location("_hlo_canned",
                                                  ROOT / "tests" / "test_hlo_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CANNED


@pytest.mark.parametrize("source", ["jax", "canned"])
def test_hlo_parser_equals_the_reference(source):
    hlo = _jax_hlo() if source == "jax" else _canned()
    want, got = jhlo.analyze_hlo(hlo), thlo.analyze_hlo(hlo)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    if source == "jax":     # the scans multiply: 5 + 4·3 trips of a 16×16 product
        assert got.flops >= (5 + 12) * 2 * 8 * 16 * 16
    comps, jcomps = thlo.parse_computations(hlo), jhlo.parse_computations(hlo)
    assert list(comps) == list(jcomps)
    entry = thlo._entry_name(hlo)
    assert entry == jhlo._entry_name(hlo)
    assert thlo.execution_multipliers(comps, entry) == \
        jhlo.execution_multipliers(jcomps, entry)


def test_roofline_terms_equal_the_reference_under_its_constants():
    kw = dict(hlo_flops=3.1e15, hlo_bytes=2.2e11, collective_bytes=4.4e9, n_chips=256,
              model_flops=5.0e17)
    want = jhlo.RooflineTerms(**kw).as_dict()
    got = thlo.RooflineTerms(**kw, peak_flops=jhlo.PEAK_FLOPS_BF16, hbm_bw=jhlo.HBM_BW,
                             ici_bw=jhlo.ICI_BW).as_dict()
    assert got == want
    h100 = thlo.RooflineTerms(**kw)
    assert (thlo.PEAK_FLOPS_BF16, thlo.HBM_BW, thlo.ICI_BW) == (989e12, 3.35e12, 450e9)
    assert h100.compute_s == kw["hlo_flops"] / 989e12
    assert h100.dominant == "compute"


# --------------------------------------------------------------------------- #
# the CLI and the records
# --------------------------------------------------------------------------- #
def test_dryrun_writes_every_cell(tmp_path):
    assert dryrun.main(["--out", str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 80
    applies = {(a, s): (ok, why) for a, s, ok, why in tconfigs.all_cells()}
    for r in recs:
        ok, why = applies[(r["arch"], r["shape"])]
        assert r["status"] == ("ok" if ok else "skipped") and r["skip_reason"] == why
        assert r["remat"] == "full" and r["moe_impl"] == "dense"
        if ok:
            m, roof = r["memory"], r["roofline"]
            assert m["temp_bytes"] is None and m["temp_bytes_reason"]
            assert r["collectives"]["collective_bytes"] is None and r["collectives"]["reason"]
            assert roof["flops_source"] == "model" and roof["bytes_source"] == "arguments"
            assert roof["peak_flops"] == 989e12 and roof["hbm_bw"] == 3.35e12
            assert roof["flops_per_device"] == roof["model_flops"] / r["n_chips"]
            assert roof["bytes_per_device"] == m["argument_bytes"]
            assert roof["useful_flops_ratio"] is None and roof["roofline_fraction"] is None
            assert roof["ratio_reason"] and roof["collective_s"] is None
            assert ("working_copy_bytes" in m) == (r["shape"] == "train_4k")
            assert r["n_chips"] == (512 if r["mesh"] == "pod2x16x16" else 256)
    # a second run finds every record cached
    assert dryrun.main(["--out", str(tmp_path), "--arch", "qwen2-1.5b"]) == 0


def test_dryrun_labels_its_records_and_leaves_the_flags_as_they_were(tmp_path):
    """``--remat`` and ``--moe-impl`` hold for the run alone: the records
    carry them, and no flag of the process changes."""
    before = dict(tflags._FLAGS)
    assert dryrun.main(["--out", str(tmp_path), "--arch", "mixtral-8x7b", "--shape",
                        "train_4k", "--mesh", "single", "--remat", "none",
                        "--moe-impl", "dispatch"]) == 0
    rec = json.loads((tmp_path / "mixtral-8x7b__train_4k__pod16x16.json").read_text())
    assert rec["status"] == "ok" and rec["act_shard"] is not None
    assert (rec["remat"], rec["moe_impl"]) == ("none", "dispatch")
    assert tflags._FLAGS == before


def test_dryrun_cli_runs_without_the_reference(tmp_path):
    guard = ("import sys, runpy\n"
             "class Block:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('repro', 'jax'):\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, Block())\n"
             "sys.argv = ['dryrun'] + sys.argv[1:]\n"
             "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", guard, "--arch", "qwen2-1.5b,mamba2-1.3b",
                          "--mesh", "single", "--out", str(tmp_path)],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert len(recs) == 8
    assert recs["qwen2-1.5b__long_500k__pod16x16.json"]["status"] == "skipped"
    assert recs["mamba2-1.3b__long_500k__pod16x16.json"]["status"] == "ok"
    assert "all requested cells done" in out.stdout


def test_error_shows_as_status_and_exit_code(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "step_shardings", boom)
    assert dryrun.main(["--out", str(tmp_path), "--arch", "whisper-tiny",
                        "--shape", "train_4k", "--mesh", "single"]) == 1
    rec = json.loads((tmp_path / "whisper-tiny__train_4k__pod16x16.json").read_text())
    assert rec["status"] == "error" and "planted" in rec["error"]


def test_train_cell_bytes_equal_what_the_trainer_holds():
    """A train cell on one device at the trainer's shape: argument bytes
    (f32 params, m, v, step, int32 batch) plus the working copy equal the
    bytes of the masters, model weights, moments, step and batch the
    trainer held (the card's smoke test gates the same at full width)."""
    cfg = tconfigs.get_config("qwen2-1.5b").reduced()
    dcfg = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    report = ttrainer.train(cfg, ttrainer.TrainConfig(
        steps=1, microbatches=2, opt=topt.AdamWConfig(lr=1e-3)), dcfg, device="cpu")
    shape = tconfigs.ShapeSpec("train_small", dcfg.seq_len, dcfg.global_batch, "train")
    rec = dryrun.cell_record(cfg, shape, dryrun.one_device_mesh(), "one")
    m = rec["memory"]
    assert m["argument_bytes"] + m["working_copy_bytes"] == sum(report.held_bytes.values())
    assert m["working_copy_bytes"] == report.held_bytes["working_copy"]

"""Guards of the PyTorch port: it never imports JAX or the JAX package,
its entry points never fall back to the CPU when no card is present, and
its kernel modules import on a host without ``triton`` or ``nvcc``."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.plan import Plan, ReplicaGroup
from repro_torch.kernels import build, split_plan
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.moe_gmm import kernel as moe_kernel
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch.mesh import logical_devices
from repro_torch.models import lm
from repro_torch.serving.backend import TorchBackend, make_torch_backend
from repro_torch.serving.engine import Engine
from repro_torch.serving.sharded import PipelinedEngine

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden_imports(path: Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_never_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    port = ROOT / "src" / "repro_torch"
    assert {port / "core" / "schedulers.py", port / "core" / "policy.py",
            port / "core" / "plan.py", port / "configs" / "whisper_tiny.py",
            port / "distributed" / "sharding.py", port / "distributed" / "expert_parallel.py",
            port / "serving" / "sharded.py", port / "launch" / "mesh.py",
            port / "launch" / "sharded_check.py", port / "launch" / "train.py",
            port / "models" / "zoo.py", port / "distributed" / "compression.py",
            port / "distributed" / "hlo_analysis.py", port / "launch" / "dryrun.py",
            port / "models" / "flags.py",
            *(port / "training" / f"{m}.py"
              for m in ("optim", "data", "checkpoint", "trainer", "prng"))} <= set(files)
    offenders = {str(p.relative_to(ROOT)): b for p in files
                 if (b := _forbidden_imports(p))}
    assert offenders == {}
    # the logical device set needs no environment flag (the reference's
    # sharded check forces XLA host devices through one)
    assert "XLA_FLAGS" not in (port / "launch" / "sharded_check.py").read_text()


def test_scan_catches_forbidden_imports_but_not_repro_torch(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.models\nfrom repro_torch import device\n")
    assert _forbidden_imports(probe) == []
    probe.write_text("import jax.numpy as jnp\nfrom repro.models import lm\n"
                     "from jax import lax\nimport repro\n")
    assert _forbidden_imports(probe) == ["jax.numpy", "repro.models", "jax", "repro"]


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.serving.backend, "
            "repro_torch.launch.serve, repro_torch.launch.sharded_check, "
            "repro_torch.launch.train, repro_torch.distributed.compression, "
            "repro_torch.launch.dryrun, repro_torch.training.prng\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'triton'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; these check the no-card path")


def test_entry_points_raise_without_a_card():
    _no_card()
    cfg = get_config("qwen2-1.5b").reduced()
    model = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_torch_backend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_paged_cache(cfg, 4, 16)


def test_kernel_launchers_refuse_cpu_tensors():
    """The CUDA launchers never compute on the host: given tensors
    that are not on the card they raise before building anything."""
    q = torch.zeros(2, 4, 16)
    kp = torch.zeros(5, 4, 2, 16)
    pt = torch.ones(2, 2, dtype=torch.int32)
    kl = torch.ones(2, dtype=torch.int32)
    w = torch.zeros(2, 64, 64)
    before = (rms_kernel.launches, fd_kernel.launches, fa_kernel.launches,
              moe_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        rms_kernel.rmsnorm(q, torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA"):
        fd_kernel.paged_flash_decode(q, kp, kp, pt, kl)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q[:, None], kp[:2], kp[:2])
    with pytest.raises(ValueError, match="CUDA"):
        moe_kernel.moe_gmm(torch.zeros(1, 3, 64).expand(2, 3, 64), w, w, w)
    assert (rms_kernel.launches, fd_kernel.launches, fa_kernel.launches,
            moe_kernel.launches) == before
    assert rms_kernel._fn is None and fd_kernel._fn is None and fa_kernel._fn is None
    assert moe_kernel._fn is None


def test_ops_route_only_cpu_and_cuda():
    """Ops send CUDA tensors to the kernel and CPU tensors to the plain
    version; any other device raises instead of computing somewhere."""
    meta = torch.device("meta")
    q = torch.zeros(2, 4, 16, device=meta)
    kp = torch.zeros(5, 4, 2, 16, device=meta)
    pt = torch.ones(2, 2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        rms_ops.rmsnorm(q, torch.zeros(16, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        fd_ops.paged_flash_decode(q, kp, kp, pt, pt[:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        fa_ops.flash_attention(q[:, None], kp[:2], kp[:2])
    w = torch.zeros(2, 64, 64, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        moe_ops.moe_gmm(torch.zeros(2, 3, 64, device=meta), w, w, w)


def test_unported_paths_raise_not_implemented():
    """A pp-2 group builds a ``PipelinedEngine`` (its stages share the one
    device); a tp-2 group of a family the port does not shard (mamba2, with
    an allocator over logical devices) raises and returns its submesh;
    ``fail`` refuses an engine the pool does not hold, as the reference's
    does; every config of the registry, whisper's encoder-decoder included,
    builds its model and its contiguous cache."""
    cfg = get_config("qwen2-1.5b").reduced()
    model = lm.init_params(cfg, device="cpu")
    for arch in ("gemma2-9b", "zamba2-7b", "whisper-tiny"):
        served = get_config(arch).reduced()
        lm.init_cache(served, 1, 32, device="cpu")
        lm.init_params(served, device="cpu")
    eng = Engine(cfg, model, n_slots=1, max_seq_len=32, device="cpu")
    backend = TorchBackend(cfg, model, device="cpu")
    with pytest.raises(ValueError, match="not in this pool"):
        backend.pool.fail(eng)
    pp2 = ReplicaGroup("m", "H100-80G", 1, 2, 1, pp=2)
    backend.apply_plan(Plan((pp2,)), None)
    assert [type(e) for e in backend.pool._replicas[pp2]] == [PipelinedEngine]
    ssm = get_config("mamba2-1.3b").reduced()
    ssm_backend = TorchBackend(ssm, lm.init_params(ssm, device="cpu"), device="cpu",
                               devices=logical_devices(4, "cpu"))
    with pytest.raises(NotImplementedError, match="not sharded by the port"):
        ssm_backend.apply_plan(Plan((ReplicaGroup("m", "H100-80G", 2, 2, 1),)), None)
    assert ssm_backend.allocator.free_devices == 4
    assert backend.failure_count == 0


def test_cuda_build_is_keyed_by_source_and_headers(tmp_path, monkeypatch):
    """Libraries are named by a hash of the .cu and the shared headers, under
    the checkout's build directory, so an edited kernel is rebuilt."""
    assert build.BUILD_DIR == ROOT / "build" / "repro_torch_kernels"
    for name in ("paged_flash_decode", "flash_attention", "ssd_scan", "moe_gmm",
                 "rmsnorm"):
        assert (build.CSRC / f"{name}.cu").exists()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel")
    (csrc / "common.cuh").write_text("// v1")
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path("k")
    assert first == build.library_path("k") and first.parent == build.BUILD_DIR
    (csrc / "common.cuh").write_text("// v2")
    assert build.library_path("k") != first
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["k"])


# (kv_len per lane, KV heads, window, tiles per split on 132 SMs)
DECODE_PLANS = {
    "timed": ([0, 1, 17, 300, 777, 1024, 1500, 2048], 2, None, 2),
    "qwen2_decode": ([257, 262, 266, 270, 275, 279, 284, 288], 2, None, 1),
    "mixtral_decode": ([129, 190, 250, 310, 370, 430, 490, 544], 8, None, 2),
    "all_idle": ([0] * 8, 2, None, 1),
    "window": ([0, 1, 17, 300, 777, 1024, 1500, 2048], 8, 512, 2),
}


# dynamic shared memory per block of the bf16 bodies at D 128
# (csrc TcLayout<128>::kBytes, as the card's build reports them)
FA_D128_SMEM, DECODE_D128_SMEM = 87_040, 73_984


@pytest.mark.parametrize("case", sorted(DECODE_PLANS))
def test_decode_split_plan_fills_the_card(case):
    """The decode kernels' split plan (the card computes it from kv_len;
    ``split_plan`` mirrors it): at most ``per`` live tiles per split and
    MAX_SPLITS splits per lane, every live tile of a lane in exactly one
    split, no split for an idle lane, and every item inside the host's
    grid."""
    kv_len, hkv, window, want_per = DECODE_PLANS[case]
    Sk, T = 2048, split_plan.TILE
    target = split_plan.target(132, DECODE_D128_SMEM)
    tiles = [split_plan.lane_tiles(n, 1, Sk, window) for n in kv_len]
    n_cap = fd_kernel.max_splits(hkv, Sk, target)
    per, splits = split_plan.split_plan(hkv, tiles, target, n_cap)
    assert per == want_per and max(splits) <= n_cap == fd_kernel.MAX_SPLITS
    for n, t, kvl in zip(splits, tiles, kv_len):
        lo, hi = split_plan.lane_keys(kvl, 1, Sk, window)
        live = [i for i in range(Sk // T) if i * T < hi and i * T + T > lo]
        assert len(live) == t
        if t == 0:
            assert n == 0
            continue
        ranges = split_plan.split_tiles(t, n)
        assert len(ranges) == n and all(0 < e - b <= per for b, e in ranges)
        covered = [lo // T + i for b, e in ranges for i in range(b, e)]
        assert covered == live
    items = split_plan.work_items(hkv, splits)
    assert hkv * sum(splits) <= items <= split_plan.grid_bound(hkv, len(kv_len), target)


@pytest.mark.parametrize("smem,blocks", [
    (46_080, 2),            # flash attention D 64: four fit, registers allow two
    (76_800, 2),            # flash attention D 112
    (FA_D128_SMEM, 2),
    (168_960, 1),           # flash attention D 256
    (65_280, 2),            # decode D 112
    (DECODE_D128_SMEM, 2),
    (143_616, 1),           # decode D 256
    (232_448, 1),           # the most one block may take
])
def test_split_plan_target_follows_shared_memory(smem, blocks):
    """The plan aims at one wave: as many blocks as fit an SM by shared
    memory (two up to D 128, one at D 256), at most two (registers).  A
    prefill chunk of one lane (16 live tiles, 16 pairs) splits into 16
    single-tile splits at 264 blocks and 8 two-tile splits at 132, and a
    decode of spread lengths keeps within the host's grid."""
    want = 132 * blocks
    assert split_plan.target(132, smem) == want
    tiles = [fa_kernel.lane_tiles(n, 64, 2048, None) for n in [1024] + [0] * 7]
    per, splits = split_plan.split_plan(16, tiles, want)
    assert split_plan.max_splits(16, 2048, want) == min(32, -(-want // 16))
    assert per == -(-16 * 16 // want) and splits == [16 // per] + [0] * 7
    kv = [0, 1, 17, 300, 777, 1024, 1500, 2048]
    tiles = [split_plan.lane_tiles(n, 1, 2048, None) for n in kv]
    n_cap = fd_kernel.max_splits(8, 2048, want)
    per, splits = split_plan.split_plan(8, tiles, want, n_cap)
    assert per == -(-8 * sum(tiles) // want) and max(splits) <= n_cap
    assert all(s_ == -(-t // per) for s_, t in zip(splits, tiles))
    assert split_plan.work_items(8, splits) <= split_plan.grid_bound(8, len(kv), want)


def test_attention_launchers_take_the_sources_head_dims():
    """The wrappers' head dims are exactly the instantiations that the
    sources dispatch to and size: 64, 112 (zamba2), 128 and 256 (gemma2);
    the decode launchers refuse any other D and a group of more than 16
    query heads before anything is built."""
    assert fa_kernel.HEAD_DIMS == fd_kernel.HEAD_DIMS == (64, 112, 128, 256)
    for name in ("flash_attention", "paged_flash_decode"):
        src = (build.CSRC / f"{name}.cu").read_text()
        for fn in ("dispatch_d", "smem_of"):
            body = src[src.index(f" {fn}("):]
            body = body[:body.index("\n}\n")]
            dims = tuple(int(d) for d in re.findall(r"D == (\d+)", body))
            assert dims == fa_kernel.HEAD_DIMS, (name, fn, dims)
    for D in fd_kernel.HEAD_DIMS:
        fd_kernel.check_dims("decode", D, 16)
    for D in (16, 96, 100, 120, 192, 512):
        with pytest.raises(ValueError, match="head dim"):
            fd_kernel.check_dims("decode", D, 2)
    with pytest.raises(ValueError, match="m16 fragment"):
        fd_kernel.check_dims("decode", 256, 17)
    assert fd_kernel._fn is None and fd_kernel._contig_fn is None


def test_flash_attention_split_plan_fills_the_card():
    # a serving prefill chunk: one lane of 16 live tiles (kv_len 1024, Sq 64),
    # 12 (row block, KV head) pairs with work, spread over 132 SMs
    target = split_plan.target(132, FA_D128_SMEM)
    tiles = [fa_kernel.lane_tiles(n, 64, 2048, None) for n in [1024] + [0] * 7]
    assert tiles == [16] + [0] * 7
    per, splits = split_plan.split_plan(12, tiles, target)
    assert per == 1 and splits == [16] + [0] * 7
    assert 12 * sum(splits) >= 132
    assert split_plan.max_splits(12, 2048, target) == 22 >= max(splits)
    # a grid that already fills the card gets one split and no combine
    assert split_plan.max_splits(600, 2048, target) == 1
    assert split_plan.split_plan(600, [32] * 8, target)[1] == [1] * 8
    assert split_plan.split_plan(96, [8] * 8, target, n_cap=1)[1] == [1] * 8
    # never more splits than live key tiles, and none for an idle lane
    assert split_plan.split_plan(12, [3, 0], target) == (1, [3, 0])
    for pairs in (1, 12, 32, 96):
        lanes = [0, 1, 5, 16, 32]
        per, splits = split_plan.split_plan(pairs, lanes, target)
        assert all(n <= t for n, t in zip(splits, lanes))
        assert all(n <= split_plan.max_splits(pairs, 2048, target) for n in splits)
    # the live range: a window drops the tiles below the first query's reach
    assert fa_kernel.lane_tiles(1024, 64, 2048, 256) == 16 - 705 // 64
    assert fa_kernel.lane_tiles(3000, 64, 2048, None) == 32


def test_flash_attention_paged_launcher_refuses_bad_inputs():
    """Paged mode refuses a bad page table or page size, and tensors that
    are not on the card, before anything is built or counted."""
    q = torch.zeros(2, 8, 4, 16)
    kp = torch.zeros(9, 4, 2, 16)
    pt = torch.ones(2, 3, dtype=torch.int32)
    kl = torch.ones(2, dtype=torch.int32)
    before = fa_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, kp, kp, kv_len=kl, ptab=pt)
    with pytest.raises(ValueError, match="ptab must be int32"):
        fa_kernel.flash_attention(q, kp, kp, kv_len=kl, ptab=pt.long())
    with pytest.raises(ValueError, match="ptab must be int32"):
        fa_kernel.flash_attention(q, kp, kp, kv_len=kl, ptab=pt[:1])
    with pytest.raises(ValueError, match="ptab must be int32"):
        fa_kernel.flash_attention(q, kp, kp, kv_len=kl, ptab=pt[0])
    odd = torch.zeros(9, 6, 2, 16)
    with pytest.raises(ValueError, match="power of two"):
        fa_kernel.flash_attention(q, odd, odd, kv_len=kl, ptab=pt)
    assert fa_kernel.launches == before and fa_kernel._fn is None


def test_moe_gmm_launcher_refuses_bad_inputs():
    """The grouped SwiGLU's launcher refuses a dtype, shape, stride or
    alignment the kernel does not take, and tensors that are not on the
    card, before anything is built or counted."""
    w = torch.zeros(2, 64, 128)
    wd = torch.zeros(2, 128, 64)
    x = torch.zeros(2, 3, 64)
    before = moe_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        moe_kernel.moe_gmm(x, w, w, wd)
    with pytest.raises(ValueError, match="CUDA"):
        moe_kernel.moe_gmm(x[:1].expand(2, 3, 64), w, w, wd)
    with pytest.raises(ValueError, match="f32 or bf16"):
        moe_kernel.moe_gmm(x.half(), w.half(), w.half(), wd.half())
    with pytest.raises(ValueError, match="f32 or bf16"):
        moe_kernel.moe_gmm(x, w.bfloat16(), w, wd)
    with pytest.raises(ValueError, match="bad shapes"):
        moe_kernel.moe_gmm(x[0], w, w, wd)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        moe_kernel.moe_gmm(x, w, w, w)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        moe_kernel.moe_gmm(torch.zeros(3, 3, 64), w, w, wd)
    odd = torch.zeros(2, 3, 96)
    with pytest.raises(ValueError, match="multiples of 64"):
        moe_kernel.moe_gmm(odd, torch.zeros(2, 96, 128), torch.zeros(2, 96, 128),
                           torch.zeros(2, 128, 96))
    with pytest.raises(ValueError, match="weights must be contiguous"):
        moe_kernel.moe_gmm(x, w, w, torch.zeros(2, 64, 128).transpose(1, 2))
    with pytest.raises(ValueError, match="strides"):        # rows not contiguous
        moe_kernel.moe_gmm(torch.zeros(2, 64, 3).transpose(1, 2), w, w, wd)
    with pytest.raises(ValueError, match="strides"):        # expert stride 5·64
        moe_kernel.moe_gmm(torch.zeros(2, 5, 64)[:, :3], w, w, wd)
    with pytest.raises(ValueError, match="16-byte aligned"):
        moe_kernel.moe_gmm(torch.zeros(2 * 3 * 64 + 1)[1:].view(2, 3, 64), w, w, wd)
    assert moe_kernel.launches == before and moe_kernel._fn is None


def test_kernel_modules_import_without_triton_or_nvcc(tmp_path):
    """``triton`` is blocked and no ``nvcc`` is reachable in the child."""
    code = ("import sys\n"
            "sys.modules['triton'] = None\n"
            "from repro_torch.kernels.rmsnorm import ops, kernel\n"
            "from repro_torch.kernels.flash_decode import ops, kernel\n"
            "from repro_torch.kernels.flash_attention import ops, kernel\n"
            "from repro_torch.kernels.ssd_scan import ops, kernel\n"
            "from repro_torch.kernels.moe_gmm import ops, kernel\n"
            "import repro_torch.models.lm, repro_torch.models.ssd\n"
            "import repro_torch.models.flags\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": str(tmp_path),
                              "CUDA_HOME": str(tmp_path / "no-cuda")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

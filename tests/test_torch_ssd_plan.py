"""The launch plan of the SSD scan kernel, as ``kernels/ssd_scan/kernel.py``
mirrors it from ``csrc/ssd_scan.cu``: the mirror's constants, shapes and
grids are the source's; every (lane, head, state row) belongs to one block;
every block's shared memory fits the card; (p, n) = (64, 64) and (64, 128)
are taken and other shapes refused."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "ssd_scan.cu").read_text()
F32_SRC, TC_SRC = SOURCE.split("namespace tc {", 1)
SMEM_MAX = 232448              # dynamic shared memory a block may use (H100)


def _consts(src):
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_plan_mirrors_the_cuda_source():
    tc, f32 = _consts(TC_SRC), _consts(F32_SRC)
    assert tc["kChunk"] == ssd_kernel.CHUNK == 64
    assert tc["kPb"] == ssd_kernel.PB
    assert tc["kThreads"] == ssd_kernel.THREADS
    assert tc["kPad"] == ssd_kernel._PAD
    assert f32["kL"] == ssd_kernel._F32_CHUNK
    entry = SOURCE[SOURCE.index('extern "C" int ssd_scan('):]
    shapes = {tuple(map(int, m)) for m in re.findall(r"if \(P == (\d+) && N == (\d+)\)", entry)}
    assert shapes == set(ssd_kernel.SHAPES)
    assert "grid = dim3(H, P / tc::kPb, batch);" in SOURCE
    assert "grid = dim3(H, batch);" in SOURCE


@pytest.mark.parametrize("b,h", [(1, 64), (3, 64), (8, 64), (2, 5)])
def test_every_lane_head_and_state_row_belongs_to_one_block(b, h):
    p = 64
    gx, gy, gz = ssd_kernel.grid(b, h, p)
    owners = {}
    for x in range(gx):
        for y in range(gy):
            for z in range(gz):                  # head x, rows [y PB, (y+1) PB), lane z
                for r in range(y * ssd_kernel.PB, (y + 1) * ssd_kernel.PB):
                    owners.setdefault((z, x, r), []).append((x, y, z))
    assert set(owners) == {(ln, hd, r) for ln in range(b) for hd in range(h) for r in range(p)}
    assert all(len(v) == 1 for v in owners.values())


def test_one_lane_of_mamba2_fills_the_card():
    gx, gy, gz = ssd_kernel.grid(1, 64, 64)
    assert gx * gy * gz >= 128            # 132 SMs; the f32 body's grid is 64


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p,n", [(64, 128), (64, 64)])
def test_shared_memory_of_every_block_fits(dtype, p, n):
    smem = ssd_kernel.smem_bytes(dtype, p, n)
    assert 0 < smem <= SMEM_MAX and smem % 16 == 0
    if dtype == torch.bfloat16:           # a whole chunk's B and C, twice
        assert smem > 2 * 2 * 2 * ssd_kernel.CHUNK * n


def test_shapes_outside_the_instantiations_are_refused():
    for p, n in ssd_kernel.SHAPES:
        ssd_kernel.smem_bytes(torch.bfloat16, p, n)
    for p, n in ((64, 32), (128, 128), (32, 64)):
        with pytest.raises(ValueError, match="not in"):
            ssd_kernel.smem_bytes(torch.bfloat16, p, n)
    with pytest.raises(ValueError, match="multiple"):
        ssd_kernel.grid(1, 64, 48)
    # the kernel's wrapper refuses CPU tensors before it looks at the shape
    x = torch.zeros(1, 8, 2, 64)
    B = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(x, torch.zeros(1, 8, 2), torch.zeros(2), B, B)

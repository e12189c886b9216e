"""Plain versions of the port's kernels vs the JAX Pallas kernels run in
interpret mode, on the shapes of the JAX kernel tests.  These are the
specifications the Hopper kernels are held to on the card (``chip_smoke.py``).
Inputs come from seeded numpy; tolerances are those of ``test_kernels.py``:
2e-5 in f32, 2e-2 in bf16.  Lanes with ``kv_len = 0`` are left out of the
cross-framework comparisons: the port writes zeros there, like the TPU
kernel, while the JAX gather path gives the mean of fully masked rows."""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_decode.kernel import paged_flash_decode_kernel
from repro.kernels.rmsnorm.kernel import rmsnorm_kernel
from repro.models import layers as jlayers
from repro_torch.kernels import split_plan
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode import ops as tfd
from repro_torch.kernels.rmsnorm import ops as trms

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(b), torch.from_numpy(b.view(np.uint16).copy()).view(torch.bfloat16)
    a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("shape", [(4, 100, 256), (7, 384), (2, 3, 130),
                                   (1, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal(shape), dtype)
    s = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    want = rmsnorm_kernel(jx, jnp.asarray(s), interpret=True)
    got = trms.rmsnorm(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("h,hkv,window,D,page", [(4, 4, None, 16, 8),
                                                 (4, 2, None, 16, 8),
                                                 (4, 2, 16, 16, 8),
                                                 (12, 2, 20, 128, 16)])
def test_paged_decode_plain_matches_pallas(h, hkv, window, D, page):
    rng = np.random.default_rng(3)
    B, n_pages, pps = 3, 17, 6
    q = rng.standard_normal((B, h, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, D)).astype(np.float32)
    ptab = rng.integers(1, n_pages, size=(B, pps)).astype(np.int32)
    kv_len = np.array([5, 23, 48], np.int32)
    want = paged_flash_decode_kernel(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(ptab),
                                     jnp.asarray(kv_len), window=window,
                                     interpret=True)
    got = tfd.paged_flash_decode(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp), torch.from_numpy(ptab),
                                 torch.from_numpy(kv_len), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_paged_decode_empty_lane_writes_zero_like_the_tpu_kernel():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kp = rng.standard_normal((9, 8, 2, 16)).astype(np.float32)
    vp = rng.standard_normal((9, 8, 2, 16)).astype(np.float32)
    ptab = rng.integers(1, 9, size=(2, 3)).astype(np.int32)
    kv_len = np.array([0, 9], np.int32)
    want = np.asarray(paged_flash_decode_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ptab),
        jnp.asarray(kv_len), interpret=True))
    got = tfd.paged_flash_decode(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp), torch.from_numpy(ptab),
                                 torch.from_numpy(kv_len)).numpy()
    assert not got[0].any() and not want[0].any()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_head_slice_tiles_the_full_decode_and_checks_gqa():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((9, 4, 4, 16)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((9, 4, 4, 16)).astype(np.float32))
    ptab = torch.from_numpy(rng.integers(1, 9, size=(2, 5)).astype(np.int32))
    kl = torch.tensor([7, 20], dtype=torch.int32)
    full = tfd.paged_flash_decode(q, kp, vp, ptab, kl)
    part = tfd.paged_flash_decode_head_slice(q, kp[:, :, 2:].contiguous(),
                                             vp[:, :, 2:].contiguous(), ptab,
                                             kl, 2, 4)
    torch.testing.assert_close(part, full[:, 4:], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        tfd.paged_flash_decode_head_slice(q, kp, vp, ptab, kl, 0, 3)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,cap", [
    (2, 256, 256, 4, 2, 64, True, None, None),
    (1, 128, 384, 4, 4, 64, True, 128, None),
    (2, 128, 128, 2, 2, 128, True, None, 50.0),
    (1, 256, 256, 4, 1, 64, False, None, None),
    (1, 256, 256, 2, 2, 64, True, 64, 30.0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(B, Sq, Sk, H, Hkv, D, causal,
                                              window, cap, dtype):
    rng = np.random.default_rng(7)
    jq, tq = _pair(rng.standard_normal((B, Sq, H, D)), dtype)
    jk, tk = _pair(rng.standard_normal((B, Sk, Hkv, D)), dtype)
    jv, tv = _pair(rng.standard_normal((B, Sk, Hkv, D)), dtype)
    want = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                               softcap=cap, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=cap)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("window", [None, 6])
def test_flash_attention_kv_len_matches_paged_prefill_mask(window):
    """Per-row kv_len is exactly the paged prefill mask of
    ``layers.paged_attention_fwd`` (gather + sdpa with ``kpos < lens``)."""
    rng = np.random.default_rng(11)
    B, C, S, H, Hkv, D = 3, 8, 32, 4, 2, 16
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lens = np.array([8, 19, 32], np.int32)
    pos2 = lens[:, None] - C + np.arange(C, dtype=np.int32)[None]
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    mask = (jlayers._attn_mask(jnp.asarray(pos2), jnp.asarray(kpos), window)
            & (jnp.asarray(kpos) < jnp.asarray(lens)[:, None])[:, None, None, :])
    want = jlayers.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window,
                              kv_len=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("window", [None, 6])
def test_flash_attention_ptab_matches_gather_and_paged_prefill(window, page):
    """With ``ptab`` the plain flash attention reads the page pools through
    the page table: it equals the call on the gathered K/V, and on its
    active lanes the JAX paged prefill (``_attn_mask`` + ``sdpa`` on the
    gathered pages, as in ``layers.paged_attention_fwd``).  The page table
    is scattered and not monotone; lane 1 has ``kv_len = 0`` and gets
    zeros (the JAX gather path gives the mean of fully masked rows there)."""
    rng = np.random.default_rng(13 + page)
    B, C, H, Hkv, D, n_ptab = 3, 8, 4, 2, 16, 5
    P, S = B * n_ptab + 1, n_ptab * page
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    ptab = rng.permutation(np.arange(1, P)).reshape(B, n_ptab).astype(np.int32)
    assert (np.diff(ptab, axis=1) < 0).any()
    lens = np.array([19, 0, S - 3], np.int32)
    tq, tkp, tvp = (torch.from_numpy(a) for a in (q, kp, vp))
    tpt, tl = torch.from_numpy(ptab), torch.from_numpy(lens)
    got = tfa.flash_attention(tq, tkp, tvp, causal=True, window=window,
                              kv_len=tl, ptab=tpt)
    K = kp[ptab].reshape(B, S, Hkv, D)
    V = vp[ptab].reshape(B, S, Hkv, D)
    gathered = tfa.flash_attention(tq, torch.from_numpy(K), torch.from_numpy(V),
                                   causal=True, window=window, kv_len=tl)
    torch.testing.assert_close(got, gathered, atol=0, rtol=0)
    assert not got[1].any()
    pos2 = lens[:, None] - C + np.arange(C, dtype=np.int32)[None]
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    mask = (jlayers._attn_mask(jnp.asarray(pos2), jnp.asarray(kpos), window)
            & (jnp.asarray(kpos) < jnp.asarray(lens)[:, None])[:, None, None, :])
    want = np.asarray(jlayers.sdpa(jnp.asarray(q), jnp.asarray(K), jnp.asarray(V), mask))
    act = lens > 0
    np.testing.assert_allclose(got.numpy()[act], want[act], atol=2e-5, rtol=2e-5)


def _decode_by_plan(q, kp, vp, ptab, kv_len, window, n_sm):
    """What the decode split and combine kernels compute, in f32: the
    plan mirror cuts each (lane, KV head)'s live keys into splits, each
    split runs the plain version's arithmetic to a partial (m, l, acc), and
    the combine's formula merges them; a lane with no live key stays 0."""
    P, page, Hkv, D = kp.shape
    B, H, _ = q.shape
    G, Sk, T = H // Hkv, ptab.shape[1] * page, split_plan.TILE
    target = split_plan.target(n_sm, 73_984)     # the bf16 body's at D 128: two an SM
    tiles = [split_plan.lane_tiles(int(n), 1, Sk, window) for n in kv_len]
    per, splits = split_plan.split_plan(Hkv, tiles, target,
                                        fd_kernel.max_splits(Hkv, Sk, target))
    k = kp[ptab.long()].reshape(B, Sk, Hkv, D).float()
    v = vp[ptab.long()].reshape(B, Sk, Hkv, D).float()
    out = torch.zeros(B, H, D)
    for b in range(B):
        lo, hi = split_plan.lane_keys(int(kv_len[b]), 1, Sk, window)
        ranges = split_plan.split_tiles(tiles[b], splits[b]) if tiles[b] else []
        assert all(e - s <= per for s, e in ranges)
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G].float()
            parts = []
            for s, e in ranges:
                k0 = max((lo // T + s) * T, lo)
                k1 = min((lo // T + e) * T, hi)
                sc = qg @ k[b, k0:k1, h].T * (1.0 / math.sqrt(D))
                m = sc.amax(-1, keepdim=True)
                p = torch.exp(sc - m)
                parts.append((m, p.sum(-1, keepdim=True), p @ v[b, k0:k1, h]))
            if not parts:
                continue
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            wts = [torch.exp(m - M) for m, _, _ in parts]
            L = sum(w * l for w, (_, l, _) in zip(wts, parts))
            A = sum(w * a for w, (_, _, a) in zip(wts, parts))
            out[b, h * G:(h + 1) * G] = A / L.clamp(min=1e-30)
    return out, splits


@pytest.mark.parametrize("window", [None, 100, 1000])
@pytest.mark.parametrize("n_sm", [1, 8, 132])
def test_decode_split_plan_reassembles_the_plain_and_pallas_decode(window, n_sm):
    """Cut by the plan mirror and merged by the combine's formula, the
    decode equals the plain version and the Pallas kernel within 2e-5;
    kv_len-0 lanes give 0, and at 132 SMs every live lane splits."""
    rng = np.random.default_rng(8)
    B, H, Hkv, D, page, n_ptab, n_pages = 7, 12, 2, 16, 16, 20, 150
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, Hkv, D)).astype(np.float32)
    ptab = rng.permutation(np.arange(1, n_pages))[:B * n_ptab]
    ptab = ptab.reshape(B, n_ptab).astype(np.int32)
    kv_len = np.array([0, 1, 63, 64, 65, 200, 320], np.int32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, ptab, kv_len)]
    got, splits = _decode_by_plan(*t, window, n_sm)
    want = tfd.paged_flash_decode(*t, window=window)
    pallas = paged_flash_decode_kernel(*(jnp.asarray(a) for a in (q, kp, vp, ptab, kv_len)),
                                       window=window, interpret=True)
    assert not got[0].any() and not np.asarray(pallas)[0].any()
    if n_sm == 132:
        assert all(n == split_plan.lane_tiles(int(kl), 1, 320, window)
                   for n, kl in zip(splits, kv_len))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5, rtol=2e-5)

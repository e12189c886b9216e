"""Plain versions of the port's kernels vs the JAX Pallas kernels run in
interpret mode, on the shapes of the JAX kernel tests.  These are the
specifications the Hopper kernels are held to on the card (``chip_smoke.py``).
Inputs come from seeded numpy; tolerances are those of ``test_kernels.py``:
2e-5 in f32, 2e-2 in bf16.  Lanes with ``kv_len = 0`` are left out of the
cross-framework comparisons: the port writes zeros there, like the TPU
kernel, while the JAX gather path gives the mean of fully masked rows."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_decode.kernel import paged_flash_decode_kernel
from repro.kernels.rmsnorm.kernel import rmsnorm_kernel
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import ops as tfa
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

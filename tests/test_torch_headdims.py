"""The attention kernels' plain versions at the head dims of gemma2-9b
(D 256, two query heads a KV head, tanh logit softcap 50) and zamba2-7b
(D 112, one), against the JAX package: flash attention against the Pallas
``flash_attention_kernel`` in interpret mode; the decode, paged and
contiguous, without a softcap against the Pallas decode kernels in
interpret mode, and with the softcap against the JAX gather path
(``layers.sdpa`` with ``logit_cap``, where the reference decodes
softcapped configs: its Pallas decode has no softcap).  Inputs come from
seeded numpy; tolerances are those of ``test_kernels.py``: 2e-5 in f32,
2e-2 in bf16.  The CUDA bodies are held to these plain versions on the
card (``chip_smoke.py``, phase 3)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_decode.kernel import (flash_decode_kernel,
                                               paged_flash_decode_kernel)
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_decode import ops as tfd

# the suite runs files in parallel workers: keep each to one intra-op thread
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GEMMA2 = (4, 2, 256, 50.0)          # H, Hkv, D, softcap (heads cut, D and G kept)
ZAMBA2 = (4, 4, 112, None)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(b), torch.from_numpy(b.view(np.uint16).copy()).view(torch.bfloat16)
    a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("shape,window", [(GEMMA2, None), (GEMMA2, 64), (ZAMBA2, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(shape, window, dtype):
    H, Hkv, D, cap = shape
    rng = np.random.default_rng(17)
    B, Sq, Sk = 1, 128, 256
    jq, tq = _pair(rng.standard_normal((B, Sq, H, D)), dtype)
    jk, tk = _pair(rng.standard_normal((B, Sk, Hkv, D)), dtype)
    jv, tv = _pair(rng.standard_normal((B, Sk, Hkv, D)), dtype)
    want = jfa.flash_attention(jq, jk, jv, causal=True, window=window, softcap=cap,
                               interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=True, window=window, softcap=cap)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _decode_inputs(shape, seed):
    H, Hkv, D, _ = shape
    rng = np.random.default_rng(seed)
    B, page, n_pages, pps = 3, 16, 13, 4
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, Hkv, D)).astype(np.float32)
    ptab = rng.permutation(np.arange(1, n_pages))[:B * pps].reshape(B, pps).astype(np.int32)
    kv_len = np.array([5, 37, 64], np.int32)
    return q, kp, vp, ptab, kv_len


@pytest.mark.parametrize("shape", [GEMMA2, ZAMBA2], ids=["D256", "D112"])
@pytest.mark.parametrize("window", [None, 20])
def test_paged_decode_plain_matches_pallas(shape, window):
    q, kp, vp, ptab, kv_len = _decode_inputs(shape, 3)
    want = paged_flash_decode_kernel(*(jnp.asarray(a) for a in (q, kp, vp, ptab, kv_len)),
                                     window=window, interpret=True)
    got = tfd.paged_flash_decode(*(torch.from_numpy(a) for a in (q, kp, vp, ptab, kv_len)),
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", [GEMMA2, ZAMBA2], ids=["D256", "D112"])
def test_contiguous_decode_plain_matches_pallas(shape):
    q, kp, vp, ptab, kv_len = _decode_inputs(shape, 4)
    B, S = ptab.shape[0], ptab.shape[1] * kp.shape[1]
    k = kp[ptab].reshape(B, S, *kp.shape[2:])
    v = vp[ptab].reshape(B, S, *vp.shape[2:])
    want = flash_decode_kernel(*(jnp.asarray(a) for a in (q, k, v, kv_len)), block_k=32,
                               interpret=True)
    got = tfd.flash_decode(*(torch.from_numpy(a) for a in (q, k, v, kv_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("cap", [50.0, 2.0])
def test_softcapped_decode_plain_matches_the_reference_gather_path(window, cap):
    """gemma2's decode: the scores capped by ``cap·tanh(s/cap)`` before the
    mask, as ``layers.sdpa`` does on the reference's gather path (the
    query at position ``kv_len − 1`` sees keys below ``kv_len``, and with
    a window the last ``window``).  A cap of 2 binds on every score."""
    q, kp, vp, ptab, kv_len = _decode_inputs(GEMMA2, 5)
    B, S = ptab.shape[0], ptab.shape[1] * kp.shape[1]
    k = kp[ptab].reshape(B, S, *kp.shape[2:])
    v = vp[ptab].reshape(B, S, *vp.shape[2:])
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    qpos = (kv_len - 1)[:, None]
    mask = (jlayers._attn_mask(jnp.asarray(qpos), jnp.asarray(kpos), window)
            & (jnp.asarray(kpos) < jnp.asarray(kv_len)[:, None])[:, None, None, :])
    want = np.asarray(jlayers.sdpa(jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
                                   mask, logit_cap=cap))[:, 0]
    t = [torch.from_numpy(a) for a in (q, kp, vp, ptab, kv_len)]
    paged = tfd.paged_flash_decode(*t, window=window, softcap=cap).numpy()
    np.testing.assert_allclose(paged, want, atol=2e-5, rtol=2e-5)
    if window is None:
        contig = tfd.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), t[4], softcap=cap).numpy()
        np.testing.assert_allclose(contig, want, atol=2e-5, rtol=2e-5)
    uncapped = tfd.paged_flash_decode(*t, window=window).numpy()
    assert np.abs(uncapped - want).max() > 1e-3          # the cap changes the output

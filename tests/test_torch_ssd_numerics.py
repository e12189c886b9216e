"""Where the SSD scan's bf16 body (``csrc/ssd_scan.cu``, tensor cores)
rounds, emulated in plain PyTorch and held to the Pallas
``ssd_scan_kernel`` (interpret mode, zero state: it takes none) and to the
port's plain version ``ssd_scan_ref`` (nonzero initial state), at mamba2's
full width (h 64, p 64, n 128), one lane.

The emulation follows the kernel's plan: chunks of 64 positions, the tail
zero-padded; x, B, C and the initial state as bf16 values, entering the
products as they are; the three f32 factors -- the masked decay-weighted
scores M = (C.B^T) o L dt, the carried state in C.state^T and w_j x_j in
the state update -- as bf16 hi + lo halves; every sum in f32; y and the
final state rounded to bf16 once.  Tolerance 2e-2 (bf16), atol + rtol as
``chip_smoke.py`` holds the kernel on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

torch.set_num_threads(1)

TOL = 2e-2
H, P, N = 64, 64, 128          # mamba2-1.3b: heads, head_dim, d_state


def _split(t: torch.Tensor):
    """f32 -> (hi, lo) bf16 values with hi + lo ~ t (``split_bf16``)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _emulate(x, dt, A, B, C, state):
    """The bf16 body's arithmetic: x, B, C, state bf16-valued f32 tensors
    (state may be None); returns y, final state as bf16."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = ssd_kernel.CHUNK
    pad = -s % L
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dtp = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Bp = torch.nn.functional.pad(B[:, :, 0], (0, 0, 0, pad))
    Cp = torch.nn.functional.pad(C[:, :, 0], (0, 0, 0, pad))
    st = torch.zeros((b, h, p, n)) if state is None else state.clone()
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    ys = []
    for c0 in range(0, s + pad, L):
        xc, dtc = xp[:, c0:c0 + L], dtp[:, c0:c0 + L]          # (b,L,h,p), (b,L,h)
        Bc, Cc = Bp[:, c0:c0 + L], Cp[:, c0:c0 + L]            # (b,L,n)
        cum = torch.cumsum(dtc * A, dim=1)                      # (b,L,h)
        G = Cc @ Bc.transpose(1, 2)                             # (b,i,j)
        seg = cum[:, :, None, :] - cum[:, None, :, :]           # (b,i,j,h)
        M = torch.where(tri[None, :, :, None],
                        G[..., None] * torch.exp(seg) * dtc[:, None],
                        torch.zeros(()))
        Mh, Ml = _split(M)
        yd = (torch.einsum("bijh,bjhp->bihp", Mh, xc)
              + torch.einsum("bijh,bjhp->bihp", Ml, xc))
        Sh, Sl = _split(st)
        yo = (torch.einsum("bin,bhpn->bihp", Cc, Sh)
              + torch.einsum("bin,bhpn->bihp", Cc, Sl))
        ys.append(yd + torch.exp(cum)[..., None] * yo)
        end = cum[:, -1]                                         # (b,h)
        w = dtc * torch.exp(end[:, None] - cum)                  # (b,L,h)
        Wh, Wl = _split(w[..., None] * xc)
        st = (st * torch.exp(end)[..., None, None]
              + torch.einsum("bjhp,bjn->bhpn", Wh, Bc)
              + torch.einsum("bjhp,bjn->bhpn", Wl, Bc))
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(torch.bfloat16), st.to(torch.bfloat16)


def _inputs(s, seed):
    """chip_smoke.py's SSD inputs: dt log-uniform in [1e-3, 0.1], A = -(1..H),
    bf16 x, B, C and state."""
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (1, s, H))).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float()

    x = bf(rng.standard_normal((1, s, H, P)) * 0.5)
    B = bf(rng.standard_normal((1, s, 1, N)) * 0.3)
    C = bf(rng.standard_normal((1, s, 1, N)) * 0.3)
    st = bf(rng.standard_normal((1, H, P, N)) * 0.3)
    return x, torch.from_numpy(dt), torch.from_numpy(A), B, C, st


def _close(got, want):
    g, w = got.float(), want.float()
    bad = (g - w).abs() > TOL + TOL * w.abs()
    assert torch.isfinite(g).all() and not bad.any(), (
        f"{int(bad.sum())} elements beyond {TOL}, max err {float((g - w).abs().max())}")


@pytest.mark.parametrize("s", [1, 2, 37, 64, 256])
def test_bf16_rounding_plan_matches_the_plain_version_with_state(s):
    x, dt, A, B, C, st = _inputs(s, seed=s)
    y, fin = _emulate(x, dt, A, B, C, st)
    y_r, fin_r = ssd_scan_ref(x, dt, A, B, C, min(s, 64), st)
    assert y.shape == (1, s, H, P) and fin.shape == (1, H, P, N)
    _close(y, y_r.to(torch.bfloat16))
    _close(fin, fin_r.to(torch.bfloat16))


@pytest.mark.parametrize("s", [1, 2, 37, 64, 256])
def test_bf16_rounding_plan_matches_pallas_from_zero_state(s):
    x, dt, A, B, C, _ = _inputs(s, seed=100 + s)
    y, _ = _emulate(x, dt, A, B, C, None)
    want = ssd_scan_kernel(*(jnp.asarray(t.numpy()) for t in (x, dt, A, B, C)),
                           chunk=min(s, 64), interpret=True)
    _close(y, torch.from_numpy(np.array(want)).to(torch.bfloat16))

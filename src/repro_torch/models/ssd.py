"""Mamba-2 SSD block — chunked parallel form + decode step (port of
``src/repro/models/ssd.py``).

The block is an ``nn.Module`` (:class:`Mamba2`) whose parameter names mirror
the JAX pytree (``in_proj.w``, ``conv_w``, ``conv_b``, ``A_log``, ``D``,
``dt_bias``, ``norm_scale``, ``out_proj.w``).  The two projections are
stored in the working dtype, the rest in f32, as the JAX block uses them.
The chunked scan goes through the SSD scan op (CUDA kernel on the card, its
plain version on the CPU), the gated norm through the RMSNorm op; the
projections, the depthwise conv and the S = 1 recurrent step stay plain
PyTorch, as the JAX block leaves them to XLA.  Each branch keeps the JAX
block's precision: the chunked branch convolves in the activation dtype,
the recurrent step convolves in f32 and updates the state in the
activation dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

State = Tuple[torch.Tensor, torch.Tensor]      # (conv (B, K-1, conv_dim), ssm (B, h, p, n))


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class _Proj(nn.Module):
    """A projection weight ``w`` in the JAX ``(d_in, d_out)`` layout."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)


class Mamba2(nn.Module):
    """Mamba-2 mixer weights; ``forward`` is :func:`mamba2_fwd`."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        s: SSMConfig = cfg.ssm
        d = cfg.d_model
        di, nh = s.d_inner(d), s.n_heads(d)
        conv_dim = di + 2 * s.n_groups * s.d_state
        self.cfg = cfg
        self.in_proj = _Proj(d, 2 * di + 2 * s.n_groups * s.d_state + nh, dtype, device)
        self.conv_w = _param((s.d_conv, conv_dim), torch.float32, device)
        self.conv_b = _param((conv_dim,), torch.float32, device)
        self.A_log = _param((nh,), torch.float32, device)
        self.D = _param((nh,), torch.float32, device)
        self.dt_bias = _param((nh,), torch.float32, device)
        self.norm_scale = _param((di,), torch.float32, device)
        self.out_proj = _Proj(di, d, dtype, device)

    def forward(self, x: torch.Tensor, state: Optional[State] = None):
        return mamba2_fwd(self, self.cfg, x, state)


def init_vector(name: str, n: int, generator: torch.Generator) -> Optional[torch.Tensor]:
    """``init_mamba2``'s value for the 1-D parameter ``name`` of length
    ``n`` (f32, on the generator's device), or None for the zero-filled ones
    (``conv_b``, ``norm_scale``).  ``A_log = log(1..nh)``, ``D = 1`` and
    ``dt_bias`` the inverse softplus of a log-uniform dt in [1e-3, 1e-1]."""
    dev = generator.device
    if name == "A_log":
        return torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
    if name == "D":
        return torch.ones(n, dtype=torch.float32, device=dev)
    if name == "dt_bias":
        u = torch.rand(n, dtype=torch.float32, device=dev, generator=generator)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    return None


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d in x's dtype. x: (B, S, C), w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i].to(x.dtype) for i in range(K))
    return out + b.to(x.dtype)


def mamba2_fwd(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
               state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """Mamba-2 block. x: (B, S, d).

    state = (conv_state (B, d_conv-1, conv_dim), ssm_state (B, h, p, n)) to
    continue from a previous call: S == 1 runs the recurrent step, S > 1 the
    chunked scan seeded with the carried state (chunked prefill).  state =
    None processes x as a fresh sequence.  Returns (y, new_state); the input
    state is not modified.
    """
    s: SSMConfig = cfg.ssm
    B_, S, d = x.shape
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    conv_dim = di + 2 * gn

    zxbcdt = x @ p.in_proj.w
    z = zxbcdt[..., :di]
    xBC_raw = zxbcdt[..., di:di + conv_dim]                  # pre-conv inputs
    dt = F.softplus(zxbcdt[..., di + conv_dim:].float() + p.dt_bias)  # (B,S,nh)
    A = -torch.exp(p.A_log)                                  # (nh,) negative

    if state is None or S > 1:
        if state is None:
            prev_ssm = None
            src = xBC_raw
            xBC = F.silu(_causal_conv(xBC_raw, p.conv_w, p.conv_b))
        else:
            # chunked continuation: the conv sees the carried d_conv-1
            # history instead of zero padding, the scan seeds from the state
            prev_conv, prev_ssm = state
            src = torch.cat([prev_conv.to(xBC_raw.dtype), xBC_raw], dim=1)
            K = p.conv_w.shape[0]
            conv = sum(src[:, i:i + S, :] * p.conv_w[i].to(x.dtype)
                       for i in range(K)) + p.conv_b.to(x.dtype)
            xBC = F.silu(conv)
        xs = xBC[..., :di].reshape(B_, S, nh, s.head_dim)
        Bm = xBC[..., di:di + gn].reshape(B_, S, s.n_groups, s.d_state)
        Cm = xBC[..., di + gn:].reshape(B_, S, s.n_groups, s.d_state)
        y, fin = ssd_ops.ssd_scan(xs.contiguous(), dt.contiguous(), A,
                                  Bm.contiguous(), Cm.contiguous(),
                                  min(s.chunk_size, S), initial_state=prev_ssm)
        # conv state for a continuation: the last d_conv-1 pre-conv inputs
        tail = s.d_conv - 1
        conv_state = src[:, max(src.shape[1] - tail, 0):]
        if conv_state.shape[1] < tail:
            conv_state = F.pad(conv_state, (0, 0, tail - conv_state.shape[1], 0))
        new_state = (conv_state, fin)
    else:
        conv_state, ssm_state = state
        window = torch.cat([conv_state.to(xBC_raw.dtype), xBC_raw], dim=1)
        conv = torch.einsum("bkc,kc->bc", window.float(), p.conv_w) + p.conv_b
        xBC1 = F.silu(conv.to(x.dtype))
        xs = xBC1[:, :di].reshape(B_, nh, s.head_dim)
        Bv = xBC1[:, di:di + gn].reshape(B_, s.n_groups, s.d_state)[:, 0]
        Cv = xBC1[:, di + gn:].reshape(B_, s.n_groups, s.d_state)[:, 0]
        dt1 = dt[:, 0]                                       # (B, nh)
        dA = torch.exp(dt1 * A[None, :])
        upd = torch.einsum("bhp,bn->bhpn", xs * dt1[..., None].to(x.dtype), Bv)
        ssm_new = ssm_state.to(x.dtype) * dA[..., None, None].to(x.dtype) + upd
        y = torch.einsum("bhpn,bn->bhp", ssm_new, Cv)[:, None]  # (B, 1, nh, p)
        new_state = (window[:, 1:], ssm_new)
        xs = xs[:, None]

    y = y + xs * p.D[None, None, :, None].to(x.dtype)
    y = y.reshape(B_, S, di) * F.silu(z)
    # gated RMSNorm (the RMSNorm op's formula over d_inner), then out_proj
    y = rms_ops.rmsnorm(y.contiguous(), p.norm_scale, cfg.norm_eps)
    return y @ p.out_proj.w, new_state

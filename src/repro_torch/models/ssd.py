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


def split_zxbcdt(cfg: ModelConfig, zxbcdt: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``in_proj``'s output (B, S, 2·d_inner + 2·g·n + h) cut into the gate
    ``z`` (d_inner), the pre-conv ``xBC`` (conv_dim) and the raw ``dt`` (h)."""
    s: SSMConfig = cfg.ssm
    di = s.d_inner(cfg.d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim],
            zxbcdt[..., di + conv_dim:])


def conv_step(xBC_raw: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
              state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depthwise causal conv and SiLU over any slice of the conv
    channels (the conv is per channel, so a slice is exact): x (B, S, c),
    ``conv_w`` (K, c), ``conv_b`` (c,), ``state`` the carried (B, K-1, c)
    pre-conv inputs or None (a fresh sequence).  Returns the post-SiLU
    (B, S, c) and the next conv state.  Without a state, or for S > 1, the
    conv runs in x's dtype; the S = 1 recurrent step runs it in f32, as the
    JAX block does."""
    S, dtype = xBC_raw.shape[1], xBC_raw.dtype
    K = conv_w.shape[0]
    tail = K - 1
    if state is not None and S == 1:
        window = torch.cat([state.to(dtype), xBC_raw], dim=1)
        conv = torch.einsum("bkc,kc->bc", window.float(), conv_w) + conv_b
        return F.silu(conv.to(dtype))[:, None], window[:, 1:]
    if state is None:
        src = xBC_raw
        xBC = F.silu(_causal_conv(xBC_raw, conv_w, conv_b))
    else:
        # chunked continuation: the conv sees the carried d_conv-1 history
        # instead of zero padding
        src = torch.cat([state.to(dtype), xBC_raw], dim=1)
        conv = sum(src[:, i:i + S, :] * conv_w[i].to(dtype)
                   for i in range(K)) + conv_b.to(dtype)
        xBC = F.silu(conv)
    # conv state for a continuation: the last d_conv-1 pre-conv inputs
    conv_state = src[:, max(src.shape[1] - tail, 0):]
    if conv_state.shape[1] < tail:
        conv_state = F.pad(conv_state, (0, 0, tail - conv_state.shape[1], 0))
    return xBC, conv_state


def split_xBC(cfg: ModelConfig, xBC: torch.Tensor, heads: slice = slice(None)
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The post-conv (B, S, conv_dim) cut into the ``heads`` of x
    (B, S, h, p) and the shared B and C (B, S, g, n)."""
    s: SSMConfig = cfg.ssm
    B_, S, _ = xBC.shape
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    xs = xBC[..., :di].reshape(B_, S, s.n_heads(cfg.d_model), s.head_dim)[:, :, heads]
    return (xs, xBC[..., di:di + gn].reshape(B_, S, s.n_groups, s.d_state),
            xBC[..., di + gn:].reshape(B_, S, s.n_groups, s.d_state))


def scan_step(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, state: Optional[torch.Tensor], chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSM over any set of heads (heads are independent): xs (B, S, h,
    p), dt (B, S, h) f32, A (h,), Bm and Cm (B, S, 1, n), ``state`` the
    carried (B, h, p, n) or None.  Without a state, or for S > 1, the SSD
    scan op (seeded with the state: chunked prefill); the S = 1 recurrent
    step otherwise, its state update in x's dtype.  Returns y (B, S, h, p)
    and the next state."""
    S, dtype = xs.shape[1], xs.dtype
    if state is None or S > 1:
        return ssd_ops.ssd_scan(xs.contiguous(), dt.contiguous(), A, Bm.contiguous(),
                                Cm.contiguous(), min(chunk, S), initial_state=state)
    x1, dt1 = xs[:, 0], dt[:, 0]                             # (B, h, p), (B, h)
    Bv, Cv = Bm[:, 0, 0], Cm[:, 0, 0]
    dA = torch.exp(dt1 * A[None, :])
    upd = torch.einsum("bhp,bn->bhpn", x1 * dt1[..., None].to(dtype), Bv)
    ssm_new = state.to(dtype) * dA[..., None, None].to(dtype) + upd
    return torch.einsum("bhpn,bn->bhp", ssm_new, Cv)[:, None], ssm_new


def gate(y: torch.Tensor, xs: torch.Tensor, D: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``(y + x·D)·SiLU(z)`` over a set of heads: y, xs (B, S, h, p), D
    (h,), z (B, S, h·p).  Returns (B, S, h·p), the gated norm's input."""
    B_, S, h, p = y.shape
    y = y + xs * D[None, None, :, None].to(xs.dtype)
    return y.reshape(B_, S, h * p) * F.silu(z)


def mamba2_fwd(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
               state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """Mamba-2 block. x: (B, S, d).

    state = (conv_state (B, d_conv-1, conv_dim), ssm_state (B, h, p, n)) to
    continue from a previous call: S == 1 runs the recurrent step, S > 1 the
    chunked scan seeded with the carried state (chunked prefill).  state =
    None processes x as a fresh sequence.  Returns (y, new_state); the input
    state is not modified.  The steps (:func:`conv_step`,
    :func:`scan_step`, :func:`gate`) are those a tensor-parallel shard runs
    on its slice of the conv channels and of the heads.
    """
    z, xBC_raw, dt_raw = split_zxbcdt(cfg, x @ p.in_proj.w)
    dt = F.softplus(dt_raw.float() + p.dt_bias)              # (B, S, nh)
    A = -torch.exp(p.A_log)                                  # (nh,) negative
    xBC, conv_state = conv_step(xBC_raw, p.conv_w, p.conv_b,
                                None if state is None else state[0])
    xs, Bm, Cm = split_xBC(cfg, xBC)
    y, fin = scan_step(xs, dt, A, Bm, Cm, None if state is None else state[1],
                       cfg.ssm.chunk_size)
    # gated RMSNorm (the RMSNorm op's formula over d_inner), then out_proj
    y = rms_ops.rmsnorm(gate(y, xs, p.D, z).contiguous(), p.norm_scale, cfg.norm_eps)
    return y @ p.out_proj.w, (conv_state, fin)

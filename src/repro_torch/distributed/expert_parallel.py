"""Expert-parallel MoE FFN (port of ``src/repro/distributed/expert_parallel.py``).

The expert axis is split over the mesh's tensor-parallel axis: shard ``s``
holds experts ``[s·E/tp, (s+1)·E/tp)`` and runs them through the port's
grouped SwiGLU (:func:`repro_torch.kernels.moe_gmm.ops.moe_gmm`, the CUDA
kernel on the card) over one copy of the tokens (expert stride 0, as
:func:`repro_torch.models.layers.moe_dense_mix` feeds it).  Each shard
weights its experts' outputs by their gates, and the partial outputs are
summed in shard order (the reference's ``psum``).  Semantics are exactly the
dense mix (every token visits every expert, no capacity dropping), so a
sharded engine's tokens equal the unsharded one's up to the order of the
f32 sums.

Gating runs replicated (the router is small): every shard computes the same
gates from its own copy of the router and of x.  The reference runs the
shards under ``shard_map``; here each is a launch on its logical device.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers import moe_gates


def _expert_slices(p, s: int, ep: int, device: torch.device):
    """Shard ``s``'s (router, w_gate, w_up, w_down) on ``device``: taken
    from per-shard lists when ``p`` holds them, else sliced off the full
    expert axis."""
    if isinstance(p.w_gate, (list, tuple)):
        return p.router[s], p.w_gate[s], p.w_up[s], p.w_down[s]
    e_loc = p.w_gate.shape[0] // ep
    sl = slice(s * e_loc, (s + 1) * e_loc)
    return (p.router.to(device), p.w_gate[sl].to(device), p.w_up[sl].to(device),
            p.w_down[sl].to(device))


def ep_moe_partials(p, cfg: ModelConfig, xs: Sequence[torch.Tensor],
                    devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Each shard's gate-weighted output (B, S, d) on its device.  ``xs``
    holds x on every shard's device; ``p`` holds the full expert tensors
    or, as a sharded engine keeps them, lists of per-shard slices (and of
    router copies)."""
    ep = len(devices)
    e_total = (sum(w.shape[0] for w in p.w_gate) if isinstance(p.w_gate, (list, tuple))
               else p.w_gate.shape[0])
    if e_total % ep != 0:
        raise ValueError(f"n_experts={e_total} not divisible by "
                         f"expert-parallel degree {ep}")
    e_loc = e_total // ep
    out = []
    for s, (x, dev) in enumerate(zip(xs, devices)):
        router, wg, wu, wd = _expert_slices(p, s, ep, dev)
        B, S, d = x.shape
        T = B * S
        gates = moe_gates(_Router(router), cfg, x).reshape(T, e_total).to(x.dtype)
        y = moe_ops.moe_gmm(x.reshape(1, T, d).expand(e_loc, T, d), wg, wu, wd)
        g = gates[:, s * e_loc:(s + 1) * e_loc]
        out.append(torch.einsum("etd,te->td", y, g).reshape(B, S, d))
    return out


class _Router:
    """The router weight in the shape :func:`moe_gates` reads."""

    def __init__(self, router: torch.Tensor):
        self.router = router


def sum_in_order(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Σ parts on ``device``, added in shard order (the row-parallel and
    expert-parallel reduction)."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def ep_moe_mix(p, cfg: ModelConfig, x: torch.Tensor, mesh: Mesh,
               axis: str = "model") -> torch.Tensor:
    """Expert-parallel dense-mix MoE over the ``axis`` shards of ``mesh``:
    x (B, S, d) goes to every shard, each runs its experts, and the partial
    outputs are summed in shard order on x's device."""
    devices = mesh.axis_devices(axis)
    parts = ep_moe_partials(p, cfg, [x.to(d) for d in devices], devices)
    return sum_in_order(parts, x.device)

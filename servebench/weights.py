"""Seeded weights, drawn on the device by parameter name and shape.

A family module (``servebench/families/<model_type>.py``) lists its
parameters in groups: group 0 is the embedding, the head and the final norm,
group ``l + 1`` is layer ``l``.  Each group is one uniform draw in bf16 from
its own generator on the device, seeded from (seed, group), cut into the
group's tensors and scaled in place: the program's loader and the plain
reference call :func:`draw_group` alike, so both see the same numbers, and
the reference can draw one layer at a time.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], float, torch.dtype]   # name, shape, scale, stored dtype


def group_seed(seed: int, group: int) -> int:
    return (int(seed) * 1_000_003 + 7_919 * (group + 1)) % (1 << 63)


def draw_group(specs: Sequence[Spec], seed: int, group: int,
               device) -> Dict[str, torch.Tensor]:
    """The group's tensors: uniform in ±scale, rounded to bf16 (stored
    dtypes other than bf16 are the bf16 values upcast)."""
    numel = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    flat = torch.empty(sum(numel), dtype=torch.bfloat16, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, shape, scale, dtype), n in zip(specs, numel):
        t = flat[off:off + n].view(shape)
        t.mul_(scale)
        out[name] = t if dtype == torch.bfloat16 else t.to(dtype)
        off += n
    return out


def load_program(model: torch.nn.Module, groups: List[List[Spec]], seed: int,
                 device) -> None:
    """Copy every group's draw into the program's parameters of the same
    name and shape; raise if a name or shape differs or a parameter is left
    undrawn."""
    params = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for gi, specs in enumerate(groups):
            for name, val in draw_group(specs, seed, gi, device).items():
                if name not in params:
                    raise KeyError(f"the program has no parameter {name!r}")
                p = params[name]
                if tuple(p.shape) != tuple(val.shape):
                    raise ValueError(f"{name}: program shape {tuple(p.shape)}, "
                                     f"drawn {tuple(val.shape)}")
                p.copy_(val)
                seen.add(name)
    left = sorted(set(params) - seen)
    if left:
        raise KeyError(f"parameters the benchmark does not draw: {left[:5]}")

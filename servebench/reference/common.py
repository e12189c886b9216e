"""Plain float32 building blocks of the references, and the lower-precision
control's weight rounding.  Plain PyTorch: no kernel, no cache, no batching."""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

Weights = Dict[str, torch.Tensor]
GetGroup = Callable[[int], Weights]      # group index -> f32 tensors by name

FP8_MAX = 448.0                          # largest finite float8_e4m3fn


def no_tf32() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) times the weight, stored as (1 + scale)."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last axis of x (S, ..., D) at positions
    0..S-1, rotating its two halves (rotate_half)."""
    S, D = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    shape = (S,) + (1,) * (x.dim() - 2) + (D // 2,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


ATTN_ROWS = 1024                         # queries a block: (H, 1024, S) scores


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """softmax(q k^T scale) v over keys at or before each query.  q (S, H,
    Dq), k (S, H, Dq), v (S, H, Dv) -> (S, H, Dv).  Queries go in blocks,
    each over the keys up to its last query, so that long sequences fit."""
    S, out = q.shape[0], []
    for a in range(0, S, ATTN_ROWS):
        b = min(a + ATTN_ROWS, S)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        mask = torch.ones(b - a, b, dtype=torch.bool, device=q.device).tril(a)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", p, v[:b]))
    return torch.cat(out)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd


def fp8_round(name: str, w: torch.Tensor) -> torch.Tensor:
    """The control's weights: each matrix rounded to float8 e4m3 with one
    scale per output column (per row for the embedding), back in float32.
    Vectors (norm scales) are left as they are."""
    if w.dim() < 2:
        return w
    axis = -1 if name == "embed" else -2
    amax = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def f32_group(draw: Callable[[int], Weights], control: bool) -> GetGroup:
    """Group getter in float32 (names as drawn); with ``control`` every
    matrix goes through :func:`fp8_round` first."""
    def get(gi: int) -> Weights:
        out = {}
        for name, t in draw(gi).items():
            t = t.to(torch.float32)
            out[name] = fp8_round(name, t) if control else t
        return out
    return get


def head_logits(xs: Sequence[torch.Tensor], want: Sequence[Sequence[int]],
                top: Weights, eps: float, tied: bool) -> List[torch.Tensor]:
    """Final norm and head at the wanted positions of each sequence: f32
    logits (n_i, V)."""
    head = top["embed"].t() if tied else top["lm_head"]
    out = []
    for x, pos in zip(xs, want):
        h = rmsnorm(x[torch.as_tensor(list(pos), device=x.device)],
                    top["final_norm.scale"], eps)
        out.append(h @ head)
    return out


def embed_tokens(top: Weights, seqs: Sequence[Sequence[int]],
                 device) -> List[torch.Tensor]:
    return [top["embed"][torch.as_tensor(list(s), device=device)] for s in seqs]

"""Transformer layers: GQA and MLA attention, SwiGLU and MoE, over paged
and contiguous caches (port of ``src/repro/models/layers.py``).

Weights keep the JAX package's ``(d_in, d_out)`` layout and are applied as
``x @ w``, so carrying JAX weights over is a plain copy.  On the card the
projection, bias and embedding tensors are stored in the working dtype once,
at load, instead of being cast on every call as the JAX ``linear`` does —
the numbers are the same.  Norm scales stay f32 (the norm computes in f32).

The projections, the SwiGLU products, the MoE router and the tied head
stay ``torch.matmul``: they are plain products that the JAX package leaves
to XLA outside any Pallas kernel.  RMSNorm, decode attention (paged and
contiguous), prefill attention and the MoE experts' grouped SwiGLU go
through the port's kernel ops (CUDA on the card, their plain
versions on the CPU).

Multi-head latent attention (:class:`MLA`, :func:`mla_fwd`,
:func:`paged_mla_fwd`) stays PyTorch ops on both devices: the reference
runs no Pallas kernel for it (its paged step passes ``use_kernel=False``
and its contiguous path is einsums), so its products are plain products
that the JAX package leaves to XLA.  The scores and the softmax are f32,
as in JAX (``preferred_element_type=float32``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import flags

NEG_INF = -2.0 ** 30  # large-negative that survives bf16


# --------------------------------------------------------------------------- #
# norms / positional
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·(1+scale)`` computed in f32, through the
    RMSNorm op (the JAX model inlines the same formula in jnp)."""
    return rms_ops.rmsnorm(x, scale, eps)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Split halves, f32 math."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                          # (D/2,)
    ang = positions.float()[..., None] * inv                      # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def linear(w: torch.Tensor, b: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b
    return y


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
              causal: bool = True) -> torch.Tensor:
    """(B, 1, Sq, Sk) boolean mask. q_pos: (B, Sq), k_pos: (B, Sk)."""
    diff = q_pos[:, :, None] - k_pos[:, None, :]
    mask = (diff >= 0) if causal else torch.ones_like(diff, dtype=torch.bool)
    if window is not None:
        mask = mask & (diff < window)
    return mask[:, None, :, :]


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
         logit_cap: Optional[float] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """Plain grouped-query attention (GQA by repeating K/V), scores and
    softmax in f32.  q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); mask:
    (B, 1, Sq, Sk).  The CPU-only reference path; the serving path runs the
    kernel ops instead."""
    D = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = softcap(s, logit_cap)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                              device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """GQA attention weights (``wq``/``wk``/``wv``/``wo`` in (d_in, d_out),
    optional ``bq``/``bk``/``bv``); :func:`attention_fwd` and
    :func:`paged_attention_fwd` apply them."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = _weight((d, h * dh), dtype, device)
        self.wk = _weight((d, hk * dh), dtype, device)
        self.wv = _weight((d, hk * dh), dtype, device)
        self.wo = _weight((h * dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _weight((h * dh,), dtype, device)
            self.bk = _weight((hk * dh,), dtype, device)
            self.bv = _weight((hk * dh,), dtype, device)
        else:
            self.bq = self.bk = self.bv = None


def _qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Projections with bias, RoPE on q and k: (B, C, H, D), (B, C, Hkv, D) ×2."""
    B, C, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = linear(p.wq, p.bq, x).reshape(B, C, H, D)
    k = linear(p.wk, p.bk, x).reshape(B, C, Hkv, D)
    v = linear(p.wv, p.bv, x).reshape(B, C, Hkv, D)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention_fwd(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, window: Optional[int],
                  kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA attention over a contiguous cache (the JAX ``attention_fwd``,
    self-attention cases; cross-attention is :func:`cross_attention_fwd`).

    * full-sequence mode, ``kv_cache`` None: causal attention over x itself
      (flash-attention kernel, window and softcap as configured).  The JAX
      function builds the causal mask here whatever its ``causal`` argument
      says (``src/repro/models/layers.py:226``), so whisper's encoder,
      which passes ``causal=False``, is causal there and here.
    * cache mode: ``kv_cache = (K, V)`` buffers (B, S_max, Hkv, D) of x's
      batch rows.  Rows flagged in ``active`` (B,) bool (None: all) write
      this chunk's K/V at ``positions`` in place; the others keep their
      buffers.  Attention then runs over the buffer with
      ``kv_len = positions[:, -1] + 1`` for active rows and 0 (zeros out)
      otherwise — exactly the JAX mask ``_attn_mask(positions, kpos) &
      (kpos >= 0)`` for a row whose cache holds positions ``0 .. p0-1``,
      which the engine keeps true (a claimed slot is wiped and prefilled
      from position 0; an installed slot must hold every earlier
      position).  ``C == 1`` runs the contiguous decode kernel, ``C > 1``
      the flash-attention kernel with per-row ``kv_len``.
    * rolling sliding-window ring (``window`` given with a cache): the
      chunk is written at ``positions % S_max`` and ``kv_len =
      min(positions[:, -1] + 1, S_max)``.  The buffer is
      ``min(window, max_seq_len)`` long, so it holds only positions inside
      the window, and the kernels get no window.  The engine's chunk rule
      (chunks only while the prefix fits the ring, then one token at a
      time) keeps every multi-token chunk unwrapped, so flash attention
      reads rows ``[0, kv_len)`` in position order; a decode reads every
      valid row, whose order softmax does not see.

    Unlike the JAX function, which returns the new buffers, the port
    writes them in place and returns only the attention output (B, C, d).
    """
    B, C, _ = x.shape
    H, D = cfg.n_heads, cfg.d_head
    q, k, v = _qkv(p, cfg, x, positions)
    if kv_cache is None:
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                     softcap=cfg.attn_logit_softcap)
        return out.reshape(B, C, H * D) @ p.wo
    K, V = kv_cache
    S_max = K.shape[1]
    act = (torch.ones(B, dtype=torch.bool, device=x.device) if active is None
           else active.bool())
    rows = torch.arange(B, device=x.device)[:, None].expand(B, C)
    slots = positions % S_max if window is not None else positions
    keep = act[:, None, None, None]
    K[rows, slots] = torch.where(keep, k, K[rows, slots])
    V[rows, slots] = torch.where(keep, v, V[rows, slots])
    lens = positions[:, -1] + 1
    if window is not None:
        lens = lens.clamp(max=S_max)
    lens = torch.where(act, lens, 0).to(torch.int32)
    if C == 1:
        out = fd_ops.flash_decode(q[:, 0].contiguous(), K, V, lens,
                                  cfg.attn_logit_softcap)[:, None]
    else:
        out = fa_ops.flash_attention(q, K, V, causal=True,
                                     softcap=cfg.attn_logit_softcap,
                                     kv_len=lens)
    return out.reshape(B, C, H * D) @ p.wo


def cross_kv(p: Attention, cfg: ModelConfig,
             enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention keys and values from the encoder
    output (B, F, d): ``enc_out @ wk`` and ``enc_out @ wv`` as (B, F, Hkv,
    D), no bias and no RoPE, as the JAX ``_decoder_layer_fwd`` makes them."""
    B, F, _ = enc_out.shape
    shape = (B, F, cfg.n_kv_heads, cfg.d_head)
    return (enc_out @ p.wk).reshape(shape), (enc_out @ p.wv).reshape(shape)


def cross_attention_fwd(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                        xk: torch.Tensor, xv: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-attention of x (B, C, d) over fixed keys and values xk, xv
    (B, F, Hkv, D) (the JAX ``attention_fwd`` with ``xattn_kv``): q gets
    ``wq`` and its bias, no RoPE, and nothing is masked but the keys at or
    past ``kv_len`` (B,) int32 (None: all F).  A lane with ``kv_len`` 0
    attends nothing and gets zeros, as the other paths' inactive lanes do
    (the JAX gather path gives them the mean of the values instead).
    ``C == 1`` runs the contiguous decode kernel (``kv_len`` required),
    ``C > 1`` the flash-attention kernel with ``causal=False``."""
    B, C, _ = x.shape
    H, D = cfg.n_heads, cfg.d_head
    q = linear(p.wq, p.bq, x).reshape(B, C, H, D)
    if C == 1 and kv_len is not None:
        out = fd_ops.flash_decode(q[:, 0].contiguous(), xk, xv, kv_len,
                                  cfg.attn_logit_softcap)[:, None]
    else:
        out = fa_ops.flash_attention(q, xk, xv, causal=False,
                                     softcap=cfg.attn_logit_softcap, kv_len=kv_len)
    return out.reshape(B, C, H * D) @ p.wo


def paged_attention_fwd(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                        pos2: torch.Tensor, window: Optional[int],
                        kp: torch.Tensor, vp: torch.Tensor, ptab: torch.Tensor,
                        lens: torch.Tensor, widx: torch.Tensor) -> torch.Tensor:
    """GQA attention against one layer's paged KV pool.

    x: (B, C, d) token chunk at absolute positions ``pos2`` (B, C);
    kp/vp: (P, page, Hkv, D) physical page pools of this layer; ptab:
    (B, n_ptab) int32 logical block → physical page; lens: (B,) int32 valid
    kv length after this chunk's writes; widx: (B·C,) flat pool row
    (page·page_size + offset) each token writes to, inactive lanes already
    diverted into the trash page by the caller.

    Unlike the JAX function, which returns new pools, the port writes this
    chunk's K/V into ``kp``/``vp`` in place (``index_copy_`` into the
    ``(P·page, Hkv, D)`` view) and returns only the attention output.
    ``C == 1`` runs the paged decode kernel (with the ``paged_shard`` flag
    set, :func:`~repro_torch.kernels.flash_decode.ops.sharded_paged_flash_decode`
    over the flag's mesh); ``C > 1`` runs the
    flash-attention kernel on the pools through ``ptab`` (the kernel reads
    the mapped pages in place; no gathered copy) with per-row
    ``kv_len = lens``.
    """
    B, C, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    P, page = kp.shape[0], kp.shape[1]
    q, k, v = _qkv(p, cfg, x, pos2)

    kp.view(P * page, Hkv, D).index_copy_(0, widx, k.reshape(B * C, Hkv, D))
    vp.view(P * page, Hkv, D).index_copy_(0, widx, v.reshape(B * C, Hkv, D))

    shard = flags.get_flag("paged_shard")
    if C == 1 and shard is not None:
        out = fd_ops.sharded_paged_flash_decode(
            q[:, 0], kp, vp, ptab, lens, shard["mesh"], shard.get("axis", "model"),
            window=window, softcap=cfg.attn_logit_softcap)[:, None]
    elif C == 1:
        out = fd_ops.paged_flash_decode_head_slice(
            q[:, 0], kp, vp, ptab, lens, 0, Hkv, window=window,
            softcap=cfg.attn_logit_softcap)[:, None]
    else:
        out = fa_ops.flash_attention(q, kp, vp, causal=True, window=window,
                                     softcap=cfg.attn_logit_softcap,
                                     kv_len=lens, ptab=ptab)
    return out.reshape(B, C, H * D) @ p.wo


# --------------------------------------------------------------------------- #
# MLA (multi-head latent attention: MiniCPM3 / DeepSeek-V2)
# --------------------------------------------------------------------------- #
class MLA(nn.Module):
    """MLA weights in the JAX ``init_mla`` layout (d_in, d_out): ``wq_a``
    (d, q_lora), ``wq_b`` (q_lora, H·(d_nope + d_rope)), ``wkv_a``
    (d, r + d_rope), ``wk_b`` (r, H·d_nope), ``wv_b`` (r, H·d_v), ``wo``
    (H·d_v, d); :func:`mla_fwd` and :func:`paged_mla_fwd` apply them."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.wq_a = _weight((d, m.q_lora_rank), dtype, device)
        self.wq_b = _weight((m.q_lora_rank, H * qd), dtype, device)
        self.wkv_a = _weight((d, m.kv_lora_rank + m.qk_rope_head_dim), dtype, device)
        self.wk_b = _weight((m.kv_lora_rank, H * m.qk_nope_head_dim), dtype, device)
        self.wv_b = _weight((m.kv_lora_rank, H * m.v_head_dim), dtype, device)
        self.wo = _weight((H * m.v_head_dim, d), dtype, device)


def mla_qkv(p: MLA, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Absorbed query ``q_lat = q_nope · wk_b`` (B, S, H, r), the roped
    query part (B, S, H, d_rope), and this chunk's latent cache entries
    ``[c_lat, rope(k_rope)]`` (B, S, r + d_rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H, r, dn = cfg.n_heads, m.kv_lora_rank, m.qk_nope_head_dim
    q = ((x @ p.wq_a) @ p.wq_b).reshape(B, S, H, dn + m.qk_rope_head_dim)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = x @ p.wkv_a
    k_rope = apply_rope(ckv[:, :, None, r:], positions, cfg.rope_theta)[:, :, 0]
    ckv = torch.cat([ckv[..., :r], k_rope], dim=-1)
    q_lat = torch.einsum("bshd,rhd->bshr", q[..., :dn], p.wk_b.reshape(r, H, dn))
    return q_lat, q_rope, ckv


def mla_attend(p: MLA, cfg: ModelConfig, q_lat: torch.Tensor,
               q_rope: torch.Tensor, ckv: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Scores in latent space over the keys ``ckv`` (B, Sk, r + d_rope),
    f32 scores and softmax, ``o = (p · c_k) · wv_b · wo``.  mask:
    (B, 1, Sq, Sk) bool."""
    m = cfg.mla
    B, S, H, r = q_lat.shape
    c_k, kr = ckv[..., :r], ckv[..., r:]
    s = (torch.einsum("bshr,bkr->bhsk", q_lat.float(), c_k.float())
         + torch.einsum("bshd,bkd->bhsk", q_rope.float(), kr.float()))
    s = torch.where(mask, s * (1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)),
                    NEG_INF)
    pr = torch.softmax(s, dim=-1).to(q_lat.dtype)
    o_lat = torch.einsum("bhsk,bkr->bshr", pr, c_k)
    o = torch.einsum("bshr,rhd->bshd", o_lat, p.wv_b.reshape(r, H, m.v_head_dim))
    return o.reshape(B, S, H * m.v_head_dim) @ p.wo


def mla_fwd(p: MLA, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
            kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MLA over the compressed latent (the JAX ``mla_fwd``).

    * full-sequence mode, ``kv_cache`` None: causal attention over x.
    * cache mode: ``kv_cache = (Ckv, kpos)``, this layer's latent buffer
      (B, S_max, r + d_rope) and its absolute positions (B, S_max) int32
      (-1: empty).  Rows flagged in ``active`` (B,) bool (None: all) write
      this chunk's entries and positions at ``positions`` in place; the
      attention is masked causally and by ``kpos >= 0``, as in JAX.

    Unlike the JAX function, which returns the new buffers, the port
    writes them in place and returns only the attention output (B, S, d).
    """
    B, S, _ = x.shape
    q_lat, q_rope, ckv = mla_qkv(p, cfg, x, positions)
    if kv_cache is None:
        return mla_attend(p, cfg, q_lat, q_rope, ckv,
                          attn_mask(positions, positions, None))
    Ckv, kpos = kv_cache
    act = (torch.ones(B, dtype=torch.bool, device=x.device) if active is None
           else active.bool())
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
    Ckv[rows, positions] = torch.where(act[:, None, None], ckv, Ckv[rows, positions])
    kpos[rows, positions] = torch.where(act[:, None], positions.to(kpos.dtype),
                                        kpos[rows, positions])
    mask = attn_mask(positions, kpos, None) & (kpos >= 0)[:, None, None, :]
    return mla_attend(p, cfg, q_lat, q_rope, Ckv, mask)


def paged_mla_fwd(p: MLA, cfg: ModelConfig, x: torch.Tensor, pos2: torch.Tensor,
                  ckvp: torch.Tensor, ptab: torch.Tensor, lens: torch.Tensor,
                  widx: torch.Tensor) -> torch.Tensor:
    """MLA against one layer's paged latent pool ``ckvp`` (P, page,
    r + d_rope), with :func:`paged_attention_fwd`'s contract: ``widx``
    (B·C,) flat pool rows, inactive lanes already diverted into the trash
    page; the chunk's entries are written in place (``index_copy_``).  The
    mapped pages are gathered (``ckvp[ptab]``) and masked causally and by
    ``lens``, as the JAX function does."""
    B, C, _ = x.shape
    P, page, w = ckvp.shape
    q_lat, q_rope, ckv = mla_qkv(p, cfg, x, pos2)
    ckvp.view(P * page, w).index_copy_(0, widx, ckv.reshape(B * C, w))
    S = ptab.shape[1] * page
    keys = ckvp[ptab.long()].reshape(B, S, w)
    kpos = torch.arange(S, device=x.device)[None].expand(B, S)
    mask = (attn_mask(pos2, kpos, None)
            & (kpos < lens[:, None])[:, None, None, :])
    return mla_attend(p, cfg, q_lat, q_rope, keys, mask)


# --------------------------------------------------------------------------- #
# feed-forward: SwiGLU + MoE
# --------------------------------------------------------------------------- #
class SwiGLU(nn.Module):
    """SwiGLU weights (``w_gate``/``w_up`` (d, F), ``w_down`` (F, d));
    :func:`swiglu` applies them."""

    def __init__(self, d: int, d_ff: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.w_gate = _weight((d, d_ff), dtype, device)
        self.w_up = _weight((d, d_ff), dtype, device)
        self.w_down = _weight((d_ff, d), dtype, device)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p.w_gate)
    u = x @ p.w_up
    return (g * u) @ p.w_down


class MoE(nn.Module):
    """MoE FFN weights in the JAX layout: ``router`` (d, E), ``w_gate`` and
    ``w_up`` (E, d, F), ``w_down`` (E, F, d); :func:`moe_dense_mix` and
    :func:`moe_dispatch` apply them."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _weight((d, e), dtype, device)
        self.w_gate = _weight((e, d, f), dtype, device)
        self.w_up = _weight((e, d, f), dtype, device)
        self.w_down = _weight((e, f, d), dtype, device)


def _route(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """Router: f32 softmax over the experts, top-k, renormalised.  Returns
    (top_p (B, S, K) f32, top_i (B, S, K) int64, probs (B, S, E) f32)."""
    probs = torch.softmax((x @ p.router).float(), dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    return top_p / top_p.sum(dim=-1, keepdim=True), top_i, probs


def moe_gates(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense router gates (B, S, E): renormalised top-k probabilities
    scattered back into the full expert axis, zeros elsewhere."""
    top_p, top_i, probs = _route(p, cfg, x)
    return torch.zeros_like(probs).scatter_(-1, top_i, top_p)


def moe_dense_mix(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Baseline MoE: every expert on every token, mixed by the gates.  The
    experts run as one grouped SwiGLU over a single copy of the B·S tokens
    (expert stride 0), as ``ep_moe_mix`` feeds the TPU kernel."""
    B, S, d = x.shape
    E, T = cfg.n_experts, B * S
    gates = moe_gates(p, cfg, x).reshape(T, E).to(x.dtype)
    y = moe_ops.moe_gmm(x.reshape(1, T, d).expand(E, T, d),
                        p.w_gate, p.w_up, p.w_down)                    # (E, T, d)
    return torch.einsum("etd,te->td", y, gates).reshape(B, S, d)


def moe_dispatch(p: MoE, cfg: ModelConfig, x: torch.Tensor,
                 capacity_factor: float = 1.25) -> torch.Tensor:
    """Capacity-based scatter dispatch MoE, with the JAX semantics.

    Capacity is per batch row, ``C = max(ceil(S·K/E·factor), 1)``; a decode
    step (``S == 1 and B > 1``) is one row of B tokens.  Within a row the
    (token, k) pairs claim expert slots in flattened order (cumulative sum),
    and pairs beyond C are dropped (weight 0).  The JAX (B, E, C, d) buffers
    are packed as (E, B·C, d), so one grouped-SwiGLU launch serves every row.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if S == 1 and B > 1:
        return moe_dispatch(p, cfg, x.reshape(1, B, d), capacity_factor).reshape(B, S, d)
    C = max(int(math.ceil(S * K / E * capacity_factor)), 1)
    dev = x.device
    top_p, top_i, _ = _route(p, cfg, x)
    flat_e = top_i.reshape(B, S * K)
    onehot = (flat_e[..., None] == torch.arange(E, device=dev)).long()   # (B, S·K, E)
    pos = (onehot.cumsum(dim=1) - onehot).gather(2, flat_e[..., None])[..., 0]
    keep = pos < C
    # row of each (token, k) pair in the packed (E·B·C, d) buffer; dropped
    # pairs point at their expert's first slot and add zeros there
    slot = (flat_e * (B * C) + torch.arange(B, device=dev)[:, None] * C
            + torch.where(keep, pos, 0)).reshape(-1)
    src = x.repeat_interleave(K, dim=1) * keep[..., None].to(x.dtype)
    buf = torch.zeros((E * B * C, d), dtype=x.dtype, device=dev)
    buf.index_add_(0, slot, src.reshape(-1, d))
    y = moe_ops.moe_gmm(buf.view(E, B * C, d), p.w_gate, p.w_up, p.w_down)
    w = (top_p.reshape(B, S * K) * keep).to(x.dtype)
    out = y.reshape(E * B * C, d)[slot].reshape(B, S * K, d) * w[..., None]
    return out.reshape(B, S, K, d).sum(dim=2)

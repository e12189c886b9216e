"""Language model: dense (GQA or MLA, or gemma2's local/global pairs),
MoE, vlm, SSM, hybrid (zamba2) and encoder-decoder (whisper) families
(port of ``src/repro/models/lm.py``).

The JAX model is a pure function over a parameter pytree with a
``lax.scan`` over stacked layers; here it is an ``nn.Module`` (:class:`LM`)
and the scan is a Python loop.  Its layer stacks mirror the JAX ones:
``layers`` (an ``nn.ModuleList`` of :class:`DecoderLayer` for the dense,
vlm and moe families or :class:`MambaLayer` for the ssm family),
``layer_pairs`` (L/2 pairs of a local and a global :class:`DecoderLayer`,
gemma2), or ``mamba_groups`` (G groups of ``attn_every − 1``
:class:`MambaLayer`), ``mamba_tail`` and one ``shared_attn``
:class:`DecoderLayer` applied after every group (zamba2), or whisper's
encoder stack ``enc_layers`` (with ``enc_pos`` and ``enc_norm``) beside
its decoder ``layers``, whose layers carry a cross-attention.  A moe layer's
FFN is chosen by the ``moe_impl`` flag (:mod:`repro_torch.models.flags`)
on every call.
Weights come from :func:`init_params` (seeded ``torch.Generator``) or from
JAX weights through :func:`params_from_jax` (numpy in, no JAX import);
:func:`params_to_jax` lays the port's named tensors out as the JAX pytree
again (checkpoints either package resumes).

Two caches, as in the JAX package:

* the paged pool of the pageable families (:func:`init_paged_cache`:
  ``kp/vp``, MLA ``ckvp``; :func:`paged_step`);
* the contiguous per-slot cache (:func:`init_cache`: dense ``k/v/pos`` —
  a rolling ring of ``min(window, seq_len)`` rows for a sliding-window
  config — MLA ``ckv/pos``, SSM ``conv/ssm``, gemma2's ``loc_*`` ring and
  ``glob_*`` buffer, zamba2's nested ``groups`` and ``tail`` state with
  ``attn_*`` per group, whisper's ``k/v/pos`` with the cross-attention's
  ``xk/xv``; :func:`step_with_cache`, :func:`decode_step`,
  :func:`prefill_step`).

Unlike the JAX functions, which return new caches, the steps write the
caches in place, and only for the batch rows they are told to keep: a
JAX-style ``torch.where`` over the whole cache would copy it every
dispatch.  :func:`reset_slots` and :func:`mask_cache_update` keep the JAX
semantics (new tensors); the engine uses the in-place :func:`wipe_slots_`.

Pipeline stages (:func:`slice_stage_params`, :func:`slice_stage_cache`,
:func:`stage_step`, :func:`paged_stage_step`, :func:`concat_stage_states`)
run a layer slice of a stage-sliceable family; :func:`step_with_cache` and
:func:`paged_step` are their one-stage case.

The migration wire format (:func:`extract_slot`, :func:`install_slot`,
:func:`extract_paged_slot`, :func:`install_paged_slot`) is host numpy with
the JAX keys, shapes and int32 ``pos``; bf16 leaves travel as float32
(exact, and JAX's install casts them to its cache dtype), and JAX's bf16
leaves are accepted by dtype name.
"""
from __future__ import annotations

import copy
import functools
import math
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, working_dtype
from repro_torch.distributed.expert_parallel import ep_moe_mix
from repro_torch.models import flags, ssd
from repro_torch.models.layers import (MLA, Attention, MoE, RMSNorm, SwiGLU,
                                       attention_fwd, cross_attention_fwd,
                                       cross_kv, mla_fwd, moe_dense_mix,
                                       moe_dispatch, paged_attention_fwd,
                                       paged_mla_fwd, softcap, swiglu)

Cache = Dict[str, object]       # leaves are tensors; zamba2 nests "groups"/"tail"


# --------------------------------------------------------------------------- #
# paging rules (copies of the JAX gates)
# --------------------------------------------------------------------------- #
def pageable(cfg: ModelConfig) -> bool:
    """Families whose cache is pure positional KV: dense/moe (incl. pure
    SWA), MLA, vlm.  Recurrent state (ssm/hybrid), encoder-decoder xattn and
    gemma-style local/global pairs stay on the contiguous path."""
    return (cfg.family not in ("ssm", "hybrid")
            and not cfg.is_encoder_decoder
            and cfg.local_global_every == 0)


def ring_window(cfg: ModelConfig) -> Optional[int]:
    """The window of a contiguous cache that rolls (pure-SWA configs), or
    None: the buffer then indexes by absolute position."""
    if cfg.sliding_window is not None and cfg.local_global_every == 0:
        return cfg.sliding_window
    return None


def paged_window(cfg: ModelConfig) -> Optional[int]:
    """Sliding window for the paged mask: a paged SWA cache stores every
    position and masks by window instead of ring-rotating."""
    return ring_window(cfg)


def rolling_rows(cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """Rows of the contiguous cache's rolling ring at ``seq_len`` — the
    pure-SWA buffer or gemma2's local buffer, ``min(window, seq_len)`` —
    or None.  Past them a prefill chunk would wrap the ring (the engine's
    chunk rule, the JAX ``Engine._rolling_limit``)."""
    return None if cfg.sliding_window is None else min(cfg.sliding_window, seq_len)


def _hybrid_shape(cfg: ModelConfig) -> Tuple[int, int, int]:
    """zamba2's stacks: (groups G, Mamba layers per group, tail layers)."""
    G = cfg.n_layers // cfg.attn_every
    return G, cfg.attn_every - 1, cfg.n_layers - G * cfg.attn_every


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype: Optional[torch.dtype] = None,
                     device: DeviceLike = None) -> Cache:
    """Zero-filled page pools ``{"kp", "vp"}`` of shape
    (L, n_pages, page_size, Hkv, D), or for MLA the latent pool
    ``{"ckvp"}`` (L, n_pages, page_size, r + d_rope).  Physical page 0 is
    the trash page."""
    if not pageable(cfg):
        raise ValueError(f"family {cfg.family!r} is not pageable")
    device = resolve_device(device)
    dtype = working_dtype(cfg) if dtype is None else dtype
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckvp": torch.zeros((cfg.n_layers, n_pages, page_size,
                                     m.kv_lora_rank + m.qk_rope_head_dim),
                                    dtype=dtype, device=device)}
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #
def _ffn_fwd(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or for the moe family: with the ``ep_shard`` flag set, the
    expert-parallel dense mix over its mesh
    (:func:`repro_torch.distributed.expert_parallel.ep_moe_mix`); else the
    MoE FFN named by the ``moe_impl`` flag: ``"dispatch"`` runs
    :func:`moe_dispatch`, anything else :func:`moe_dense_mix` (the JAX
    ``_ffn_fwd``)."""
    if cfg.family == "moe":
        ep = flags.get_flag("ep_shard")
        if ep is not None:
            return ep_moe_mix(p, cfg, x, ep["mesh"], ep.get("axis", "model"))
        impl = flags.get_flag("moe_impl")
        return (moe_dispatch if impl == "dispatch" else moe_dense_mix)(p, cfg, x)
    return swiglu(p, x)


class DecoderLayer(nn.Module):
    """Pre-norm decoder layer: rmsnorm → attention (GQA, or MLA when
    ``cfg.mla`` is set) → with ``cross``, rmsnorm ``ln_x`` → cross-attention
    ``xattn`` → rmsnorm → SwiGLU or MoE.  ``attend(attn, h)`` applies the
    attention weights against whichever cache the caller holds, and
    ``cross(xattn, h)`` the cross-attention's against the encoder's keys
    (the JAX ``_decoder_layer_fwd`` / ``_paged_decoder_layer_fwd``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None,
                 cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = (MLA if cfg.mla is not None else Attention)(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ffn = (MoE(cfg, dtype, device) if cfg.family == "moe" else
                    SwiGLU(cfg.d_model, cfg.d_ff, dtype, device))
        if cross:
            self.ln_x = RMSNorm(cfg.d_model, cfg.norm_eps, device)
            self.xattn = Attention(cfg, dtype, device)

    def forward(self, x, attend, cross=None):
        x = x + attend(self.attn, self.ln1(x))
        if cross is not None:
            x = x + cross(self.xattn, self.ln_x(x))
        return x + _ffn_fwd(self.ffn, self.cfg, self.ln2(x))


class MambaLayer(nn.Module):
    """rmsnorm → Mamba-2 mixer, residual (the JAX ``_mamba_layer_fwd``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mixer = ssd.Mamba2(cfg, dtype, device)

    def forward(self, x, state=None):
        out, new_state = self.mixer(self.ln(x), state)
        return x + out, new_state


class LM(nn.Module):
    """Decoder-only LM.  Parameter names mirror the JAX pytree, one index
    per stacked axis (``layers.{l}.attn.wq`` ↔ ``layers/attn/wq[l]``,
    ``layers.{l}.attn.wkv_a`` ↔ ``layers/attn/wkv_a[l]`` for MLA,
    ``layers.{l}.ffn.router`` ↔ ``layers/ffn/router[l]``,
    ``layers.{l}.mixer.in_proj.w`` ↔ ``layers/mixer/in_proj/w[l]``;
    gemma2 ``layer_pairs.{i}.{j}.attn.wq`` ↔ ``layer_pairs/attn/wq[i, j]``,
    j = 0 local, 1 global; zamba2 ``mamba_groups.{g}.{i}.…`` ↔
    ``mamba_groups/…[g, i]``, ``mamba_tail.{i}.…`` ↔ ``mamba_tail/…[i]``,
    ``shared_attn.…`` ↔ ``shared_attn/…``; whisper ``enc_pos``,
    ``enc_layers.{l}.…`` ↔ ``enc_layers/…[l]``, ``enc_norm.scale``,
    ``layers.{l}.xattn.wq`` ↔ ``layers/xattn/wq[l]``)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        # "meta": shapes only, nothing allocated (the sharding rules' walk)
        device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        dtype = working_dtype(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.zeros((cfg.vocab_size, cfg.d_model), dtype=dtype, device=device),
            requires_grad=False)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros((cfg.d_model, cfg.vocab_size), dtype=dtype,
                            device=device), requires_grad=False)
        stack = lambda layer, n: nn.ModuleList(layer(cfg, dtype, device)
                                               for _ in range(n))
        if cfg.family == "hybrid":
            G, per, tail = _hybrid_shape(cfg)
            self.mamba_groups = nn.ModuleList(stack(MambaLayer, per) for _ in range(G))
            if tail:
                self.mamba_tail = stack(MambaLayer, tail)
            self.shared_attn = DecoderLayer(cfg, dtype, device)
        elif cfg.local_global_every == 2:
            self.layer_pairs = nn.ModuleList(stack(DecoderLayer, 2)
                                             for _ in range(cfg.n_layers // 2))
        elif cfg.is_encoder_decoder:
            self.enc_pos = nn.Parameter(
                torch.zeros((cfg.n_frames, cfg.d_model), dtype=dtype, device=device),
                requires_grad=False)
            self.enc_layers = stack(DecoderLayer, cfg.n_encoder_layers)
            self.enc_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
            self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, device, cross=True)
                                        for _ in range(cfg.n_layers))
        else:
            self.layers = stack(MambaLayer if cfg.family == "ssm" else DecoderLayer,
                                cfg.n_layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head


def _init_scale(cfg: ModelConfig, name: str, shape) -> float:
    """lm.init_params' distributions: uniform ±1/√d_in for matrices, d_in
    being the second-to-last axis (the expert tensors (E, d_in, d_out) too;
    the embedding and whisper's ``enc_pos`` use 1/√d_model), zeros for
    biases and norm scales."""
    if len(shape) < 2:
        return 0.0
    if name in ("embed", "enc_pos"):
        return 1.0 / math.sqrt(cfg.d_model)
    return 1.0 / math.sqrt(shape[-2])


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> LM:
    """Fresh random weights drawn from ``generator`` (seed 0 on the CPU when
    None) in parameter order, on the generator's device, then stored on
    ``device`` in the working dtype (norm scales and the mixer's vectors in
    f32).  The Mamba-2 mixer's ``A_log``, ``D`` and ``dt_bias`` follow
    ``init_mamba2`` (:func:`repro_torch.models.ssd.init_vector`)."""
    model = LM(cfg, device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            vec = None
            if ".mixer." in name and p.dim() == 1:
                vec = ssd.init_vector(name.rsplit(".", 1)[-1], p.shape[0], gen)
            s = _init_scale(cfg, name, p.shape)
            if vec is not None:
                p.copy_(vec)
            elif s == 0.0:
                p.zero_()
            else:
                p.copy_(torch.empty(p.shape, dtype=torch.float32,
                                    device=gen.device).uniform_(-s, s, generator=gen))
    return model


# stacked subtrees of the JAX pytree and their stack axes
_STACKS = {"layers": 1, "layer_pairs": 2, "mamba_groups": 2, "mamba_tail": 1,
           "shared_attn": 0, "enc_layers": 1, "enc_norm": 0}


def named_from_jax(cfg: ModelConfig, np_params: Mapping) -> Dict[str, object]:
    """A JAX-layout pytree (stacks with their leading axes, :data:`_STACKS`;
    numpy or tensor leaves) → the port's parameter names, one index per
    stacked axis (the map behind :func:`params_from_jax`, inverted by
    :func:`params_to_jax`)."""
    flat: Dict[str, np.ndarray] = {"embed": np_params["embed"],
                                   "final_norm.scale": np_params["final_norm"]["scale"]}
    for top in ("lm_head", "enc_pos"):
        if top in np_params:
            flat[top] = np_params[top]

    def walk(top: str, depth: int, prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(top, depth, f"{prefix}.{k}" if prefix else k, v)
            return
        arr = node if isinstance(node, torch.Tensor) else np.asarray(node)
        for idx in np.ndindex(*arr.shape[:depth]):
            flat[".".join([top, *map(str, idx), prefix])] = arr[idx]
    for top, depth in _STACKS.items():
        if top in np_params:
            walk(top, depth, "", np_params[top])
    return flat


def params_from_jax(cfg: ModelConfig, np_params: Mapping,
                    device: DeviceLike = None) -> LM:
    """Build the port's model from the JAX parameter pytree given as numpy
    arrays (``jax.tree.map(np.asarray, params)``): a plain copy, since both
    keep the ``(d_in, d_out)`` layout.  Takes numpy only — no JAX import."""
    model = LM(cfg, device)
    flat = named_from_jax(cfg, np_params)
    names = dict(model.named_parameters())
    if set(flat) != set(names):
        raise ValueError(f"parameter mismatch: missing {sorted(set(names) - set(flat))}"
                         f", unexpected {sorted(set(flat) - set(names))}")
    with torch.no_grad():
        for name, p in names.items():
            src = _to_torch(flat[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
    return model


def params_to_jax(cfg: ModelConfig, named: Mapping[str, object],
                  convert: Optional[Callable] = None) -> Dict[str, object]:
    """The inverse of :func:`params_from_jax`'s name map: tensors (or numpy
    arrays) under the port's parameter names — the model's, or any dict
    keyed like them, as the optimizer's moments are — laid out as the JAX
    parameter pytree, each stack with its leading axes (:data:`_STACKS`;
    ``torch.stack`` or ``np.stack``).  ``convert`` is applied to each leaf
    as soon as it is stacked (a host copy keeps one stack on the device at
    a time)."""
    groups: Dict[Tuple[str, ...], Dict[Tuple[int, ...], object]] = {}
    for name, leaf in named.items():
        parts = name.split(".")
        depth = _STACKS.get(parts[0], 0)
        idx = tuple(int(i) for i in parts[1:1 + depth])
        groups.setdefault((parts[0], *parts[1 + depth:]), {})[idx] = leaf
    tree: Dict[str, object] = {}
    for path, items in groups.items():
        depth = _STACKS.get(path[0], 0)
        if depth:
            shape = tuple(max(i[a] for i in items) + 1 for a in range(depth))
            leaves = [items[i] for i in np.ndindex(*shape)]
            stack = torch.stack if isinstance(leaves[0], torch.Tensor) else np.stack
            leaf = stack(leaves).reshape(*shape, *leaves[0].shape)
        else:
            leaf = items[()]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf if convert is None else convert(leaf)
    return tree


def _to_torch(arr) -> torch.Tensor:
    arr = np.array(arr, order="C", copy=True)    # JAX hands out read-only views
    if arr.dtype.name == "bfloat16":           # ml_dtypes bf16 from JAX
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy for the wire format; bf16 becomes float32 (exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def cache_from_numpy(cache: Mapping, device: DeviceLike = None) -> Cache:
    """A JAX cache given as numpy arrays → port tensors, leaf by leaf (any
    of :func:`init_cache`'s or :func:`init_paged_cache`'s layouts, nested
    dicts included)."""
    device = resolve_device(device)
    return _map_leaves(lambda path, leaf: _to_torch(leaf).to(device), cache)


paged_cache_from_numpy = cache_from_numpy


def _embed(model: LM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings; gemma2 scales them by √d_model rounded to the
    working dtype first, as the reference does."""
    x = model.embed[tokens]
    if cfg.local_global_every:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _logits(model: LM, cfg: ModelConfig, x: torch.Tensor,
            last_only: bool) -> torch.Tensor:
    """Final norm and head, f32 logits; ``last_only`` keeps the last
    position (rows are independent, so it is normalised alone)."""
    if last_only:
        x = x[:, -1:].contiguous()
    logits = (model.final_norm(x) @ model.head()).float()
    return softcap(logits, cfg.final_logit_softcap)


# --------------------------------------------------------------------------- #
# full-sequence forward
# --------------------------------------------------------------------------- #
# the "dots" policy: keep the outputs of matrix products without batch
# dimensions (the counterpart of ``dots_with_no_batch_dims_saveable``)
_DOTS = functools.partial(ckpt.create_selective_checkpoint_contexts,
                          [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _maybe_remat(fn: Callable) -> Callable:
    """``fn`` checkpointed as the ``remat`` flag says, while autograd
    records a graph: ``"full"`` keeps only its inputs and recomputes it in
    the backward, ``"dots"`` also keeps the ``aten.mm``/``aten.addmm``
    outputs, ``"none"`` keeps everything.  Under ``no_grad`` or
    ``inference_mode`` ``fn`` runs as it is."""
    pol = flags.get_flag("remat")
    if pol == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"context_fn": _DOTS} if pol == "dots" else {}
    return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def encode(model: LM, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over frame embeddings (B, F, d): ``enc_pos`` added,
    then per layer (one remat unit) self-attention with RoPE at the frame
    positions 0 … F−1 and SwiGLU, then ``enc_norm`` (the encoder of the
    JAX ``forward``).  The self-attention is causal, as the JAX encoder's
    is: it passes ``causal=False``, which the JAX ``attention_fwd`` ignores
    in full-sequence mode.  Returns (B, F, d) in the working dtype."""
    x = frames.to(model.enc_pos.dtype) + model.enc_pos[None]
    B, F, _ = x.shape
    fpos = torch.arange(F, device=x.device)[None].expand(B, F)

    def enc_body(layer, h):
        h = h + attention_fwd(layer.attn, cfg, layer.ln1(h), fpos, None)
        return h + swiglu(layer.ffn, layer.ln2(h))
    for layer in model.enc_layers:
        x = _maybe_remat(functools.partial(enc_body, layer))(x)
    return model.enc_norm(x)


def fill_cross_cache(model: LM, cfg: ModelConfig, cache: Cache,
                     enc_out: torch.Tensor) -> Cache:
    """Write each decoder layer's cross-attention keys and values of the
    encoder output (B, F, d), one row per cache slot, into the cache's
    ``xk``/``xv`` in place.  The serving engine never calls it: like the
    JAX engine, it serves with the zeros :func:`init_cache` gives."""
    for l, layer in enumerate(model.layers):
        xk, xv = cross_kv(layer.xattn, cfg, enc_out)
        cache["xk"][l].copy_(xk)
        cache["xv"][l].copy_(xv)
    return cache


def forward(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward from position 0 without a cache (the JAX
    ``forward``). tokens (B, S) → logits (B, S, V); an encoder-decoder
    config also takes the frame embeddings (B, F, d), runs :func:`encode`
    and cross-attends every decoder layer to it.

    The remat units are the reference's scan bodies, each wrapped by
    :func:`_maybe_remat`: a layer of the dense, moe and ssm stacks, a
    (local, global) pair, a zamba2 group (its Mamba layers, then the shared
    block), a tail layer, an encoder layer, and a decoder layer with its
    cross-attention keys and values."""
    B, S = tokens.shape
    x = _embed(model, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    attend = lambda window: lambda a, h: (
        mla_fwd(a, cfg, h, positions) if cfg.mla is not None else
        attention_fwd(a, cfg, h, positions, window))
    unit = lambda fn, *args: _maybe_remat(functools.partial(fn, *args))
    mamba = lambda layer, h: layer(h)[0]
    if cfg.family == "ssm":
        for layer in model.layers:
            x = unit(mamba, layer)(x)
    elif cfg.family == "hybrid":
        def group_body(group, h):
            for layer in group:
                h = layer(h)[0]
            return model.shared_attn(h, attend(None))
        for group in model.mamba_groups:
            x = unit(group_body, group)(x)
        for layer in getattr(model, "mamba_tail", ()):
            x = unit(mamba, layer)(x)
    elif cfg.local_global_every == 2:
        def pair_body(local, glob, h):
            return glob(local(h, attend(cfg.sliding_window)), attend(None))
        for local, glob in model.layer_pairs:
            x = unit(pair_body, local, glob)(x)
    elif cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name}: forward needs frame embeddings")
        enc = encode(model, cfg, frames)

        def dec_body(layer, h, enc):
            xk, xv = cross_kv(layer.xattn, cfg, enc)
            return layer(h, attend(None),
                         lambda a, q: cross_attention_fwd(a, cfg, q, xk, xv))
        for layer in model.layers:
            x = unit(dec_body, layer)(x, enc)
    else:
        for layer in model.layers:
            x = unit(lambda layer, h: layer(h, attend(cfg.sliding_window)), layer)(x)
    return _logits(model, cfg, x, last_only=False)


# --------------------------------------------------------------------------- #
# contiguous per-slot cache
# --------------------------------------------------------------------------- #
def cache_seq_len(cfg: ModelConfig, seq_len: int) -> int:
    """Physical KV buffer length (rolling buffer for pure-SWA archs)."""
    window = ring_window(cfg)
    return seq_len if window is None else min(window, seq_len)


def init_cache(cfg: ModelConfig, B: int, seq_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Cache:
    """Zero-filled contiguous cache for ``B`` slots of up to ``seq_len``
    positions, with the JAX keys: dense ``{"k", "v"}`` (L, B, S, Hkv, D)
    and ``"pos"`` (L, B, S) int32 filled with -1, ``S = cache_seq_len(cfg,
    seq_len)`` (a ring for a sliding-window config); MLA ``{"ckv"}``
    (L, B, S, r + d_rope) and ``"pos"``; ssm ``{"conv"}``
    (L, B, d_conv-1, conv_dim) and ``{"ssm"}`` (L, B, h, p, n); gemma2
    ``loc_{k,v,pos}`` (L/2, B, min(window, seq_len), …) and
    ``glob_{k,v,pos}`` (L/2, B, seq_len, …); zamba2 ``groups`` =
    ``{conv, ssm}`` (G, per_group, B, …), ``attn_{k,v,pos}`` (G, B,
    seq_len, …) and ``tail`` = ``{conv, ssm}`` (trailing, B, …); whisper
    the dense keys and ``{"xk", "xv"}`` (L, B, n_frames, Hkv, D), zeros.
    ``device="meta"`` gives the shapes alone (the dry run's specs)."""
    device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    dtype = working_dtype(cfg) if dtype is None else dtype

    def kv(n: int, S: int, prefix: str = "") -> Cache:
        shape = (n, B, S, cfg.n_kv_heads, cfg.d_head)
        return {f"{prefix}k": torch.zeros(shape, dtype=dtype, device=device),
                f"{prefix}v": torch.zeros(shape, dtype=dtype, device=device),
                f"{prefix}pos": torch.full((n, B, S), -1, dtype=torch.int32,
                                           device=device)}

    def ssm(*stack: int) -> Cache:
        s = cfg.ssm
        conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
        return {"conv": torch.zeros((*stack, B, s.d_conv - 1, conv_dim), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((*stack, B, s.n_heads(cfg.d_model), s.head_dim,
                                    s.d_state), dtype=dtype, device=device)}

    L = cfg.n_layers
    if cfg.family == "ssm":
        return ssm(L)
    if cfg.family == "hybrid":
        G, per, tail = _hybrid_shape(cfg)
        c = {"groups": ssm(G, per), **kv(G, seq_len, "attn_")}
        if tail:
            c["tail"] = ssm(tail)
        return c
    if cfg.local_global_every == 2:
        return {**kv(L // 2, rolling_rows(cfg, seq_len), "loc_"),
                **kv(L // 2, seq_len, "glob_")}
    S = cache_seq_len(cfg, seq_len)
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros((L, B, S, m.kv_lora_rank + m.qk_rope_head_dim),
                                   dtype=dtype, device=device),
                "pos": torch.full((L, B, S), -1, dtype=torch.int32, device=device)}
    if cfg.is_encoder_decoder:
        shape = (L, B, cfg.n_frames, cfg.n_kv_heads, cfg.d_head)
        return {**kv(L, S), "xk": torch.zeros(shape, dtype=dtype, device=device),
                "xv": torch.zeros(shape, dtype=dtype, device=device)}
    return kv(L, S)


def step_with_cache(model: LM, cfg: ModelConfig, cache: Cache,
                    tokens: torch.Tensor, pos2: torch.Tensor, *,
                    rows: Optional[Tuple[int, int]] = None,
                    write: Optional[torch.Tensor] = None,
                    last_only: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Cache-backed forward over a token chunk, contiguous cache edition.

    tokens/pos2: (n, C) int for the batch rows ``rows = (lo, hi)`` of the
    cache (None: all of them); positions run contiguously per row.  Only
    the rows listed in ``write`` ((k,) int64 offsets into ``lo:hi``, on the
    cache's device; None: all) keep their updates — the JAX step followed
    by ``mask_cache_update`` — and they are written in place.  Attention
    rows outside ``write`` attend nothing (zeros).  SSM rows continue from
    their carried state: S == 1 runs the recurrent step, S > 1 the chunked
    scan.  A sliding-window config writes its ring at ``pos2 % S``; a
    chunk must not wrap it (the engine's chunk rule).  An encoder-decoder
    config cross-attends each layer to its ``xk``/``xv`` rows, all
    ``n_frames`` of them (none for rows outside ``write``).  Returns logits
    (n, C, V) in f32, or (n, 1, V) when ``last_only``, and the cache.
    """
    if stage_sliceable(cfg):
        return stage_step(model, cfg, cache, tokens, pos2, first=True, last=True,
                          rows=rows, write=write, last_only=last_only)
    n, C = tokens.shape
    lo, hi = _rows_of(cache, rows, n)
    pos2 = pos2.long()
    x = _embed(model, cfg, tokens)
    active = _active_rows(n, write, tokens.device)

    def mamba(layer, x, conv, ssm_st):
        return _mamba_write(layer, x, conv, ssm_st, write)

    def attend(layer, x, prefix: str, l: int, window: Optional[int], cross=None):
        """``layer`` against buffer ``l`` of the ``{prefix}k/v`` stack."""
        kv = (cache[f"{prefix}k"][l, lo:hi], cache[f"{prefix}v"][l, lo:hi])
        return layer(x, lambda a, h: attention_fwd(a, cfg, h, pos2, window,
                                                   kv_cache=kv, active=active), cross)

    if cfg.family == "hybrid":
        _write_pos(cache["attn_pos"][:, lo:hi], pos2, active, ring=False)
        groups = cache["groups"]
        for g, group in enumerate(model.mamba_groups):
            for i, layer in enumerate(group):
                x = mamba(layer, x, groups["conv"][g, i, lo:hi], groups["ssm"][g, i, lo:hi])
            x = attend(model.shared_attn, x, "attn_", g, None)
        for i, layer in enumerate(getattr(model, "mamba_tail", ())):
            x = mamba(layer, x, cache["tail"]["conv"][i, lo:hi],
                      cache["tail"]["ssm"][i, lo:hi])
    elif cfg.local_global_every == 2:
        _write_pos(cache["loc_pos"][:, lo:hi], pos2, active, ring=True)
        _write_pos(cache["glob_pos"][:, lo:hi], pos2, active, ring=False)
        for i, (local, glob) in enumerate(model.layer_pairs):
            x = attend(local, x, "loc_", i, cfg.sliding_window)
            x = attend(glob, x, "glob_", i, None)
    else:                                   # encoder-decoder
        window = ring_window(cfg)
        _write_pos(cache["pos"][:, lo:hi], pos2, active, ring=window is not None)
        xlen = torch.where(active, cache["xk"].shape[2], 0).to(torch.int32)
        for l, layer in enumerate(model.layers):
            cross = lambda a, h: cross_attention_fwd(
                a, cfg, h, cache["xk"][l, lo:hi], cache["xv"][l, lo:hi], xlen)
            x = attend(layer, x, "", l, window, cross)
    return _logits(model, cfg, x, last_only), cache


def _rows_of(cache: Cache, rows: Optional[Tuple[int, int]], n: int) -> Tuple[int, int]:
    lo, hi = (0, _batch_size(cache)) if rows is None else rows
    if hi - lo != n:
        raise ValueError(f"rows {lo}:{hi} do not match {n} token rows")
    return lo, hi


def _active_rows(n: int, write: Optional[torch.Tensor], device) -> torch.Tensor:
    """(n,) bool: the rows listed in ``write`` (None: all)."""
    active = torch.ones(n, dtype=torch.bool, device=device)
    if write is not None:
        active = torch.zeros_like(active).index_fill_(0, write, True)
    return active


def _mamba_write(layer, x: torch.Tensor, conv: torch.Tensor, ssm_st: torch.Tensor,
                 write: Optional[torch.Tensor]) -> torch.Tensor:
    """One Mamba layer from a slot range's state, kept for ``write``."""
    x, (c2, s2) = layer(x, (conv, ssm_st))
    if write is None:
        conv.copy_(c2)
        ssm_st.copy_(s2)
    else:
        conv.index_copy_(0, write, c2.index_select(0, write).to(conv.dtype))
        ssm_st.index_copy_(0, write, s2.index_select(0, write).to(ssm_st.dtype))
    return x


def _write_pos(pos: torch.Tensor, pos2: torch.Tensor, active: torch.Tensor,
               ring: bool) -> None:
    """Record this chunk's positions (n, C) in every layer's position
    buffer ``pos`` (N, n, S) for the ``active`` rows: at ``pos2 % S`` on a
    ring, else at ``pos2``."""
    n, C = pos2.shape
    r = torch.arange(n, device=pos2.device)[:, None].expand(n, C)
    slots = pos2 % pos.shape[2] if ring else pos2
    pos[:, r, slots] = torch.where(active[:, None], pos2.to(pos.dtype), pos[:, r, slots])


def decode_step(model: LM, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """One decoding step. tokens: (B, 1); positions: (B,).  Returns
    (logits (B, 1, V), cache updated in place)."""
    return step_with_cache(model, cfg, cache, tokens, positions[:, None])


def prefill_step(model: LM, cfg: ModelConfig, cache: Cache,
                 tokens: torch.Tensor, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, Cache]:
    """Chunked prefill: advance C tokens against the cache in one dispatch.
    tokens/positions: (B, C), contiguous per row.  Returns (logits
    (B, C, V), cache updated in place)."""
    return step_with_cache(model, cfg, cache, tokens, positions)


# --------------------------------------------------------------------------- #
# cache leaves (zamba2 nests "groups" and "tail")
# --------------------------------------------------------------------------- #
def _leaves(cache: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(key path, leaf) of every leaf of a (nested) cache dict."""
    for k, v in cache.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _map_leaves(fn: Callable, cache: Mapping, *others: Mapping,
                path: Tuple[str, ...] = ()) -> Dict[str, object]:
    """The same nesting with ``fn(path, leaf, *other leaves)`` at each leaf."""
    return {k: (_map_leaves(fn, v, *(o[k] for o in others), path=path + (k,))
                if isinstance(v, Mapping) else fn(path + (k,), v, *(o[k] for o in others)))
            for k, v in cache.items()}


def _stack_depth(path: Tuple[str, ...]) -> int:
    """Stack axes before the batch axis: 2 for zamba2's group state
    (G, per_group), 1 everywhere else (the JAX ``_stack_depth``)."""
    return 2 if path[0] == "groups" else 1


def _slot_index(path: Tuple[str, ...], slot) -> tuple:
    return (slice(None),) * _stack_depth(path) + (slot,)


def _batch_size(cache: Mapping) -> int:
    path, leaf = next(_leaves(cache))
    return leaf.shape[_stack_depth(path)]


def _leaf_init(path: Tuple[str, ...]) -> int:
    return -1 if path[-1].endswith("pos") else 0


def _slot_mask(path: Tuple[str, ...], leaf: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    d = _stack_depth(path)
    return flags.bool().reshape((1,) * d + (-1,) + (1,) * (leaf.dim() - d - 1))


def reset_slots(cfg: ModelConfig, cache: Cache, reset: torch.Tensor) -> Cache:
    """JAX semantics, new tensors: the slots flagged in ``reset`` (B,) bool
    go back to empty — position buffers to -1, KV and recurrent state to
    zero.  A reused slot must be wiped before its first chunk: recurrent
    state is continued unconditionally."""
    return _map_leaves(lambda p, leaf: torch.where(
        _slot_mask(p, leaf, reset), torch.full_like(leaf, _leaf_init(p)), leaf), cache)


def mask_cache_update(cfg: ModelConfig, old_cache: Cache, new_cache: Cache,
                      active: torch.Tensor) -> Cache:
    """JAX semantics, new tensors: keep updates only for the slots flagged
    in ``active`` (B,) bool; inactive slots keep the old cache."""
    return _map_leaves(lambda p, old, new: torch.where(_slot_mask(p, old, active), new, old),
                       old_cache, new_cache)


def wipe_slots_(cache: Cache, slots: Sequence[int]) -> Cache:
    """:func:`reset_slots` in place for the listed slots."""
    for path, leaf in _leaves(cache):
        for s in slots:
            leaf[_slot_index(path, s)].fill_(_leaf_init(path))
    return cache


# --------------------------------------------------------------------------- #
# paged step
# --------------------------------------------------------------------------- #
def paged_step(model: LM, cfg: ModelConfig, cache: Cache,
               tokens: torch.Tensor, pos2: torch.Tensor, ptab: torch.Tensor,
               active: torch.Tensor, *, page_size: int,
               last_only: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Cache-backed forward over a token chunk, paged pool edition.

    tokens/pos2: (B, C) int; ptab: (B, n_ptab) logical block → physical page
    (0 = unmapped/trash); active: (B,) bool.  The write index is computed
    once and shared by every layer: active lanes scatter into their mapped
    page at ``pos % page_size``, inactive lanes into the trash page at
    ``arange(C) % page_size``.  Valid kv length per lane is
    ``pos2[:, -1] + 1`` (0 when inactive).  The pools in ``cache`` are
    updated in place and returned.  Returns logits (B, C, V) in f32, or
    (B, 1, V) for the last position only when ``last_only``.
    """
    return paged_stage_step(model, cfg, cache, tokens, pos2, ptab, active,
                            page_size=page_size, first=True, last=True,
                            last_only=last_only)


def paged_indices(pos2: torch.Tensor, ptab: torch.Tensor, active: torch.Tensor,
                  page_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lens, ptab, widx) of a paged chunk, shared by every layer: ``lens``
    (B,) int32 valid keys after the chunk (0 when inactive), ``ptab`` as
    contiguous int32, ``widx`` (B·C,) flat pool rows, inactive lanes
    diverted into the trash page at ``arange(C) % page_size``."""
    C = pos2.shape[1]
    active = active.bool()
    pos2 = pos2.long()
    lens = torch.where(active, pos2[:, -1] + 1, 0).to(torch.int32)
    ptab = ptab.to(torch.int32).contiguous()
    phys = torch.gather(ptab.long(), 1, pos2 // page_size)            # (B, C)
    widx = phys * page_size + pos2 % page_size
    trash = (torch.arange(C, device=pos2.device) % page_size)[None, :]
    return lens, ptab, torch.where(active[:, None], widx, trash).reshape(-1)


# --------------------------------------------------------------------------- #
# pipeline stages (layer-granular slicing for pp replicas)
# --------------------------------------------------------------------------- #
def stage_sliceable(cfg: ModelConfig) -> bool:
    """Families whose layers are ONE homogeneous stack and whose contiguous
    cache stacks every leaf on a leading layer axis, so a pipeline stage is
    a pure ``[lo:hi]`` slice: dense/moe (incl. pure SWA), MLA, vlm, and
    plain SSM.  Hybrid groups, encoder-decoder cross-attention and
    gemma-style local/global pairs stay at pp=1."""
    return (cfg.family != "hybrid"
            and not cfg.is_encoder_decoder
            and cfg.local_global_every == 0)


class Stage:
    """One pipeline stage's parameters over layers ``[lo, hi)``: the layer
    modules (shared with the whole model, not copied), the embedding on the
    first stage, the final norm and head on the last — the embedding again
    for tied configs, so those hold the table on both end stages.  Duck-types
    :class:`LM` for :func:`stage_step` and :func:`paged_stage_step`."""

    def __init__(self, cfg: ModelConfig, layers, embed=None, final_norm=None,
                 lm_head=None):
        self.cfg = cfg
        self.layers = list(layers)
        self.embed = embed
        self.final_norm = final_norm
        self.lm_head = lm_head

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head

    def to(self, device: torch.device) -> "Stage":
        """This stage on ``device``: itself when already there, else a copy."""
        if self.device == device:
            return self
        mv = lambda m: None if m is None else copy.deepcopy(m).to(device)
        tv = lambda t: None if t is None else t.to(device)
        return Stage(self.cfg, [mv(layer) for layer in self.layers], tv(self.embed),
                     mv(self.final_norm), tv(self.lm_head))

    @property
    def device(self) -> torch.device:
        return next(self.named_parameters())[1].device

    def named_parameters(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """:class:`LM`'s names, the layers numbered from 0 within the stage."""
        for name, t in (("embed", self.embed), ("lm_head", self.lm_head)):
            if t is not None:
                yield name, t
        if self.final_norm is not None:
            yield "final_norm.scale", self.final_norm.scale
        for i, layer in enumerate(self.layers):
            for name, t in layer.named_parameters():
                yield f"layers.{i}.{name}", t


def slice_stage_params(cfg: ModelConfig, model: LM, lo: int, hi: int,
                       first: bool, last: bool) -> Stage:
    """Parameters of one pipeline stage over layers ``[lo, hi)`` (the JAX
    ``slice_stage_params``): the layer modules of ``model`` themselves, the
    embedding on the first stage (and on the last for tied configs), the
    final norm and LM head on the last."""
    return Stage(cfg, model.layers[lo:hi],
                 model.embed if first or (last and cfg.tie_embeddings) else None,
                 model.final_norm if last else None,
                 model.lm_head if last and not cfg.tie_embeddings else None)


def slice_stage_cache(cache: Cache, lo: int, hi: int) -> Cache:
    """Cache slice for layers ``[lo, hi)``: views of every leaf's leading
    layer axis (stage-sliceable families stack every leaf on it)."""
    return _map_leaves(lambda path, t: t[lo:hi], cache)


def concat_stage_states(parts: Sequence[Mapping]) -> Dict[str, object]:
    """Reassemble per-stage extracts (host numpy, leading layer axis) into
    the full per-layer wire format — byte-identical to a single-engine
    extract, so a pipelined export installs anywhere."""
    return _map_leaves(lambda path, *ls: np.concatenate(ls, axis=0), *parts)


def stage_step(stage, cfg: ModelConfig, cache: Cache, x: torch.Tensor,
               pos2: torch.Tensor, *, first: bool, last: bool,
               rows: Optional[Tuple[int, int]] = None,
               write: Optional[torch.Tensor] = None,
               last_only: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Contiguous-cache forward over ONE pipeline stage's layer slice (the
    JAX ``stage_step``), with :func:`step_with_cache`'s ``rows``/``write``
    contract.  ``x`` is the int tokens (n, C) on the first stage and the
    previous stage's hidden state (n, C, d) otherwise; ``cache`` holds the
    stage's layers.  Returns logits on the last stage (as
    :func:`step_with_cache`) and the hidden state to hand off otherwise.
    Composing the stages in order reproduces :func:`step_with_cache`."""
    n = pos2.shape[0]
    lo, hi = _rows_of(cache, rows, n)
    pos2 = pos2.long()
    if first:
        x = _embed(stage, cfg, x)
    if cfg.family == "ssm":
        for l, layer in enumerate(stage.layers):
            x = _mamba_write(layer, x, cache["conv"][l, lo:hi], cache["ssm"][l, lo:hi],
                             write)
    else:
        active = _active_rows(n, write, pos2.device)
        if cfg.mla is not None:
            for l, layer in enumerate(stage.layers):
                kv = (cache["ckv"][l, lo:hi], cache["pos"][l, lo:hi])
                x = layer(x, lambda a, h: mla_fwd(a, cfg, h, pos2, kv_cache=kv,
                                                  active=active))
        else:
            window = ring_window(cfg)
            _write_pos(cache["pos"][:, lo:hi], pos2, active, ring=window is not None)
            for l, layer in enumerate(stage.layers):
                kv = (cache["k"][l, lo:hi], cache["v"][l, lo:hi])
                x = layer(x, lambda a, h: attention_fwd(a, cfg, h, pos2, window,
                                                        kv_cache=kv, active=active))
    if not last:
        return x, cache
    return _logits(stage, cfg, x, last_only), cache


def paged_stage_step(stage, cfg: ModelConfig, cache: Cache, x: torch.Tensor,
                     pos2: torch.Tensor, ptab: torch.Tensor, active: torch.Tensor,
                     *, page_size: int, first: bool, last: bool,
                     last_only: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Paged forward over ONE pipeline stage's layer slice of the pool (the
    JAX ``paged_stage_step``), with :func:`paged_step`'s contract.  The
    write indices are recomputed per stage from the same (pos2, ptab,
    active) — they are stage-invariant, so every stage scatters into the
    same page rows of its own layer slice.  Composing the stages in order
    reproduces :func:`paged_step`."""
    lens, ptab, widx = paged_indices(pos2, ptab, active, page_size)
    pos2 = pos2.long()
    if first:
        x = _embed(stage, cfg, x)
    if cfg.mla is not None:
        for layer, ckvp in zip(stage.layers, cache["ckvp"]):
            x = layer(x, lambda a, h: paged_mla_fwd(a, cfg, h, pos2, ckvp, ptab,
                                                    lens, widx))
    else:
        window = paged_window(cfg)
        for layer, kp, vp in zip(stage.layers, cache["kp"], cache["vp"]):
            x = layer(x, lambda a, h: paged_attention_fwd(
                a, cfg, h, pos2, window, kp, vp, ptab, lens, widx))
    if not last:
        return x, cache
    return _logits(stage, cfg, x, last_only), cache


# --------------------------------------------------------------------------- #
# per-slot cache migration (live KV/SSM state transfer across engines)
# --------------------------------------------------------------------------- #
class SlotMigrationError(ValueError):
    """A slot state cannot be installed into the target cache — shape/config
    mismatch, or the target buffers cannot hold the positions the request
    still attends to."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SlotMigrationError(msg)


def extract_slot(cfg: ModelConfig, cache: Cache, slot: int) -> Dict[str, object]:
    """One batch slot's KV/SSM state as a host copy: the (nested) cache
    dict with the batch axis removed, positions absolute (the JAX wire
    format)."""
    return _map_leaves(lambda p, leaf: _to_numpy(leaf[_slot_index(p, slot)]), cache)


def _install_copy(dst: torch.Tensor, src) -> torch.Tensor:
    """Position-independent state (SSM/conv recurrent state) for one slot:
    checked against the slot view ``dst`` (L, ...), returned as a tensor
    ready to copy in."""
    _require(tuple(src.shape) == tuple(dst.shape),
             f"state shape {tuple(src.shape)} != cache slot shape {tuple(dst.shape)}")
    return _to_torch(src).to(device=dst.device, dtype=dst.dtype)


def _install_attn(dst_leaves, src_leaves, dst_pos: torch.Tensor, src_pos,
                  slot: int, window: Optional[int], position: int) -> Callable[[], None]:
    """Check one slot's attention entries against the target buffers;
    returns the write that scatters them by absolute position, overwriting
    the whole slot.

    dst leaves: (N, B, S_dst, ...) sharing ``dst_pos`` (N, B, S_dst); src
    leaves: (N, S_src, ...) host arrays sharing ``src_pos`` (N, S_src).
    Non-rolling buffers (``window`` None) index by position; a ring indexes
    by ``position % S_dst`` and keeps positions ``>= position - S_dst``,
    refusing when one still inside the window would be lost (the JAX
    rule).  Beyond the JAX checks, every position the next decode reads —
    ``[0, position)``, or the ring's ``[position - S_dst + 1, position)`` —
    must be in the state: the port's kernels read a slot's first
    ``kv_len`` rows instead of masking by ``pos``.  Nothing is written
    before the returned write runs, so a caller checks every part of a
    state before it writes any.
    """
    src_pos = np.asarray(src_pos)
    N, S_src = src_pos.shape
    _require(dst_pos.shape[0] == N,
             f"layer-stack mismatch: {dst_pos.shape[0]} != {N}")
    S_dst = int(dst_pos.shape[2])
    valid = src_pos >= 0
    if window is None:
        _require(position < S_dst,
                 f"next decode position {position} outside target buffer of "
                 f"length {S_dst}")
        _require(not valid.any() or int(src_pos.max()) < S_dst,
                 f"cached position {int(src_pos.max())} outside target buffer "
                 f"of length {S_dst}")
        keep, lo = valid, 0
        dest = np.where(valid, src_pos, 0)
    else:
        keep = valid & (src_pos >= position - S_dst)
        _require(not (valid & (src_pos > position - window) & ~keep).any(),
                 f"target ring of length {S_dst} cannot hold the positions "
                 f"still visible inside window {window}")
        lo = max(0, position - S_dst + 1)
        dest = np.where(keep, src_pos, 0) % S_dst
    n_idx, s_idx = np.nonzero(keep)
    d_idx = dest[n_idx, s_idx]
    have = np.zeros((N, position + 1), bool)
    inside = src_pos[n_idx, s_idx] <= position
    have[n_idx[inside], src_pos[n_idx, s_idx][inside]] = True
    _require(bool(have[:, lo:position].all()),
             "state lacks positions the request still attends to")
    for dst, src in zip(dst_leaves, src_leaves):
        _require(tuple(src.shape[2:]) == tuple(dst.shape[3:])
                 and src.shape[0] == N and src.shape[1] == S_src,
                 f"attention state shape {tuple(src.shape)} incompatible "
                 f"with cache {tuple(dst.shape)}")

    def write() -> None:
        dev = dst_pos.device
        ni, si, di = (torch.from_numpy(a.astype(np.int64)).to(dev)
                      for a in (n_idx, s_idx, d_idx))
        for dst, src in zip(dst_leaves, src_leaves):
            buf = torch.zeros((N, S_dst) + tuple(dst.shape[3:]), dtype=dst.dtype,
                              device=dev)
            buf[ni, di] = _to_torch(src).to(device=dev, dtype=dst.dtype)[ni, si]
            dst[:, slot].copy_(buf)
        posbuf = torch.full((N, S_dst), -1, dtype=torch.int32, device=dev)
        posbuf[ni, di] = torch.from_numpy(src_pos.astype(np.int32)).to(dev)[ni, si]
        dst_pos[:, slot].copy_(posbuf)
    return write


def install_slot(cfg: ModelConfig, cache: Cache, slot: int, state: Mapping,
                 position: int) -> Cache:
    """Install an :func:`extract_slot` state (from the port or from JAX)
    into batch slot ``slot``, in place.

    ``position`` is the request's next decode position (its cache holds
    positions < ``position``).  The whole slot is overwritten, so a previous
    occupant can never leak through.  A sliding-window ring (the pure-SWA
    buffer, gemma2's local buffer) takes the state rotated by position;
    gemma2's global buffer and zamba2's per-group buffers index by it;
    recurrent state and whisper's ``xk``/``xv`` are copied whole.
    Raises :class:`SlotMigrationError` (cache untouched) when the state
    cannot be represented in the target cache; the caller then falls back
    to recompute-from-continuation.
    """
    try:
        writes = []

        def attn(prefix: str, keys, window: Optional[int]) -> None:
            writes.append(_install_attn(
                [cache[prefix + k] for k in keys], [state[prefix + k] for k in keys],
                cache[prefix + "pos"], state[prefix + "pos"], slot, window, position))

        def copied(dst: Cache, src: Mapping, stack: int,
                   keys=("conv", "ssm")) -> None:
            idx = (slice(None),) * stack + (slot,)
            for k in keys:
                t = _install_copy(dst[k][idx], src[k])
                writes.append(lambda k=k, t=t: dst[k][idx].copy_(t))

        if cfg.family == "ssm":
            copied(cache, state, 1)
        elif cfg.family == "hybrid":
            copied(cache["groups"], state["groups"], 2)
            if "tail" in cache:
                _require("tail" in state, "state lacks the mamba tail stack")
                copied(cache["tail"], state["tail"], 1)
            attn("attn_", ("k", "v"), None)
        elif cfg.mla is not None:
            attn("", ("ckv",), None)
        elif cfg.local_global_every == 2:
            attn("loc_", ("k", "v"), cfg.sliding_window)
            attn("glob_", ("k", "v"), None)
        else:
            attn("", ("k", "v"), ring_window(cfg))
            if cfg.is_encoder_decoder:
                copied(cache, state, 1, ("xk", "xv"))
        for write in writes:
            write()
        return cache
    except SlotMigrationError:
        raise
    except (KeyError, IndexError, TypeError, ValueError, RuntimeError) as e:
        raise SlotMigrationError(
            f"slot state incompatible with target cache: {e}") from e


def extract_paged_slot(cfg: ModelConfig, cache: Cache, pages: Sequence[int],
                       position: int, page_size: int) -> Dict[str, np.ndarray]:
    """Gather one request's pages into the *contiguous* extract format
    (:func:`extract_slot`'s layout), so a paged export installs into either
    a contiguous target (:func:`install_slot`) or a paged one
    (:func:`install_paged_slot`)."""
    pools = {"ckv": "ckvp"} if cfg.mla is not None else {"k": "kp", "v": "vp"}
    first = cache[next(iter(pools.values()))]
    idx = torch.as_tensor(list(pages), dtype=torch.long, device=first.device)
    S_src = len(pages) * page_size
    L = first.shape[0]
    ar = np.arange(S_src)
    pos_row = np.where(ar < position, ar, -1).astype(np.int32)
    out = {}
    for key, pool in pools.items():
        t = cache[pool][:, idx]
        out[key] = _to_numpy(t.reshape(L, S_src, *t.shape[3:]))
    out["pos"] = np.broadcast_to(pos_row, (L, S_src)).copy()
    return out


def install_paged_slot(cfg: ModelConfig, cache: Cache, pages: Sequence[int],
                       state: Mapping, position: int, page_size: int) -> Cache:
    """Scatter a contiguous-format slot state into freshly-owned pages, in
    place.  ``pages[j]`` is the physical page for logical block j (0 =
    trash for SWA blocks wholly outside the window).  Positions must be
    layer-uniform; raises :class:`SlotMigrationError` (pools untouched)
    when positions the request still attends to are missing from the state
    or fall in a trash block."""
    try:
        src_pos = np.asarray(state["pos"])
        L, S_src = src_pos.shape
        if cfg.mla is not None:
            dst_leaves, src_leaves = [cache["ckvp"]], [state["ckv"]]
        else:
            dst_leaves = [cache["kp"], cache["vp"]]
            src_leaves = [state["k"], state["v"]]
        _require(int(dst_leaves[0].shape[0]) == L,
                 f"layer-stack mismatch: {dst_leaves[0].shape[0]} != {L}")
        _require(bool((src_pos == src_pos[0]).all()),
                 "paged install requires layer-uniform cache positions")
        sp = src_pos[0]
        pages = list(pages)
        n_blocks = len(pages)
        S_buf = n_blocks * page_size
        _require(S_buf >= position,
                 f"{n_blocks} pages cannot hold {position} positions")
        window = paged_window(cfg)
        lo_req = 0 if window is None else max(position - window + 1, 0)
        keep = (sp >= 0) & (sp < position)
        have = np.zeros(S_buf, bool)
        have[sp[keep]] = True
        req = np.zeros(S_buf, bool)
        req[lo_req:position] = True
        for j, pid in enumerate(pages):
            if pid == 0:
                _require(not req[j * page_size:(j + 1) * page_size].any(),
                         "still-visible positions mapped to the trash page")
        _require(not (req & ~have).any(),
                 "state lacks positions the request still attends to")
        for dst, src in zip(dst_leaves, src_leaves):
            _require(src.shape[0] == L and src.shape[1] == S_src
                     and tuple(src.shape[2:]) == tuple(dst.shape[3:]),
                     f"state shape {tuple(src.shape)} incompatible with "
                     f"pool {tuple(dst.shape)}")
        jsel = [j for j, pid in enumerate(pages) if pid != 0]
        dev = dst_leaves[0].device
        pidx = torch.as_tensor([pages[j] for j in jsel], dtype=torch.long, device=dev)
        jidx = torch.as_tensor(jsel, dtype=torch.long, device=dev)
        kidx = torch.from_numpy(np.flatnonzero(keep)).to(dev)
        didx = torch.from_numpy(sp[keep].astype(np.int64)).to(dev)
        for dst, src in zip(dst_leaves, src_leaves):
            buf = torch.zeros((L, S_buf) + tuple(dst.shape[3:]), dtype=dst.dtype,
                              device=dev)
            buf[:, didx] = _to_torch(src).to(device=dev, dtype=dst.dtype)[:, kidx]
            blocks = buf.reshape(L, n_blocks, page_size, *buf.shape[2:])
            dst[:, pidx] = blocks[:, jidx]
        return cache
    except SlotMigrationError:
        raise
    except (KeyError, IndexError, TypeError, ValueError, RuntimeError) as e:
        raise SlotMigrationError(
            f"slot state incompatible with paged pool: {e}") from e

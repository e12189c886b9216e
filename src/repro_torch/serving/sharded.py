"""Sharded and pipelined replicas: TP × DP × PP engines on carved submeshes
of logical devices (port of ``src/repro/serving/sharded.py``).

Each :class:`~repro_torch.core.plan.ReplicaGroup` with ``tp·dp > 1``
becomes a :class:`ShardedEngine` on a private ``(dp, tp)`` submesh carved by
a :class:`SubmeshAllocator` from a set of logical devices
(:mod:`repro_torch.launch.mesh`).  A group with ``pp > 1`` becomes a
:class:`PipelinedEngine`: the layer stack is cut at the group's
``stage_cuts`` and each stage runs on its own ``(dp, tp)`` stage submesh, or,
without an allocator, every stage on the engine's device.

The reference commits parameters and caches onto a JAX mesh and lets GSPMD
partition one program.  The port has no GSPMD, so a sharded layer slice is a
:class:`ShardGroup` whose execution is written out per logical device:

* **Weights follow the decision.**  :func:`~repro_torch.distributed.sharding.sharding_decision`
  gives every parameter its spec (``fsdp_axis=None``: serving replicas
  replicate weights across ``data``).  A leaf the spec shards on ``model``
  is held in slices, one per logical device; a replicated leaf is held whole
  on every device of the submesh (one tensor where devices share a card).
* **Megatron TP.**  ``wq``/``wk``/``wv`` (and their biases) and
  ``w_gate``/``w_up`` are column-split, ``wo`` and ``w_down`` row-split; each
  shard runs the port's layer functions on its heads (a shard config of
  ``H/tp`` query and ``Hkv/tp`` KV heads), and the row-parallel partials are
  summed in shard order.  RMSNorm runs on the full hidden state on every
  shard.  The embedding is vocab-parallel (each shard looks up the rows it
  holds, zeros elsewhere, summed), the head too, with the logits gathered
  before the argmax.
* **EP** (mixtral) through :func:`~repro_torch.distributed.expert_parallel.ep_moe_partials`:
  whole experts per shard, the grouped SwiGLU kernel per shard.
* **The KV cache splits by KV heads** — the paged pool as the reference's
  ``paged_cache_pspecs`` says, and the contiguous cache too (the reference
  splits its sequence axis; a sequence split decode needs a cross-shard
  softmax combine that the CUDA decode does not expose, and a head split
  holds the same bytes per device).  Each shard decodes its own slice (the
  per-shard body of :func:`~repro_torch.kernels.flash_decode.ops.sharded_paged_flash_decode`)
  and runs flash attention for prefill chunks on its heads.
* **KV-head fallback.**  Where ``Hkv % tp != 0`` (qwen2-1.5b at tp 4) the
  cache is replicated on every shard and the fallback is recorded as the
  reference records it; each shard gathers the column-split K/V, writes the
  whole cache, and decodes its query heads against the KV head they map to
  through a row-table view of the replicated pool
  (:func:`~repro_torch.kernels.flash_decode.ops.kv_head_rows`) — the same
  CUDA kernels, no copy.
* **DP** splits the slot lanes over ``data`` when ``_batch_entry`` says so
  (each data row computes its own lanes; a paged pool is replicated over
  ``data`` and the rows' writes are copied to the other rows' pools after
  each dispatch); otherwise every data row computes every lane.
* **PP** stages hand the hidden state (d_model·dtype bytes per token) to the
  next stage's device; prefill chunks are streamed in up to ``pp``
  micro-chunks.

Mutable state (caches, pools) is never shared between logical devices, even
on one card.  Migration rides the host wire format: an export gathers the
shards (and concatenates the stages), an install validates the state on a
full-layout staging copy that ``_adopt_cache`` re-splits into the shards.

Families other than dense, vlm and moe (GQA), and head counts that ``tp``
does not divide (the reference's ``fsdp`` mode), raise ``NotImplementedError``
under ``tp·dp > 1``; PP without TP serves every stage-sliceable family.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import ReplicaGroup, default_stage_cuts, valid_stage_cuts
from repro_torch.distributed import sharding
from repro_torch.distributed.expert_parallel import ep_moe_partials, sum_in_order
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.launch.mesh import Mesh, logical_devices
from repro_torch.models import lm
from repro_torch.models.layers import (apply_rope, attention_fwd, linear,
                                       paged_attention_fwd, rmsnorm, softcap, swiglu)
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Engine

_REMAINDER = "ROADMAP.md queue 1 item 9's remainder"


class SubmeshOversubscribed(RuntimeError):
    """An allocation asked for more devices than the allocator has free."""


class SubmeshAllocator:
    """Carves per-replica (or per-stage) submeshes from a fixed device set.

    Deterministic: devices are handed out in ascending ``id`` order and
    returned to the free list in sorted order, so the same alloc/release
    sequence always yields the same placement.  Allocation is
    fragment-aware: :meth:`alloc` best-fits a request into the smallest
    contiguous-id fragment that holds it and falls back to gathering across
    fragments rather than raising while enough devices are free;
    :meth:`alloc_stages` carves one submesh per pipeline stage.
    """

    def __init__(self, devices: Optional[Sequence] = None,
                 axes: Tuple[str, ...] = ("pipe", "data", "model"),
                 mesh_factory: Optional[Callable] = None):
        if devices is None:
            devices = logical_devices()
        self.axes = tuple(axes)
        self._mesh_factory = mesh_factory or Mesh
        self._free: List = sorted(devices, key=lambda d: d.id)
        self.shortfalls = 0      # groups engine_for_group degraded for lack of devices
        # id(mesh) -> (mesh, devices): holding the mesh keeps its id stable
        self._owned: Dict[int, Tuple[object, List]] = {}

    @property
    def free_devices(self) -> int:
        return len(self._free)

    @property
    def total_devices(self) -> int:
        return len(self._free) + sum(len(d) for _, d in self._owned.values())

    def fragments(self) -> List[List]:
        """Maximal runs of consecutive device ids in the free set."""
        out: List[List] = []
        for d in self._free:
            if out and d.id == out[-1][-1].id + 1:
                out[-1].append(d)
            else:
                out.append([d])
        return out

    def _select(self, n: int) -> List:
        """Best-fit into the smallest fragment that holds the whole request,
        else gather across fragments in id order."""
        fits = [f for f in self.fragments() if len(f) >= n]
        take = min(fits, key=len)[:n] if fits else self._free[:n]
        ids = {d.id for d in take}
        self._free = [d for d in self._free if d.id not in ids]
        return take

    def can_alloc(self, shape: Sequence[int]) -> bool:
        return int(np.prod(tuple(shape))) <= len(self._free)

    def alloc(self, shape: Sequence[int]):
        """Carve one submesh; ``shape`` maps onto the TRAILING axis names.
        Raises only when the free set is genuinely too small."""
        shape = tuple(int(s) for s in shape)
        n = int(np.prod(shape))
        if n > len(self._free):
            raise SubmeshOversubscribed(
                f"submesh {shape} needs {n} devices but only "
                f"{len(self._free)} of {self.total_devices} are free")
        take = self._select(n)
        grid = np.empty(len(take), dtype=object)
        grid[:] = take
        mesh = self._mesh_factory(grid.reshape(shape), self.axes[-len(shape):])
        self._owned[id(mesh)] = (mesh, take)
        return mesh

    def try_alloc(self, shape: Sequence[int]):
        return self.alloc(shape) if self.can_alloc(shape) else None

    def can_alloc_stages(self, pp: int, stage_shape: Sequence[int]) -> bool:
        return pp * int(np.prod(tuple(stage_shape))) <= len(self._free)

    def alloc_stages(self, pp: int, stage_shape: Sequence[int]) -> List:
        """Carve ``pp`` stage submeshes of ``stage_shape`` each; stages may
        land on different fragments."""
        if not self.can_alloc_stages(pp, stage_shape):
            n = pp * int(np.prod(tuple(stage_shape)))
            raise SubmeshOversubscribed(
                f"{pp} stages of {tuple(stage_shape)} need {n} devices but "
                f"only {len(self._free)} of {self.total_devices} are free")
        return [self.alloc(stage_shape) for _ in range(pp)]

    def try_alloc_stages(self, pp: int, stage_shape: Sequence[int]) -> Optional[List]:
        if not self.can_alloc_stages(pp, stage_shape):
            return None
        return self.alloc_stages(pp, stage_shape)

    def release(self, mesh) -> None:
        """Return a submesh's devices; releasing twice (or a foreign mesh)
        is a no-op."""
        entry = self._owned.pop(id(mesh), None)
        if entry is None:
            return
        self._free = sorted(self._free + entry[1], key=lambda d: d.id)


def fused_paged_unsupported_reason(cfg: ModelConfig, tp: int) -> Optional[str]:
    """Why the head-sharded paged decode cannot run for this (config, tp) —
    ``None`` when it can (the reference's gate, same outputs)."""
    if cfg.mla is not None:
        return "mla"
    if cfg.attn_logit_softcap is not None:
        return "softcap"
    if tp > 1 and cfg.n_kv_heads % tp != 0:
        return "kv_heads"
    return None


def sharded_unsupported_reason(cfg: ModelConfig, tp: int) -> Optional[str]:
    """Why the port cannot run this config on a submesh with ``tp`` model
    shards, or None.  The reference partitions every family through GSPMD;
    the port's per-shard execution covers the GQA decoder families with
    query heads divisible by ``tp``."""
    if cfg.family not in ("dense", "vlm", "moe") or cfg.mla is not None:
        kind = "mla" if cfg.mla is not None else cfg.family
        return f"family {kind!r}"
    if cfg.local_global_every or cfg.is_encoder_decoder:
        return "local/global pairs" if cfg.local_global_every else "encoder-decoder"
    if cfg.n_heads % tp != 0:
        return f"n_heads={cfg.n_heads} not divisible by tp={tp}"
    return None


def _require_shardable(cfg: ModelConfig, mesh) -> None:
    reason = sharded_unsupported_reason(cfg, mesh.shape.get("model", 1))
    if reason is not None:
        raise NotImplementedError(
            f"{cfg.name} on a {mesh.shape} submesh: {reason} is not sharded by "
            f"the port ({_REMAINDER})")


def _path_spec(specs, path: Tuple[str, ...]) -> Tuple:
    node = specs
    for key in path:
        node = node[key]
    return tuple(node)


def _take(t: torch.Tensor, spec: Tuple, s: int, tp: int, axis: str) -> Tuple[torch.Tensor, bool]:
    """Shard ``s`` of ``t`` under ``spec`` (dims on ``axis`` split in tp
    equal parts); also whether anything was split."""
    split = False
    for dim, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            n = t.shape[dim] // tp
            t = t.narrow(dim, s * n, n)
            split = True
    return t, split


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardGroup:
    """Layers ``[lo, hi)`` of a model (a :class:`~repro_torch.models.lm.Stage`)
    held and run per logical device of a ``(dp, tp)`` mesh, with their KV
    caches (a paged pool, or a contiguous cache of ``n_slots`` slots)."""

    def __init__(self, cfg: ModelConfig, stage: lm.Stage, mesh, *, first: bool,
                 last: bool, paged: bool, n_slots: int, max_seq_len: int,
                 n_pages: int = 0, page_size: int = 16):
        _require_shardable(cfg, mesh)
        self.cfg, self.mesh = cfg, mesh
        self.first, self.last, self.paged = first, last, paged
        self.n_layers = len(stage.layers)
        self.n_slots, self.page_size = n_slots, page_size
        pol = dataclasses.replace(sharding.make_policy(mesh, cfg), fsdp_axis=None)
        self.policy = pol
        self.decision = sharding.sharding_decision(cfg, pol, stage)
        self.tp, self.dp = mesh.shape["model"], mesh.shape.get("data", 1)
        self.rows = [[d.device for d in row] for row in mesh.devices.reshape(self.dp, self.tp)]
        self.ids = [[d.id for d in row] for row in mesh.devices.reshape(self.dp, self.tp)]
        H, Hkv, tp = cfg.n_heads, cfg.n_kv_heads, self.tp
        self.kv_split = Hkv % tp == 0
        self.hkv_s = Hkv // tp if self.kv_split else Hkv
        self.shard_cfg = dataclasses.replace(cfg, n_heads=H // tp, n_kv_heads=self.hkv_s)
        b = sharding._batch_entry(pol, n_slots)
        self.lane_split = self.dp > 1 and b is not None
        per = n_slots // self.dp if self.lane_split else n_slots
        self.lanes = [(r * per, (r + 1) * per) if self.lane_split else (0, n_slots)
                      for r in range(self.dp)]
        self._place_weights(stage)
        self.caches = [[self._new_cache(dev, per, max_seq_len, n_pages) for dev in row]
                       for row in self.rows]

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #
    def _place_weights(self, stage: lm.Stage) -> None:
        """Per data row and shard, a namespace tree of the layer weights
        (``layers[l].attn.wq`` …) and the end-stage tables, each leaf sliced
        by its spec; replicated leaves and identical slices on one physical
        device are the same tensor."""
        specs, axis, tp = self.decision.param_specs, self.policy.tp_axis, self.tp
        memo: Dict[Tuple, torch.Tensor] = {}
        self.split: Dict[str, bool] = {}

        def leaf(t: torch.Tensor, path: Tuple[str, ...], stacked: bool, s: int,
                 dev: torch.device) -> torch.Tensor:
            spec = _path_spec(specs, path)[1 if stacked else 0:]
            part, split = _take(t, spec, s, tp, axis)
            self.split[".".join(path)] = split
            key = (id(t), s if split else -1, dev)
            if key not in memo:
                memo[key] = part.to(dev).contiguous()
            return memo[key]

        def tree(module, prefix: Tuple[str, ...], s: int, dev) -> SimpleNamespace:
            root = SimpleNamespace()
            for name, t in module.named_parameters():
                *parents, last = name.split(".")
                node = root
                for p in parents:
                    if not hasattr(node, p):
                        setattr(node, p, SimpleNamespace())
                    node = getattr(node, p)
                setattr(node, last, leaf(t, prefix + tuple(name.split(".")), True, s, dev))
            return root

        self.weights = []
        for row in self.rows:
            shards = []
            for s, dev in enumerate(row):
                w = SimpleNamespace(layers=[tree(layer, ("layers",), s, dev)
                                            for layer in stage.layers])
                for wl in w.layers:
                    if not self.cfg.qkv_bias:
                        wl.attn.bq = wl.attn.bk = wl.attn.bv = None
                w.embed = (None if stage.embed is None else
                           leaf(stage.embed, ("embed",), False, s, dev))
                w.lm_head = (None if stage.lm_head is None else
                             leaf(stage.lm_head, ("lm_head",), False, s, dev))
                w.final_norm = (None if stage.final_norm is None else
                                leaf(stage.final_norm.scale, ("final_norm", "scale"),
                                     False, s, dev))
                shards.append(w)
            self.weights.append(shards)
        self.ffn_split = (self.decision.ep or self.split.get("layers.ffn.w_down", False))
        self.ep = self.decision.ep and self.cfg.family == "moe"
        if self.ep:   # per-shard lists, as ep_moe_partials takes them
            self.ep_layers = [[SimpleNamespace(**{k: [getattr(w.layers[l].ffn, k) for w in shards]
                                                  for k in ("router", "w_gate", "w_up", "w_down")})
                               for l in range(self.n_layers)] for shards in self.weights]

    def _new_cache(self, dev, lanes: int, max_seq_len: int, n_pages: int) -> lm.Cache:
        cfg = dataclasses.replace(self.cfg, n_layers=self.n_layers, n_kv_heads=self.hkv_s)
        if self.paged:
            return lm.init_paged_cache(cfg, n_pages, self.page_size, device=dev)
        return lm.init_cache(cfg, lanes, max_seq_len, device=dev)

    def bytes_per_device(self) -> Dict[int, int]:
        """Bytes each logical device holds: its weights (as the layout
        places them, a shared tensor counted on every device that holds it)
        and its caches."""
        out = {}
        for r, row in enumerate(self.weights):
            for s, w in enumerate(row):
                seen, n = set(), 0
                for t in _tensors(w):
                    if id(t) not in seen:
                        seen.add(id(t))
                        n += _tensor_bytes(t)
                n += sum(_tensor_bytes(t) for _, t in lm._leaves(self.caches[r][s]))
                out[self.ids[r][s]] = n
        return out

    # ------------------------------------------------------------------ #
    # collectives over the shards of one data row
    # ------------------------------------------------------------------ #
    @staticmethod
    def _per_device(make, devs: Sequence[torch.device]) -> List[torch.Tensor]:
        """``make(device)`` for every shard, made once per physical device:
        the shards of one card share the replica."""
        memo: Dict[torch.device, torch.Tensor] = {}
        for d in devs:
            if d not in memo:
                memo[d] = make(d)
        return [memo[d] for d in devs]

    def _spread(self, t: torch.Tensor, devs: Sequence[torch.device]) -> List[torch.Tensor]:
        """``t`` on every shard's device."""
        return self._per_device(t.to, devs)

    def _add_reduced(self, xs: List[torch.Tensor], parts: List[torch.Tensor],
                     devs, split: bool) -> List[torch.Tensor]:
        """x + Σ parts (summed in shard order) on every shard, or, for a
        replicated sublayer, x + its own full output."""
        if not split:
            return [x + p for x, p in zip(xs, parts)]
        total = sum_in_order(parts, devs[0])
        x_of = dict(zip(devs, xs))
        return self._per_device(lambda d: x_of[d] + total.to(d), devs)

    # ------------------------------------------------------------------ #
    # the forward of one data row
    # ------------------------------------------------------------------ #
    def _embed(self, r: int, tokens: torch.Tensor) -> List[torch.Tensor]:
        """Vocab-parallel lookup: each shard holds rows [s·V/tp, (s+1)·V/tp)
        and contributes them (zeros elsewhere); exactly one shard is nonzero
        per token, so the sum is exact."""
        devs, ws = self.rows[r], self.weights[r]
        if not self.split["embed"]:
            return [w.embed[tokens.to(d)] for w, d in zip(ws, devs)]
        parts = []
        for s, (w, d) in enumerate(zip(ws, devs)):
            tok = tokens.to(d).long()
            n = w.embed.shape[0]
            local = tok - s * n
            hit = (local >= 0) & (local < n)
            rows = w.embed[local.clamp(0, n - 1)]
            parts.append(torch.where(hit[..., None], rows, torch.zeros_like(rows)))
        x = sum_in_order(parts, devs[0])
        return self._spread(x, devs)

    def _logits(self, r: int, xs: List[torch.Tensor], last_only: bool) -> torch.Tensor:
        """Final norm on every shard, each shard's vocab columns, gathered
        in shard order on the row's first device (f32)."""
        devs, ws, cfg = self.rows[r], self.weights[r], self.cfg
        outs = []
        for w, x in zip(ws, xs):
            if last_only:
                x = x[:, -1:].contiguous()
            head = w.embed.t() if cfg.tie_embeddings else w.lm_head
            outs.append((rmsnorm(x, w.final_norm, cfg.norm_eps) @ head).float())
        split = self.split["embed" if cfg.tie_embeddings else "lm_head"]
        logits = (torch.cat([o.to(devs[0]) for o in outs], dim=-1) if split
                  else outs[0])
        return softcap(logits, cfg.final_logit_softcap)

    def _finish(self, r: int, xs: List[torch.Tensor], last_only: bool) -> torch.Tensor:
        """Logits on the last stage, else the hidden state to hand off."""
        return self._logits(r, xs, last_only) if self.last else xs[0]

    def _ffn(self, r: int, l: int, hs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each shard's FFN output: a partial of the split FFN (EP experts,
        or d_ff columns of SwiGLU / of every expert), or the whole output
        where the weights replicate."""
        if self.ep:
            return ep_moe_partials(self.ep_layers[r][l], self.cfg, hs, self.rows[r])
        if self.cfg.family == "moe":
            return [lm._ffn_fwd(w.layers[l].ffn, self.cfg, h)
                    for w, h in zip(self.weights[r], hs)]
        return [swiglu(w.layers[l].ffn, h) for w, h in zip(self.weights[r], hs)]

    def _layers(self, r: int, xs: List[torch.Tensor], attn_parts) -> List[torch.Tensor]:
        """Every layer of the slice on data row ``r``'s shards;
        ``attn_parts(l, hs)`` maps the shards' normed inputs to their
        attention outputs (wo partials)."""
        devs, ws, eps = self.rows[r], self.weights[r], self.cfg.norm_eps
        for l in range(self.n_layers):
            hs = [rmsnorm(x, w.layers[l].ln1.scale, eps) for x, w in zip(xs, ws)]
            xs = self._add_reduced(xs, attn_parts(l, hs), devs, True)
            hs = [rmsnorm(x, w.layers[l].ln2.scale, eps) for x, w in zip(xs, ws)]
            xs = self._add_reduced(xs, self._ffn(r, l, hs), devs, self.ffn_split)
        return xs

    def _replicated_kv(self, r: int, l: int, hs: List[torch.Tensor], pos2s):
        """At a KV-head fallback: every shard's whole K and V (B, C, Hkv, D),
        RoPE'd — the column-split projections gathered in shard order, or
        each shard's own where the weights replicate."""
        cfg, ws = self.cfg, self.weights[r]
        B, C, _ = hs[0].shape
        ks = [linear(w.layers[l].attn.wk, w.layers[l].attn.bk, h) for w, h in zip(ws, hs)]
        vs = [linear(w.layers[l].attn.wv, w.layers[l].attn.bv, h) for w, h in zip(ws, hs)]
        out = []
        for s, dev in enumerate(self.rows[r]):
            cat = lambda ps: (torch.cat([p.to(dev) for p in ps], dim=-1)
                              if self.split["layers.attn.wk"] else ps[s])
            k = cat(ks).reshape(B, C, cfg.n_kv_heads, cfg.d_head)
            out.append((apply_rope(k, pos2s[s], cfg.rope_theta),
                        cat(vs).reshape(B, C, cfg.n_kv_heads, cfg.d_head)))
        return out

    def _query_runs(self, w, h: torch.Tensor, pos2: torch.Tensor, s: int, attend) -> torch.Tensor:
        """Shard ``s``'s attention output at a KV-head fallback: its query
        heads attended run by run against the KV head each run maps to
        (``attend(q_run, kv_head)``), then its wo rows."""
        cfg = self.cfg
        B, C, _ = h.shape
        Hq, D, G = cfg.n_heads // self.tp, cfg.d_head, cfg.n_heads // cfg.n_kv_heads
        q = apply_rope(linear(w.attn.wq, w.attn.bq, h).reshape(B, C, Hq, D), pos2,
                       cfg.rope_theta)
        outs, a = [], 0
        while a < Hq:
            kvh = (s * Hq + a) // G
            b = min(Hq, (kvh + 1) * G - s * Hq)
            outs.append(attend(q[:, :, a:b].contiguous(), kvh))
            a = b
        return torch.cat(outs, dim=2).reshape(B, C, Hq * D) @ w.attn.wo

    def _head_run(self, k_view: torch.Tensor, v_view: torch.Tensor, rows: torch.Tensor,
                  lens: torch.Tensor, window: Optional[int], q: torch.Tensor) -> torch.Tensor:
        """One query run against one KV head of a replicated cache, read
        through its row table: the paged decode for C == 1, flash attention
        for a chunk."""
        cap = self.cfg.attn_logit_softcap
        if q.shape[1] == 1:
            return fd_ops.paged_flash_decode(q[:, 0].contiguous(), k_view, v_view, rows,
                                             lens, window, cap)[:, None]
        return fa_ops.flash_attention(q, k_view, v_view, causal=True, window=window,
                                      softcap=cap, kv_len=lens, ptab=rows)

    def _paged_row(self, r: int, x: torch.Tensor, pos2: torch.Tensor,
                   ptab: torch.Tensor, active: torch.Tensor,
                   last_only: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """:func:`~repro_torch.models.lm.paged_stage_step` of the slice on
        data row ``r`` for the lanes given; also the pool rows it wrote."""
        devs, cfg = self.rows[r], self.cfg
        lens, ptab, widx = lm.paged_indices(pos2, ptab.to(devs[0]), active.to(devs[0]),
                                            self.page_size)
        on = lambda t: self._spread(t, devs)
        pos2s, ptabs, lenss, widxs = on(pos2.long()), on(ptab), on(lens), on(widx)
        xs = self._embed(r, x) if self.first else on(x)
        window, caches = lm.paged_window(cfg), self.caches[r]
        rows_of: Dict[Tuple[int, int], torch.Tensor] = {}

        def attn_parts(l, hs):
            ws = [w.layers[l] for w in self.weights[r]]
            if self.kv_split:
                return [paged_attention_fwd(w.attn, self.shard_cfg, h, pos2s[s], window,
                                            caches[s]["kp"][l], caches[s]["vp"][l],
                                            ptabs[s], lenss[s], widxs[s])
                        for s, (w, h) in enumerate(zip(ws, hs))]
            parts = []
            for s, (w, h, (k, v)) in enumerate(zip(ws, hs, self._replicated_kv(r, l, hs, pos2s))):
                kp, vp = caches[s]["kp"][l], caches[s]["vp"][l]
                P, page, Hkv, D = kp.shape
                kp.view(P * page, Hkv, D).index_copy_(0, widxs[s], k.reshape(-1, Hkv, D))
                vp.view(P * page, Hkv, D).index_copy_(0, widxs[s], v.reshape(-1, Hkv, D))

                def attend(q, kvh, s=s, kp=kp, vp=vp, page=page, Hkv=Hkv):
                    if (s, kvh) not in rows_of:
                        rows_of[s, kvh] = fd_ops.kv_head_rows(ptabs[s], page, Hkv, kvh)
                    return self._head_run(fd_ops.head_view(kp), fd_ops.head_view(vp),
                                          rows_of[s, kvh], lenss[s], window, q)
                parts.append(self._query_runs(w, h, pos2s[s], s, attend))
            return parts

        xs = self._layers(r, xs, attn_parts)
        return self._finish(r, xs, last_only), widx

    def _contig_row(self, r: int, x: torch.Tensor, pos2: torch.Tensor,
                    rows: Tuple[int, int], write: Optional[torch.Tensor],
                    last_only: bool) -> torch.Tensor:
        """:func:`~repro_torch.models.lm.stage_step` of the slice on data
        row ``r``: ``rows`` are local to the row's cache, ``write`` offsets
        into them (None: all)."""
        devs, cfg = self.rows[r], self.cfg
        lo, hi = rows
        n = pos2.shape[0]
        on = lambda t: self._spread(t, devs)
        pos2s = on(pos2.long())
        actives = on(lm._active_rows(n, write, pos2.device))
        window, caches = lm.ring_window(cfg), self.caches[r]
        for s, c in enumerate(caches):
            lm._write_pos(c["pos"][:, lo:hi], pos2s[s], actives[s], ring=window is not None)
        xs = self._embed(r, x) if self.first else on(x)
        rows_of: Dict[Tuple[int, int], torch.Tensor] = {}

        def attn_parts(l, hs):
            ws = [w.layers[l] for w in self.weights[r]]
            if self.kv_split:
                return [attention_fwd(w.attn, self.shard_cfg, h, pos2s[s], window,
                                      kv_cache=(caches[s]["k"][l, lo:hi], caches[s]["v"][l, lo:hi]),
                                      active=actives[s])
                        for s, (w, h) in enumerate(zip(ws, hs))]
            parts = []
            for s, (w, h, (k, v)) in enumerate(zip(ws, hs, self._replicated_kv(r, l, hs, pos2s))):
                K, V = caches[s]["k"][l], caches[s]["v"][l]          # (B_r, S, Hkv, D)
                S, Hkv = K.shape[1], K.shape[2]
                pos, act = pos2s[s], actives[s]
                lanes = torch.arange(lo, hi, device=pos.device)[:, None].expand_as(pos)
                slots = pos % S if window is not None else pos
                keep = act[:, None, None, None]
                K[lanes, slots] = torch.where(keep, k, K[lanes, slots])
                V[lanes, slots] = torch.where(keep, v, V[lanes, slots])
                lens = pos[:, -1] + 1
                if window is not None:
                    lens = lens.clamp(max=S)
                lens = torch.where(act, lens, 0).to(torch.int32)

                def attend(q, kvh, s=s, K=K, V=V, S=S, Hkv=Hkv, lens=lens):
                    if (s, kvh) not in rows_of:
                        rows_of[s, kvh] = fd_ops.contiguous_kv_head_rows(
                            K.shape[0], S, Hkv, kvh, K.device)[lo:hi].contiguous()
                    return self._head_run(fd_ops.head_view(K), fd_ops.head_view(V),
                                          rows_of[s, kvh], lens, None, q)
                parts.append(self._query_runs(w, h, pos2s[s], s, attend))
            return parts

        xs = self._layers(r, xs, attn_parts)
        return self._finish(r, xs, last_only)

    # ------------------------------------------------------------------ #
    # the stage interface (all lanes in, all lanes out, on the lead device)
    # ------------------------------------------------------------------ #
    @property
    def lead(self) -> torch.device:
        return self.rows[0][0]

    @property
    def cache(self):
        return self.caches

    def _out(self, n: int, like: torch.Tensor) -> torch.Tensor:
        return torch.zeros((n,) + tuple(like.shape[1:]), dtype=like.dtype, device=self.lead)

    def step_paged(self, x, pos2, ptab, active, last_only: bool = True) -> torch.Tensor:
        """One chunk through the slice for every lane; with the lanes split
        over ``data``, each row computes its own (a row with no active lane
        is skipped and gives zeros) and its pool writes are then copied to
        the other rows' pools.  ``ptab`` and ``active`` are host tensors
        (a row's activity is read without waiting for the device)."""
        out, written = None, []
        for r, (a, b) in enumerate(self.lanes):
            if self.lane_split and not bool(active[a:b].any()):
                continue
            y, widx = self._paged_row(r, x[a:b].to(self.rows[r][0]), pos2[a:b],
                                      ptab[a:b], active[a:b], last_only)
            if not self.lane_split:         # every row computes every lane
                out = y if out is None else out
                continue
            out = self._out(self.n_slots, y) if out is None else out
            out[a:b] = y.to(self.lead)
            written.append((r, widx))
        for r, widx in written:
            for r2 in range(self.dp):
                if r2 != r:
                    for src, dst in zip(self.caches[r], self.caches[r2]):
                        for key in ("kp", "vp"):
                            L, P, page = src[key].shape[:3]
                            flat = lambda t: t.view(L, P * page, *t.shape[3:])
                            flat(dst[key]).index_copy_(1, widx.to(dst[key].device),
                                                       flat(src[key])[:, widx].to(dst[key].device))
        return out

    def step_contig(self, x, pos2, rows: Optional[Tuple[int, int]], write,
                    last_only: bool = True) -> torch.Tensor:
        """:func:`~repro_torch.models.lm.stage_step` over lanes ``rows``
        (None: all) with offsets ``write`` into them (None: all; a host
        tensor)."""
        lo, hi = (0, self.n_slots) if rows is None else rows
        out = None
        for r, (a, b) in enumerate(self.lanes):
            s0, s1 = max(a, lo), min(b, hi)
            if s0 >= s1:
                continue
            w = None
            if write is not None:
                g = write.long() + lo
                g = g[(g >= s0) & (g < s1)]
                if self.lane_split and g.numel() == 0:
                    continue
                w = (g - s0).to(self.rows[r][0])
            y = self._contig_row(r, x[s0 - lo:s1 - lo].to(self.rows[r][0]),
                                 pos2[s0 - lo:s1 - lo], (s0 - a, s1 - a), w, last_only)
            if not self.lane_split:         # every row computes every lane
                out = y if out is None else out
                continue
            out = self._out(hi - lo, y) if out is None else out
            out[s0 - lo:s1 - lo] = y.to(self.lead)
        return out

    def _owners(self, slot: int) -> List[Tuple[int, int]]:
        """(data row, local index) of every replica of lane ``slot``."""
        return [(r, slot - a) for r, (a, b) in enumerate(self.lanes) if a <= slot < b]

    def wipe(self, slots: Sequence[int]) -> None:
        for slot in slots:
            for r, i in self._owners(slot):
                for c in self.caches[r]:
                    lm.wipe_slots_(c, [i])

    def _heads(self, s: int) -> slice:
        return slice(s * self.hkv_s, (s + 1) * self.hkv_s) if self.kv_split else slice(None)

    def _full(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """A cache leaf's shards gathered along the KV-head axis (dim 3)."""
        if not self.kv_split:
            return parts[0]
        return torch.cat([p.to(self.lead) for p in parts], dim=3)

    def extract_slot(self, slot: int):
        r, i = self._owners(slot)[0]
        cs = self.caches[r]
        full = {k: self._full([c[k][:, i:i + 1] for c in cs]) for k in ("k", "v")}
        full["pos"] = cs[0]["pos"][:, i:i + 1]
        return lm.extract_slot(self.cfg, full, 0)

    def extract_pages(self, pages: Sequence[int], position: int):
        idx = torch.as_tensor(list(pages), dtype=torch.long)
        cs = self.caches[0]
        full = {k: self._full([c[k][:, idx.to(c[k].device)] for c in cs]) for k in ("kp", "vp")}
        return lm.extract_paged_slot(self.cfg, full, range(len(pages)), position,
                                     self.page_size)

    def stage_slot(self, slot: int, state, position: int):
        """Validate ``state`` into a one-slot full-layout staging cache;
        :meth:`adopt` re-splits it into the shards."""
        cfg = dataclasses.replace(self.cfg, n_layers=self.n_layers)
        S = self.caches[0][0]["k"].shape[2]
        staging = lm.init_cache(cfg, 1, S, device=self.lead)
        lm.install_slot(self.cfg, staging, 0, state, position)
        return ("slot", slot, staging)

    def stage_pages(self, pages: Sequence[int], state, position: int):
        """Validate ``state`` into full-layout staging pages (page j + 1 for
        the request's block j, 0 for its trash blocks); :meth:`adopt`
        scatters them into every shard's pool."""
        c0 = self.caches[0][0]["kp"]
        shape = (self.n_layers, len(pages) + 1, self.page_size, self.cfg.n_kv_heads,
                 self.cfg.d_head)
        staging = {k: torch.zeros(shape, dtype=c0.dtype, device=self.lead) for k in ("kp", "vp")}
        spages = [0 if pid == kvcache.TRASH_PAGE else j + 1 for j, pid in enumerate(pages)]
        lm.install_paged_slot(self.cfg, staging, spages, state, position, self.page_size)
        return ("pages", list(pages), staging)

    def adopt(self, staged):
        kind, where, staging = staged
        if kind == "slot":
            for r, i in self._owners(where):
                for s, c in enumerate(self.caches[r]):
                    h = self._heads(s)
                    for k in ("k", "v"):
                        c[k][:, i].copy_(staging[k][:, 0, :, h])
                    c["pos"][:, i].copy_(staging["pos"][:, 0])
        else:
            real = [j for j, pid in enumerate(where) if pid != kvcache.TRASH_PAGE]
            src = torch.as_tensor([j + 1 for j in real], dtype=torch.long, device=self.lead)
            for row in self.caches:
                for s, c in enumerate(row):
                    dst = torch.as_tensor([where[j] for j in real], dtype=torch.long,
                                          device=c["kp"].device)
                    for k in ("kp", "vp"):
                        c[k][:, dst] = staging[k][:, src][:, :, :, self._heads(s)].to(c[k].device)
        return self.caches


def _tensors(ns) -> List[torch.Tensor]:
    """Every tensor of a namespace tree of weights."""
    if isinstance(ns, torch.Tensor):
        return [ns]
    if isinstance(ns, SimpleNamespace):
        return [t for v in vars(ns).values() for t in _tensors(v)]
    if isinstance(ns, (list, tuple)):
        return [t for v in ns for t in _tensors(v)]
    return []


class _PlainStage:
    """A layer slice on one device: :func:`~repro_torch.models.lm.stage_step`
    and :func:`~repro_torch.models.lm.paged_stage_step` over a
    :class:`~repro_torch.models.lm.Stage` and its cache slice, with
    :class:`ShardGroup`'s stage interface."""

    def __init__(self, cfg: ModelConfig, stage: lm.Stage, cache: lm.Cache,
                 first: bool, last: bool, page_size: int, ident: Optional[int] = None):
        self.cfg, self.stage, self.cache = cfg, stage, cache
        self.first, self.last, self.page_size = first, last, page_size
        self.lead = stage.device
        self.ident = ident          # the logical device's id, None off a mesh

    def step_paged(self, x, pos2, ptab, active, last_only: bool = True):
        return lm.paged_stage_step(self.stage, self.cfg, self.cache, x, pos2,
                                   ptab.to(self.lead), active.to(self.lead),
                                   page_size=self.page_size, first=self.first,
                                   last=self.last, last_only=last_only)[0]

    def step_contig(self, x, pos2, rows, write, last_only: bool = True):
        return lm.stage_step(self.stage, self.cfg, self.cache, x, pos2, first=self.first,
                             last=self.last, rows=rows,
                             write=None if write is None else write.to(self.lead),
                             last_only=last_only)[0]

    def wipe(self, slots: Sequence[int]) -> None:
        lm.wipe_slots_(self.cache, slots)

    def extract_slot(self, slot: int):
        return lm.extract_slot(self.cfg, self.cache, slot)

    def extract_pages(self, pages: Sequence[int], position: int):
        return lm.extract_paged_slot(self.cfg, self.cache, pages, position, self.page_size)

    def stage_slot(self, slot: int, state, position: int):
        return lm.install_slot(self.cfg, self.cache, slot, state, position)

    def stage_pages(self, pages: Sequence[int], state, position: int):
        return lm.install_paged_slot(self.cfg, self.cache, pages, state, position,
                                     self.page_size)

    def adopt(self, staged):
        return self.cache

    def bytes_per_device(self) -> Dict[int, int]:
        if self.ident is None:
            return {}
        weights = {id(t): _tensor_bytes(t) for _, t in self.stage.named_parameters()}
        return {self.ident: sum(weights.values())
                + sum(_tensor_bytes(t) for _, t in lm._leaves(self.cache))}


class _StagedEngine(Engine):
    """An :class:`Engine` whose model steps run through ``self.stages`` —
    one :class:`ShardGroup` (sharded) or ``pp`` stages (pipelined) — each
    taking every lane's tokens or hidden state and handing its output to
    the next stage's lead device.  Slot export/install go through the
    stages and the host wire format."""

    microbatches = 1

    def _spans(self, C: int) -> List[Tuple[int, int]]:
        mb = max(min(self.microbatches, C), 1)
        if mb > 1 and C % mb == 0:
            w = C // mb
            return [(j * w, (j + 1) * w) for j in range(mb)]
        return [(0, C)]

    def _run(self, tokens: np.ndarray, positions: np.ndarray, step) -> torch.Tensor:
        """Every micro-chunk through every stage; the greedy next token."""
        for s, e in self._spans(tokens.shape[1]):
            x = torch.from_numpy(np.ascontiguousarray(tokens[:, s:e]))
            pos = torch.from_numpy(np.ascontiguousarray(positions[:, s:e]))
            for st in self.stages:
                x = step(st, x.to(st.lead), pos.to(st.lead))
        return torch.argmax(x[:, -1, :], dim=-1)

    def _paged_exec(self, tokens, positions, active):
        ptab, act = torch.from_numpy(self._ptab), torch.from_numpy(active)
        with torch.inference_mode():
            next_tok = self._run(tokens, positions,
                                 lambda st, x, pos: st.step_paged(x, pos, ptab, act))
        self.dispatches += 1
        return next_tok

    def _contig_exec(self, tokens, positions, rows=None, write=None, reset=()):
        w = None if write is None else torch.from_numpy(np.asarray(write, np.int64))
        with torch.inference_mode():
            for st in self.stages:
                st.wipe(reset)
            next_tok = self._run(tokens, positions,
                                 lambda st, x, pos: st.step_contig(x, pos, rows, w))
        self.dispatches += 1
        return next_tok

    def _extract_slot_state(self, slot: int):
        return lm.concat_stage_states([st.extract_slot(slot) for st in self.stages])

    def _extract_paged_slot_state(self, slot: int, position: int):
        pages = self._slot_pages[slot]
        return lm.concat_stage_states([st.extract_pages(pages, position)
                                       for st in self.stages])

    def _parts(self, state):
        """The wire-format state cut at the stage boundaries."""
        return [lm._map_leaves(lambda p, a, lo=lo, hi=hi: a[lo:hi], state)
                for lo, hi in zip(self._bounds[:-1], self._bounds[1:])]

    def _install_slot_state(self, slot: int, state, position: int):
        return [st.stage_slot(slot, part, position)
                for st, part in zip(self.stages, self._parts(state))]

    def _install_paged_slot_state(self, pages, state, position: int):
        return [st.stage_pages(pages, part, position)
                for st, part in zip(self.stages, self._parts(state))]

    def _adopt_cache(self, staged):
        """Re-split the installed host state into every stage's shards."""
        return [st.adopt(s) for st, s in zip(self.stages, staged)]

    def bytes_per_device(self) -> Dict[int, int]:
        """Bytes each logical device of this replica holds (weights as the
        layout places them, and caches)."""
        out: Dict[int, int] = {}
        for st in self.stages:
            out.update(st.bytes_per_device())
        return out


class ShardedEngine(_StagedEngine):
    """An :class:`Engine` whose weights and cache live sharded on a
    ``(dp, tp)`` submesh (one :class:`ShardGroup` over every layer).

    Behaviourally identical to the base engine (slots, paging, migration,
    scheduling hooks); only where the state lives and how a step runs
    differ.  Tokens equal a single-device engine's up to the order of the
    f32 sums; parity tests pin float32.
    """

    def __init__(self, cfg: ModelConfig, params: lm.LM, mesh,
                 allocator: Optional[SubmeshAllocator] = None, **kw):
        _require_shardable(cfg, mesh)
        self.mesh = mesh
        self.allocator = allocator
        kw.setdefault("device", params.device)
        super().__init__(cfg, params, **kw)
        self._bounds = (0, cfg.n_layers)
        group = ShardGroup(cfg, lm.slice_stage_params(cfg, params, 0, cfg.n_layers, True, True),
                           mesh, first=True, last=True, paged=self.paged,
                           n_slots=self.n_slots, max_seq_len=self.max_seq_len,
                           n_pages=self.page_pool.n_pages if self.paged else 0,
                           page_size=self.page_size)
        pol = group.policy
        self.sharding_policy = pol
        self.decision = group.decision
        self._ep_flag = {"mesh": mesh, "axis": pol.tp_axis} if pol.ep else None
        self._paged_shard_flag = None
        self.paged_kernel_fused = False
        if self.paged:
            reason = fused_paged_unsupported_reason(cfg, self.tp)
            if reason is None:
                self.paged_kernel_fused = True
                if self.tp > 1:
                    self._paged_shard_flag = {"mesh": mesh, "axis": pol.tp_axis}
            elif reason == "kv_heads":
                # the pool replicates its KV heads: a real tp downgrade,
                # visible to tp_fallback_fraction as in the reference
                self.decision.fallbacks.append(sharding.FallbackRecord(
                    "paged_kernel", 3, cfg.n_kv_heads, pol.tp_axis, self.tp))
            else:
                self.decision.fallbacks.append(sharding.FallbackRecord(
                    f"paged_kernel:{reason}", 3, cfg.n_kv_heads, "", self.tp))
        self.stages = [group]
        self.cache = [group.caches]

    @property
    def tp(self) -> int:
        return self.mesh.shape[self.sharding_policy.tp_axis]

    @property
    def dp(self) -> int:
        return self.mesh.shape.get("data", 1)

    def release_devices(self) -> None:
        """Return this replica's submesh to the allocator (idempotent)."""
        if self.allocator is not None:
            self.allocator.release(self.mesh)
            self.allocator = None


class PipelinedEngine(_StagedEngine):
    """An :class:`Engine` whose layer stack is cut into ``pp`` stages.

    Stage ``i`` holds layers ``[bounds[i], bounds[i+1])`` (``bounds = (0,) +
    stage_cuts + (n_layers,)``) — the model's own layer modules, no copy —
    plus the embedding on the first stage and the final norm and head on the
    last.  With ``stage_meshes`` each stage runs on its own ``(dp, tp)``
    submesh (a :class:`ShardGroup` when it holds more than one device);
    without, every stage runs on the engine's device and its cache is a
    layer slice (a view) of the engine's cache.

    Paged KV serves from per-stage page pools: each stage's pool is its
    layer slice, and :class:`~repro_torch.serving.kvcache.StagedPagePool` /
    ``StagedPrefixIndex`` keep every stage's allocator and prefix trie in
    lockstep, so one page table drives all stages and prefix reuse works
    under pp.  Prefill chunks stream through the stages in up to
    ``microbatches`` (default ``pp``) equal micro-chunks.  Slot
    export/install reassemble / re-slice the full per-layer wire format, so
    re-cutting the stage boundaries migrates in-flight requests.
    """

    def __init__(self, cfg: ModelConfig, params: lm.LM, stage_cuts: Sequence[int],
                 stage_meshes: Optional[Sequence] = None,
                 allocator: Optional[SubmeshAllocator] = None,
                 microbatches: Optional[int] = None, **kw):
        if not lm.stage_sliceable(cfg):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} cannot be stage-sliced")
        cuts = tuple(int(c) for c in stage_cuts)
        pp = len(cuts) + 1
        if pp < 2 or not valid_stage_cuts(cfg.n_layers, pp, cuts):
            raise ValueError(f"invalid stage cuts {cuts} for a {cfg.n_layers}-layer model")
        self.stage_cuts = cuts
        self._bounds = (0,) + cuts + (cfg.n_layers,)
        self.stage_meshes = list(stage_meshes) if stage_meshes is not None else None
        if self.stage_meshes is not None:
            if len(self.stage_meshes) != pp:
                raise ValueError(f"got {len(self.stage_meshes)} stage meshes for pp={pp}")
            for m in self.stage_meshes:
                if m.size > 1:
                    _require_shardable(cfg, m)
        self.allocator = allocator
        self.microbatches = pp if microbatches is None else int(microbatches)
        kw.setdefault("device", params.device)
        super().__init__(cfg, params, **kw)
        self._build_stages(params)

    @property
    def pp(self) -> int:
        return len(self._bounds) - 1

    @property
    def tp(self) -> int:
        return self.stage_meshes[0].shape.get("model", 1) if self.stage_meshes else 1

    @property
    def dp(self) -> int:
        return self.stage_meshes[0].shape.get("data", 1) if self.stage_meshes else 1

    def _build_stages(self, params: lm.LM) -> None:
        cfg, pp = self.cfg, self.pp
        full_cache = self.cache
        self.stages: List = []
        self.stage_decisions: List = [None] * pp
        stage_tp = self.tp
        reason = fused_paged_unsupported_reason(cfg, stage_tp) if self.paged else None
        self.paged_kernel_fused = self.paged and reason is None
        for i in range(pp):
            lo, hi = self._bounds[i], self._bounds[i + 1]
            first, last = i == 0, i == pp - 1
            sp = lm.slice_stage_params(cfg, params, lo, hi, first, last)
            mesh = self.stage_meshes[i] if self.stage_meshes else None
            if mesh is not None and mesh.size > 1:
                st = ShardGroup(cfg, sp, mesh, first=first, last=last, paged=self.paged,
                                n_slots=self.n_slots, max_seq_len=self.max_seq_len,
                                n_pages=self.page_pool.n_pages if self.paged else 0,
                                page_size=self.page_size)
                decision = st.decision
            else:
                dev = self.device if mesh is None else mesh.devices.flat[0].device
                cache = lm.slice_stage_cache(full_cache, lo, hi)
                if dev != self.device:
                    cache = lm._map_leaves(lambda p, t: t.to(dev), cache)
                st = _PlainStage(cfg, sp.to(dev), cache, first, last, self.page_size,
                                 None if mesh is None else mesh.devices.flat[0].id)
                decision = None
                if mesh is not None:
                    pol = dataclasses.replace(sharding.make_policy(mesh, cfg), fsdp_axis=None)
                    decision = sharding.sharding_decision(cfg, pol, sp)
            if decision is not None and self.paged and not self.paged_kernel_fused:
                # the record the single-submesh engine keeps
                axis = decision.tp_axis if reason == "kv_heads" else ""
                path = "paged_kernel" if reason == "kv_heads" else f"paged_kernel:{reason}"
                decision.fallbacks.append(sharding.FallbackRecord(
                    path, 3, cfg.n_kv_heads, axis, stage_tp))
            self.stage_decisions[i] = decision
            self.stages.append(st)
        self.cache = [st.cache for st in self.stages]
        if self.paged:
            # per-stage lockstep pools/tries over the stages' layer slices
            stages = [(self._bounds[i], self._bounds[i + 1]) for i in range(pp)]
            self.page_pool = kvcache.StagedPagePool(self.page_pool.n_pages, stages)
            self.prefix_index = kvcache.StagedPrefixIndex(self.page_size, stages)

    def release_devices(self) -> None:
        """Return every stage submesh to the allocator (idempotent)."""
        if self.allocator is not None and self.stage_meshes:
            for m in self.stage_meshes:
                self.allocator.release(m)
        self.allocator = None


def engine_for_group(cfg: ModelConfig, params: lm.LM, group: ReplicaGroup,
                     allocator: Optional[SubmeshAllocator], **kw) -> Engine:
    """Build the engine for one replica of ``group`` (the reference's rules).

    ``pp > 1`` groups of a stage-sliceable family build a
    :class:`PipelinedEngine` with one carved ``(dp, tp)`` stage submesh per
    stage (no meshes without an allocator).  A ``tp·dp > 1`` group gets a
    :class:`ShardedEngine` on one carved submesh.  Otherwise — a
    single-device group, or an allocator too short of devices (counted in
    its ``shortfalls``) — a plain :class:`Engine`.  A family the port does
    not shard raises ``NotImplementedError`` once its submesh was carved
    (and returns it first).
    """
    if group.pp > 1 and lm.stage_sliceable(cfg) and cfg.n_layers >= group.pp:
        cuts = group.stage_cuts or default_stage_cuts(cfg.n_layers, group.pp)
        if valid_stage_cuts(cfg.n_layers, group.pp, cuts):
            meshes = None
            if allocator is not None:
                meshes = allocator.try_alloc_stages(group.pp, group.stage_submesh_shape)
                if meshes is None:  # shrunk hardware: degrade below
                    allocator.shortfalls += 1
                    cuts = None
            if cuts is not None:
                try:
                    return PipelinedEngine(cfg, params, cuts, stage_meshes=meshes,
                                           allocator=allocator, **kw)
                except NotImplementedError:
                    for m in meshes or ():
                        allocator.release(m)
                    raise
    if allocator is not None and group.tp * group.dp > 1:
        sub = allocator.try_alloc(group.stage_submesh_shape)
        if sub is None:
            allocator.shortfalls += 1
        else:
            try:
                return ShardedEngine(cfg, params, sub, allocator=allocator, **kw)
            except NotImplementedError:
                allocator.release(sub)
                raise
    return Engine(cfg, params, **kw)

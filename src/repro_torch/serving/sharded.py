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
partition one program.  The port has no GSPMD, so a sharded model (or
layer slice) is a :class:`ShardGroup` whose execution is written out per
logical device, walking the block list that
:func:`~repro_torch.models.lm.step_with_cache` walks
(:func:`~repro_torch.models.lm.blocks`: ``layers``, ``layer_pairs``,
zamba2's ``mamba_groups`` / ``shared_attn`` / ``mamba_tail``):

* **Weights follow the decision.**  :func:`~repro_torch.distributed.sharding.sharding_decision`
  gives every parameter its spec (``fsdp_axis=None``: serving replicas
  replicate weights across ``data``).  A leaf the spec shards on ``model``
  is held in slices, one per logical device; a whole leaf is held on every
  device of the submesh (one tensor where devices share a card).  Where a
  split does not follow the heads, a shard computes its slice and the
  slices are gathered in shard order (the copy GSPMD inserts).
* **Megatron TP** (``tp`` mode).  ``wq``/``wk``/``wv`` (and their biases),
  MLA's ``wq_b``/``wk_b``/``wv_b`` and ``w_gate``/``w_up`` are
  column-split, ``wo`` and ``w_down`` row-split; each shard runs the port's
  layer functions on its heads (a shard config of ``H/tp`` query and
  ``Hkv/tp`` KV heads; MLA's ``wq_a``/``wkv_a`` are whole, so every shard
  computes the same latent), and the row-parallel partials are summed in
  shard order.  RMSNorm runs on the full hidden state on every shard.  The
  embedding is vocab-parallel (each shard looks up the rows it holds, zeros
  elsewhere, summed), the head too, with the logits gathered before the
  final softcap and the argmax.  whisper's cross-attention runs per shard
  on its heads against its lanes' whole ``xk``/``xv``.
* **Mamba-2** (:meth:`ShardGroup._mamba`): each shard's ``in_proj``
  columns gathered into the whole ``zxbcdt``; the depthwise conv on its
  slice of ``conv_dim`` with its slice of the conv state (exact: the conv
  is per channel), the post-SiLU ``xBC`` gathered; the SSD scan (or the
  S = 1 step) on its heads with its heads' state; ``y`` and ``norm_scale``
  gathered for the gated RMSNorm over the whole d_inner, then its
  ``out_proj`` rows, the partials summed.
* **EP** (mixtral) through :func:`~repro_torch.distributed.expert_parallel.ep_moe_partials`:
  whole experts per shard, the grouped SwiGLU kernel per shard.
* **Caches follow the reference's cache specs** (``cache_pspecs``,
  ``paged_cache_pspecs``): conv channels and ssm heads split; MLA's
  contiguous ``ckv`` split by sequence (a chunk row is written on the shard
  that holds its position, and a step gathers the rows in shard order),
  its paged latent pool whole on every shard (each writes its own copy);
  whisper's ``xk``/``xv`` whole.  The exception: the contiguous GQA caches
  split by KV heads (the reference splits their sequence axis; a sequence
  split decode needs a cross-shard softmax combine that the CUDA decode
  does not expose, and a head split holds the same bytes per device), as
  the paged pool does.  Each shard decodes its own slice and runs flash
  attention for prefill chunks on its heads.
* **KV-head fallback.**  Where ``Hkv % tp != 0`` (qwen2-1.5b at tp 4) the
  KV cache is replicated on every shard and the fallback is recorded as the
  reference records it; each shard gathers the column-split K/V, writes the
  whole cache, and decodes its query heads against the KV head they map to
  through a row-table view of the replicated cache
  (:func:`~repro_torch.kernels.flash_decode.ops.kv_head_rows`) — the same
  CUDA kernels, no copy.
* **fsdp mode**, where ``tp`` does not divide the heads (the reference's
  ``make_policy``: qwen2-1.5b at tp 8, whisper-tiny at tp 4).  Every device
  is a row of one shard: it holds the leaves as the decision slices them,
  gathers a block's whole weights in shard order before it runs the block
  (ZeRO-3's all-gather, dropped after it), and computes the lanes
  ``_batch_entry`` gives it over ``(data, model)`` with whole heads.
* **DP** splits the slot lanes over ``data`` when ``_batch_entry`` says so
  (each row computes its own lanes; a paged pool is replicated over the
  rows and the rows' writes are copied to the other rows' pools after each
  dispatch); otherwise every row computes every lane.
* **PP** stages hand the hidden state (d_model·dtype bytes per token) to the
  next stage's device; prefill chunks are streamed in up to ``pp``
  micro-chunks.

Mutable state (caches, pools) is never shared between logical devices, even
on one card.  Migration rides the host wire format: an export gathers the
shards (and concatenates the stages), an install validates the state on a
full-layout staging copy that ``_adopt_cache`` re-splits into the shards.
"""
from __future__ import annotations

import dataclasses
import warnings
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import ReplicaGroup, default_stage_cuts, valid_stage_cuts
from repro_torch.distributed import sharding
from repro_torch.distributed.expert_parallel import ep_moe_partials, sum_in_order
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.launch.mesh import Mesh, logical_devices
from repro_torch.models import lm, ssd
from repro_torch.models.layers import (apply_rope, attention_fwd, attn_mask, linear,
                                       mla_attend, mla_fwd, mla_qkv, paged_attention_fwd,
                                       paged_mla_fwd, rmsnorm, softcap, swiglu)
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Engine


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


def _path_spec(specs, path: Tuple[str, ...]) -> Tuple:
    node = specs
    for key in path:
        node = node[key]
    return tuple(node)


def _model_dim(spec: Tuple, axis: str) -> Optional[int]:
    """The dim ``spec`` shards on ``axis``, or None."""
    for dim, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return dim
    return None


def _jax_path(name: str) -> Tuple[Tuple[str, ...], int]:
    """A port parameter name's leaf in the JAX layout and its stack depth
    (``mamba_groups.0.1.mixer.conv_w`` → ``("mamba_groups", "mixer",
    "conv_w")``, 2)."""
    parts = name.split(".")
    depth = lm.STACKS.get(parts[0], 0)
    return (parts[0], *parts[1 + depth:]), depth


def _tree(flat: Dict[str, object]):
    """Port parameter names → a namespace tree (``w.layers[3].attn.wq``,
    ``w.mamba_groups[0][1].mixer.conv_w``): numbered parts become lists.
    An attention without biases gets ``bq``/``bk``/``bv`` = None, as
    :class:`~repro_torch.models.layers.Attention` has them."""
    root: Dict = {}
    for name, v in flat.items():
        *parents, last = name.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [build(node[str(i)]) for i in range(len(node))]
        ns = SimpleNamespace(**{k: build(v) for k, v in node.items()})
        if hasattr(ns, "wq") and hasattr(ns, "wo"):
            for b in ("bq", "bk", "bv"):
                ns.__dict__.setdefault(b, None)
        return ns
    return build(root)


def _tree_map(fn: Callable, tree, *others):
    """``fn(leaf, *other leaves)`` over namespace trees of one structure."""
    if isinstance(tree, SimpleNamespace):
        return SimpleNamespace(**{k: _tree_map(fn, v, *(getattr(o, k) for o in others))
                                  for k, v in vars(tree).items()})
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree)]
    return fn(tree, *others)


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardGroup:
    """A model's layers — the whole :class:`~repro_torch.models.lm.LM`, or a
    pipeline :class:`~repro_torch.models.lm.Stage` — held and run per
    logical device of a ``(dp, tp)`` mesh, with their caches (a paged pool,
    or a contiguous cache of ``n_slots`` slots).

    The step walks the model's :func:`~repro_torch.models.lm.blocks` as
    :func:`~repro_torch.models.lm.stage_step` does (:attr:`blocks`): a
    Mamba-2 layer, a GQA or MLA decoder layer (with whisper's
    cross-attention), over ``layers``, ``layer_pairs`` or zamba2's
    ``mamba_groups`` / ``shared_attn`` / ``mamba_tail``.  In ``tp`` mode a
    data row's shards cooperate on its lanes; in ``fsdp`` mode every device
    is a row of one shard that computes its own lanes with the whole
    weights, gathered block by block."""

    def __init__(self, cfg: ModelConfig, params, mesh, *, first: bool, last: bool,
                 paged: bool, n_slots: int, max_seq_len: int, n_pages: int = 0,
                 page_size: int = 16):
        self.cfg, self.mesh = cfg, mesh
        self.first, self.last, self.paged = first, last, paged
        self.n_layers = len(params.layers) if isinstance(params, lm.Stage) else cfg.n_layers
        self.n_slots, self.page_size, self.max_seq_len = n_slots, page_size, max_seq_len
        pol = dataclasses.replace(sharding.make_policy(mesh, cfg), fsdp_axis=None)
        self.policy = pol
        self.decision = sharding.sharding_decision(cfg, pol, params)
        self.fsdp = pol.mode == "fsdp"
        dp, tp = mesh.shape.get("data", 1), mesh.shape["model"]
        grid = mesh.devices.reshape(dp, tp)
        self._place_weights(params, grid)
        # compute rows: a data row's tp shards, or under fsdp each device
        # alone; the lanes split over the rows as the batch axes divide them
        self.tp = 1 if self.fsdp else tp
        self.cells = ([[(r, s)] for r in range(dp) for s in range(tp)] if self.fsdp
                      else [[(r, s) for s in range(tp)] for r in range(dp)])
        self.rows = [[grid[c].device for c in row] for row in self.cells]
        self.ids = [[grid[c].id for c in row] for row in self.cells]
        self.dp = len(self.rows)
        b = sharding._batch_entry(pol, n_slots)
        groups = 1 if b is None else dp if b == "data" else dp * tp
        per = n_slots // groups
        self.lanes = [(k * groups // self.dp * per, (k * groups // self.dp + 1) * per)
                      for k in range(self.dp)]
        self.lane_split = groups > 1
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.kv_split = Hkv % self.tp == 0
        self.hkv_s = Hkv // self.tp if self.kv_split else Hkv
        self.shard_cfg = dataclasses.replace(cfg, n_heads=H // self.tp, n_kv_heads=self.hkv_s)
        self.blocks, self.pos_keys = lm.blocks(cfg, self.n_layers), lm.pos_buffers(cfg)
        meta = self._meta_cache(n_pages)
        self.cdim = self._cache_dims(meta)
        self.ssm_split = any(d is not None for p, d in self.cdim.items() if p[-1] == "ssm")
        self.conv_split = any(d is not None for p, d in self.cdim.items() if p[-1] == "conv")
        self.caches = [[self._new_cache(meta, dev, self.lanes[r][1] - self.lanes[r][0])
                        for dev in row] for r, row in enumerate(self.rows)]

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #
    def _place_weights(self, params, grid) -> None:
        """Per mesh cell, a namespace tree of the weights (:func:`_tree`),
        each leaf sliced by its spec; replicated leaves and identical slices
        on one physical device are the same tensor.  :attr:`wsplit` holds
        each leaf's split dim (None: whole)."""
        specs, axis, tp = self.decision.param_specs, self.policy.tp_axis, grid.shape[1]
        named = list(params.named_parameters())
        dims = {}
        for name, _ in named:
            path, depth = _jax_path(name)
            dims[name] = _model_dim(_path_spec(specs, path)[depth:], axis)
        memo: Dict[Tuple, torch.Tensor] = {}
        self.weights = []
        for r in range(grid.shape[0]):
            row = []
            for s in range(tp):
                dev, held = grid[r, s].device, {}
                for name, t in named:
                    dim = dims[name]
                    key = (id(t), -1 if dim is None else s, dev)
                    if key not in memo:
                        part = t if dim is None else t.narrow(dim, s * (t.shape[dim] // tp),
                                                              t.shape[dim] // tp)
                        memo[key] = part.to(dev).contiguous()
                    held[name] = memo[key]
                row.append(_tree(held))
            self.weights.append(row)
        self.wsplit = _tree(dims)
        self.whole = _tree_map(lambda d: None, self.wsplit)
        self.ep = self.decision.ep and self.cfg.family == "moe" and not self.fsdp

    def _meta_cache(self, n_pages: int) -> lm.Cache:
        """The whole replica's cache, shapes only."""
        cfg = dataclasses.replace(self.cfg, n_layers=self.n_layers)
        if self.paged:
            return lm.init_paged_cache(cfg, max(n_pages, 1), self.page_size, device="meta")
        return lm.init_cache(cfg, self.n_slots, self.max_seq_len, device="meta")

    def _cache_dims(self, meta: lm.Cache) -> Dict[Tuple[str, ...], Optional[int]]:
        """Each cache leaf's dim split over the shards (None: whole): the
        reference's ``cache_pspecs`` / ``paged_cache_pspecs``, except that
        the contiguous GQA caches split by KV heads (their position buffers
        stay whole) or, where tp does not divide the KV heads, replicate.
        Under fsdp a row's cache holds its lanes with whole heads."""
        if self.fsdp:
            return {p: None for p, _ in lm.leaves(meta)}
        fn = sharding.paged_cache_pspecs if self.paged else sharding.cache_pspecs
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", sharding.ShardingFallback)
            specs = fn(self.cfg, self.policy, meta)
        gqa = not self.paged and self.cfg.mla is None
        out = {}
        for path, _ in lm.leaves(meta):
            name = path[-1]
            if gqa and (name in ("k", "v") or name.endswith(("_k", "_v"))):
                out[path] = 3 if self.kv_split else None
            elif gqa and (name == "pos" or name.endswith("_pos")):
                out[path] = None
            else:
                out[path] = _model_dim(_path_spec(specs, path), self.policy.tp_axis)
        return out

    def _new_cache(self, meta: lm.Cache, dev, lanes: int) -> lm.Cache:
        """One shard's cache: ``lanes`` slots (contiguous), each leaf's
        split dim cut to its 1/tp."""
        def leaf(path, t):
            shape = list(t.shape)
            if not self.paged:
                shape[lm.stack_depth(path)] = lanes
            if self.cdim[path] is not None:
                shape[self.cdim[path]] //= self.tp
            return torch.full(shape, lm.leaf_init(path), dtype=t.dtype, device=dev)
        return lm.map_leaves(leaf, meta)

    def bytes_per_device(self) -> Dict[int, int]:
        """Bytes each logical device holds: its weights (as the layout
        places them, a shared tensor counted on every device that holds it)
        and its caches."""
        out = {}
        grid = self.mesh.devices.reshape(len(self.weights), -1)
        for r, row in enumerate(self.weights):
            for s, w in enumerate(row):
                seen, n = set(), 0
                for t in _tensors(w):
                    if id(t) not in seen:
                        seen.add(id(t))
                        n += _tensor_bytes(t)
                out[grid[r, s].id] = n
        for r, row in enumerate(self.caches):
            for s, c in enumerate(row):
                out[self.ids[r][s]] += sum(_tensor_bytes(t) for _, t in lm.leaves(c))
        return out

    # ------------------------------------------------------------------ #
    # collectives over the shards of one row
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

    def _gather(self, parts: List[torch.Tensor], split: bool, devs) -> List[torch.Tensor]:
        """The shards' slices of a last axis concatenated in shard order on
        every shard (the copy GSPMD inserts), or the parts themselves where
        nothing is split."""
        if not split:
            return parts
        return self._per_device(lambda d: torch.cat([p.to(d) for p in parts], dim=-1), devs)

    def _blk(self, r: int, get) -> Tuple[List, object]:
        """Block ``get`` of the weight tree on row ``r``: each shard's
        weights and the tree of their split dims.  Under fsdp the device
        gathers the block's whole weights from its mesh row in shard order
        (ZeRO-3's all-gather, dropped after the block)."""
        if not self.fsdp:
            return [get(w) for w in self.weights[self.cells[r][0][0]]], get(self.wsplit)
        (mr, ms), dev = self.cells[r][0], self.rows[r][0]
        full = _tree_map(lambda dim, *ts: ts[ms] if dim is None else
                         torch.cat([t.to(dev) for t in ts], dim),
                         get(self.wsplit), *(get(w) for w in self.weights[mr]))
        return [full], get(self.whole)

    # ------------------------------------------------------------------ #
    # the forward of one row
    # ------------------------------------------------------------------ #
    def _embed(self, r: int, tokens: torch.Tensor) -> List[torch.Tensor]:
        """Vocab-parallel lookup: each shard holds rows [s·V/tp, (s+1)·V/tp)
        and contributes them (zeros elsewhere); exactly one shard is nonzero
        per token, so the sum is exact."""
        devs, cfg = self.rows[r], self.cfg
        tables, split = self._blk(r, lambda w: w.embed)
        if split is None:
            return [lm.embed_scale(cfg, t[tokens.to(d)]) for t, d in zip(tables, devs)]
        parts = []
        for s, (t, d) in enumerate(zip(tables, devs)):
            tok = tokens.to(d).long()
            n = t.shape[0]
            local = tok - s * n
            hit = (local >= 0) & (local < n)
            rows = t[local.clamp(0, n - 1)]
            parts.append(torch.where(hit[..., None], rows, torch.zeros_like(rows)))
        return self._spread(lm.embed_scale(cfg, sum_in_order(parts, devs[0])), devs)

    def _logits(self, r: int, xs: List[torch.Tensor], last_only: bool) -> torch.Tensor:
        """Final norm on every shard, each shard's vocab columns, gathered
        in shard order on the row's first device (f32), then the final
        softcap."""
        devs, cfg = self.rows[r], self.cfg
        scales, _ = self._blk(r, lambda w: w.final_norm.scale)
        tied = cfg.tie_embeddings
        heads, split = self._blk(r, (lambda w: w.embed) if tied else (lambda w: w.lm_head))
        outs = []
        for x, scale, head in zip(xs, scales, heads):
            if last_only:
                x = x[:, -1:].contiguous()
            outs.append((rmsnorm(x, scale, cfg.norm_eps) @ (head.t() if tied else head)).float())
        logits = (torch.cat([o.to(devs[0]) for o in outs], dim=-1) if split is not None
                  else outs[0])
        return softcap(logits, cfg.final_logit_softcap)

    def _finish(self, r: int, xs: List[torch.Tensor], last_only: bool) -> torch.Tensor:
        """Logits on the last stage, else the hidden state to hand off."""
        return self._logits(r, xs, last_only) if self.last else xs[0]

    def _walk(self, r: int, xs: List[torch.Tensor], ctx) -> List[torch.Tensor]:
        for b in self.blocks:
            ws, sp = self._blk(r, b.get)
            xs = (self._mamba if b.kind == "mamba" else self._decoder)(r, ws, sp, xs, ctx, b)
        return xs

    def _decoder(self, r: int, ws, sp, xs, ctx, b: lm.Block) -> List[torch.Tensor]:
        """ln1 → attention (GQA or MLA) → with ``b.cross``, ln_x →
        cross-attention → ln2 → FFN, each sublayer's partials summed."""
        devs, eps = self.rows[r], self.cfg.norm_eps
        attend = self._mla if b.kind == "mla" else self._attn
        hs = [rmsnorm(x, w.ln1.scale, eps) for x, w in zip(xs, ws)]
        xs = self._add_reduced(xs, attend(r, ws, sp, hs, ctx, b), devs,
                               sp.attn.wo is not None)
        if b.cross:
            hs = [rmsnorm(x, w.ln_x.scale, eps) for x, w in zip(xs, ws)]
            xs = self._add_reduced(xs, self._cross(r, ws, hs, ctx, b), devs,
                                   sp.xattn.wo is not None)
        hs = [rmsnorm(x, w.ln2.scale, eps) for x, w in zip(xs, ws)]
        return self._add_reduced(xs, self._ffn(r, ws, hs), devs, sp.ffn.w_down is not None)

    def _ffn(self, r: int, ws, hs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each shard's FFN output: a partial of the split FFN (EP experts,
        or d_ff columns of SwiGLU / of every expert), or the whole output
        where the weights are whole."""
        if self.ep:
            layer = SimpleNamespace(**{k: [getattr(w.ffn, k) for w in ws]
                                       for k in ("router", "w_gate", "w_up", "w_down")})
            return ep_moe_partials(layer, self.cfg, hs, self.rows[r])
        if self.cfg.family == "moe":
            return [lm.ffn_fwd(w.ffn, self.cfg, h) for w, h in zip(ws, hs)]
        return [swiglu(w.ffn, h) for w, h in zip(ws, hs)]

    def _attn(self, r: int, ws, sp, hs, ctx, b: lm.Block) -> List[torch.Tensor]:
        """GQA attention of every shard on its heads (wo partials) against
        the block's ``{prefix}k/v`` buffer or the paged pool, its KV slice,
        or at a KV-head fallback the replicated cache."""
        caches, scfg, window = self.caches[r], self.shard_cfg, b.window
        if self.kv_split:
            if ctx.paged:
                return [paged_attention_fwd(w.attn, scfg, h, ctx.pos2s[s], window,
                                            b.leaf(c, "kp"), b.leaf(c, "vp"), ctx.ptabs[s],
                                            ctx.lenss[s], ctx.widxs[s])
                        for s, (w, h, c) in enumerate(zip(ws, hs, caches))]
            lo, hi = ctx.lo, ctx.hi
            return [attention_fwd(w.attn, scfg, h, ctx.pos2s[s], window,
                                  kv_cache=(b.leaf(c, "k", lo, hi), b.leaf(c, "v", lo, hi)),
                                  active=ctx.actives[s])
                    for s, (w, h, c) in enumerate(zip(ws, hs, caches))]
        parts = []
        for s, (w, h, c, (k, v)) in enumerate(zip(ws, hs, caches,
                                                  self._replicated_kv(ws, sp, hs, ctx.pos2s))):
            parts.append(self._query_runs(w, h, ctx.pos2s[s], s,
                                          self._fallback(ctx, s, c, k, v, b)))
        return parts

    def _fallback(self, ctx, s: int, c, k, v, b: lm.Block):
        """At a KV-head fallback: write shard ``s``'s whole K and V into its
        replicated buffer, and return ``attend(q_run, kv_head)`` over it."""
        window = b.window
        if ctx.paged:
            kp, vp = b.leaf(c, "kp"), b.leaf(c, "vp")
            P, page, Hkv, D = kp.shape
            kp.view(P * page, Hkv, D).index_copy_(0, ctx.widxs[s], k.reshape(-1, Hkv, D))
            vp.view(P * page, Hkv, D).index_copy_(0, ctx.widxs[s], v.reshape(-1, Hkv, D))

            def attend(q, kvh):
                key = ("paged", s, kvh)
                if key not in ctx.rows_of:
                    ctx.rows_of[key] = fd_ops.kv_head_rows(ctx.ptabs[s], page, Hkv, kvh)
                return self._head_run(fd_ops.head_view(kp), fd_ops.head_view(vp),
                                      ctx.rows_of[key], ctx.lenss[s], window, q)
            return attend
        lo, hi = ctx.lo, ctx.hi
        K, V = b.leaf(c, "k"), b.leaf(c, "v")                       # (B_r, S, Hkv, D)
        S, Hkv = K.shape[1], K.shape[2]
        pos, act = ctx.pos2s[s], ctx.actives[s]
        lanes = torch.arange(lo, hi, device=pos.device)[:, None].expand_as(pos)
        slots = pos % S if window is not None else pos
        keep = act[:, None, None, None]
        K[lanes, slots] = torch.where(keep, k, K[lanes, slots])
        V[lanes, slots] = torch.where(keep, v, V[lanes, slots])
        lens = pos[:, -1] + 1
        if window is not None:
            lens = lens.clamp(max=S)
        lens = torch.where(act, lens, 0).to(torch.int32)

        def attend(q, kvh):
            key = (b.prefix, s, kvh)
            if key not in ctx.rows_of:
                ctx.rows_of[key] = fd_ops.contiguous_kv_head_rows(
                    K.shape[0], S, Hkv, kvh, K.device)[lo:hi].contiguous()
            return self._head_run(fd_ops.head_view(K), fd_ops.head_view(V),
                                  ctx.rows_of[key], lens, None, q)
        return attend

    def _replicated_kv(self, ws, sp, hs: List[torch.Tensor], pos2s):
        """At a KV-head fallback: every shard's whole K and V (B, C, Hkv, D),
        RoPE'd — the column-split projections gathered in shard order, or
        each shard's own where the weights are whole."""
        cfg = self.cfg
        B, C, _ = hs[0].shape
        ks = [linear(w.attn.wk, w.attn.bk, h) for w, h in zip(ws, hs)]
        vs = [linear(w.attn.wv, w.attn.bv, h) for w, h in zip(ws, hs)]
        out = []
        for s, h in enumerate(hs):
            dev = h.device
            cat = lambda ps: (torch.cat([p.to(dev) for p in ps], dim=-1)
                              if sp.attn.wk is not None else ps[s])
            k = cat(ks).reshape(B, C, cfg.n_kv_heads, cfg.d_head)
            out.append((apply_rope(k, pos2s[s], cfg.rope_theta),
                        cat(vs).reshape(B, C, cfg.n_kv_heads, cfg.d_head)))
        return out

    def _runs(self, q: torch.Tensor, s: int, attend) -> torch.Tensor:
        """Shard ``s``'s query heads (B, C, Hq, D) attended run by run
        against the KV head each run maps to (``attend(q_run, kv_head)``)."""
        Hq, G = q.shape[2], self.cfg.n_heads // self.cfg.n_kv_heads
        outs, a = [], 0
        while a < Hq:
            kvh = (s * Hq + a) // G
            b = min(Hq, (kvh + 1) * G - s * Hq)
            outs.append(attend(q[:, :, a:b].contiguous(), kvh))
            a = b
        return torch.cat(outs, dim=2)

    def _query_runs(self, w, h: torch.Tensor, pos2: torch.Tensor, s: int, attend) -> torch.Tensor:
        """Shard ``s``'s attention output at a KV-head fallback: its RoPE'd
        query heads through :meth:`_runs`, then its wo rows."""
        cfg = self.cfg
        B, C, _ = h.shape
        Hq, D = cfg.n_heads // self.tp, cfg.d_head
        q = apply_rope(linear(w.attn.wq, w.attn.bq, h).reshape(B, C, Hq, D), pos2,
                       cfg.rope_theta)
        return self._runs(q, s, attend).reshape(B, C, Hq * D) @ w.attn.wo

    def _head_run(self, k_view: torch.Tensor, v_view: torch.Tensor, rows: torch.Tensor,
                  lens: torch.Tensor, window: Optional[int], q: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
        """Query heads against KV heads of a whole cache read through a row
        table of its page-size-1 view: the paged decode for C == 1, flash
        attention for a chunk."""
        cap = self.cfg.attn_logit_softcap
        if q.shape[1] == 1:
            return fd_ops.paged_flash_decode(q[:, 0].contiguous(), k_view, v_view, rows,
                                             lens, window, cap)[:, None]
        return fa_ops.flash_attention(q, k_view, v_view, causal=causal, window=window,
                                      softcap=cap, kv_len=lens, ptab=rows)

    def _cross(self, r: int, ws, hs, ctx, b: lm.Block) -> List[torch.Tensor]:
        """whisper's cross-attention of every shard on its query heads
        against its lanes' whole ``xk``/``xv`` (the reference replicates
        them over ``model``): shard ``s`` reads KV heads ``[s·w, (s+1)·w)``
        through a row table of the cache's view of ``w = Hkv/tp`` heads a
        row, one launch and no copy (under fsdp the whole, ``w = Hkv``).
        tp divides whisper's KV heads in ``tp`` mode, as H == Hkv.  Active
        lanes attend all ``n_frames``, the others nothing."""
        cfg, w = self.cfg, self.hkv_s
        assert self.kv_split, "tp divides an encoder-decoder's KV heads"
        out = []
        for s, (wt, h, c) in enumerate(zip(ws, hs, self.caches[r])):
            xk, xv = b.leaf(c, "xk", ctx.lo, ctx.hi), b.leaf(c, "xv", ctx.lo, ctx.hi)
            (B, C, _), F = h.shape, xk.shape[1]
            xlen = torch.where(ctx.actives[s], F, 0).to(torch.int32)
            if ("x", s) not in ctx.rows_of:
                ctx.rows_of["x", s] = fd_ops.contiguous_kv_head_rows(
                    B, F, cfg.n_kv_heads // w, s, xk.device)
            q = linear(wt.xattn.wq, wt.xattn.bq, h).reshape(B, C, -1, cfg.d_head)
            o = self._head_run(fd_ops.head_view(xk, w), fd_ops.head_view(xv, w),
                               ctx.rows_of["x", s], xlen, None, q, causal=False)
            out.append(o.reshape(B, C, -1) @ wt.xattn.wo)
        return out

    def _mla(self, r: int, ws, sp, hs, ctx, b: lm.Block) -> List[torch.Tensor]:
        """MLA of every shard on its heads: ``wq_a``/``wkv_a`` are whole, so
        every shard computes the same latent.  The paged pool is whole on
        every shard (each writes its own copy); a contiguous ``ckv`` split
        by sequence takes each chunk row on the shard that holds its
        position, and every shard then reads all rows in shard order."""
        caches, scfg = self.caches[r], self.shard_cfg
        if ctx.paged:
            return [paged_mla_fwd(w.attn, scfg, h, ctx.pos2s[s], b.leaf(c, "ckvp"),
                                  ctx.ptabs[s], ctx.lenss[s], ctx.widxs[s])
                    for s, (w, h, c) in enumerate(zip(ws, hs, caches))]
        lo, hi = ctx.lo, ctx.hi
        if self.cdim[("ckv",)] is None:
            return [mla_fwd(w.attn, scfg, h, ctx.pos2s[s],
                            kv_cache=(b.leaf(c, "ckv", lo, hi), b.leaf(c, "pos", lo, hi)),
                            active=ctx.actives[s])
                    for s, (w, h, c) in enumerate(zip(ws, hs, caches))]
        qs = []
        for s, (w, h, c) in enumerate(zip(ws, hs, caches)):
            q_lat, q_rope, ckv = mla_qkv(w.attn, scfg, h, ctx.pos2s[s])
            lane, j, row = self._owned(r, ctx)[s]
            b.leaf(c, "ckv", lo, hi)[lane, row] = ckv[lane, j]
            b.leaf(c, "pos", lo, hi)[lane, row] = ctx.pos2s[s][lane, j].to(torch.int32)
            qs.append((q_lat, q_rope))
        out = []
        for s, (w, (q_lat, q_rope)) in enumerate(zip(ws, qs)):
            dev = q_lat.device
            keys = torch.cat([b.leaf(c, "ckv", lo, hi).to(dev) for c in caches], dim=1)
            kpos = torch.cat([b.leaf(c, "pos", lo, hi).to(dev) for c in caches], dim=1)
            mask = attn_mask(ctx.pos2s[s], kpos, None) & (kpos >= 0)[:, None, None, :]
            out.append(mla_attend(w.attn, scfg, q_lat, q_rope, keys, mask))
        return out

    def _owned(self, r: int, ctx) -> List[Tuple[torch.Tensor, ...]]:
        """Per shard, the chunk entries it holds rows for under the
        sequence split of ``ckv``: (lane, chunk column, local row), from
        the host positions (no wait on the device), once a step."""
        if ctx.own is None:
            S = self.caches[r][0]["ckv"].shape[2]
            ctx.own = []
            for s, dev in enumerate(self.rows[r]):
                local = ctx.pos2 - s * S
                b, j = ((local >= 0) & (local < S) & ctx.act[:, None]).nonzero(as_tuple=True)
                ctx.own.append(tuple(t.to(dev) for t in (b, j, local[b, j])))
        return ctx.own

    def _mamba(self, r: int, ws, sp, xs, ctx, b: lm.Block) -> List[torch.Tensor]:
        """One Mamba-2 layer on every shard, :func:`~repro_torch.models.ssd.mamba2_fwd`
        cut by the layout: each shard's ``in_proj`` columns gathered into
        the whole ``zxbcdt``; the conv on its channels of ``conv_dim`` with
        its conv state, the post-SiLU ``xBC`` gathered; the SSD scan (or
        the S = 1 step) on its heads with its heads' state; the gated norm
        over the gathered d_inner, then its ``out_proj`` rows, summed."""
        cfg, devs, eps = self.cfg, self.rows[r], self.cfg.norm_eps
        sc, m = cfg.ssm, sp.mixer
        nh, P = sc.n_heads(cfg.d_model), sc.head_dim
        conv_dim = sc.d_inner(cfg.d_model) + 2 * sc.n_groups * sc.d_state
        mix = [w.mixer for w in ws]
        hs = [rmsnorm(x, w.ln.scale, eps) for x, w in zip(xs, ws)]
        zs = self._gather([h @ p.in_proj.w for h, p in zip(hs, mix)],
                          m.in_proj.w is not None, devs)
        states = [(b.leaf(c, "conv", ctx.lo, ctx.hi), b.leaf(c, "ssm", ctx.lo, ctx.hi))
                  for c in self.caches[r]]
        cw = conv_dim // self.tp if self.conv_split else conv_dim
        hn = nh // self.tp if self.ssm_split else nh
        convs, conv_new = [], []
        for s, (z, p, (conv_st, _)) in enumerate(zip(zs, mix, states)):
            raw = ssd.split_zxbcdt(cfg, z)[1].narrow(-1, s * cw if self.conv_split else 0, cw)
            y, st = ssd.conv_step(raw, p.conv_w, p.conv_b, conv_st)
            convs.append(y)
            conv_new.append(st)
        xBCs = self._gather(convs, self.conv_split, devs)
        ys, ssm_new = [], []
        for s, (z, xBC, p, (_, ssm_st)) in enumerate(zip(zs, xBCs, mix, states)):
            heads = slice(s * hn, (s + 1) * hn) if self.ssm_split else slice(None)
            gz, _, dt_raw = ssd.split_zxbcdt(cfg, z)
            dt = F.softplus(dt_raw[..., heads].float() + p.dt_bias[heads])
            xh, Bm, Cm = ssd.split_xBC(cfg, xBC, heads)
            y, fin = ssd.scan_step(xh, dt, -torch.exp(p.A_log[heads]), Bm, Cm, ssm_st,
                                   sc.chunk_size)
            cols = slice(heads.start * P, heads.stop * P) if self.ssm_split else slice(None)
            ys.append(ssd.gate(y, xh, p.D[heads], gz[..., cols]).contiguous())
            ssm_new.append(fin)
        ys = self._gather(ys, self.ssm_split, devs)
        scales = self._gather([p.norm_scale for p in mix], m.norm_scale is not None, devs)
        parts = []
        for s, (y, scale, p) in enumerate(zip(ys, scales, mix)):
            y = rmsnorm(y, scale, eps)
            w_out = p.out_proj.w
            if m.out_proj.w is not None:
                y = y.narrow(-1, s * w_out.shape[0], w_out.shape[0])
            parts.append(y @ w_out)
        for s, ((conv_st, ssm_st), cn, sn) in enumerate(zip(states, conv_new, ssm_new)):
            write = None if ctx.writes is None else ctx.writes[s]
            lm.keep_rows_(conv_st, cn, write)
            lm.keep_rows_(ssm_st, sn, write)
        return self._add_reduced(xs, parts, devs, m.out_proj.w is not None)

    def _paged_row(self, r: int, x: torch.Tensor, pos2: torch.Tensor,
                   ptab: torch.Tensor, active: torch.Tensor,
                   last_only: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """:func:`~repro_torch.models.lm.paged_stage_step` of the slice on
        row ``r`` for the lanes given; also the pool rows it wrote."""
        devs = self.rows[r]
        lens, ptab, widx = lm.paged_indices(pos2.to(devs[0]), ptab.to(devs[0]),
                                            active.to(devs[0]), self.page_size)
        on = lambda t: self._spread(t, devs)
        ctx = SimpleNamespace(paged=True, pos2s=on(pos2.long()), ptabs=on(ptab),
                              lenss=on(lens), widxs=on(widx), rows_of={})
        xs = self._embed(r, x) if self.first else on(x)
        return self._finish(r, self._walk(r, xs, ctx), last_only), widx

    def _contig_row(self, r: int, x: torch.Tensor, pos2: torch.Tensor,
                    rows: Tuple[int, int], write: Optional[torch.Tensor],
                    last_only: bool) -> torch.Tensor:
        """:func:`~repro_torch.models.lm.stage_step` of the slice on row
        ``r``: ``rows`` are local to the row's cache, ``write`` offsets into
        them (None: all); ``pos2`` and ``write`` are host tensors."""
        devs = self.rows[r]
        lo, hi = rows
        on = lambda t: self._spread(t, devs)
        pos2 = pos2.long()
        act = lm.active_rows(pos2.shape[0], write, pos2.device)
        ctx = SimpleNamespace(paged=False, lo=lo, hi=hi, pos2=pos2, act=act,
                              pos2s=on(pos2), actives=on(act),
                              writes=None if write is None else on(write),
                              rows_of={}, own=None)
        for s, c in enumerate(self.caches[r]):
            for key, ring in self.pos_keys:
                lm.write_pos(c[key][:, lo:hi], ctx.pos2s[s], ctx.actives[s], ring=ring)
        xs = self._embed(r, x) if self.first else on(x)
        return self._finish(r, self._walk(r, xs, ctx), last_only)

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
        over the rows, each row computes its own (a row with no active lane
        is skipped and gives zeros) and its pool writes are then copied to
        the other rows' pools.  ``pos2``, ``ptab`` and ``active`` are host
        tensors (a row's activity is read without waiting for the device)."""
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
                        for key in src:
                            L, P, page = src[key].shape[:3]
                            flat = lambda t: t.view(L, P * page, *t.shape[3:])
                            flat(dst[key]).index_copy_(1, widx.to(dst[key].device),
                                                       flat(src[key])[:, widx].to(dst[key].device))
        return out

    def step_contig(self, x, pos2, rows: Optional[Tuple[int, int]], write,
                    last_only: bool = True) -> torch.Tensor:
        """:func:`~repro_torch.models.lm.stage_step` over lanes ``rows``
        (None: all) with offsets ``write`` into them (None: all); ``pos2``
        and ``write`` are host tensors."""
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
                w = g - s0
            y = self._contig_row(r, x[s0 - lo:s1 - lo].to(self.rows[r][0]),
                                 pos2[s0 - lo:s1 - lo], (s0 - a, s1 - a), w, last_only)
            if not self.lane_split:         # every row computes every lane
                out = y if out is None else out
                continue
            out = self._out(hi - lo, y) if out is None else out
            out[s0 - lo:s1 - lo] = y.to(self.lead)
        return out

    def _owners(self, slot: int) -> List[Tuple[int, int]]:
        """(row, local index) of every replica of lane ``slot``."""
        return [(r, slot - a) for r, (a, b) in enumerate(self.lanes) if a <= slot < b]

    def wipe(self, slots: Sequence[int]) -> None:
        for slot in slots:
            for r, i in self._owners(slot):
                for c in self.caches[r]:
                    lm.wipe_slots_(c, [i])

    def _full(self, path: Tuple[str, ...], parts: List[torch.Tensor]) -> torch.Tensor:
        """A cache leaf's shards gathered along its split dim, in shard
        order, on the lead device."""
        dim = self.cdim[path]
        if dim is None:
            return parts[0]
        return torch.cat([p.to(self.lead) for p in parts], dim=dim)

    def _part(self, path: Tuple[str, ...], full: torch.Tensor, s: int) -> torch.Tensor:
        """Shard ``s``'s slice of a full-layout cache leaf."""
        dim = self.cdim[path]
        if dim is None:
            return full
        n = full.shape[dim] // self.tp
        return full.narrow(dim, s * n, n)

    def extract_slot(self, slot: int):
        r, i = self._owners(slot)[0]
        one = lambda p: lm.slot_index(p, slice(i, i + 1))
        full = lm.map_leaves(lambda p, *ls: self._full(p, [t[one(p)] for t in ls]),
                             *self.caches[r])
        return lm.extract_slot(self.cfg, full, 0)

    def extract_pages(self, pages: Sequence[int], position: int):
        idx = torch.as_tensor(list(pages), dtype=torch.long)
        full = lm.map_leaves(lambda p, *ls: self._full(p, [t[:, idx.to(t.device)] for t in ls]),
                             *self.caches[0])
        return lm.extract_paged_slot(self.cfg, full, range(len(pages)), position,
                                     self.page_size)

    def stage_slot(self, slot: int, state, position: int):
        """Validate ``state`` into a one-slot full-layout staging cache;
        :meth:`adopt` re-splits it into the shards."""
        cfg = dataclasses.replace(self.cfg, n_layers=self.n_layers)
        staging = lm.init_cache(cfg, 1, self.max_seq_len, device=self.lead)
        lm.install_slot(self.cfg, staging, 0, state, position)
        return ("slot", slot, staging)

    def stage_pages(self, pages: Sequence[int], state, position: int):
        """Validate ``state`` into full-layout staging pages (page j + 1 for
        the request's block j, 0 for its trash blocks); :meth:`adopt`
        scatters them into every shard's pool."""
        cfg = dataclasses.replace(self.cfg, n_layers=self.n_layers)
        staging = lm.init_paged_cache(cfg, len(pages) + 1, self.page_size, device=self.lead)
        spages = [0 if pid == kvcache.TRASH_PAGE else j + 1 for j, pid in enumerate(pages)]
        lm.install_paged_slot(self.cfg, staging, spages, state, position, self.page_size)
        return ("pages", list(pages), staging)

    def adopt(self, staged):
        kind, where, staging = staged
        if kind == "slot":
            for r, i in self._owners(where):
                for s, c in enumerate(self.caches[r]):
                    for path, leaf in lm.leaves(c):
                        src = staging
                        for key in path:
                            src = src[key]
                        part = self._part(path, src[lm.slot_index(path, slice(0, 1))], s)
                        leaf[lm.slot_index(path, slice(i, i + 1))].copy_(part)
        else:
            real = [j for j, pid in enumerate(where) if pid != kvcache.TRASH_PAGE]
            src = torch.as_tensor([j + 1 for j in real], dtype=torch.long, device=self.lead)
            for row in self.caches:
                for s, c in enumerate(row):
                    for key, leaf in c.items():
                        dst = torch.as_tensor([where[j] for j in real], dtype=torch.long,
                                              device=leaf.device)
                        leaf[:, dst] = self._part((key,), staging[key][:, src], s).to(leaf.device)
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
        return lm.paged_stage_step(self.stage, self.cfg, self.cache, x, pos2.to(self.lead),
                                   ptab.to(self.lead), active.to(self.lead),
                                   page_size=self.page_size, first=self.first,
                                   last=self.last, last_only=last_only)[0]

    def step_contig(self, x, pos2, rows, write, last_only: bool = True):
        return lm.stage_step(self.stage, self.cfg, self.cache, x, pos2.to(self.lead),
                             first=self.first,
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
                + sum(_tensor_bytes(t) for _, t in lm.leaves(self.cache))}


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
                x = step(st, x.to(st.lead), pos)
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
        return [lm.map_leaves(lambda p, a, lo=lo, hi=hi: a[lo:hi], state)
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
        self.mesh = mesh
        self.allocator = allocator
        kw.setdefault("device", params.device)
        super().__init__(cfg, params, **kw)
        self._bounds = (0, cfg.n_layers)
        group = ShardGroup(cfg, params, mesh, first=True, last=True, paged=self.paged,
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
                    cache = lm.map_leaves(lambda p, t: t.to(dev), cache)
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
    its ``shortfalls``) — a plain :class:`Engine`.  A submesh whose
    engine fails to build goes back to the allocator.
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
                except BaseException:
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
            except BaseException:   # e.g. out of memory placing the shards
                allocator.release(sub)
                raise
    return Engine(cfg, params, **kw)

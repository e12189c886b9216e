"""Sharding rules mapping the model and its caches onto a mesh (port of
``src/repro/distributed/sharding.py``).

Policy (the reference's):
  * batch dims           -> ("pod", "data")  (or ("data",) single-pod)
  * weight "FSDP" dim    -> "data"  (ZeRO-3-style)
  * weight tensor-par dim-> "model" (Megatron: heads / d_ff / vocab)
  * KV-cache sequence    -> "model"; the paged pool's KV heads -> "model"
  * params replicated over "pod"

Every rule is sanitised against divisibility: any dim not divisible by its
assigned axis size falls back to replication on that dim, warned once and
recorded in the active :class:`ShardingDecision`.

The reference walks a JAX pytree; here the walk goes over the JAX layout of
the port's parameters — the paths and stacked shapes that
:func:`repro_torch.models.lm.params_from_jax` reads (``layers.{l}.attn.wq``
is the leaf ``("layers", "attn", "wq")`` of shape ``(L, d, H·D)``) — in the
sorted-key order of a JAX dict pytree, so specs and fallback records come
out as the reference's.  A :class:`PartitionSpec` is a plain tuple of
entries (None, an axis name, or a tuple of axis names).

:func:`step_shardings` gives the dry run's in/out placement trees of a
cell's step as spec trees over the policy's mesh (the reference's
``NamedSharding`` trees, mesh left implicit); :func:`shard_shape` and
:func:`shard_bytes` turn a placement into each device's shard.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm


class PartitionSpec(tuple):
    """Per-dim mesh-axis assignment: ``PartitionSpec(None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class ShardingFallback(UserWarning):
    """A requested shard assignment was dropped (dim % axis_size != 0) and
    the dim replicated instead.  Warned once per (path, dim, axis);
    recorded in the active :class:`ShardingDecision`."""


@dataclass(frozen=True)
class FallbackRecord:
    """One dropped shard assignment: ``path[axis_index]`` of size ``dim``
    was not divisible by ``axis`` (size ``axis_size``) and fell back to
    replication."""
    path: str
    axis_index: int
    dim: int
    axis: str
    axis_size: int


@dataclass
class ShardingDecision:
    """What actually got sharded for one (cfg, policy) pair: the sanitised
    ``param_specs`` and every dropped assignment.  ``tp_fallback_fraction``
    is the share of tensor-parallel assignments that replicated instead."""
    mode: str
    tp_axis: str
    tp_requested: int
    ep: bool = False
    param_specs: Any = None
    fallbacks: List[FallbackRecord] = field(default_factory=list)

    def _mentions_tp(self, entry) -> bool:
        if entry is None:
            return False
        if isinstance(entry, tuple):
            return self.tp_axis in entry
        return entry == self.tp_axis

    @property
    def tp_fallback_fraction(self) -> float:
        dropped = sum(1 for f in self.fallbacks if self.tp_axis in (f.axis or ""))
        kept = 0
        if self.param_specs is not None:
            for spec in spec_leaves(self.param_specs).values():
                kept += sum(1 for e in spec if self._mentions_tp(e))
        return dropped / max(dropped + kept, 1)

    @property
    def effective_tp(self) -> int:
        """1 when every TP assignment fell back; the requested degree
        otherwise."""
        return 1 if self.tp_fallback_fraction >= 1.0 else self.tp_requested


# warn-once bookkeeping + the decision currently collecting fallbacks
_WARNED: set = set()
_ACTIVE_DECISION: Optional[ShardingDecision] = None


def _record_fallback(path: str, axis_index: int, dim: int, entry,
                     axis_size: int) -> None:
    axis = "+".join(entry) if isinstance(entry, tuple) else str(entry)
    key = (path, axis_index, axis, dim)
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(
            f"sharding fallback: {path or '<anon>'}[{axis_index}] dim={dim} "
            f"not divisible by axis {axis!r} (size {axis_size}); replicating",
            ShardingFallback, stacklevel=3)
    if _ACTIVE_DECISION is not None:
        _ACTIVE_DECISION.fallbacks.append(
            FallbackRecord(path, axis_index, dim, axis, axis_size))


def sharding_decision(cfg: ModelConfig, pol: "ShardingPolicy",
                      params) -> ShardingDecision:
    """Compute param specs while recording every divisibility fallback."""
    global _ACTIVE_DECISION
    d = ShardingDecision(mode=pol.mode, tp_axis=pol.tp_axis,
                         tp_requested=pol.tp_size, ep=pol.ep)
    _ACTIVE_DECISION = d
    try:
        d.param_specs = param_pspecs(cfg, pol, params)
    finally:
        _ACTIVE_DECISION = None
    return d


@dataclass(frozen=True)
class ShardingPolicy:
    mesh: Mesh
    mode: str = "tp"                 # "tp": Megatron TP × FSDP; "fsdp": pure ZeRO-3/DP
    tp_axis: str = "model"
    fsdp_axis: Optional[str] = "data"
    batch_axes: Tuple[str, ...] = ("data",)
    # decode-2D-TP: replicate the decode batch so the data axis is free for
    # weight-row sharding
    replicate_batch: bool = False
    # expert parallelism: shard the MoE expert axis on tp_axis (dense-mix
    # semantics, gate-weighted sum of the shards) instead of slicing d_ff
    ep: bool = False

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis]

    @property
    def batch_axes_pref(self) -> Tuple[str, ...]:
        """Preference order for batch sharding; fsdp mode also uses the
        model axis for pure data parallelism."""
        if self.mode == "fsdp":
            return (*self.batch_axes, self.tp_axis)
        return self.batch_axes

    @property
    def batch_size_divisor(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.batch_axes]))


def _tp_compatible(cfg: ModelConfig, tp: int) -> bool:
    """Megatron-style head sharding needs q-head counts divisible by tp."""
    if cfg.family == "ssm":
        return cfg.ssm.n_heads(cfg.d_model) % tp == 0
    if cfg.n_heads % tp != 0:
        return False
    if cfg.family == "hybrid" and cfg.ssm is not None:
        if cfg.ssm.n_heads(cfg.d_model) % tp != 0:
            return False
    return True


def make_policy(mesh: Mesh, cfg: Optional[ModelConfig] = None,
                ep: Optional[bool] = None) -> ShardingPolicy:
    axes = tuple(mesh.axis_names)
    batch_axes = ("pod", "data") if "pod" in axes else ("data",)
    mode = "tp"
    tp = mesh.shape["model"]
    if cfg is not None and not _tp_compatible(cfg, tp):
        mode = "fsdp"
    if ep is None:
        # expert parallelism by default whenever the expert axis divides
        ep = bool(cfg is not None and cfg.family == "moe" and tp > 1
                  and cfg.n_experts % tp == 0)
    return ShardingPolicy(mesh, mode=mode, batch_axes=batch_axes, ep=ep)


def _axis_size(mesh: Mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return int(np.prod([mesh.shape[a] for a in entry]))
    return mesh.shape[entry]


def _sanitize(mesh: Mesh, shape: Tuple[int, ...], spec: Tuple,
              path: str = "") -> PartitionSpec:
    """Drop axis assignments whose dim isn't divisible by the axis size;
    each drop warns once and is recorded in the active decision."""
    out = []
    for i, (dim, entry) in enumerate(zip(shape, spec)):
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            _record_fallback(path, i, dim, entry, _axis_size(mesh, entry))
            entry = None
        out.append(entry)
    return P(*out)


def _pad(shape: Tuple[int, ...], trailing: Tuple) -> Tuple:
    """Prepend None for stacked leading dims."""
    return tuple([None] * (len(shape) - len(trailing))) + tuple(trailing)


# --------------------------------------------------------------------------- #
# the JAX layout of the port's parameters, and tree walks over it
# --------------------------------------------------------------------------- #
def jax_layout(model, meta: bool = False) -> Dict[str, Any]:
    """The port's parameters as the reference's nested pytree of shapes:
    ``layers.{l}.attn.wq`` (d, H·D) becomes ``{"layers": {"attn": {"wq":
    (L, d, H·D)}}}``, ``final_norm.scale`` ``{"final_norm": {"scale":
    (d,)}}``.  Leaves are shape tuples, or with ``meta`` ``meta`` tensors
    of the stacked shape in the parameters' dtype."""
    stacked: Dict[Tuple[str, ...], Tuple[List[int], Tuple[int, ...]]] = {}
    dtypes: Dict[Tuple[str, ...], torch.dtype] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        depth = lm.STACKS.get(parts[0])
        if depth is None:
            path, idx = tuple(parts), []
        else:
            path = (parts[0], *parts[1 + depth:])
            idx = [int(i) for i in parts[1:1 + depth]]
        top, shape = stacked.get(path, ([0] * len(idx), tuple(p.shape)))
        stacked[path] = ([max(a, i + 1) for a, i in zip(top, idx)], shape)
        dtypes[path] = p.dtype
    tree: Dict[str, Any] = {}
    for path, (stack, shape) in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        full = tuple(stack) + shape
        node[path[-1]] = (torch.empty(full, dtype=dtypes[path], device="meta")
                          if meta else full)
    return tree


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, tuple) else tuple(leaf.shape)


def _walk(fn: Callable, tree: Mapping, path: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """``fn(path, shape)`` at every leaf of a nested mapping, in a JAX dict
    pytree's (sorted-key) order."""
    return {k: (_walk(fn, tree[k], path + (k,)) if isinstance(tree[k], Mapping)
                else fn(path + (k,), _shape_of(tree[k])))
            for k in sorted(tree)}


def _as_tree(params) -> Mapping:
    return params if isinstance(params, Mapping) else jax_layout(params)


# --------------------------------------------------------------------------- #
# parameter specs
# --------------------------------------------------------------------------- #
def _param_rule(cfg: ModelConfig, pol: ShardingPolicy, path: Tuple[str, ...],
                shape: Tuple[int, ...]) -> Tuple:
    tp, fs = pol.tp_axis, pol.fsdp_axis
    name = path[-1]
    in_moe_ffn = (cfg.family == "moe" and "ffn" in path)

    if name == "embed":
        return (tp, fs)
    if name == "lm_head":
        return (fs, tp)
    if name == "enc_pos":
        return (None, None)
    if name in ("scale", "A_log", "D", "dt_bias"):
        return (None,)
    if name == "norm_scale":
        return (tp,)
    if name in ("bq", "bk", "bv", "conv_b"):
        return (tp,)
    if name == "conv_w":
        return (None, tp)
    if name == "router":
        return (fs, None)
    if in_moe_ffn and name in ("w_gate", "w_up"):
        # EP shards the expert axis (whole experts per device); TP slices
        # every expert's d_ff instead
        return (tp, fs, None) if pol.ep else (None, fs, tp)
    if in_moe_ffn and name == "w_down":
        return (tp, None, fs) if pol.ep else (None, tp, fs)
    if name in ("wq", "wk", "wv", "w_gate", "w_up"):
        return (fs, tp)
    if name in ("wo", "w_down"):
        return (tp, fs)
    if name in ("wq_a", "wkv_a"):
        return (fs, None)
    if name in ("wq_b", "wk_b", "wv_b"):
        return (None, tp)
    if name == "w":  # in_proj / out_proj inner linears (mamba blocks)
        if "out_proj" in path:
            return (tp, fs)
        return (fs, tp)
    if name == "b":
        return (tp,)
    return tuple([None] * len(shape))


def param_pspecs(cfg: ModelConfig, pol: ShardingPolicy, params) -> Dict[str, Any]:
    """Specs of every parameter: ``params`` is an :class:`~repro_torch.models.lm.LM`
    or a nested mapping of shapes (or tensors) in the JAX layout."""
    def one(path, shape):
        rule = _param_rule(cfg, pol, path, shape)
        return _sanitize(pol.mesh, shape, _pad(shape, rule), path=".".join(path))
    return _walk(one, _as_tree(params))


def opt_pspecs(cfg: ModelConfig, pol: ShardingPolicy, opt) -> Dict[str, Any]:
    """m/v mirror param shardings; step counter replicated."""
    def one(path, shape):
        if path and path[0] == "step":
            return P()
        rule_path = path[1:] if path and path[0] in ("m", "v") else path
        rule = _param_rule(cfg, pol, rule_path, shape)
        return _sanitize(pol.mesh, shape, _pad(shape, rule), path=".".join(path))
    return _walk(one, opt)


# --------------------------------------------------------------------------- #
# batch / cache specs
# --------------------------------------------------------------------------- #
def _batch_entry(pol: ShardingPolicy, B: int, ignore_replicate: bool = False):
    """Longest prefix of the batch-axis preference list that divides B."""
    if pol.replicate_batch and not ignore_replicate:
        return None
    pref = pol.batch_axes_pref
    for k in range(len(pref), 0, -1):
        cand = pref[:k]
        if B % int(np.prod([pol.mesh.shape[a] for a in cand])) == 0:
            return cand if len(cand) > 1 else cand[0]
    return None


def activation_shard_flags(pol: ShardingPolicy, B: int, S: int) -> Dict[str, Any]:
    """Hidden-state constraint per cell: batch over the data axes, sequence
    over the model axis (Megatron-style sequence parallelism)."""
    b = _batch_entry(pol, B)
    bsz = 1 if b is None else _axis_size(pol.mesh, b)
    b_axes = (b,) if isinstance(b, str) else (b or ())
    seq = None
    if (S > 1 and S % pol.tp_size == 0 and pol.tp_axis not in b_axes):
        seq = pol.tp_axis
    return {"batch": b, "batch_size": bsz,
            "seq": seq, "seq_size": pol.tp_size if seq else 1}


def batch_pspecs(cfg: ModelConfig, pol: ShardingPolicy, batch) -> Dict[str, Any]:
    def one(path, shape):
        b = _batch_entry(pol, shape[0])
        rest = [None] * (len(shape) - 1)
        return _sanitize(pol.mesh, shape, (b, *rest))
    return _walk(one, batch)


def cache_pspecs(cfg: ModelConfig, pol: ShardingPolicy, cache) -> Dict[str, Any]:
    """Contiguous caches: (stack..., B, S, H, D) -> seq sharded on tp; ssm
    states: heads sharded on tp.  Batch on batch axes when divisible."""
    tp = pol.tp_axis

    def one(path, shape):
        name = path[-1]
        nstack = 2 if "groups" in path and name in ("conv", "ssm") else 1
        b = _batch_entry(pol, shape[nstack], ignore_replicate=True)
        if name in ("xk", "xv"):                      # whisper cross KV
            spec = (None, b, None, None, None)
        elif name in ("k", "v") or name.endswith("_k") or name.endswith("_v"):
            spec = (None, b, tp, None, None)
        elif name == "ckv":                           # MLA latent
            spec = (None, b, tp, None)
        elif name == "pos" or name.endswith("_pos"):
            spec = (None, b, tp)
        elif name == "conv":
            spec = tuple([None] * nstack) + (b, None, tp)
        elif name == "ssm":
            spec = tuple([None] * nstack) + (b, tp, None, None)
        else:
            spec = tuple([None] * len(shape))
        return _sanitize(pol.mesh, shape, spec, path=".".join(path))
    return _walk(one, cache)


def paged_cache_pspecs(cfg: ModelConfig, pol: ShardingPolicy, cache) -> Dict[str, Any]:
    """Paged KV pool (L, n_pages, page_size, H, D): KV **heads** shard on
    the tp axis, pages replicate (page indices are request-local and must
    stay addressable from every shard).  MLA's latent pool replicates."""
    tp = pol.tp_axis

    def one(path, shape):
        if path[-1] in ("kp", "vp"):
            spec = (None, None, None, tp, None)
        else:                               # ckvp + anything unforeseen
            spec = tuple([None] * len(shape))
        return _sanitize(pol.mesh, shape, spec, path=".".join(path))
    return _walk(one, cache)


def spec_leaves(tree) -> Dict[str, PartitionSpec]:
    """``{"layers.attn.wq": spec, ...}`` of a spec tree."""
    out: Dict[str, PartitionSpec] = {}

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                out[key] = v
    walk(tree, "")
    return out


# --------------------------------------------------------------------------- #
# full in/out placements per step kind, and the shards they give
# --------------------------------------------------------------------------- #
def step_shardings(cfg: ModelConfig, shape: ShapeSpec, pol: ShardingPolicy,
                   specs: Dict[str, Any]):
    """(in, out) placement trees matching the step signatures, over
    ``specs`` (:func:`repro_torch.models.zoo.input_specs`):

    train   -> in (params, opt_state, batch), out (loss, params, opt_state)
    prefill -> in (params, batch), out last-token logits (B, V)
    decode  -> in (params, cache, tokens, positions), out (tokens, cache)
    """
    mesh = pol.mesh
    p_params = param_pspecs(cfg, pol, specs["params"])
    if shape.kind == "train":
        p_opt = opt_pspecs(cfg, pol, specs["opt_state"])
        p_batch = batch_pspecs(cfg, pol, specs["batch"])
        return (p_params, p_opt, p_batch), (P(), p_params, p_opt)
    if shape.kind == "prefill":
        p_batch = batch_pspecs(cfg, pol, specs["batch"])
        b = _batch_entry(pol, shape.global_batch)
        out = _sanitize(mesh, (shape.global_batch, cfg.vocab_size), (b, pol.tp_axis))
        return (p_params, p_batch), out
    p_cache = cache_pspecs(cfg, pol, specs["cache"])
    b = _batch_entry(pol, shape.global_batch)
    tok = _sanitize(mesh, (shape.global_batch, 1), (b, None))
    pos = _sanitize(mesh, (shape.global_batch,), (b,))
    out_tok = _sanitize(mesh, (shape.global_batch,), (b,))
    return (p_params, p_cache, tok, pos), (out_tok, p_cache)


def shard_shape(mesh: Mesh, shape: Tuple[int, ...], spec: PartitionSpec) -> Tuple[int, ...]:
    """One device's shard of a ``shape`` placed by ``spec`` (replicated
    dims and trailing dims the spec leaves out stay whole)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _axis_size(mesh, e) for d, e in zip(shape, entries))


def _zip_leaves(tree, specs) -> List[Tuple[Any, PartitionSpec]]:
    if isinstance(specs, PartitionSpec):
        return [(tree, specs)]
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _zip_leaves(tree[k], specs[k])]
    return [x for t, s in zip(tree, specs) for x in _zip_leaves(t, s)]


def shard_bytes(mesh: Mesh, tree, specs) -> int:
    """Bytes one device holds of every leaf of ``tree`` (tensors, ``meta``
    ones included, in nested dicts, tuples or lists) placed by the spec tree
    ``specs`` of the same structure."""
    total = 0
    for leaf, spec in _zip_leaves(tree, specs):
        total += int(np.prod(shard_shape(mesh, tuple(leaf.shape), spec),
                             dtype=np.int64)) * leaf.element_size()
    return total

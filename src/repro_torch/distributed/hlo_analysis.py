"""Analytic shape-aware costs of sharded replicas (port of the costing part
of ``src/repro/distributed/hlo_analysis.py``).

The shadow rung prices a replica group's shape with these Eq. 6 / Eq. 8
terms: the effective TP degree under a sharding fallback, the per-step TP
collectives, the replica rebuild, the pipeline bubble and stage hand-off,
and the unfused paged-decode overhead.  The while-aware HLO parser and
``analyze_hlo`` (roofline terms from a compiled module) are not here yet:
they come with the dry run, ROADMAP queue 1 item 11.
"""
from __future__ import annotations


# --------------------------------------------------------------------------- #
# analytic shape-aware costs for sharded replicas (no compiled module needed)
#
# These are the Eq. 6 / Eq. 8 terms expressed per ReplicaGroup shape so the
# shadow rung and the roofline tables can rank TP-vs-DP trade-offs without
# compiling every candidate.  ``z`` is a repro_torch.core.plan.ModelSpec and ``g``
# a repro_torch.core.plan.GPUType (duck-typed: only the named attributes are read).
# --------------------------------------------------------------------------- #
def tp_fallback_fraction(z, tp: int) -> float:
    """Analytic counterpart of ShardingDecision.tp_fallback_fraction: 0.0
    when the model shards cleanly at this degree (heads divide for dense
    attention/FFN, or experts divide for the EP path), 1.0 when NEITHER
    does — the sharding layer would replicate every TP dim and the replica
    pays tp× devices for 1× compute."""
    if tp <= 1:
        return 0.0
    heads_ok = bool(z.n_heads and z.n_heads % tp == 0)
    experts_ok = bool(z.n_experts and z.n_experts % tp == 0)
    return 0.0 if (heads_ok or experts_ok) else 1.0


def effective_tp(z, tp: int) -> int:
    """TP degree the compute actually splits by (1 under full fallback)."""
    return 1 if tp_fallback_fraction(z, tp) >= 1.0 else max(tp, 1)


def tp_collective_bytes_per_token(z, tp: int) -> float:
    """Eq. 6 traffic: two ring all-reduces per layer over the residual
    stream, per token, per device — 2 · 2(t−1)/t · L · d · η bytes."""
    if tp <= 1:
        return 0.0
    return (2.0 * 2.0 * (tp - 1) / tp
            * z.n_layers * z.d_model * z.dtype_bytes)


def step_collective_s(z, g, tp: int, batch: int, seq: int = 1) -> float:
    """Wall-clock of one step's TP collectives for ``batch·seq`` tokens on
    GPUType ``g`` (intra-node link while the shard fits a node)."""
    eff = effective_tp(z, tp)
    if eff <= 1:
        return 0.0
    bw = g.intra_bw if eff <= g.devices_per_node else g.inter_bw
    return tp_collective_bytes_per_token(z, eff) * batch * seq / bw


def rebuild_cost_s(z, g, tp: int, pp: int = 1) -> float:
    """Shape-aware replica (re)build: each device of a tp-way (and pp-deep)
    replica pulls its 1/(tp·pp) weight shard over PCIe in parallel, so
    widening TP or deepening the pipeline shrinks the rebuild the shadow
    rung charges for a placement change — including a stage re-cut, which
    diffs as a placement change and re-stages only layer slices."""
    shard = z.weight_bytes / max(effective_tp(z, tp) * max(pp, 1), 1)
    return shard / g.pcie_bw


def pipeline_bubble_fraction(pp: int, microbatches: int) -> float:
    """Fill/drain bubble of a pp-stage pipeline fed m microbatches:
    (pp − 1) / (pp − 1 + m).  The engine streams each prefill chunk as up
    to pp micro-chunks, so m defaults to the chunk stream depth — deeper
    pipelines claw back less of their 1/pp per-stage compute win."""
    if pp <= 1:
        return 0.0
    return (pp - 1) / float(pp - 1 + max(microbatches, 1))


def stage_activation_bytes_per_token(z, pp: int) -> float:
    """Inter-stage hand-off traffic: each of the pp−1 boundaries forwards
    the d_model hidden state per token (replicated commit onto the next
    stage's submesh)."""
    if pp <= 1:
        return 0.0
    return (pp - 1) * z.d_model * z.dtype_bytes


def stage_handoff_s(z, g, pp: int, batch: int, seq: int = 1) -> float:
    """Wall-clock of one step's inter-stage activation transfers for
    ``batch·seq`` tokens.  Stage submeshes land on separate fragments by
    design, so the hand-off is priced at the intra-node link — the honest
    tax that keeps shadow ranking from preferring pp when one contiguous
    submesh (pure TP) is actually available."""
    return stage_activation_bytes_per_token(z, pp) * batch * seq / g.intra_bw


def fused_paged_supported(z, tp: int) -> bool:
    """Analytic counterpart of the engines' fused paged flash-decode gate
    (``serving.sharded.fused_paged_unsupported_reason``): the shard_map
    wrapper needs KV-head counts divisible by tp.  ModelSpec carries no
    softcap/MLA capability bits, so this covers the *sharding* half of the
    gate — the half that varies with the (tp, dp, pp) shape being priced;
    kernel-capability gaps are shape-invariant and cancel in ranking."""
    kv = getattr(z, "n_kv_heads", 0) or 0
    if kv <= 0:
        return False
    return kv % max(tp, 1) == 0


def unfused_paged_decode_overhead_s(z, g, tp: int, batch: int,
                                    kv_tokens: int) -> float:
    """Extra HBM time per decode step when paged decode cannot run fused.

    The unfused path gathers the page pool into contiguous (B, S, Hkv, D)
    K and V copies per layer — materialised (written) then read by the
    attention matmuls, while the fused kernel streams pages once.  Per
    step that is 2 (K,V) · 2 (write + re-read) extra passes over
    ``batch · kv_tokens`` tokens' per-layer KV bytes, split across the
    effective tp shards' aggregate HBM bandwidth."""
    kv = getattr(z, "n_kv_heads", 0) or 0
    if kv <= 0:                       # no per-head KV cache to gather
        return 0.0
    eff = effective_tp(z, tp)
    per_tok = z.n_layers * kv * z.d_head * z.dtype_bytes
    return 2.0 * 2.0 * batch * kv_tokens * per_tok / (eff * g.hbm_bw)

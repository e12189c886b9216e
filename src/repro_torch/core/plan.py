"""Serving-plan / cluster / workload data model (paper §2.1, §5.1, Table 5)
(port of ``src/repro/core/plan.py``: a copy, so plans built by either
control plane drive either backend).

A *serving plan* σ assigns each model a replica group (GPU type, TP degree,
per-replica batch, replica count).  A *policy* is the pair
(should_reschedule(ctx), schedule(ctx)) that produces plans over time.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


# --------------------------------------------------------------------------- #
# hardware
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class GPUType:
    name: str
    mem_bytes: float           # HBM capacity per device (m_g)
    flops: float               # peak dense BF16/FP16 FLOP/s (F_g)
    hbm_bw: float              # bytes/s (B_g)
    pcie_bw: float             # bytes/s reconfiguration transport (P_g)
    intra_bw: float            # NVLink/ICI intra-node bytes/s
    inter_bw: float            # cross-node bytes/s
    devices_per_node: int = 8


# Paper environments (§7) + TPU v5e target (DESIGN.md §3)
HARDWARE: Dict[str, GPUType] = {
    "H100-80G": GPUType("H100-80G", 80e9, 989e12, 3.35e12, 64e9, 300e9, 50e9, 8),
    "H200-SXM": GPUType("H200-SXM", 141e9, 989e12, 4.80e12, 64e9, 300e9, 50e9, 8),
    "A100-80G": GPUType("A100-80G", 80e9, 312e12, 2.03e12, 32e9, 300e9, 20e9 / 8, 8),
    "A100-40G": GPUType("A100-40G", 40e9, 312e12, 1.55e12, 32e9, 300e9, 20e9 / 8, 8),
    "H20-96G": GPUType("H20-96G", 96e9, 148e12, 4.0e12, 64e9, 300e9, 20e9 / 8, 8),
    "TPU-v5e": GPUType("TPU-v5e", 16e9, 197e12, 819e9, 25e9, 50e9, 25e9, 4),
}
HARDWARE["H100-SXM"] = dataclasses.replace(HARDWARE["H100-80G"], name="H100-SXM")


# --------------------------------------------------------------------------- #
# models (simulator-side description; Eq. 2 terms)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ModelSpec:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0
    n_experts: int = 0          # MoE
    top_k: int = 0
    ssm_state: int = 0          # attention-free decode state
    dtype_bytes: float = 2.0    # η/8
    tied_embeddings: bool = False  # Eq. 2 uses 2·H·V (untied); tied halves it

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))

    @property
    def weight_bytes(self) -> float:
        """Eq. 2, generalised to MoE (all experts stored)."""
        d, dh = self.d_model, self.d_head
        ffn = 3 * d * self.d_ff
        if self.n_experts:
            ffn *= self.n_experts
        per_layer = (ffn
                     + 2 * self.n_heads * d * dh
                     + 2 * self.n_kv_heads * d * dh)
        emb = (1 if self.tied_embeddings else 2) * d * self.vocab_size
        return (self.n_layers * per_layer + emb) * self.dtype_bytes

    @property
    def active_ffn_factor(self) -> float:
        if self.n_experts:
            return self.top_k / self.n_experts
        return 1.0

    @property
    def kv_bytes_per_token(self) -> float:
        if self.n_heads == 0:
            return 0.0
        return 2 * self.n_layers * self.n_kv_heads * self.d_head * self.dtype_bytes


def qwen25(size: str) -> ModelSpec:
    """Qwen2.5 family used by the paper's case studies (Appendix H)."""
    t = {
        "1.5B": dict(n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960),
        "3B": dict(n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008),
        "7B": dict(n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944),
        "14B": dict(n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824),
        "32B": dict(n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648),
        "72B": dict(n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568),
    }[size]
    return ModelSpec(name=f"qwen2.5-{size.lower()}", vocab_size=152064, **t)


QWEN25_FAMILY = {s: qwen25(s) for s in ("1.5B", "3B", "7B", "14B", "32B", "72B")}


def spec_from_config(cfg) -> ModelSpec:
    """Bridge: assigned-architecture ModelConfig -> simulator ModelSpec."""
    return ModelSpec(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=max(cfg.n_heads, 1), n_kv_heads=max(cfg.n_kv_heads, 1),
        d_ff=cfg.d_ff if cfg.d_ff else 2 * cfg.d_model,  # ssm in_proj approx
        vocab_size=cfg.vocab_size, d_head=cfg.d_head or 0,
        n_experts=cfg.n_experts, top_k=cfg.top_k,
        ssm_state=(cfg.ssm.d_state if cfg.ssm else 0),
        tied_embeddings=cfg.tie_embeddings,
    )


# --------------------------------------------------------------------------- #
# workload / cluster / plan
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Workload:
    """λ_{z,i}, s^p_{z,i}, s^d_{z,i} for one model at one timestamp."""
    model: str
    batch: int
    prefill_len: int
    decode_len: int


@dataclass(frozen=True)
class ClusterState:
    gpus: Tuple[Tuple[str, int], ...]      # ((gpu_type, count), ...)

    def count(self, g: str) -> int:
        return dict(self.gpus).get(g, 0)

    @property
    def total(self) -> int:
        return sum(c for _, c in self.gpus)

    def types(self) -> List[str]:
        return [g for g, c in self.gpus if c > 0]


def default_stage_cuts(n_layers: int, pp: int,
                       balance: str = "even") -> Tuple[int, ...]:
    """Interior layer boundaries for a ``pp``-deep pipeline.

    With ``bounds = (0,) + cuts + (n_layers,)``, stage *i* runs layers
    ``[bounds[i], bounds[i+1])``.  ``even`` splits near-equally;
    ``front-light`` gives stage 0 one fewer layer (it already hosts the
    embedding lookup) and ``rear-light`` lightens the last stage (it hosts
    the final norm + LM head).  Returns ``()`` when ``pp <= 1`` or the model
    is shallower than the pipeline.
    """
    pp = int(pp)
    if pp <= 1 or n_layers < pp:
        return ()
    bounds = [round(i * n_layers / pp) for i in range(pp + 1)]
    bounds[0], bounds[pp] = 0, n_layers
    for i in range(1, pp + 1):           # rounding can collapse boundaries
        bounds[i] = max(bounds[i], bounds[i - 1] + 1)
    for i in range(pp, 0, -1):           # ...push back if we overshot the top
        if bounds[i - 1] >= bounds[i]:
            bounds[i - 1] = bounds[i] - 1
    if balance == "front-light" and bounds[1] > 1:
        bounds[1] -= 1
    elif balance == "rear-light" and bounds[pp] - bounds[pp - 1] > 1:
        bounds[pp - 1] += 1
    return tuple(bounds[1:pp])


def valid_stage_cuts(n_layers: int, pp: int, cuts: Tuple[int, ...]) -> bool:
    """True when ``cuts`` are legal interior boundaries for a ``pp``-deep
    pipeline over ``n_layers`` layers: len pp-1, strictly increasing, and
    strictly inside (0, n_layers) so every stage owns >= 1 layer."""
    if pp <= 1:
        return tuple(cuts) == ()
    if len(cuts) != pp - 1:
        return False
    b = (0,) + tuple(int(c) for c in cuts) + (n_layers,)
    return all(b[i] < b[i + 1] for i in range(pp))


@dataclass(frozen=True)
class ReplicaGroup:
    model: str
    gpu_type: str
    tp: int
    batch: int                 # per-replica concurrent batch
    count: int                 # number of replicas
    # intra-replica data parallelism: each replica's submesh is (dp, tp) and
    # its batch is sharded dp-ways, so one replica owns tp·dp devices.
    # Trailing default keeps every positional ReplicaGroup(...) call working.
    dp: int = 1
    # pipeline parallelism: pp stages, each on its own (dp, tp) stage submesh,
    # so one replica owns pp·dp·tp devices.  stage_cuts are the interior layer
    # boundaries (len pp-1, strictly increasing); () means the default even
    # split.  Stages tolerate fragmented free sets — each stage submesh can
    # land on a different free fragment, which is the whole point of pp on
    # elastic clusters (FlexPipe).
    pp: int = 1
    stage_cuts: Tuple[int, ...] = ()

    @property
    def devices(self) -> int:
        return self.tp * self.dp * self.pp * self.count

    @property
    def capacity(self) -> int:
        return self.batch * self.count

    @property
    def submesh_shape(self) -> Tuple[int, int, int]:
        """(pipe, data, model) mesh shape of one replica."""
        return (self.pp, self.dp, self.tp)

    @property
    def stage_submesh_shape(self) -> Tuple[int, int]:
        """(data, model) mesh shape of ONE pipeline stage — what the
        allocator actually carves, pp times per replica."""
        return (self.dp, self.tp)


@dataclass(frozen=True)
class Plan:
    groups: Tuple[ReplicaGroup, ...] = ()

    def for_model(self, model: str) -> List[ReplicaGroup]:
        return [g for g in self.groups if g.model == model]

    def devices_used(self) -> Dict[str, int]:
        used: Dict[str, int] = {}
        for g in self.groups:
            used[g.gpu_type] = used.get(g.gpu_type, 0) + g.devices
        return used

    def placement(self, model: str) -> Tuple[Tuple, ...]:
        """Hashable (gpu_type, tp, dp, pp, stage_cuts, count) tuple per
        model — reconfig diffing.  dp/pp/stage_cuts join tp so a TP×DP×PP
        reshape of the same device budget — including a pure stage re-cut at
        unchanged pp — registers as a placement change and routes through
        the pool's migrate path instead of being silently ignored."""
        return tuple(sorted((g.gpu_type, g.tp, g.dp, g.pp, g.stage_cuts,
                             g.count)
                            for g in self.groups if g.model == model))


EMPTY_PLAN = Plan(())


@dataclass
class Ctx:
    """Shared observation passed to should_reschedule / schedule (§5.1)."""
    time: float
    timestamp_idx: int
    workloads: List[Workload]
    cluster: ClusterState
    current_plan: Optional[Plan]
    models: Dict[str, ModelSpec]
    hardware: Dict[str, GPUType]
    simulator: "object"                    # roofline simulator (duck-typed)
    history: List[List[Workload]] = field(default_factory=list)
    last_resched_workloads: Optional[List[Workload]] = None
    last_resched_cluster: Optional[ClusterState] = None
    scratch: Dict = field(default_factory=dict)   # policy-private state

    def workload_for(self, model: str) -> Optional[Workload]:
        for w in self.workloads:
            if w.model == model:
                return w
        return None

    def cluster_changed(self) -> bool:
        return (self.last_resched_cluster is not None
                and self.last_resched_cluster != self.cluster)

    def workload_shift(self) -> float:
        """Relative L1 shift in per-model load vs. the last reschedule."""
        if not self.last_resched_workloads:
            return float("inf")
        old = {w.model: w for w in self.last_resched_workloads}
        num = den = 0.0
        for w in self.workloads:
            o = old.get(w.model)
            ot = o.batch * (o.prefill_len + o.decode_len) if o else 0.0
            nt = w.batch * (w.prefill_len + w.decode_len)
            num += abs(nt - ot)
            den += max(ot, 1.0)
        return num / max(den, 1.0)

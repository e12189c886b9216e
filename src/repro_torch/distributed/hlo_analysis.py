"""While-aware HLO analysis, roofline terms at the card's peaks, and the
analytic shape-aware costs of sharded replicas (port of
``src/repro/distributed/hlo_analysis.py``).

The text parser is the reference's, as is: computations are parsed into
blocks, a while op's ``known_trip_count`` multiplies its body and condition
(nested whiles compose), FLOPs are 2 × |out| × |contraction| of every
``dot``, HBM bytes Σ top-level op output bytes × 2, collective bytes Σ the
outputs of all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute.  It is pure text work: the port lowers to no HLO, so
its dry run (:mod:`repro_torch.launch.dryrun`) fills :class:`RooflineTerms`
from the model's FLOPs and the step's argument bytes instead, and the
parser reads HLO text that JAX wrote.

:class:`RooflineTerms` keeps the reference's arithmetic with the H100's
datasheet peaks in place of the TPU constants.

The shadow rung prices a replica group's shape with the Eq. 6 / Eq. 8
terms below: the effective TP degree under a sharding fallback, the
per-step TP collectives, the replica rebuild, the pipeline bubble and stage
hand-off, and the unfused paged-decode overhead.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "token": 0,
}

_COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COMP_HEADER_RE = re.compile(
    r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\((.*?)\)\s*->", re.MULTILINE)
_OP_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^()]*\)|[a-z0-9]+\[[0-9,]*\]\S*)\s+"
    r"([\w\-\$]+)\(")
_WHILE_RE = re.compile(
    r"while\(.*?condition=%?([\w.\-]+),\s*body=%?([\w.\-]+)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_LHS_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_LHS_BATCH_RE = re.compile(r"lhs_batch_dims=\{([0-9,]*)\}")
_OPERANDS_RE = re.compile(r"\(((?:%[\w.\-]+(?:,\s*)?)+)\)")


def _parse_shape(text: str) -> Tuple[int, List[Tuple[str, List[int]]]]:
    """Total bytes + list of (dtype, dims) for a shape string (maybe tuple)."""
    total = 0
    shapes = []
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        dl = [int(d) for d in dims.split(",")] if dims else []
        n = 1
        for d in dl:
            n *= d
        total += n * _DTYPE_BYTES[dt]
        shapes.append((dt, dl))
    return total, shapes


@dataclass
class _Op:
    name: str
    shape_text: str
    kind: str
    line: str


@dataclass
class _Computation:
    name: str
    params: Dict[str, str] = field(default_factory=dict)   # name -> shape text
    ops: List[_Op] = field(default_factory=list)
    lines: List[str] = field(default_factory=list)         # raw body lines


def parse_computations(hlo: str) -> Dict[str, _Computation]:
    comps: Dict[str, _Computation] = {}
    cur: Optional[_Computation] = None
    for raw in hlo.splitlines():
        line = raw.rstrip()
        header = _COMP_HEADER_RE.match(line.strip()) if line.endswith("{") else None
        if header and "=" not in line.split("(")[0]:
            cur = _Computation(header.group(1))
            comps[cur.name] = cur
            # parse params: "param_0.2: f32[7,128,64], param_1: s32[]"
            for part in header.group(2).split(","):
                if ":" in part:
                    pname, pshape = part.split(":", 1)
                    cur.params[pname.strip().lstrip("%")] = pshape.strip()
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        cur.lines.append(line)
        m = _OP_DEF_RE.match(line)
        if m:
            cur.ops.append(_Op(m.group(1), m.group(2), m.group(3), line))
    return comps


def _entry_name(hlo: str) -> Optional[str]:
    m = re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo, re.MULTILINE)
    return m.group(1) if m else None


def execution_multipliers(comps: Dict[str, _Computation],
                          entry: str) -> Tuple[Dict[str, float], Dict[str, str]]:
    """Per-computation execution count: entry=1; while bodies × trip_count;
    fusion/call callees inherit the caller's multiplier.

    Also returns a reach-kind map: "control" (entry / while body+cond — ops
    materialize to HBM) vs "fused" (fusion / to_apply bodies — ops stay in
    registers/VMEM)."""
    mult: Dict[str, float] = {name: 0.0 for name in comps}
    kind: Dict[str, str] = {name: "fused" for name in comps}
    if entry not in comps:
        return {name: 1.0 for name in comps}, {name: "control" for name in comps}
    mult[entry] = 1.0
    kind[entry] = "control"
    # iterate to fixpoint over RAW lines (op-regex can miss exotic tuple
    # shapes; the call-graph scan must not). DAG → few passes suffice.
    for _ in range(len(comps) + 2):
        changed = False
        for cname, comp in comps.items():
            m = mult.get(cname, 0.0)
            if m <= 0:
                continue
            for line in comp.lines:
                trip = 1.0
                targets: List[str] = []
                tkind = "fused"
                wm = _WHILE_RE.search(line)
                if wm:
                    tm = _TRIP_RE.search(line)
                    trip = float(tm.group(1)) if tm else 1.0
                    targets = [wm.group(1), wm.group(2)]
                    tkind = "control"
                else:
                    cm = _CALLS_RE.search(line)
                    if cm:
                        targets = [cm.group(1)]
                    tm = re.search(r"to_apply=%?([\w.\-]+)", line)
                    if tm:
                        targets.append(tm.group(1))
                for t in targets:
                    if t in mult:
                        new = m * trip
                        if new > mult[t]:
                            mult[t] = new
                            changed = True
                        if tkind == "control" and kind[t] != "control":
                            kind[t] = "control"
                            changed = True
        if not changed:
            break
    # anything still unreached (parser miss): count once, never drop
    for name in mult:
        if mult[name] <= 0:
            mult[name] = 1.0
    return mult, kind


def _dot_flops(comp: _Computation, op: _Op) -> float:
    out_bytes, out_shapes = _parse_shape(op.shape_text)
    if not out_shapes:
        return 0.0
    out_elems = 1
    for d in out_shapes[0][1]:
        out_elems *= d
    cm = _LHS_CONTRACT_RE.search(op.line)
    if not cm:
        return 0.0
    cdims = [int(x) for x in cm.group(1).split(",")] if cm.group(1) else []
    # lhs operand shape
    om = _OPERANDS_RE.search(op.line[op.line.index(op.kind):])
    if not om:
        return 0.0
    lhs_name = om.group(1).split(",")[0].strip().lstrip("%")
    lhs_shape_text = comp.params.get(lhs_name)
    if lhs_shape_text is None:
        for other in comp.ops:
            if other.name == lhs_name:
                lhs_shape_text = other.shape_text
                break
    if lhs_shape_text is None:
        return 0.0
    _, lhs_shapes = _parse_shape(lhs_shape_text)
    if not lhs_shapes:
        return 0.0
    ldims = lhs_shapes[0][1]
    k = 1
    for c in cdims:
        if c < len(ldims):
            k *= ldims[c]
    return 2.0 * out_elems * k


_SKIP_BYTES_KINDS = {"tuple", "get-tuple-element", "parameter", "constant",
                     "bitcast", "after-all", "partition-id", "replica-id"}


@dataclass
class HLOAnalysis:
    flops: float = 0.0                 # per-device, while-scaled, dots only
    bytes_accessed: float = 0.0        # per-device, while-scaled estimate
    collective_bytes: float = 0.0      # per-device, while-scaled
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        parts = [f"{k}: n={int(self.collective_count.get(k, 0))} "
                 f"bytes={int(v):,}"
                 for k, v in sorted(self.collective_by_kind.items())]
        return "; ".join(parts) if parts else "none"


def analyze_hlo(hlo: str) -> HLOAnalysis:
    comps = parse_computations(hlo)
    entry = _entry_name(hlo)
    if entry:
        mult, kind = execution_multipliers(comps, entry)
    else:
        mult = {n: 1.0 for n in comps}
        kind = {n: "control" for n in comps}
    res = HLOAnalysis()
    for cname, comp in comps.items():
        m = mult.get(cname, 1.0)
        if m <= 0:
            continue
        materializes = kind.get(cname, "control") == "control"
        for op in comp.ops:
            if op.kind == "dot":
                res.flops += m * _dot_flops(comp, op)
            if materializes and op.kind not in _SKIP_BYTES_KINDS:
                b, _ = _parse_shape(op.shape_text)
                res.bytes_accessed += m * 2.0 * b
            for ckind in _COLLECTIVE_KINDS:
                if op.kind == ckind or op.kind == f"{ckind}-start":
                    b, _ = _parse_shape(op.shape_text)
                    # -start outputs carry (input, output) tuples; halve
                    if op.kind.endswith("-start"):
                        b = b / 2.0
                    res.collective_bytes += m * b
                    res.collective_by_kind[ckind] = \
                        res.collective_by_kind.get(ckind, 0.0) + m * b
                    res.collective_count[ckind] = \
                        res.collective_count.get(ckind, 0.0) + m
                    break
    return res


# --------------------------------------------------------------------------- #
# roofline terms at the card's peaks
# --------------------------------------------------------------------------- #
# NVIDIA H100 SXM5 80GB, from NVIDIA's datasheet (peaks, not measurements):
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12                # HBM3 bytes/s per card
ICI_BW = 450e9                  # NVLink 4, bytes/s per direction per card


@dataclass
class RooflineTerms:
    hlo_flops: float            # per-device FLOPs (while-scaled)
    hlo_bytes: float            # per-device HBM bytes (while-scaled estimate)
    collective_bytes: float     # per-device collective traffic (while-scaled)
    n_chips: int
    model_flops: float = 0.0    # useful whole-step FLOPs (6·N·D / 2·N·D)
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.ici_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        if self.hlo_flops <= 0:
            return 0.0
        return (self.model_flops / self.n_chips) / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """ideal useful-FLOPs time / dominant-bound time."""
        if self.bound_s <= 0:
            return 0.0
        ideal = (self.model_flops / self.n_chips) / self.peak_flops
        return ideal / self.bound_s

    def as_dict(self) -> Dict[str, float]:
        return {
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_chips": self.n_chips,
        }


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

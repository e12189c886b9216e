"""Roofline-based serving simulator — faithful Appendix-B implementation (port of ``src/repro/core/simulator.py``).

Provides the two estimators the evaluator needs:
  * serve-time estimation  Λ(z, g, t, b, s_p, s_d)   (Eqs. 3–6)
  * reconfiguration cost   RECONFIG-COST(σ_{i-1}, σ_i)  (Eqs. 8–11)

plus memory feasibility (Eq. 7) and plan-level makespan aggregation
(T_balanced = max_z L_z).  Hardware profiles live in plan.HARDWARE; the
``calibration`` dict lets the control plane fit per-(model, hw) efficiency
factors against measured/dry-run numbers (DESIGN.md §3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.plan import (ClusterState, GPUType, ModelSpec, Plan,
                             ReplicaGroup, Workload, valid_stage_cuts)

PENALTY = 1e9                   # Λ∞ for infeasible groups
MEM_THETA = 0.8                 # Eq. 7 memory utilisation threshold


def _pcie_coeff(weight_bytes: float) -> float:
    """c_z ∈ [5.3, 11.5]: smaller models pay more per byte (App. B)."""
    gb = weight_bytes / 1e9
    lo_gb, hi_gb = 3.0, 150.0
    x = min(max((math.log(max(gb, 1e-3)) - math.log(lo_gb))
                / (math.log(hi_gb) - math.log(lo_gb)), 0.0), 1.0)
    return 11.5 - x * (11.5 - 5.3)


@dataclass
class Simulator:
    models: Dict[str, ModelSpec]
    hardware: Dict[str, GPUType]
    # multiplicative efficiency calibration: (model, gpu) -> factor on Λ
    calibration: Dict[Tuple[str, str], float] = field(default_factory=dict)
    # caches: Λ memo + plan-level serve-cost memo (Plan/Workload are frozen)
    _memo: Dict[Tuple, float] = field(default_factory=dict)
    _serve_memo: Dict[Tuple, float] = field(default_factory=dict)

    # ------------------------------------------------------------------ #
    # roofline op model (Eqs. 3–4)
    # ------------------------------------------------------------------ #
    @staticmethod
    def op_time(flops: float, bytes_: float, g: GPUType) -> float:
        if flops <= 0:
            return bytes_ / g.hbm_bw if bytes_ > 0 else 0.0
        ai = flops / max(bytes_, 1.0)
        perf = min(ai * g.hbm_bw, g.flops)
        return flops / perf

    # ------------------------------------------------------------------ #
    # per-phase transformer costs
    # ------------------------------------------------------------------ #
    def _layer_time(self, z: ModelSpec, g: GPUType, t: int, b: int,
                    s: int, kv_len: float, phase: str) -> float:
        """One transformer layer, TP degree t: proj + attention + FFN (+DK)."""
        d, dh = z.d_model, z.d_head
        h, hk = z.n_heads / t, max(z.n_kv_heads / t, 1.0)
        eta = z.dtype_bytes
        tok = b * s

        total = 0.0
        # QKV + output projections
        qkv_flops = 2 * tok * d * (h * dh + 2 * hk * dh) + 2 * tok * (h * dh) * d
        qkv_bytes = (d * (h + 2 * hk + h) * dh) * eta + 2 * tok * d * eta
        total += self.op_time(qkv_flops, qkv_bytes, g)
        # attention scores + values
        if z.n_heads > 0:
            attn_flops = 2 * b * h * s * kv_len * dh * 2
            attn_bytes = (b * hk * kv_len * dh * 2 * eta          # KV read
                          + b * h * s * dh * 2 * eta)
            total += self.op_time(attn_flops, attn_bytes, g)
        if z.ssm_state:
            ssd_flops = 2 * tok * (2 * d / t) * z.ssm_state * 2
            ssd_bytes = b * (2 * d / t) * z.ssm_state * 4 + tok * d * eta
            total += self.op_time(ssd_flops, ssd_bytes, g)
        # FFN (MoE: active-expert compute, all-touched-expert weight traffic)
        ffn_flops = 2 * tok * 3 * d * (z.d_ff / t) * (z.top_k if z.n_experts else 1)
        n_e = min(z.n_experts, max(tok * z.top_k, 1)) if z.n_experts else 1
        ffn_bytes = (3 * d * z.d_ff / t) * n_e * eta + 2 * tok * d * eta
        total += self.op_time(ffn_flops, ffn_bytes, g)
        return total

    def _comm_time(self, z: ModelSpec, g: GPUType, t: int, b: int, s: int) -> float:
        """Eq. 6: two ring all-reduces per layer."""
        if t <= 1:
            return 0.0
        r = g.intra_bw if t <= g.devices_per_node else g.inter_bw
        vol = 2 * (t - 1) / t * 2 * z.n_layers * z.d_model * b * s * z.dtype_bytes
        return vol / r

    def prefill_time(self, z: ModelSpec, g: GPUType, t: int, b: int,
                     s_p: int) -> float:
        per_layer = self._layer_time(z, g, t, b, s_p, kv_len=s_p / 2, phase="prefill")
        head = self.op_time(2 * b * s_p * z.d_model * z.vocab_size / t,
                            z.d_model * z.vocab_size * z.dtype_bytes / t, g)
        return z.n_layers * per_layer + head + self._comm_time(z, g, t, b, s_p)

    def decode_time(self, z: ModelSpec, g: GPUType, t: int, b: int,
                    s_p: int, s_d: int) -> float:
        """Σ_k per-token decode cost with growing KV (closed-form mean KV)."""
        if s_d <= 0:
            return 0.0
        mean_kv = s_p + s_d / 2
        per_layer = self._layer_time(z, g, t, b, 1, kv_len=mean_kv, phase="decode")
        head = self.op_time(2 * b * z.d_model * z.vocab_size / t,
                            z.d_model * z.vocab_size * z.dtype_bytes / t, g)
        per_tok = z.n_layers * per_layer + head + self._comm_time(z, g, t, b, 1)
        return s_d * per_tok

    # ------------------------------------------------------------------ #
    # Λ and memory feasibility
    # ------------------------------------------------------------------ #
    def group_latency(self, z_name: str, g_name: str, t: int, b: int,
                      s_p: int, s_d: int) -> float:
        """Eq. 5 total latency for one replica group serving batch b."""
        key = (z_name, g_name, t, b, s_p, s_d)
        if key in self._memo:
            return self._memo[key]
        z, g = self.models[z_name], self.hardware[g_name]
        if not self.fits(z_name, g_name, t, b, s_p + s_d):
            self._memo[key] = PENALTY
            return PENALTY
        lat = (self.prefill_time(z, g, t, b, s_p)
               + self.decode_time(z, g, t, b, s_p, s_d))
        lat *= self.calibration.get((z_name, g_name), 1.0)
        self._memo[key] = lat
        return lat

    def fits(self, z_name: str, g_name: str, t: int, b: int,
             total_len: int) -> bool:
        """Eq. 7 + KV headroom."""
        z, g = self.models[z_name], self.hardware[g_name]
        shard = z.weight_bytes / t
        kv = b * total_len * z.kv_bytes_per_token / t
        return shard + kv <= MEM_THETA * g.mem_bytes

    # ------------------------------------------------------------------ #
    # plan-level serving time (makespan over models; Table 5 L_z)
    # ------------------------------------------------------------------ #
    def model_latency(self, plan: Plan, w: Workload) -> float:
        groups = plan.for_model(w.model)
        if not groups:
            return PENALTY
        worst = 0.0
        cap = sum(g.capacity for g in groups)
        if cap <= 0:
            return PENALTY
        for g in groups:
            share = math.ceil(w.batch * g.capacity / cap / max(g.count, 1))
            share = max(min(share, g.batch), 1)
            waves = math.ceil(w.batch * (g.capacity / cap) / max(g.capacity, 1))
            lat = self.group_latency(w.model, g.gpu_type, g.tp, share,
                                     w.prefill_len, w.decode_len)
            worst = max(worst, lat * max(waves, 1))
        return worst

    def serve_cost(self, plan: Plan, workloads: List[Workload]) -> float:
        """SERVE-COST(σ): makespan across concurrently-served models."""
        if plan is None or not plan.groups:
            return PENALTY
        key = (plan, tuple(workloads))
        if key not in self._serve_memo:
            self._serve_memo[key] = max(self.model_latency(plan, w)
                                        for w in workloads)
        return self._serve_memo[key]

    # ------------------------------------------------------------------ #
    # reconfiguration cost (Eqs. 8–11)
    # ------------------------------------------------------------------ #
    def weight_transfer_time(self, z_name: str, g_name: str) -> float:
        z, g = self.models[z_name], self.hardware[g_name]
        return z.weight_bytes / g.pcie_bw * _pcie_coeff(z.weight_bytes)

    def reconfig_cost(self, old: Optional[Plan], new: Plan) -> float:
        if old is None or not old.groups:
            return 0.0                      # cold start: loading folded into sched
        changed = [m for m in {g.model for g in new.groups} | {g.model for g in old.groups}
                   if old.placement(m) != new.placement(m)]
        if not changed:
            return 0.0
        t_term = 0.0
        for z in changed:
            for g in old.for_model(z):
                t_term = max(t_term, self.weight_transfer_time(z, g.gpu_type))
        t_load = 0.0
        for z in changed:
            for g in new.for_model(z):
                t_load = max(t_load, self.weight_transfer_time(z, g.gpu_type))
        return t_term + t_load

    def plan_feasible(self, plan: Plan, cluster: ClusterState,
                      workloads: Optional[List[Workload]] = None
                      ) -> Tuple[bool, str]:
        used = plan.devices_used()
        for g_name, n in used.items():
            if n > cluster.count(g_name):
                return False, f"{g_name}: need {n} > have {cluster.count(g_name)}"
        lens = {w.model: w.prefill_len + w.decode_len for w in (workloads or [])}
        for g in plan.groups:
            if (g.count <= 0 or g.tp <= 0 or g.batch <= 0 or g.dp <= 0
                    or g.pp <= 0):
                return False, f"degenerate group {g}"
            z = self.models.get(g.model)
            if z is not None and g.tp > 1:
                heads_ok = z.n_heads and z.n_heads % g.tp == 0
                experts_ok = z.n_experts and z.n_experts % g.tp == 0
                if not (heads_ok or experts_ok):
                    return False, (f"tp={g.tp} unshardable for {g.model} "
                                   f"(n_heads={z.n_heads}, "
                                   f"n_experts={z.n_experts})")
            if g.pp > 1 and z is not None:
                # pipeline stages are layer slices: recurrent-state families
                # keep pp=1 (the engine cannot stage-slice hybrid groups) and
                # the model must be at least pp layers deep; explicit cuts
                # must be strictly increasing interior boundaries
                if z.ssm_state:
                    return False, f"pp={g.pp} unsupported for ssm {g.model}"
                if z.n_layers < g.pp:
                    return False, (f"pp={g.pp} deeper than {g.model}'s "
                                   f"{z.n_layers} layers")
                if g.stage_cuts and not valid_stage_cuts(
                        z.n_layers, g.pp, g.stage_cuts):
                    return False, (f"stage cuts {g.stage_cuts} invalid for "
                                   f"pp={g.pp}, L={z.n_layers}")
            # pp divides resident weights and KV across stages exactly like
            # an extra tp factor for the per-device footprint check
            if not self.fits(g.model, g.gpu_type, g.tp * g.pp, g.batch,
                             lens.get(g.model, 2048)):
                return False, (f"OOM {g.model} on {g.gpu_type} tp={g.tp} "
                               f"pp={g.pp} b={g.batch}")
        return True, ""

    def clear_memo(self) -> None:
        self._memo.clear()
        self._serve_memo.clear()

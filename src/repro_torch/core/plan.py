"""Serving-plan / cluster / workload data model (port of ``src/repro/core/plan.py``).

A copy of the dataclasses the engine pool and backend read (``Workload``,
``ClusterState``, ``ReplicaGroup``, ``Plan``, ``EMPTY_PLAN``, ``Ctx``), with
their fields and without the planning helpers the pool and backend never
call.  The port keeps its own copy rather than importing the JAX package;
the fields and their meaning are unchanged, so plans built by either
control plane drive either backend.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


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


@dataclass(frozen=True)
class ReplicaGroup:
    model: str
    gpu_type: str
    tp: int
    batch: int                 # per-replica concurrent batch
    count: int                 # number of replicas
    dp: int = 1                # intra-replica data parallelism
    pp: int = 1                # pipeline stages per replica
    stage_cuts: Tuple[int, ...] = ()


@dataclass(frozen=True)
class Plan:
    groups: Tuple[ReplicaGroup, ...] = ()


EMPTY_PLAN = Plan(())


@dataclass
class Ctx:
    """Shared observation passed to should_reschedule / schedule (§5.1); the
    backend reads ``simulator`` from it."""
    time: float
    timestamp_idx: int
    workloads: List[Workload]
    cluster: ClusterState
    current_plan: Optional[Plan]
    models: Dict[str, object]              # model name -> simulator ModelSpec
    hardware: Dict[str, object]            # gpu type -> GPUType
    simulator: object                      # roofline simulator (duck-typed)
    history: List[List[Workload]] = field(default_factory=list)
    last_resched_workloads: Optional[List[Workload]] = None
    last_resched_cluster: Optional[ClusterState] = None
    scratch: Dict = field(default_factory=dict)   # policy-private state

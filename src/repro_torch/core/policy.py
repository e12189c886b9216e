"""Compiled policy-hook containers (port of ``src/repro/core/policy.py``).

Only the hook dataclasses the serving layer consumes are copied here:
:class:`RequestPolicy`, :class:`ReconfigPolicy`, :class:`KVCachePolicy`,
:class:`RecoveryPolicy` and :class:`HookCircuitBreaker`.  The engines and
the pool call the hooks duck-typed (``admit``, ``prioritize``,
``migration_mode``, ``cache_prefix``, ``evict_priority``, ``on_failure``), so
hooks compiled by the JAX control plane's ``PolicyProgram`` work unchanged.
``PolicyProgram``, ``render_policy`` and the seed policies come with a later
slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple


@dataclass
class RequestPolicy:
    """Compiled request-domain hooks: ``admit(rctx) -> bool`` and
    ``prioritize(rctx) -> float`` (lower runs first) over a ``RequestCtx``;
    ``preempt`` lets the engine evict a running request for a waiting one."""
    admit_fn: Callable[[Any], bool]
    prioritize_fn: Callable[[Any], float]
    preempt: bool = False
    name: str = "anon"

    def admit(self, rctx: Any) -> bool:
        return bool(self.admit_fn(rctx))

    def prioritize(self, rctx: Any) -> float:
        return float(self.prioritize_fn(rctx))


@dataclass
class ReconfigPolicy:
    """Compiled reconfig-domain hook: ``migration_mode(mctx)`` answers
    drain | migrate | recompute per in-flight request on a removed replica.
    ``may_migrate`` False keeps the teardown-before-build order."""
    mode_fn: Callable[[Any], str]
    name: str = "anon"
    may_migrate: bool = True

    def migration_mode(self, mctx: Any) -> str:
        return str(self.mode_fn(mctx))


@dataclass
class KVCachePolicy:
    """Compiled kv_cache-domain hooks over a ``KVCacheCtx``:
    ``cache_prefix`` admits a finished prompt's pages into the prefix index,
    ``evict_priority`` scores a retained block (higher evicts sooner)."""
    cache_prefix_fn: Callable[[Any], bool]
    evict_priority_fn: Callable[[Any], float]
    name: str = "anon"

    def cache_prefix(self, kctx: Any) -> bool:
        return bool(self.cache_prefix_fn(kctx))

    def evict_priority(self, kctx: Any) -> float:
        return float(self.evict_priority_fn(kctx))


@dataclass
class RecoveryPolicy:
    """Compiled recovery-domain hook plus its fault-handling knobs.  The
    port's pool stores it (the data plane installs one on every swap); the
    failure path that consults it comes with the faults slice."""
    mode_fn: Callable[[Any], str]
    name: str = "anon"
    retry_budget: int = 3
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 2.0
    straggler_factor: float = 0.0
    fail_replan: bool = False
    degraded_admit_cap: float = 0.0

    def on_failure(self, fctx: Any) -> str:
        return str(self.mode_fn(fctx))


@dataclass
class HookCircuitBreaker:
    """Per-domain circuit breaker over evolved-hook exceptions: after
    ``threshold`` consecutive failures in one domain the breaker opens and
    call sites skip that domain's hook until :meth:`reset`."""
    threshold: int = 5
    consecutive: Dict[str, int] = field(default_factory=dict)
    trips: Dict[str, int] = field(default_factory=dict)   # domain -> trip count
    _open: set = field(default_factory=set)

    def failure(self, domain: str) -> bool:
        """Record one hook exception; True when this failure trips the
        breaker (first trip only — an open breaker stays open)."""
        n = self.consecutive.get(domain, 0) + 1
        self.consecutive[domain] = n
        if n >= self.threshold and domain not in self._open:
            self._open.add(domain)
            self.trips[domain] = self.trips.get(domain, 0) + 1
            return True
        return False

    def success(self, domain: str) -> None:
        self.consecutive[domain] = 0

    def tripped(self, domain: str) -> bool:
        return domain in self._open

    def reset(self, domain: str) -> None:
        """Close the breaker — freshly installed hooks earn a clean count."""
        self.consecutive[domain] = 0
        self._open.discard(domain)

    @property
    def open_domains(self) -> Tuple[str, ...]:
        return tuple(sorted(self._open))

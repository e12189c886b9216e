"""Continuous-batching serving engine (port of ``src/repro/serving/engine.py``).

The engine keeps a fixed set of decode slots over one of two caches: a
block-paged KV pool shared by the slots (the default for pageable
families), or a contiguous per-slot cache (``paged=False``, and every
non-pageable family such as SSM).  Each step:
  1. admits waiting requests into free slots: on the paged path a resident
     prompt prefix is mapped copy-free from the prefix index; the rest is
     prefilled in power-of-two chunks, one dispatch each, and a contiguous
     slot is wiped of its previous occupant in the first chunk's dispatch;
  2. runs one batched decode dispatch for all active slots (inputs are
     assembled in NumPy and shipped to the device once);
  3. retires finished requests (EOS / max tokens), offering their full pages
     to the prefix index.

Live slot migration: :meth:`Engine.export_slot` packs a slot's cache in the
contiguous wire format (a paged slot's pages gathered into it) and
:meth:`Engine.install_active` adopts such a state into a free slot of
either cache kind, without re-prefill.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import KVCachePolicy, RequestPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.serving import kvcache

EOS_DEFAULT = -1        # disabled unless the tokenizer defines one

# candidate prefill chunk sizes (powers of two, greedy binary decomposition)
_CHUNK_CANDIDATES = (256, 128, 64, 32, 16, 8, 4, 2, 1)


_DECODE = {"kind": "decode", "chunk": 1}     # a decode engine.dispatch span's attributes


def _dispatched(rec: telemetry.Record, span: int, kind: str, chunk: int) -> None:
    """Close an ``engine.dispatch`` span and count the dispatch."""
    rec.end(span)
    rec.count(f"dispatch.{kind}")
    if kind == "prefill":
        rec.count("tokens.prefilled", chunk)


def _read_token(rec: Optional[telemetry.Record], tokens: torch.Tensor,
                lane: int) -> int:
    """One lane's produced token, device → host (an ``engine.readback``)."""
    if rec is None:
        return int(tokens[lane])
    span = rec.begin("engine.readback")
    tok = int(tokens[lane])
    rec.end(span)
    return tok


class DrainStallError(RuntimeError):
    """``run_until_drained`` exhausted ``max_steps`` with work still in
    flight — a stall, not a clean drain."""


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: int = EOS_DEFAULT
    arrival_time: float = 0.0
    # accounting carry for continuations of preempted/recomputed requests
    first_token_time: Optional[float] = None
    prior_generated: int = 0     # tokens already produced in earlier lives
    # failure-recovery carry: how many times this request was requeued off a
    # dead replica, and the capped-exponential-backoff eligibility time the
    # pool's backlog flush honours (0.0 = immediately eligible)
    retries: int = 0
    not_before: float = 0.0


@dataclass(frozen=True)
class RequestCtx:
    """Typed view of one request against the engine's current load — the
    argument the request-domain hooks (``admit``/``prioritize``) receive."""
    rid: int
    prompt_len: int
    max_new_tokens: int
    age_s: float                     # now − arrival_time (queueing delay)
    queue_depth: int                 # requests waiting on this engine
    active: int                      # requests currently decoding
    n_slots: int

    @property
    def slot_load(self) -> float:
        return self.active / max(self.n_slots, 1)


@dataclass(frozen=True)
class MigrationCtx:
    """Typed view of one in-flight request at reconfiguration time — the
    argument the reconfig-domain hook (``migration_mode``) receives."""
    rid: int
    prompt_len: int
    generated: int                   # tokens produced so far (all lives)
    remaining: int                   # decode budget left
    position: int                    # next cache position

    @property
    def progress(self) -> float:
        return self.generated / max(self.generated + self.remaining, 1)


@dataclass(frozen=True)
class FailureCtx:
    """Typed view of one in-flight request on a replica that just died — the
    argument the recovery-domain hook (``on_failure``) receives."""
    rid: int
    prompt_len: int
    generated: int                   # tokens produced so far (all lives)
    remaining: int                   # decode budget left
    retries: int                     # times already requeued off a failure
    exportable: bool                 # slot state can be salvaged right now
    survivors: int                   # replicas left serving this model
    free_slots: int                  # open slots across those survivors
    queue_depth: int                 # pool backlog depth

    @property
    def progress(self) -> float:
        return self.generated / max(self.generated + self.remaining, 1)


@dataclass
class RequestState:
    request: Request
    slot: int
    generated: List[int] = field(default_factory=list)
    position: int = 0
    done: bool = False
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    prefill_dispatches: int = 0
    prior_generated: int = 0     # tokens produced before a preemption


@dataclass
class SlotExport:
    """One active slot packed for migration (:meth:`Engine.export_active`).

    ``request`` is the continuation — prompt + tokens generated so far,
    remaining budget, accounting carry — that any engine can re-prefill.
    ``cache`` is the extracted state in the contiguous wire format
    (:func:`repro_torch.models.lm.extract_slot`), with which a compatible
    engine resumes decoding in place; ``state`` is the live RequestState
    (its ``slot`` is stale until re-installed).
    """
    request: Request
    state: RequestState
    cfg: ModelConfig
    cache: Optional[Dict[str, np.ndarray]]   # None when exported for recompute only
    position: int


class RequestSchedulingMixin:
    """Request-domain policy dispatch (admission order, preemption, hook
    contexts), shared with the JAX engine's semantics.

    Host requirements: ``waiting``, ``active``, ``n_slots``,
    ``request_policy``, ``policy_errors``, ``preemptions``,
    ``max_prompt_len``; ``_now`` supplies the clock (wall for the real
    engine, virtual for the shadow twin)."""

    def _now(self) -> float:
        return time.monotonic()

    def _on_slot_released(self, slot: int, st: "RequestState") -> None:
        """Hook fired when a request leaves its slot outside the normal
        retire path (preemption)."""

    def request_ctx_for(self, req: Request,
                        now: Optional[float] = None) -> RequestCtx:
        now = self._now() if now is None else now
        return RequestCtx(rid=req.rid, prompt_len=len(req.prompt),
                          max_new_tokens=req.max_new_tokens,
                          age_s=max(now - req.arrival_time, 0.0),
                          queue_depth=len(self.waiting),
                          active=len(self.active), n_slots=self.n_slots)

    def migration_ctx_for(self, st: RequestState) -> MigrationCtx:
        req = st.request
        return MigrationCtx(rid=req.rid, prompt_len=len(req.prompt),
                            generated=st.prior_generated + len(st.generated),
                            remaining=req.max_new_tokens - len(st.generated),
                            position=st.position)

    def failure_ctx_for(self, st: RequestState, exportable: bool,
                        survivors: int, free_slots: int,
                        queue_depth: int) -> FailureCtx:
        req = st.request
        return FailureCtx(rid=req.rid, prompt_len=len(req.prompt),
                          generated=st.prior_generated + len(st.generated),
                          remaining=max(req.max_new_tokens
                                        - len(st.generated), 0),
                          retries=req.retries, exportable=exportable,
                          survivors=survivors, free_slots=free_slots,
                          queue_depth=queue_depth)

    # --- circuit-breaker plumbing (shared by engines and the pool) ----- #
    def _hook_open(self, domain: str) -> bool:
        br = getattr(self, "breaker", None)
        return br is not None and br.tripped(domain)

    def _hook_error(self, domain: str) -> None:
        self.policy_errors += 1
        br = getattr(self, "breaker", None)
        if br is not None:
            br.failure(domain)

    def _hook_ok(self, domain: str) -> None:
        br = getattr(self, "breaker", None)
        if br is not None:
            br.success(domain)

    def _score(self, req: Request, now: float) -> float:
        """Priority score (lower runs first).  Hook failures are advisory:
        the request falls back to FIFO-neutral priority."""
        rp = self.request_policy
        if rp is None or self._hook_open("request"):
            return 0.0
        try:
            score = rp.prioritize(self.request_ctx_for(req, now))
        except Exception:  # noqa: BLE001 — evolved code must not kill serving
            self._hook_error("request")
            return 0.0
        self._hook_ok("request")
        return score

    def _select_admissions(self, n: int) -> List[Request]:
        """Up to ``n`` waiting requests to admit now: FIFO without a request
        policy, ``prioritize`` order (ties FIFO) with one."""
        if n <= 0 or not self.waiting:
            return []
        if self.request_policy is None:
            take, self.waiting = self.waiting[:n], self.waiting[n:]
            return take
        now = self._now()
        scored = sorted((self._score(req, now), i)
                        for i, req in enumerate(self.waiting))
        picked = sorted(i for _, i in scored[:n])
        out = [self.waiting[i] for i in picked]
        for i in reversed(picked):
            del self.waiting[i]
        return out

    def _maybe_preempt(self) -> None:
        """Policy-gated preemption: when every slot is busy and a waiting
        request outranks the worst running one, evict the victim into a
        continuation request (prompt + tokens generated so far)."""
        rp = self.request_policy
        if (rp is None or not rp.preempt or not self.waiting
                or len(self.active) < self.n_slots):
            return
        now = self._now()
        best_score = min(self._score(req, now) for req in self.waiting)
        victims = []
        for slot, st in self.active.items():
            req = st.request
            remaining = req.max_new_tokens - len(st.generated)
            cont_prompt = list(req.prompt) + list(st.generated)
            if remaining < 1 or len(cont_prompt) > self.max_prompt_len(remaining):
                continue
            proxy = Request(req.rid, cont_prompt, remaining, req.eos_id,
                            req.arrival_time)
            victims.append((self._score(proxy, now), slot, proxy))
        if not victims:
            return
        worst_score, slot, proxy = max(victims, key=lambda v: v[0])
        if best_score >= worst_score:
            return
        st = self.active.pop(slot)
        self._on_slot_released(slot, st)
        proxy.first_token_time = st.first_token_time
        proxy.prior_generated = st.prior_generated + len(st.generated)
        self.waiting.append(proxy)
        self.preemptions += 1


class Engine(RequestSchedulingMixin):
    """Continuous-batching engine over a :class:`~repro_torch.models.lm.LM`.

    ``params`` is the model module; it must live on ``device`` (default:
    the CUDA card — without one the constructor raises).  ``paged=None``
    picks the paged pool for pageable families and the contiguous cache
    otherwise.
    """

    def __init__(self, cfg: ModelConfig, params: lm.LM, n_slots: int = 4,
                 max_seq_len: int = 256, chunked_prefill: bool = True,
                 max_prefill_chunk: int = 64,
                 truncate_long_prompts: bool = True,
                 request_policy: Optional[RequestPolicy] = None,
                 paged: Optional[bool] = None, page_size: int = 16,
                 n_pages: Optional[int] = None, prefix_cache: bool = True,
                 kv_cache_policy: Optional[KVCachePolicy] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if paged is None:
            paged = lm.pageable(cfg)             # the default serving path
        elif paged and not lm.pageable(cfg):
            raise ValueError(f"family {cfg.family!r} cannot use the paged "
                             f"KV cache (recurrent/xattn/paired state)")
        if params.device != self.device:
            raise ValueError(f"model lives on {params.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.chunked_prefill = chunked_prefill
        self.truncate_long_prompts = truncate_long_prompts
        self.request_policy = request_policy
        self.kv_cache_policy = kv_cache_policy
        self.policy_errors = 0       # request-hook failures (hooks are advisory)
        self.preemptions = 0
        # fault-tolerance state: ``breaker`` is installed by the owning pool;
        # ``fault_slowdown`` is the injected straggler multiplier scaling the
        # recorded step time (no real sleeps); the EMA feeds the pool's
        # straggler detector
        self.breaker = None
        self.fault_slowdown = 1.0
        self.step_ema_s = 0.0
        self.health_samples = 0
        self.paged = bool(paged)
        self.page_size = page_size
        self.prefix_cache_enabled = self.paged and prefix_cache
        self.waiting: List[Request] = []
        self.active: Dict[int, RequestState] = {}       # slot -> state
        self.finished: List[RequestState] = []
        self.dispatches = 0          # model-step invocations (perf metric)

        if not self.paged:
            self._chunk_sizes = self._allowed_chunk_sizes(max_prefill_chunk)
            self.cache = lm.init_cache(cfg, n_slots, max_seq_len,
                                       device=self.device)
            return
        pps = -(-max_seq_len // page_size)          # ceil
        self._pages_per_slot = pps
        if n_pages is None:
            # full occupancy + trash + two slots' worth of retained prefixes
            n_pages = 1 + (n_slots + 2) * pps
        self.page_pool = kvcache.PagePool(n_pages)
        self.prefix_index = kvcache.PrefixIndex(page_size)
        self.prefix_evictions = 0
        self._slot_pages: Dict[int, List[int]] = {}
        self._ptab = np.zeros((n_slots, pps), np.int32)
        self.cache = lm.init_paged_cache(cfg, n_pages, page_size,
                                         device=self.device)
        self._chunk_sizes = tuple(c for c in _CHUNK_CANDIDATES
                                  if c <= max(max_prefill_chunk, 1)) or (1,)

    def _allowed_chunk_sizes(self, cap: int) -> Tuple[int, ...]:
        """Power-of-two chunk sizes of the contiguous path (the JAX rule): a
        chunk longer than the SSD scan's chunk must be a multiple of it, and
        a rolling sliding-window ring's length (the pure-SWA buffer or
        gemma2's local buffer) must be a multiple of every chunk.  A
        multi-token write past the ring would evict rows that the chunk's
        own earlier queries still need, so chunking is only sound while the
        whole prefix fits the ring: ``_rolling_limit`` bounds where chunks
        may be used (see :meth:`_prefill_chunks`)."""
        ssd_chunk = self.cfg.ssm.chunk_size if self.cfg.ssm is not None else 0
        ring = lm.rolling_rows(self.cfg, self.max_seq_len)
        self._rolling_limit = ring
        return tuple(c for c in _CHUNK_CANDIDATES
                     if c <= max(cap, 1)
                     and not (ring is not None and ring % c)
                     and not (ssd_chunk and c > ssd_chunk and c % ssd_chunk)) or (1,)

    def _paged_exec(self, tokens: np.ndarray, positions: np.ndarray,
                    active: np.ndarray) -> torch.Tensor:
        """One paged model dispatch; returns the greedy next token per lane
        as a device tensor (the caller fetches it when it needs the value)."""
        dev = self.device
        rec = telemetry.REC
        if rec is not None:
            span = rec.begin("dispatch.inputs")
        with torch.inference_mode():
            inputs = (torch.from_numpy(tokens).to(dev),
                      torch.from_numpy(positions).to(dev),
                      torch.from_numpy(self._ptab).to(dev),
                      torch.from_numpy(active).to(dev))
            if rec is not None:
                rec.end(span)
                span = rec.begin("dispatch.launch")
            logits, _ = lm.paged_step(self.params, self.cfg, self.cache, *inputs,
                                      page_size=self.page_size, last_only=True)
            next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        if rec is not None:
            rec.end(span)
        self.dispatches += 1
        return next_tok

    def _contig_exec(self, tokens: np.ndarray, positions: np.ndarray,
                     rows: Optional[Tuple[int, int]] = None,
                     write: Optional[np.ndarray] = None,
                     reset: Sequence[int] = ()) -> torch.Tensor:
        """One contiguous-cache dispatch over slots ``rows`` (None: all):
        wipe the ``reset`` slots, step, keep the updates of the ``write``
        rows (None: all).  Returns the greedy next token per row as a
        device tensor."""
        dev = self.device
        rec = telemetry.REC
        if rec is not None:
            span = rec.begin("dispatch.inputs")
        with torch.inference_mode():
            tokens_d = torch.from_numpy(tokens).to(dev)
            positions_d = torch.from_numpy(positions).to(dev)
            write_d = None if write is None else torch.from_numpy(write).to(dev)
            if rec is not None:
                rec.end(span)
                span = rec.begin("dispatch.launch")
            lm.wipe_slots_(self.cache, reset)
            logits, _ = lm.step_with_cache(self.params, self.cfg, self.cache,
                                           tokens_d, positions_d, rows=rows,
                                           write=write_d, last_only=True)
            next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        if rec is not None:
            rec.end(span)
        self.dispatches += 1
        return next_tok

    def release_devices(self) -> None:
        """Return any exclusively-held devices when this replica retires.
        A single-device engine owns nothing exclusively."""

    # ------------------------------------------------------------------ #
    def max_prompt_len(self, max_new_tokens: int = 1) -> int:
        """Longest prompt that still fits the cache AND leaves decode room
        for ``max_new_tokens`` before step()'s position guard trips."""
        return max(1, self.max_seq_len - max(max_new_tokens, 1))

    def submit(self, req: Request) -> None:
        if req.arrival_time == 0.0:
            req.arrival_time = time.monotonic()
        limit = self.max_prompt_len(req.max_new_tokens)
        if len(req.prompt) > limit:
            if not self.truncate_long_prompts:
                raise ValueError(
                    f"prompt of {len(req.prompt)} tokens exceeds engine limit "
                    f"{limit} (max_seq_len={self.max_seq_len})")
            req = replace(req, prompt=req.prompt[-limit:])
        self.waiting.append(req)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if s not in self.active]

    @property
    def load(self) -> int:
        """Outstanding work: queued + in-flight requests (pool routing key)."""
        return len(self.waiting) + len(self.active)

    # ------------------------------------------------------------------ #
    # paged KV pool: page accounting, prefix index, kv_cache policy hooks
    # ------------------------------------------------------------------ #
    @property
    def prefix_hits(self) -> int:
        return self.prefix_index.hits if self.paged else 0

    @property
    def prefix_tokens_saved(self) -> int:
        return self.prefix_index.tokens_matched if self.paged else 0

    def _kv_ctx(self, node=None, prefix_pages: int = 0,
                prompt_len: int = 0, now: float = 0.0) -> kvcache.KVCacheCtx:
        pool = self.page_pool
        if node is None:
            return kvcache.KVCacheCtx(
                prefix_pages=prefix_pages, prompt_len=prompt_len, hits=0,
                idle_s=0.0, pool_free=pool.free_pages,
                pool_total=pool.n_pages)
        return kvcache.KVCacheCtx(
            prefix_pages=node.depth, prompt_len=0, hits=node.hits,
            idle_s=max(now - node.last_used, 0.0),
            pool_free=pool.free_pages, pool_total=pool.n_pages)

    def _evict_one(self) -> bool:
        """Drop the retained prefix block the kv_cache policy likes least
        (default LRU)."""
        cands = self.prefix_index.leaves()
        if not cands:
            return False
        now = time.monotonic()
        kp = self.kv_cache_policy

        def prio(node):
            if kp is not None and not self._hook_open("kv_cache"):
                try:
                    p = float(kp.evict_priority(self._kv_ctx(node, now=now)))
                except Exception:  # noqa: BLE001 — advisory, never fatal
                    self._hook_error("kv_cache")
                else:
                    self._hook_ok("kv_cache")
                    return p
            return max(now - node.last_used, 0.0)           # LRU fallback

        victim = max(cands, key=prio)
        self.prefix_index.remove(victim)
        self.page_pool.unref(victim.page)
        self.prefix_evictions += 1
        return True

    def _alloc_page(self) -> int:
        pid = self.page_pool.alloc()
        while pid is None:
            if not self._evict_one():
                raise RuntimeError(
                    "KV page pool exhausted with nothing left to evict")
            pid = self.page_pool.alloc()
        return pid

    def _ensure_pages(self, slot: int, upto_tokens: int) -> None:
        """Map enough logical blocks for positions < upto_tokens."""
        pages = self._slot_pages[slot]
        need = -(-upto_tokens // self.page_size)
        while len(pages) < need:
            pid = self._alloc_page()
            self._ptab[slot, len(pages)] = pid
            pages.append(pid)

    def _maybe_insert_prefix(self, seq: List[int], pages: List[int],
                             now: float) -> None:
        """Retain a finished request's full pages in the prefix index, gated
        by the kv_cache policy's ``cache_prefix`` admission hook."""
        n_full = min(len(seq) // self.page_size, len(pages))
        for j in range(n_full):
            if pages[j] == kvcache.TRASH_PAGE:
                n_full = j
                break
        if n_full == 0:
            return
        admit = True
        kp = self.kv_cache_policy
        if kp is not None and not self._hook_open("kv_cache"):
            try:
                admit = bool(kp.cache_prefix(self._kv_ctx(
                    prefix_pages=n_full, prompt_len=len(seq))))
            except Exception:  # noqa: BLE001 — advisory, never fatal
                self._hook_error("kv_cache")
                admit = True
            else:
                self._hook_ok("kv_cache")
        if not admit:
            return
        new_nodes = self.prefix_index.insert(
            seq[:n_full * self.page_size], pages[:n_full], now)
        for node in new_nodes:           # the index holds its own page share
            self.page_pool.ref(node.page)

    def _release_pages(self, slot: int, st: RequestState) -> None:
        """Return a departing request's page references; its full pages are
        first offered to the prefix index."""
        pages = self._slot_pages.pop(slot, [])
        if pages and self.prefix_cache_enabled:
            seq = (list(st.request.prompt) + list(st.generated))[:st.position]
            self._maybe_insert_prefix(seq, pages, time.monotonic())
        for pid in pages:
            self.page_pool.unref(pid)
        self._ptab[slot, :] = 0

    def _on_slot_released(self, slot: int, st: RequestState) -> None:
        if self.paged:
            self._release_pages(slot, st)

    def _retire(self, slot: int, st: RequestState) -> None:
        st.done = True
        st.finish_time = time.monotonic()
        rec = telemetry.REC
        if rec is not None:
            span = rec.begin("engine.retire", st.finish_time, rid=st.request.rid)
        self.finished.append(st)
        del self.active[slot]
        if self.paged:
            self._release_pages(slot, st)
        if rec is not None:
            rec.end(span)

    def release_all_pages(self) -> int:
        """Drop every page reference this engine holds — active slots and
        retained prefix nodes.  Returns the pool's remaining used pages
        (0 means no leak; always 0 for a contiguous engine)."""
        if not self.paged:
            return 0
        for slot in list(self._slot_pages):
            for pid in self._slot_pages.pop(slot):
                self.page_pool.unref(pid)
        self._ptab[:, :] = 0
        while True:
            leaves = self.prefix_index.leaves()
            if not leaves:
                break
            for leaf in leaves:
                self.prefix_index.remove(leaf)
                self.page_pool.unref(leaf.page)
        return self.page_pool.used_pages

    # ------------------------------------------------------------------ #
    # live slot migration (cache-state transfer across engines)
    # ------------------------------------------------------------------ #
    def export_slot(self, slot: int, with_state: bool = True,
                    release: bool = True) -> SlotExport:
        """Pop one active request out of its slot, packed for migration.

        ``with_state=False`` skips the device→host cache copy when the
        caller already knows it will recompute.  A paged slot's pages are
        gathered into the contiguous wire format.  ``release=False`` keeps
        them mapped until :meth:`release_exported`, so a hand-off that falls
        through to draining in place (``active[slot] = export.state``)
        still decodes from its own pages (the JAX engine releases them at
        once, and such a drain then finds no pages for its next write).
        """
        st = self.active.pop(slot)
        req = st.request
        remaining = max(req.max_new_tokens - len(st.generated), 1)
        cont = Request(req.rid, list(req.prompt) + list(st.generated),
                       remaining, req.eos_id, req.arrival_time,
                       first_token_time=st.first_token_time,
                       prior_generated=st.prior_generated + len(st.generated),
                       retries=req.retries)   # retry budget survives migration
        cache = None
        if self.paged:
            if with_state:
                cache = self._extract_paged_slot_state(slot, st.position)
            if release:
                self._release_pages(slot, st)
        elif with_state:
            cache = self._extract_slot_state(slot)
        return SlotExport(cont, st, self.cfg, cache, st.position)

    # slot state hooks: engines whose cache is not one monolithic dict (the
    # pipelined and sharded engines) override these; the wire format is the
    # same everywhere, so an export from any engine installs into any other
    def _extract_slot_state(self, slot: int):
        """Contiguous-path slot extract in the wire format."""
        return lm.extract_slot(self.cfg, self.cache, slot)

    def _install_slot_state(self, slot: int, state, position: int):
        """Contiguous-path slot install; returns the cache to adopt."""
        return lm.install_slot(self.cfg, self.cache, slot, state, position)

    def _extract_paged_slot_state(self, slot: int, position: int):
        """A paged slot's pages gathered into the contiguous wire format."""
        return lm.extract_paged_slot(self.cfg, self.cache, self._slot_pages[slot],
                                     position, self.page_size)

    def _install_paged_slot_state(self, pages, state, position: int):
        """Scatter a wire-format state into freshly-owned pages; returns the
        cache to adopt."""
        return lm.install_paged_slot(self.cfg, self.cache, pages, state,
                                     position, self.page_size)

    def _adopt_cache(self, cache):
        """Take the cache an install returned.  The identity here (the
        install wrote in place); a sharded engine re-splits the installed
        state into its shards."""
        return cache

    def release_exported(self, slot: int, st: RequestState) -> None:
        """Return the pages ``export_slot(slot, release=False)`` kept
        mapped, once the request ``st`` lives elsewhere."""
        if self.paged:
            self._release_pages(slot, st)

    def export_active(self, with_state: bool = True) -> List[SlotExport]:
        """Export every in-flight request (lowest slot first)."""
        return [self.export_slot(s, with_state=with_state)
                for s in sorted(self.active)]

    def install_active(self, export: SlotExport) -> bool:
        """Adopt a migrated slot directly into a free slot — no re-prefill.

        Returns False (engine unchanged) when the state cannot live here:
        no free slot, different model config, not enough decode headroom for
        the remaining budget (step()'s position guard would cut the request
        short), or buffers the extracted state cannot be scattered into.
        Callers then fall back to resubmitting ``export.request``.
        """
        free = self.free_slots()
        remaining = max(export.request.max_new_tokens, 1)
        if (not free or export.cache is None or export.cfg != self.cfg
                or export.position + remaining >= self.max_seq_len):
            return False
        slot = free[0]
        if self.paged:
            return self._install_paged(export, slot)
        try:
            cache = self._install_slot_state(slot, export.cache, export.position)
        except lm.SlotMigrationError:
            return False
        self.cache = self._adopt_cache(cache)
        st = export.state
        st.slot = slot
        self.active[slot] = st
        return True

    def _install_paged(self, export: SlotExport, slot: int) -> bool:
        """Adopt a migrated slot into freshly-owned pages.  SWA blocks wholly
        below the attention window map the trash page."""
        page = self.page_size
        position = export.position
        window = lm.paged_window(self.cfg)
        lo_req = 0 if window is None else max(position - window + 1, 0)
        n_blocks = -(-position // page)
        pages: List[int] = []
        try:
            for j in range(n_blocks):
                if (j + 1) * page <= lo_req:
                    pages.append(kvcache.TRASH_PAGE)
                else:
                    pages.append(self._alloc_page())
            cache = self._install_paged_slot_state(pages, export.cache, position)
        except (lm.SlotMigrationError, RuntimeError):
            for pid in pages:
                self.page_pool.unref(pid)
            return False
        self.cache = self._adopt_cache(cache)
        self._slot_pages[slot] = pages
        self._ptab[slot, :] = 0
        self._ptab[slot, :len(pages)] = pages
        st = export.state
        st.slot = slot
        self.active[slot] = st
        return True

    # ------------------------------------------------------------------ #
    def _prefill_into_slot(self, req: Request, slot: int) -> None:
        """Write the prompt's KV into the slot's pages and produce the first
        generated token (greedy logits at the last prompt position)."""
        rec = telemetry.REC
        if rec is not None:
            span = rec.begin("engine.admit", rid=req.rid)
            saved = self.prefix_tokens_saved
        st = RequestState(req, slot)
        self.active[slot] = st
        prompt = req.prompt or [0]
        if self.paged:
            last = self._paged_prefill(st, prompt)
        elif not self.chunked_prefill:
            last = 0
            for i, tok in enumerate(prompt):
                last = self._advance_slot(st, tok, wipe_slot=(i == 0))
                st.prefill_dispatches += 1
        else:
            last = self._prefill_chunks(st, prompt)
        st.generated.append(last)
        now = time.monotonic()
        st.first_token_time = (now if req.first_token_time is None
                               else req.first_token_time)
        st.prior_generated = req.prior_generated
        if rec is not None:
            rec.end(span, now, {"prompt": len(req.prompt),
                                "matched": self.prefix_tokens_saved - saved,
                                "chunks": st.prefill_dispatches})

    def _prefill_chunks(self, st: RequestState, prompt: List[int]) -> int:
        """Contiguous prefill in descending power-of-two chunks, one
        dispatch each over the slot's row only (rows are independent); the
        first chunk wipes the slot's previous occupant.  Past a rolling
        ring's length only single tokens are sound (the JAX rule)."""
        slot = st.slot
        rec = telemetry.REC
        prompt_arr = np.asarray(prompt, np.int32)
        off, last = 0, None
        remaining = len(prompt)
        for c in self._chunk_sizes:
            while remaining >= c:
                if (self._rolling_limit is not None and c > 1
                        and off + c > self._rolling_limit):
                    break
                if rec is not None:
                    span = rec.begin("engine.dispatch", attrs={"kind": "prefill", "chunk": c})
                last = self._contig_exec(
                    prompt_arr[None, off:off + c],
                    np.arange(off, off + c, dtype=np.int32)[None],
                    rows=(slot, slot + 1), reset=(slot,) if off == 0 else ())
                if rec is not None:
                    _dispatched(rec, span, "prefill", c)
                st.prefill_dispatches += 1
                off += c
                remaining -= c
        st.position = off
        return _read_token(rec, last, 0)    # device → host once, after the loop

    def _advance_slot(self, st: RequestState, token: int,
                      wipe_slot: bool = False) -> int:
        """Per-token prefill (``chunked_prefill=False``): one all-slot
        dispatch per prompt token that keeps only this slot's update."""
        rec = telemetry.REC
        if rec is not None:
            span = rec.begin("engine.dispatch", attrs={"kind": "prefill", "chunk": 1})
        tokens = np.zeros((self.n_slots, 1), np.int32)
        tokens[st.slot, 0] = token
        positions = np.zeros((self.n_slots, 1), np.int32)
        for slot, s in self.active.items():
            positions[slot, 0] = s.position
        next_tok = self._contig_exec(tokens, positions,
                                     write=np.array([st.slot], np.int64),
                                     reset=(st.slot,) if wipe_slot else ())
        if rec is not None:
            _dispatched(rec, span, "prefill", 1)
        st.position += 1
        return _read_token(rec, next_tok, st.slot)

    def _paged_prefill(self, st: RequestState, prompt: List[int]) -> int:
        """Prefill into pages.  A resident prompt prefix (full pages, capped
        one token short of the prompt) is mapped copy-free from the prefix
        index; only the remainder is prefilled.  Inactive lanes' writes land
        in the trash page."""
        slot = st.slot
        rec = telemetry.REC
        pages: List[int] = []
        matched = 0
        if self.prefix_cache_enabled:
            now = time.monotonic()
            if rec is not None:
                span = rec.begin("engine.prefix_match", now, rid=st.request.rid)
            pages, matched = self.prefix_index.match(prompt, now)
            for pid in pages:            # the request's own share of each page
                self.page_pool.ref(pid)
            if rec is not None:
                rec.end(span)
        self._slot_pages[slot] = list(pages)
        self._ptab[slot, :] = 0
        self._ptab[slot, :len(pages)] = pages

        prompt_arr = np.asarray(prompt, np.int32)
        active = np.zeros((self.n_slots,), bool)
        active[slot] = True
        off, last = matched, None
        remaining = len(prompt) - matched
        for c in (self._chunk_sizes if self.chunked_prefill else (1,)):
            while remaining >= c:
                if rec is not None:
                    span = rec.begin("engine.dispatch", attrs={"kind": "prefill", "chunk": c})
                self._ensure_pages(slot, off + c)
                tokens = np.zeros((self.n_slots, c), np.int32)
                positions = np.zeros((self.n_slots, c), np.int32)
                tokens[slot] = prompt_arr[off:off + c]
                positions[slot] = np.arange(off, off + c, dtype=np.int32)
                last = self._paged_exec(tokens, positions, active)
                if rec is not None:
                    _dispatched(rec, span, "prefill", c)
                st.prefill_dispatches += 1
                off += c
                remaining -= c
        st.position = off
        return _read_token(rec, last, slot)  # device → host once, after the loop

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """One engine iteration; returns number of tokens produced."""
        t0 = time.monotonic()
        rec = telemetry.REC
        if rec is not None:
            step_span = rec.begin("engine.step", t0)
        self._maybe_preempt()
        free = self.free_slots()
        admitted = 0
        for slot, req in zip(free, self._select_admissions(len(free))):
            self._prefill_into_slot(req, slot)
            admitted += 1
            st = self.active[slot]
            if (len(st.generated) >= req.max_new_tokens
                    or st.generated[-1] == req.eos_id):
                self._retire(slot, st)

        if not self.active:
            if rec is not None:
                rec.end(step_span, attrs={"admitted": admitted, "live": 0})
            return 0

        if rec is not None:
            span = rec.begin("engine.dispatch", attrs=_DECODE)
        tokens = np.zeros((self.n_slots, 1), np.int32)
        positions = np.zeros((self.n_slots, 1), np.int32)
        active = np.zeros((self.n_slots,), bool)
        live: List[RequestState] = []
        for slot, st in self.active.items():
            tokens[slot, 0] = st.generated[-1]
            positions[slot, 0] = st.position
            active[slot] = True
            live.append(st)
        if self.paged:
            for st in live:                  # map the block this write lands in
                self._ensure_pages(st.slot, st.position + 1)
            next_tok = self._paged_exec(tokens, positions, active)
        else:
            next_tok = self._contig_exec(tokens, positions,
                                         write=np.flatnonzero(active))
        if rec is not None:
            _dispatched(rec, span, "decode", 1)
            span = rec.begin("engine.readback")
        next_np = next_tok.cpu().numpy()     # one device→host transfer
        if rec is not None:
            rec.end(span)
        produced = 0
        for st in live:
            tok = int(next_np[st.slot])
            st.position += 1
            st.generated.append(tok)
            produced += 1
            req = st.request
            if (len(st.generated) >= req.max_new_tokens
                    or tok == req.eos_id
                    or st.position >= self.max_seq_len - 1):
                self._retire(st.slot, st)
        t1 = time.monotonic()
        self._record_step_time(t1 - t0)
        if rec is not None:
            rec.end(step_span, t1, {"admitted": admitted, "live": len(live)})
        return produced

    def _record_step_time(self, dt: float) -> None:
        """EMA of measured step wall-time (the pool's health signal), scaled
        by the injected straggler multiplier: the fault model degrades the
        observation, so the pool's detector sees the slowdown without real
        sleeps."""
        dt *= self.fault_slowdown
        if self.health_samples == 0:
            self.step_ema_s = dt
        else:
            self.step_ema_s = 0.7 * self.step_ema_s + 0.3 * dt
        self.health_samples += 1

    def run_until_drained(self, max_steps: int = 10_000) -> List[RequestState]:
        taken = 0
        while (self.waiting or self.active) and taken < max_steps:
            self.step()
            taken += 1
        if self.waiting or self.active:
            raise DrainStallError(
                f"engine stalled: {len(self.waiting)} waiting, "
                f"{len(self.active)} active after {max_steps} steps")
        return self.finished

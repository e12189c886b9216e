"""Host-side paged-KV bookkeeping (port of ``src/repro/serving/kvcache.py``).

A copy of the page pool allocator and prefix (radix) index, and of their
per-pipeline-stage versions driven in lockstep.  The device side
of paging lives in ``repro_torch.models.lm`` (page pools as tensors,
page-table-indexed attention); this module owns the *host* structures the
engine drives it with:

  * :class:`PagePool` — a refcounted free-list allocator over physical page
    ids.  Page 0 is reserved as the **trash page**: inactive batch lanes'
    spurious decode writes are diverted there instead of being rolled back
    (the contiguous engine's ``mask_cache_update`` has no cheap analogue
    against a shared pool), and unmapped page-table entries point at it.
  * :class:`PrefixIndex` — a radix/trie index over page-sized token blocks.
    A request whose prompt prefix is resident *maps the existing pages
    copy-free* and skips those prefill chunks entirely.  Nodes carry hit
    counters and last-use stamps so the evolvable ``kv_cache`` policy domain
    can choose admission ("cache this prefix?") and eviction (LRU vs
    hit-frequency vs pinning) under memory pressure.
  * :class:`StagedPagePool` / :class:`StagedPrefixIndex` — one pool and one
    trie per pipeline stage, kept in lockstep so one page table drives
    every stage's layer slice.
  * :class:`KVCacheCtx` — the plain-scalar typed view the ``kv_cache``
    policy hooks receive (same contract as RequestCtx/MigrationCtx: evolved
    code on the hot path sees numbers, never mutable engine state).

Sharing rules (vLLM-style): only *full* pages are ever shared, and a match
is capped at ``prompt_len - 1`` so the final prompt token is always
re-processed — prefill must still produce the first generated token's
logits.  Shared pages are read-only after insertion; every write a request
performs lands in pages it exclusively owns (or the trash page).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

TRASH_PAGE = 0


@dataclass(frozen=True)
class KVCacheCtx:
    """Typed view for the kv_cache policy hooks (plain scalars only).

    For ``cache_prefix`` (admission) the subject is a finished request's
    prompt; for ``evict_priority`` it is one retained prefix block under
    memory pressure (higher score ⇒ evicted sooner).
    """
    prefix_pages: int        # full pages in the prefix (admission) / node depth
    prompt_len: int          # prompt tokens (admission) or 0 (eviction)
    hits: int                # times this block was reused by a later request
    idle_s: float            # now − last use
    pool_free: int           # free physical pages right now
    pool_total: int          # physical pages in the pool

    @property
    def pool_pressure(self) -> float:
        return 1.0 - self.pool_free / max(self.pool_total, 1)


class PagePool:
    """Refcounted allocator over physical page ids 1..n_pages-1 (0 = trash).

    ``layers`` is an optional (lo, hi) scope label naming the layer slice
    this pool's pages back — ``None`` for an engine-global pool, a stage's
    bounds when owned by a :class:`StagedPagePool` member."""

    def __init__(self, n_pages: int, layers: Optional[Tuple[int, int]] = None):
        if n_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (1 is trash), got {n_pages}")
        self.n_pages = n_pages
        self.layers = layers
        # LIFO over descending ids: allocation order (1, 2, ...) is
        # deterministic, which shadow replay and tests rely on
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def alloc(self) -> Optional[int]:
        """One free page (refcount 1), or None under pressure — the caller
        evicts retained prefix blocks and retries."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def ref(self, pid: int) -> None:
        """Take a share of an allocated page (prefix reuse / index retention)."""
        if pid == TRASH_PAGE:
            return
        if pid not in self._ref:
            raise ValueError(f"ref of unallocated page {pid}")
        self._ref[pid] += 1

    def unref(self, pid: int) -> bool:
        """Drop one share; frees (and returns True) when the last share goes."""
        if pid == TRASH_PAGE:
            return False
        n = self._ref.get(pid)
        if n is None:
            raise ValueError(f"unref of unallocated page {pid}")
        if n > 1:
            self._ref[pid] = n - 1
            return False
        del self._ref[pid]
        self._free.append(pid)
        return True

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)


class PrefixNode:
    """One page-sized token block in the radix index."""
    __slots__ = ("key", "page", "parent", "children", "hits", "last_used",
                 "depth")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["PrefixNode"], now: float):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "PrefixNode"] = {}
        self.hits = 0
        self.last_used = now
        self.depth = 1 if parent is None else parent.depth + 1


class PrefixIndex:
    """Radix/trie over page-sized token blocks → retained physical pages.

    The index holds its own :class:`PagePool` reference for every retained
    page (taken by the caller at insert), so a retained block survives its
    original request; eviction removes leaf blocks (an interior hole would
    break every chain through it — matches stop at the first absent block
    anyway, so leaves-first keeps the structure consistent).
    """

    def __init__(self, page_size: int,
                 layers: Optional[Tuple[int, int]] = None):
        self.page_size = page_size
        self.layers = layers
        self.root: Dict[Tuple[int, ...], PrefixNode] = {}
        self.nodes = 0
        self.hits = 0                    # requests that matched ≥ 1 block
        self.misses = 0
        self.tokens_matched = 0

    def _blocks(self, tokens: Sequence[int], n: int):
        p = self.page_size
        for i in range(n):
            yield tuple(tokens[i * p:(i + 1) * p])

    def match(self, prompt: Sequence[int], now: float
              ) -> Tuple[List[int], int]:
        """Longest resident page-aligned prefix of ``prompt``.

        Returns (physical page ids, matched token count).  Capped at
        ``len(prompt) - 1`` tokens so at least one prompt token remains to
        prefill (the first generated token needs fresh logits).  Bumps hit
        counters and LRU stamps along the matched path.
        """
        cap = max(len(prompt) - 1, 0) // self.page_size
        pages: List[int] = []
        level = self.root
        for blk in self._blocks(prompt, cap):
            node = level.get(blk)
            if node is None:
                break
            node.hits += 1
            node.last_used = now
            pages.append(node.page)
            level = node.children
        if pages:
            self.hits += 1
            self.tokens_matched += len(pages) * self.page_size
        else:
            self.misses += 1
        return pages, len(pages) * self.page_size

    def insert(self, prompt: Sequence[int], pages: Sequence[int],
               now: float) -> List[PrefixNode]:
        """Retain ``prompt``'s full pages.  ``pages[i]`` is the physical page
        holding block i; blocks already resident are skipped (their canonical
        page stays), so the caller must take a pool ref for exactly the
        returned newly-inserted nodes' pages."""
        n_full = min(len(prompt) // self.page_size, len(pages))
        new: List[PrefixNode] = []
        level, parent = self.root, None
        for i, blk in enumerate(self._blocks(prompt, n_full)):
            node = level.get(blk)
            if node is None:
                node = PrefixNode(blk, pages[i], parent, now)
                level[blk] = node
                self.nodes += 1
                new.append(node)
            node.last_used = now
            level, parent = node.children, node
        return new

    def leaves(self) -> List[PrefixNode]:
        out: List[PrefixNode] = []

        def walk(level: Dict[Tuple[int, ...], PrefixNode]) -> None:
            for node in level.values():
                if node.children:
                    walk(node.children)
                else:
                    out.append(node)
        walk(self.root)
        return out

    def remove(self, node: PrefixNode) -> int:
        """Detach a leaf; returns its page id (caller drops the pool ref)."""
        if node.children:
            raise ValueError("only leaf blocks are evictable")
        level = self.root if node.parent is None else node.parent.children
        if level.get(node.key) is node:
            del level[node.key]
            self.nodes -= 1
        return node.page


class StagedPagePool:
    """Per-pipeline-stage page pools driven in lockstep.

    A pipelined engine serves each layer slice from its own stage pool (on
    a real deployment each stage host owns its pool's HBM), but a request's
    logical block j must land on the SAME physical page id in every stage —
    the page table is a single (B, n_ptab) array threaded through all stage
    scans, and slot exports concatenate stage slices gathered by those ids.
    This coordinator fans every alloc/ref/unref out to each stage's
    :class:`PagePool` and asserts the ids agree, which they do by
    construction (identical deterministic free lists, identical op
    sequence).  It duck-types ``PagePool`` so all engine bookkeeping
    (eviction, migration, leak accounting) is stage-count-agnostic.
    """

    def __init__(self, n_pages: int, stages: Sequence[Tuple[int, int]]):
        if not stages:
            raise ValueError("need >= 1 stage")
        self.n_pages = n_pages
        self.stage_pools: List[PagePool] = [
            PagePool(n_pages, layers=(lo, hi)) for lo, hi in stages]

    @property
    def free_pages(self) -> int:
        return self.stage_pools[0].free_pages

    @property
    def used_pages(self) -> int:
        return self.stage_pools[0].used_pages

    def alloc(self) -> Optional[int]:
        pids = [p.alloc() for p in self.stage_pools]
        if any(pid != pids[0] for pid in pids):  # pragma: no cover - lockstep
            raise RuntimeError(f"stage pools diverged on alloc: {pids}")
        return pids[0]

    def ref(self, pid: int) -> None:
        for p in self.stage_pools:
            p.ref(pid)

    def unref(self, pid: int) -> bool:
        freed = [p.unref(pid) for p in self.stage_pools]
        if any(f != freed[0] for f in freed):  # pragma: no cover - lockstep
            raise RuntimeError(f"stage pools diverged on unref({pid})")
        return freed[0]

    def refcount(self, pid: int) -> int:
        return self.stage_pools[0].refcount(pid)


class StagedPrefixIndex:
    """Per-stage radix tries driven in lockstep (see :class:`StagedPagePool`).

    Each stage retains the same prefix blocks on the same page ids — the
    trie structure is a pure function of the (prompt, pages) op sequence —
    so ``match`` on any stage yields the same pages; stage 0 is canonical.
    Eviction takes a stage-0 leaf and removes its *siblings* (the
    same-position nodes in every other stage's trie), keeping the tries
    identical.  Duck-types ``PrefixIndex`` for the engine and the evolvable
    ``kv_cache`` policy hooks.
    """

    def __init__(self, page_size: int, stages: Sequence[Tuple[int, int]]):
        if not stages:
            raise ValueError("need >= 1 stage")
        self.page_size = page_size
        self.stage_tries: List[PrefixIndex] = [
            PrefixIndex(page_size, layers=(lo, hi)) for lo, hi in stages]
        # id(stage-0 node) -> same-position node in each later stage's trie
        self._siblings: Dict[int, List[PrefixNode]] = {}

    @property
    def root(self):
        return self.stage_tries[0].root

    @property
    def nodes(self) -> int:
        return self.stage_tries[0].nodes

    @property
    def hits(self) -> int:
        return self.stage_tries[0].hits

    @property
    def misses(self) -> int:
        return self.stage_tries[0].misses

    @property
    def tokens_matched(self) -> int:
        return self.stage_tries[0].tokens_matched

    def match(self, prompt: Sequence[int], now: float
              ) -> Tuple[List[int], int]:
        outs = [t.match(prompt, now) for t in self.stage_tries]
        if any(o != outs[0] for o in outs):  # pragma: no cover - lockstep
            raise RuntimeError(f"stage tries diverged on match: {outs}")
        return outs[0]

    def insert(self, prompt: Sequence[int], pages: Sequence[int],
               now: float) -> List[PrefixNode]:
        per_stage = [t.insert(prompt, pages, now) for t in self.stage_tries]
        for sib in zip(*per_stage):
            if any(n.page != sib[0].page for n in sib):  # pragma: no cover
                raise RuntimeError("stage tries diverged on insert")
            self._siblings[id(sib[0])] = list(sib[1:])
        return per_stage[0]

    def leaves(self) -> List[PrefixNode]:
        return self.stage_tries[0].leaves()

    def remove(self, node: PrefixNode) -> int:
        page = self.stage_tries[0].remove(node)
        for trie, sib in zip(self.stage_tries[1:],
                             self._siblings.pop(id(node), [])):
            if trie.remove(sib) != page:  # pragma: no cover - lockstep
                raise RuntimeError("stage tries diverged on remove")
        return page

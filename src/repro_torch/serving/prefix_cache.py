"""Cross-request radix prefix cache over the COW page pool (port of
``repro.serving.prefix_cache``, DESIGN.md §7.13; the reference's code,
which is pure host accounting, unchanged but for its pool import).

A token trie keyed by page-size token chunks indexes *published runs*:
page-aligned prompt prefixes whose KV pages a retired (or preempted)
request handed to the cache through ``PagedKVPool.fork_prefix`` — one
cache-owned pool stream per decoder id space ("t" and "d"), refcount
bumped, no page copied.  Admission looks up the longest cached prefix of
an incoming prompt and binds the matching run back onto the request's
streams with ``fork_prefix``, so the batched bucketed prefill runs only
the uncached suffix.  SSM and hybrid pairs join through the checkpoint
rings: a run may carry the ring snapshot recorded at its published
length (whatever ``BatchedDecoder.snapshot`` returns), and a hit restores
it before the suffix forward; ``lookup(need_snaps=True)`` only returns
runs that end exactly at a snapshotted length.  Eviction is LRU over runs
whose pages no live request references, tagged "evict" so the pools'
``reclaim_listeners`` attribute the reclamation.

Copy-on-write safety is the pool's: cache-bound pages are full pages of a
committed prompt prefix, which the engines never truncate below (rollback
stops at committed - 1) and never write in place (writes land past the
stream length; an append onto a shared tail page goes through the pool's
COW split, mirrored physically by ``cow_listeners``).  A published run is
therefore immutable for as long as any stream shares it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.kv_pool import PagedKVPool

__all__ = ["PrefixCache", "PrefixCacheStats"]


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0
    saved_tokens: int = 0        # prefix tokens bound zero-copy
    published_runs: int = 0      # new trie entries created
    deduped_runs: int = 0        # publishes that matched an existing run
    evicted_runs: int = 0
    snap_restores: int = 0       # hits that restored an SSM ring snapshot

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


@dataclasses.dataclass
class _Entry:
    """One published run: a page-aligned token prefix whose pages live in
    cache-owned pool streams ("pc", eid) — one per decoder id space."""
    eid: int
    key: Tuple[int, ...]         # the run's tokens; len(key) == depth
    depth: int                   # tokens (page-aligned, > 0)
    snaps: Optional[Dict[str, list]]   # which -> ring snapshot, or None
    stamp: int = 0               # LRU clock

    @property
    def stream(self) -> Tuple[str, int]:
        return ("pc", self.eid)


class _Node:
    __slots__ = ("children", "entries", "passing")

    def __init__(self):
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.entries: List[_Entry] = []    # runs ending exactly here
        self.passing: List[_Entry] = []    # runs whose path crosses here


class PrefixCache:
    """Token-trie -> page-run index over the per-decoder page pools.

    The cache owns pool streams, never pages directly: every run holds a
    ``fork_prefix`` share in EVERY pool of ``pools`` (the engines prefill
    target and draft caches over the same prompt, so a hit must bind
    both), and the pool's refcounts remain the single source of truth —
    ``check()`` and the pool invariants verify each other.
    """

    def __init__(self, pools: Dict[str, PagedKVPool]):
        assert pools
        sizes = {p.page_size for p in pools.values()}
        assert len(sizes) == 1, "prefix cache needs a uniform page size"
        self.pools = dict(pools)
        self.page_size = next(iter(sizes))
        self.root = _Node()
        self.stats = PrefixCacheStats()
        self._entries: Dict[int, _Entry] = {}
        self._next_eid = 0
        self._clock = 0

    # -------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> List[_Entry]:
        return list(self._entries.values())

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i:i + ps])
                for i in range(0, len(tokens), ps)]

    def _touch(self, ent: _Entry) -> None:
        self._clock += 1
        ent.stamp = self._clock

    # -------------------------------------------------------------- publish
    def publish(self, tokens: Sequence[int], n_tokens: int,
                src: Dict[str, object],
                snaps: Optional[Dict[str, list]] = None) -> bool:
        """Publish the first ``n_tokens`` (page-aligned, > 0) of ``src``'s
        live streams as a cached run.  ``src`` maps each pool name to the
        stream key whose pages are shared (refcount bump, zero copies);
        the caller must publish BEFORE closing those streams.  A run with
        the same token path already cached is touched, not duplicated
        (its missing ring snapshot is adopted if ``snaps`` provides one).
        Returns True when a new run was created."""
        assert n_tokens > 0 and n_tokens % self.page_size == 0, n_tokens
        assert set(src) == set(self.pools), (set(src), set(self.pools))
        key = tuple(int(t) for t in tokens[:n_tokens])
        assert len(key) == n_tokens, (len(key), n_tokens)
        path = self._chunks(key)
        node = self.root
        for ch in path:
            node = node.children.setdefault(ch, _Node())
        for ent in node.entries:
            if ent.key == key:
                if ent.snaps is None and snaps:
                    ent.snaps = dict(snaps)
                self._touch(ent)
                self.stats.deduped_runs += 1
                return False
        eid, self._next_eid = self._next_eid, self._next_eid + 1
        ent = _Entry(eid=eid, key=key, depth=n_tokens,
                     snaps=dict(snaps) if snaps else None)
        for which, pool in self.pools.items():
            pool.fork_prefix(src[which], ent.stream, n_tokens)
        self._entries[eid] = ent
        node.entries.append(ent)
        node = self.root
        for ch in path:
            node = node.children[ch]
            node.passing.append(ent)
        self._touch(ent)
        self.stats.published_runs += 1
        return True

    # --------------------------------------------------------------- lookup
    def lookup(self, tokens: Sequence[int], max_tokens: int,
               need_snaps: bool = False
               ) -> Optional[Tuple[_Entry, int]]:
        """Longest cached prefix of ``tokens``, capped at ``max_tokens``
        (page-aligned down — callers cap below the prompt length so at
        least one suffix token always remains to prefill).  Returns
        ``(entry, n_tokens)``: the entry's streams hold >= n_tokens, so
        ``fork_prefix(entry.stream, ..., n_tokens)`` binds the match.

        ``need_snaps=True`` (SSM-bearing pairs) restricts the match to
        runs that END at the matched length with a recorded ring
        snapshot: a recurrent carry is only valid at the exact position
        it was checkpointed, so a partial page-run match — fine for pure
        attention, where any key prefix stands alone — cannot seed the
        ring."""
        self.stats.lookups += 1
        cap = (max_tokens // self.page_size) * self.page_size
        if cap <= 0:
            return None
        path = self._chunks(tokens[:cap])
        best: Optional[Tuple[_Entry, int]] = None
        node = self.root
        depth = 0
        for ch in path:
            nxt = node.children.get(ch)
            if nxt is None:
                break
            node = nxt
            depth += len(ch)
            if need_snaps:
                with_snaps = [e for e in node.entries
                              if e.snaps is not None and e.depth == depth]
                if with_snaps:
                    best = (max(with_snaps, key=lambda e: e.stamp), depth)
            elif node.passing:
                best = (max(node.passing, key=lambda e: e.stamp), depth)
        if best is None:
            return None
        ent, n = best
        self._touch(ent)
        self.stats.hits += 1
        self.stats.saved_tokens += n
        if need_snaps:
            self.stats.snap_restores += 1
        return ent, n

    # ------------------------------------------------------------- eviction
    def _holder_counts(self) -> Dict[str, Dict[int, int]]:
        """Per pool: page -> number of CACHE streams referencing it."""
        held: Dict[str, Dict[int, int]] = {w: {} for w in self.pools}
        for ent in self._entries.values():
            for which, pool in self.pools.items():
                for p in pool.table(ent.stream):
                    held[which][p] = held[which].get(p, 0) + 1
        return held

    def would_free(self, ent: _Entry) -> int:
        """Pages across all pools that evicting ``ent`` would return to
        the free lists: pages whose every reference is a cache stream and
        which only ``ent`` holds among cache streams."""
        held = self._holder_counts()
        freed = 0
        for which, pool in self.pools.items():
            for p in set(pool.table(ent.stream)):
                if held[which][p] == 1 and pool.refcount(p) == 1:
                    freed += 1
        return freed

    def reclaimable(self, which: str) -> int:
        """Pages in pool ``which`` held ONLY by cache streams — the pages
        pressure-driven eviction can free without touching any live
        request (admission adds these to the pool's free headroom)."""
        pool = self.pools[which]
        held = self._holder_counts()[which]
        return sum(1 for p, n in held.items() if pool.refcount(p) == n)

    def evict_lru(self) -> bool:
        """Evict the least-recently-used run whose eviction frees at
        least one page (runs pinned by live requests free nothing and are
        skipped — they cost nothing to keep).  Deeper runs sharing a
        shallower run's pages resolve over successive calls: evicting the
        deep run makes the shallow one freeable next.  Returns False when
        nothing can be freed."""
        held = self._holder_counts()
        best: Optional[_Entry] = None
        for ent in self._entries.values():
            frees = any(
                held[which][p] == 1 and pool.refcount(p) == 1
                for which, pool in self.pools.items()
                for p in set(pool.table(ent.stream)))
            if frees and (best is None or ent.stamp < best.stamp):
                best = ent
        if best is None:
            return False
        self._evict(best)
        return True

    def _evict(self, ent: _Entry) -> None:
        for pool in self.pools.values():
            pool.close(ent.stream, "evict")
        del self._entries[ent.eid]
        path = self._chunks(ent.key)
        node = self.root
        chain = []
        for ch in path:
            node = node.children[ch]
            chain.append((ch, node))
            node.passing.remove(ent)
        tail = chain[-1][1]
        tail.entries.remove(ent)
        # prune now-empty trie branches (no entries pass through them)
        parent = self.root
        for ch, node in chain:
            if not node.passing:
                del parent.children[ch]
                break
            parent = node
        self.stats.evicted_runs += 1

    def clear(self) -> int:
        """Drop every run (tests / explicit flush).  Returns runs dropped."""
        n = 0
        while self._entries:
            self._evict(next(iter(self._entries.values())))
            n += 1
        return n

    # ----------------------------------------------------------- invariants
    def check(self) -> None:
        """Trie/pool cross-invariants (the property tests run this after
        every step): every run's streams are open at exactly its depth in
        every pool, passing lists mirror the entry set, and no page is
        freed while referenced (delegated to the pool refcount checks)."""
        for ent in self._entries.values():
            for which, pool in self.pools.items():
                assert pool.is_open(ent.stream), (which, ent.eid)
                assert pool.length(ent.stream) == ent.depth, \
                    (which, ent.eid, pool.length(ent.stream), ent.depth)

        seen: List[int] = []

        def walk(node: _Node, depth_chunks: int) -> List[_Entry]:
            below: List[_Entry] = list(node.entries)
            for ent in node.entries:
                assert len(ent.key) == depth_chunks * self.page_size
                assert ent.eid in self._entries
                seen.append(ent.eid)
            for ch, child in node.children.items():
                sub = walk(child, depth_chunks + 1)
                assert sub, "childless trie branch survived eviction"
                assert sorted(id(e) for e in child.passing) \
                    == sorted(id(e) for e in sub)
                below.extend(sub)
            return below

        walk(self.root, 0)
        assert sorted(seen) == sorted(self._entries), "trie/entry drift"
        for pool in self.pools.values():
            pool.check()

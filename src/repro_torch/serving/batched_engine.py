"""Batched SpecBranch serving over paged KV (port of
``repro.serving.batched_engine``: ``BatchedDecoder``, the engine base and
``BatchedSpecBranchEngine``'s sequential-draft round).

``BatchedDecoder`` is one model plus a paged decode state with per-row
positions, so requests at different lengths share every forward: pad
writes land beyond a row's logical length (routed to the trash page),
rollback is positional (shrink the row and reclaim the rejected tokens'
pages), and SpecBranch branch forks are extra draft rows that share pages
copy-on-write in the pool.  Every attention call runs the paged-attention
kernel in place over the pages.

Engine contract: per-request token streams are distributed exactly as the
target model (token-for-token the target's greedy stream at temperature
0), and match the reference engine's streams bit for bit where the two
frameworks' float arithmetic agrees.  The loop is device-resident: logits,
draft q slices and verdict inputs stay on the device, and the host sees
only small packets (sampled tokens, confidences, verdicts).  Uniforms come
from per-request folded threefry keys indexed by a per-request decision
counter, so a request's output does not depend on its batchmates.

A SpecBranch round dispatches the branch-stage target verification BEFORE
the draft ticks (the chunk under verification was drafted last round), so
on the card the verification runs while the host drives the drafting; the
per-tick packet is double-buffered (tick t is dispatched before tick
t-1's packet is fetched, with epsilon stops applied one tick late and the
over-ingested token pruned like any rollback).  Admission runs batched
bucketed prefill: requests admitted together pad up a fixed-quantum
length ladder and each rung is ONE forward.  At temperature > 0 the chain
verdict runs through the fused verify kernel; preemption parks a row's KV
in a paged swap store on the device, read back by the gather kernel.

Not in this slice (each raises ``NotImplementedError``): the dense
backend, parallel drafting, the prefix cache, H-RAD inference, the history
predictor, mesh serving, and the batched SpS engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import NULL_RECORDER
from repro_torch.runtime import prng
from repro_torch.runtime import sampling as S
from repro_torch.runtime.cost_model import CostModel
from repro_torch.runtime.engines import EngineConfig, GenResult, GenStats
from repro_torch.serving import device_loop as DL
from repro_torch.serving.decode_state import DecodeState
from repro_torch.serving.kv_pool import (PagedKVPool, PagedStore,
                                         PoolExhausted, PoolGroup)


def _count_fetch(owner, arr: torch.Tensor) -> np.ndarray:
    """THE device -> host gate: every byte that crosses lands in
    ``owner``'s ``xfer_bytes`` / ``xfer_fetches`` tally."""
    a = arr.cpu().numpy()
    owner.xfer_bytes += a.nbytes
    owner.xfer_fetches += 1
    return a


# ---------------------------------------------------------------------------
# multi-row decoder
# ---------------------------------------------------------------------------

class BatchedDecoder:
    """One model + a paged N-row decode state with per-row positions.

    ``step`` runs one batched forward at caller-supplied per-row start
    positions and returns DEVICE logits; ``prefill_rows`` ingests a group
    of prompts into fresh rows with one forward per prefill-ladder rung.
    Pad tokens land beyond a row's logical length and go to the trash
    page, so ladder padding never touches live KV."""

    def __init__(self, params, cfg: ModelConfig, *, n_rows: int,
                 max_len: int, paged: PagedKVPool, device,
                 prefill_lanes: int = 0, prefill_quantum: int = 8):
        self.cfg = cfg
        self.n_rows, self.max_len = n_rows, max_len
        self.device = device
        self.params = params
        self.state = DecodeState(cfg, n_rows=n_rows, max_len=max_len,
                                 paged=paged, device=device)
        self.prefill_lanes = prefill_lanes or DL.bucket(n_rows)
        self.prefill_quantum = prefill_quantum

    @property
    def cache(self):
        return self.state.cache

    @property
    def free_rows(self) -> List[int]:
        return self.state.free_rows

    @property
    def row_pos(self) -> np.ndarray:
        return self.state.row_pos

    @property
    def swappable(self) -> bool:
        return self.state.swappable

    @property
    def swap_dim(self) -> int:
        return self.state.swap_dim

    def bind_row(self, row: int, key: Any) -> None:
        """Attach a pool stream to a decoder row: every forward reads the
        row's page table and length live from the pool."""
        self.state.bind(row, key)

    def unbind_row(self, row: int) -> None:
        self.state.unbind(row)

    def copy_page(self, src: int, dst: int) -> None:
        """Physical COW mirror (hooked into the pool's cow_listeners)."""
        self.state.copy_page(src, dst)

    def copy_row(self, src: int, dst: int) -> None:
        """Branch fork: zero bytes move; the fork is page-table sharing in
        the pool (the caller binds dst to the forked stream key)."""
        self.state.fork(src, dst)

    @torch.no_grad()
    def _forward(self, tokens, positions, rows=None) -> torch.Tensor:
        tab, lens = self.state.table_view(rows)
        dev = self.device
        logits, _ = M.forward(
            self.params, self.cfg,
            torch.as_tensor(tokens).to(device=dev, dtype=torch.int64),
            cache=self.cache, positions=positions,
            paged=(torch.from_numpy(tab).to(dev),
                   torch.from_numpy(lens).to(dev)))
        return logits

    def step(self, tokens, pos) -> torch.Tensor:
        """Batched forward: tokens (n_rows, T) (numpy OR device — sampled
        tokens chain straight back in), pos (n_rows,) start positions.
        Returns DEVICE logits (n_rows, T, V)."""
        assert tokens.shape[0] == self.n_rows
        T = tokens.shape[1]
        positions = (torch.from_numpy(np.asarray(pos, np.int32)).to(
            self.device)[:, None]
            + torch.arange(T, dtype=torch.int32, device=self.device)[None])
        return self._forward(tokens, positions)

    def prefill_rows(self, parts: Sequence[Tuple[int, Sequence[int]]]
                     ) -> torch.Tensor:
        """Batched bucketed prefill: each ``(row, tokens)`` prompt into its
        fresh row with ONE forward at a fixed ``(prefill_lanes,
        ladder-width)`` shape.  Lane i of the returned device logits is
        ``parts[i]``'s; pad lanes and pad positions write the trash page."""
        assert parts and len(parts) <= self.prefill_lanes
        G = self.prefill_lanes
        Tb = DL.prefill_bucket(max(len(t) for _, t in parts),
                               self.prefill_quantum)
        if Tb > self.max_len:
            raise RuntimeError(
                f"prefill bucket {Tb} overflows max_len={self.max_len}")
        toks = np.zeros((G, Tb), np.int32)
        for i, (_row, t) in enumerate(parts):
            L = len(t)
            assert 1 <= L <= Tb
            toks[i, :L] = t
            if L < Tb:
                toks[i, L:] = t[-1]
        positions = torch.arange(Tb, dtype=torch.int32,
                                 device=self.device).expand(G, Tb)
        logits = self._forward(
            toks, positions,
            [row for row, _ in parts] + [-1] * (G - len(parts)))
        for row, t in parts:
            self.state.row_pos[row] = len(t)
        return logits

    def pack_row(self, row: int, length: int) -> torch.Tensor:
        """The row's first ``length`` KV slots as (L, swap_dim) float32 rows
        on the device, gathered page by page through its table."""
        return self.state.pack_row(row, length)

    def unpack_row(self, row: int, rows: torch.Tensor) -> None:
        """Restore a row from packed token rows (inverse of pack_row)."""
        self.state.unpack_row(row, rows)


# ---------------------------------------------------------------------------
# per-request state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Stream:
    """One model-side token stream living in a decoder row."""
    row: int
    ing: int = 0                     # KV slots written (row positions 0..)
    pending: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Seq:
    rid: int
    prompt: List[int]
    max_new: int
    on_token: Optional[Callable[[int, int, float], None]]
    ctr: int = 0                     # PRNG decision counter (folded key)
    tgt: _Stream = None
    dft: _Stream = None
    out: List[int] = dataclasses.field(default_factory=list)
    stats: GenStats = dataclasses.field(default_factory=GenStats)
    streamed: int = 0                # tokens already delivered via callback
    admit_order: int = -1
    done: bool = False
    # SpecBranch carried state — distributions stay on the device
    mode: str = "draft"
    chunk: List[int] = dataclasses.field(default_factory=list)
    chunk_q: List[torch.Tensor] = dataclasses.field(default_factory=list)
    q_b: Optional[torch.Tensor] = None       # (V,) signal LOGITS, device
    q_b_conf: float = 0.0                    # host copy of max signal prob

    @property
    def committed(self) -> int:
        """Committed stream length = prompt + generated."""
        return len(self.prompt) + len(self.out)


# ---------------------------------------------------------------------------
# engine base
# ---------------------------------------------------------------------------

class BatchedEngineBase:
    name = "batched-base"
    draft_rows_per_seq = 1

    def __init__(self, draft_params, draft_cfg: ModelConfig,
                 target_params, target_cfg: ModelConfig,
                 ecfg: EngineConfig, *,
                 max_batch: int = 8,
                 page_size: int = 16,
                 pool_pages: Optional[int] = None,
                 swap_pages: int = 0,
                 hrad_params=None,
                 draft_heads=None,
                 attn_backend: str = "paged",
                 prefix_cache: bool = False,
                 debug_check: bool = False,
                 mesh=None,
                 device="cuda"):
        later = {
            "attn_backend='dense'": attn_backend != "paged",
            "draft_mode='parallel' / draft_heads":
                ecfg.draft_mode != "sequential" or draft_heads is not None,
            "prefix_cache=True": prefix_cache,
            "hrad_params (H-RAD inference)": hrad_params is not None,
            f"spec_predictor={ecfg.spec_predictor!r}":
                ecfg.spec_predictor != "off",
            "mesh serving": mesh is not None,
        }
        for what, asked in later.items():
            if asked:
                raise NotImplementedError(
                    f"{what} is ported in a later slice (ROADMAP.md queue "
                    "A); this slice serves the paged sequential-draft path")
        self.device = resolve_device(device)
        self.dp, self.dcfg = draft_params, draft_cfg
        self.tp, self.tcfg = target_params, target_cfg
        self.ecfg = ecfg
        self.max_batch = max_batch
        self.attn_backend = attn_backend
        self.debug_check = debug_check
        # device-resident loop constants: the base key lives on the host,
        # where the uniform grids are hashed (device_loop)
        self._key = prng.PRNGKey(ecfg.seed & 0x7FFFFFFF)
        self._tt = float(ecfg.temperature)
        self._dt = float(ecfg.draft_temperature)
        self._st = float(ecfg.signal_temperature)
        # chunk pad width: a carried chunk is a serial draft (<= gamma) OR
        # an adopted branch continuation (<= gamma_branch)
        self._CH = DL.bucket(max(1, ecfg.gamma, ecfg.gamma_branch))
        self._K = max(1, ecfg.k_max)
        # fused verify route: the CUDA verify kernel on the card at
        # temperature > 0, the probs-space twin otherwise
        self._use_kernel = DL.kernel_route(self._tt, self._dt, self.device)
        # uniform-window width one branch verify consumes per request
        self._W = self._CH + 1 + self._K + 1
        self.xfer_bytes = 0
        self.xfer_fetches = 0
        # split page-id spaces: target streams ("t", rid) and draft streams
        # ("d"/"b", ...) allocate from separate pools, so each decoder's
        # page buffers are sized to its own pages
        if pool_pages is None:
            t_pages = -(-max_batch * ecfg.max_len // page_size)
            d_pages = -(-max_batch * self.draft_rows_per_seq
                        * ecfg.max_len // page_size)
        else:
            per_seq = 1 + self.draft_rows_per_seq
            t_pages = max(2, round(pool_pages / per_seq))
            d_pages = max(2, pool_pages - t_pages)
        self.pools: Dict[str, PagedKVPool] = {
            "t": PagedKVPool(t_pages, page_size),
            "d": PagedKVPool(d_pages, page_size),
        }
        self.pool = PoolGroup(self.pools)      # aggregate metrics view
        # prefill length-ladder quantum (pad span < quantum)
        self._pq = 8
        lanes = DL.bucket(max_batch)   # admission groups are <= max_batch
        self.tgt_dec = BatchedDecoder(target_params, target_cfg,
                                      n_rows=max_batch, max_len=ecfg.max_len,
                                      paged=self.pools["t"],
                                      device=self.device,
                                      prefill_lanes=lanes,
                                      prefill_quantum=self._pq)
        self.dft_dec = BatchedDecoder(draft_params, draft_cfg,
                                      n_rows=max_batch
                                      * self.draft_rows_per_seq,
                                      max_len=ecfg.max_len,
                                      paged=self.pools["d"],
                                      device=self.device,
                                      prefill_lanes=lanes,
                                      prefill_quantum=self._pq)
        # accounting COW (pool) -> physical COW, each in its own buffer
        self.pools["t"].cow_listeners.append(self.tgt_dec.copy_page)
        self.pools["d"].cow_listeners.append(self.dft_dec.copy_page)
        self.swap: Optional[PagedStore] = None
        if swap_pages > 0 and self.tgt_dec.swappable:
            self.swap = PagedStore(swap_pages, page_size,
                                   self.tgt_dec.swap_dim, device=self.device)
        self._swapped: Dict[int, dict] = {}      # rid -> swap metadata
        self._pending_admits: List[Tuple[_Seq, List[int], bool]] = []
        self.cost = CostModel(c=ecfg.c)
        self.clock = 0.0
        self.timeline: List[Tuple[str, int, int]] = []
        self.active: List[_Seq] = []
        self._admit_counter = 0
        self.rec = NULL_RECORDER

    def _pool_of(self, key: Any) -> PagedKVPool:
        """Target streams ("t", rid) live in the target pool; draft streams
        and their branch forks ("d", rid) / ("b", rid, i) in the draft
        pool."""
        return self.pools["t" if key[0] == "t" else "d"]

    # ------------------------------------------------------- host boundary
    def _fetch(self, arr: torch.Tensor) -> np.ndarray:
        """The engines' device -> host gate: small packets only."""
        return _count_fetch(self, arr)

    def _count_staged(self, nbytes: int) -> None:
        """Host -> device admission traffic (prefill token frames)."""
        self.xfer_bytes += int(nbytes)
        self.xfer_fetches += 1

    @property
    def host_transfer_bytes(self) -> int:
        """Bytes moved across the host boundary: packets plus prefill
        staging.  Swap-out and swap-in are device-to-device here (the
        swap store lives on the device) and do not count, so the
        decoders never cross the boundary themselves."""
        return self.xfer_bytes

    @property
    def host_fetches(self) -> int:
        return self.xfer_fetches

    # ---------------------------------------------------------- batched fwd
    def _batched(self, dec: BatchedDecoder,
                 parts: List[Tuple[int, List[int], int]]) -> torch.Tensor:
        """One batched forward with host-staged tokens.  parts: (row,
        real_tokens, start_pos); the width pads up the bucket ladder and
        unlisted rows tick in place at their write head."""
        T = DL.bucket(max(len(t) for _, t, _ in parts))
        toks = np.zeros((dec.n_rows, T), np.int32)
        pos = np.minimum(dec.row_pos, dec.max_len - T).astype(np.int32)
        for row, t, p0 in parts:
            if p0 + T > dec.max_len:
                raise RuntimeError(
                    f"row {row} overflows max_len={dec.max_len}")
            toks[row, :len(t)] = t
            if len(t) < T:
                toks[row, len(t):] = t[-1]
            pos[row] = p0
        logits = dec.step(toks, pos)
        for row, t, p0 in parts:
            dec.row_pos[row] = p0 + len(t)
        return logits

    def _ingest(self, dec: BatchedDecoder,
                triples: List[Tuple[_Stream, Any, List[int]]]
                ) -> torch.Tensor:
        """Batched ingest of per-stream token lists + pool accounting."""
        for st, pool_key, toks in triples:
            self._pool_of(pool_key).extend(pool_key, len(toks))
        logits = self._batched(dec, [(st.row, toks, st.ing)
                                     for st, _, toks in triples])
        for st, _, toks in triples:
            st.ing += len(toks)
        return logits

    def _ingest_dev(self, dec: BatchedDecoder,
                    pairs: List[Tuple[_Stream, Any]],
                    tokens_by_row: torch.Tensor) -> torch.Tensor:
        """Single-token batched ingest with DEVICE tokens: each listed
        stream consumes tokens_by_row[stream.row] straight from the
        previous tick's sample.  Unlisted rows park at their write head."""
        mask = np.zeros(dec.n_rows, bool)
        pos = np.minimum(dec.row_pos, dec.max_len - 1).astype(np.int32)
        for st, pool_key in pairs:
            self._pool_of(pool_key).extend(pool_key, 1)
            if st.ing + 1 > dec.max_len:
                raise RuntimeError(
                    f"row {st.row} overflows max_len={dec.max_len}")
            mask[st.row] = True
            pos[st.row] = st.ing
        logits = dec.step(DL.masked_token_column(tokens_by_row, mask), pos)
        for st, _ in pairs:
            st.ing += 1
            dec.row_pos[st.row] = st.ing
        return logits

    # ----------------------------------------------------------- admission
    def _pool_keys(self, rid: int) -> Tuple[Any, Any]:
        return ("t", rid), ("d", rid)

    def admit_cost_pages(self, prompt_len: int) -> int:
        """Pages an admission takes from EACH pool."""
        return self.pools["t"].pages_for(prompt_len - 1)

    def _max_len_headroom(self) -> int:
        """Worst-case tokens a live row can hold beyond prompt + max_new:
        one round of overshoot plus a branch continuation plus bucket and
        prefill-ladder padding."""
        return (2 * (DL.bucket(self.ecfg.gamma + 2)
                     + DL.bucket(self.ecfg.gamma_branch + 2) + 4)
                + self._pq)

    def can_admit(self, prompt_len: int, max_new: int = 0) -> bool:
        if not self.tgt_dec.free_rows or len(self.active) >= self.max_batch:
            return False
        if len(self.dft_dec.free_rows) < self.draft_rows_per_seq:
            return False
        if (prompt_len + max_new + self._max_len_headroom()
                > self.ecfg.max_len):
            return False
        need = self.admit_cost_pages(prompt_len)
        return all(need + self._round_slack_pages(which) <= pool.free_pages
                   for which, pool in self.pools.items())

    def _round_slack_pages(self, which: str) -> int:
        """Pages one request may need from pool ``which`` for one
        worst-case round, kept free at admission."""
        g, gb = self.ecfg.gamma, self.ecfg.gamma_branch
        if which == "t":
            return self.pools["t"].pages_for(2 + g)
        worst = g + 1
        if self.draft_rows_per_seq > 1:
            worst += (self.draft_rows_per_seq - 1) * (1 + gb)
        return self.pools["d"].pages_for(worst) + self.draft_rows_per_seq

    def resume_out_len(self, rid: int) -> int:
        """Tokens already generated by a parked (preempted) request."""
        meta = self._swapped.get(rid)
        return len(meta["seq"].out) if meta is not None else 0

    def reserve(self, rid: int, prompt: Sequence[int], max_new: int,
                on_token=None) -> _Seq:
        """Admission bookkeeping for one request (rows, pool streams, swap
        restore) with the prefill forward DEFERRED to
        ``commit_admissions``, which ingests the whole group."""
        meta = self._swapped.pop(rid, None)
        if meta is not None:
            seq = meta["seq"]
        else:
            seq = _Seq(rid=rid, prompt=list(prompt), max_new=max_new,
                       on_token=on_token)
        toks = seq.prompt + seq.out
        assert len(toks) >= 2, "need a prompt of >= 2 tokens"
        L = len(toks) - 1
        tk, dk = self._pool_keys(rid)
        self.pools["t"].open(tk)
        self.pools["d"].open(dk)
        try:
            self.pools["t"].extend(tk, L)
            self.pools["d"].extend(dk, L)
        except PoolExhausted:
            self.pools["t"].close(tk, "preempt")
            self.pools["d"].close(dk, "preempt")
            if meta is not None:
                self._swapped[rid] = meta
            raise
        t_row = self.tgt_dec.free_rows.pop()
        d_row = self.dft_dec.free_rows.pop()
        self.tgt_dec.bind_row(t_row, tk)
        self.dft_dec.bind_row(d_row, dk)
        restored = False
        if meta is not None and meta.get("swap_key") is not None:
            self.tgt_dec.unpack_row(t_row, self.swap.get(meta["swap_key"]))
            self.swap.drop(meta["swap_key"])
            restored = True
        seq.tgt = _Stream(row=t_row, ing=L, pending=[toks[-1]])
        seq.dft = _Stream(row=d_row, ing=L, pending=[toks[-1]])
        seq.mode, seq.chunk, seq.chunk_q, seq.q_b = "draft", [], [], None
        seq.admit_order = self._admit_counter
        self._admit_counter += 1
        self.active.append(seq)
        self._pending_admits.append((seq, toks[:-1], restored))
        return seq

    def commit_admissions(self) -> None:
        """Run the deferred prefills of the current admission group: one
        forward per decoder per prefill-ladder rung (swap-restored target
        rows skip theirs)."""
        pending, self._pending_admits = self._pending_admits, []
        if not pending:
            return
        buckets: Dict[int, List[Tuple[_Seq, List[int], bool]]] = {}
        for seq, toks, restored in pending:
            width = DL.prefill_bucket(len(toks), self._pq)
            buckets.setdefault(width, []).append((seq, toks, restored))
        lanes = self.tgt_dec.prefill_lanes
        for width in sorted(buckets):
            grp = buckets[width]
            for i in range(0, len(grp), lanes):
                chunk = grp[i:i + lanes]
                tparts = [(seq.tgt.row, toks)
                          for seq, toks, restored in chunk if not restored]
                if tparts:
                    self.tgt_dec.prefill_rows(tparts)
                    # the staged (lanes, width) int32 token frame crosses
                    # host -> device once per prefill forward
                    self._count_staged(lanes * width * 4)
                    for seq, _toks, restored in chunk:
                        if not restored:
                            seq.stats.target_calls += 1
                self.dft_dec.prefill_rows([(seq.dft.row, toks)
                                           for seq, toks, _ in chunk])
                self._count_staged(lanes * width * 4)
        if self.debug_check:
            self.pool.check()

    # ----------------------------------------------------------- preemption
    def preempt_youngest(self) -> _Seq:
        """Evict the most recently admitted request (FIFO-preserving) and
        release its rows and pages; its target KV is parked in the swap
        store when possible, else recomputed at re-admission."""
        victim = max(self.active, key=lambda s: s.admit_order)
        self.active.remove(victim)
        meta = {"seq": victim, "swap_key": None}
        if self.swap is not None and victim.tgt.ing > 0:
            key = ("swap", victim.rid, victim.admit_order)
            try:
                self.swap.put(key, self.tgt_dec.pack_row(victim.tgt.row,
                                                         victim.tgt.ing))
                meta["swap_key"] = key
            except PoolExhausted:
                pass
        tk, dk = self._pool_keys(victim.rid)
        self.pools["t"].close(tk, "preempt")
        self.pools["d"].close(dk, "preempt")
        self.tgt_dec.unbind_row(victim.tgt.row)
        self.dft_dec.unbind_row(victim.dft.row)
        self.tgt_dec.free_rows.append(victim.tgt.row)
        self.dft_dec.free_rows.append(victim.dft.row)
        victim.tgt = victim.dft = None
        victim.mode, victim.chunk, victim.chunk_q = "draft", [], []
        victim.q_b = None
        self._swapped[victim.rid] = meta
        return victim

    def _make_room(self, seqs: List[_Seq],
                   fits: Callable[[List[_Seq]], bool]) -> List[_Seq]:
        """Preempt youngest-first until this round's worst case fits."""
        preempted = []
        while not fits(seqs):
            if len(seqs) <= 1:
                raise RuntimeError(
                    "KV pool too small to run a single request round "
                    f"({self.pool.num_pages} pages x {self.pool.page_size})")
            victim = self.preempt_youngest()
            seqs.remove(victim)
            preempted.append(victim)
        return preempted

    # ------------------------------------------------------------- commits
    def _commit(self, seq: _Seq, tokens: List[int], now: float) -> None:
        seq.out.extend(tokens)
        seq.stats.emitted += len(tokens)
        if seq.on_token is not None:
            while seq.streamed < min(len(seq.out), seq.max_new):
                seq.on_token(seq.rid, seq.out[seq.streamed], now)
                seq.streamed += 1
        if len(seq.out) >= seq.max_new:
            seq.done = True

    def _rollback_streams(self, seq: _Seq) -> None:
        """Reset both streams to the committed prefix, newest token pending,
        reclaiming rejected pages; the write head follows the reset."""
        keep = seq.committed - 1
        tk, dk = self._pool_keys(seq.rid)
        full = seq.prompt + seq.out
        for st, key, dec in ((seq.tgt, tk, self.tgt_dec),
                             (seq.dft, dk, self.dft_dec)):
            if st.ing > keep:
                self._pool_of(key).truncate(key, keep, "rollback")
            st.ing = min(st.ing, keep)
            dec.row_pos[st.row] = st.ing
            st.pending = [int(t) for t in full[st.ing:]]

    # -------------------------------------------------------------- retire
    def retire_done(self) -> List[Tuple[_Seq, GenResult]]:
        out = []
        for seq in [s for s in self.active if s.done]:
            self.active.remove(seq)
            tk, dk = self._pool_keys(seq.rid)
            self.pools["t"].close(tk, "retire")
            self.pools["d"].close(dk, "retire")
            self.tgt_dec.unbind_row(seq.tgt.row)
            self.dft_dec.unbind_row(seq.dft.row)
            self.tgt_dec.free_rows.append(seq.tgt.row)
            self.dft_dec.free_rows.append(seq.dft.row)
            seq.stats.finish()
            out.append((seq, GenResult(seq.out[:seq.max_new], seq.stats,
                                       [])))
        if self.debug_check:
            self.pool.check()
        return out

    # --------------------------------------------------------------- round
    def step_round(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _finish_round(self, kind: str, draft_steps: int,
                      target_calls: int) -> float:
        rnd = (kind, draft_steps, target_calls)
        self.timeline.append(rnd)
        self.clock += self.cost.round_cost(rnd)
        if self.debug_check:
            self.pool.check()
        return self.clock


# ---------------------------------------------------------------------------
# batched SpecBranch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _BranchSet:
    """Per-request branch-stage working set, alive within one round: token
    ids and confidences are host values from the tick packets, the
    continuation q's stay device logits."""
    cands: np.ndarray                        # (k,)
    streams: List[_Stream] = dataclasses.field(default_factory=list)
    conts: List[List[int]] = dataclasses.field(default_factory=list)
    cont_q: List[List[torch.Tensor]] = dataclasses.field(
        default_factory=list)
    confs: List[List[float]] = dataclasses.field(default_factory=list)
    final_sig: List[Optional[torch.Tensor]] = dataclasses.field(
        default_factory=list)
    final_conf: List[float] = dataclasses.field(default_factory=list)


class BatchedSpecBranchEngine(BatchedEngineBase):
    """SpecBranch (hybrid drafting + branch parallelism), continuous-batched.

    Per round every request advances one stage of the SpecBranch state
    machine: DRAFT-mode requests serial-draft their chunk, BRANCH-mode
    requests fork k branch rows (zero-copy page sharing) and draft
    continuations — all draft work rides the same batched single-token
    ticks — and one batched target call verifies every BRANCH-mode chunk,
    dispatched before the ticks so it overlaps them.  Losing branches and
    rejected tokens return their pages through ``truncate`` / ``close``
    with a reason tag.
    """
    name = "batched-specbranch"

    def __init__(self, *args, **kw):
        ecfg = args[4] if len(args) > 4 else kw["ecfg"]
        self.draft_rows_per_seq = 1 + max(1, ecfg.k_max)
        super().__init__(*args, **kw)

    def _branch_k(self, seq: _Seq) -> int:
        if not self.ecfg.use_branch:
            return 1
        k_max = self.ecfg.k_max
        return min(k_max, S.adaptive_k(seq.q_b_conf, k_max))

    def _bkey(self, rid: int, i: int):
        return ("b", rid, i)

    def _free_branches(self, seq: _Seq, bset: _BranchSet,
                       reason: str, keep: Optional[int] = None) -> None:
        for i, st in enumerate(bset.streams):
            if i == keep:
                continue
            self.pools["d"].close(self._bkey(seq.rid, i), reason)
            self.dft_dec.unbind_row(st.row)
            self.dft_dec.free_rows.append(st.row)

    def _by_row(self, n_rows: int, entries) -> Tuple[np.ndarray, np.ndarray]:
        """(rids, ctrs) indexed by decoder row for the tick functions;
        rows not listed keep (0, 0) and compute garbage the host ignores."""
        rids = np.zeros(n_rows, np.int32)
        ctrs = np.zeros(n_rows, np.int32)
        for row, rid, ctr in entries:
            rids[row] = rid
            ctrs[row] = ctr
        return rids, ctrs

    # --------------------------------------------------------------- round
    @torch.no_grad()
    def step_round(self) -> Dict[str, Any]:
        seqs = [s for s in self.active if not s.done]
        if not seqs:
            return {"committed": {}, "preempted": []}
        g, gb = self.ecfg.gamma, self.ecfg.gamma_branch
        K, CH = self._K, self._CH
        eps = self.ecfg.epsilon
        dev = self.device

        # has_room can't price not-yet-forked branch streams; count their
        # worst case (suffix pages + one COW tail copy each) by hand
        def fits(ss):
            d_ups, t_ups, d_extra = [], [], 0
            pd = self.pools["d"]
            for s in ss:
                if s.mode == "draft":
                    d_ups.append((("d", s.rid), len(s.dft.pending) + g))
                else:
                    k = self._branch_k(s)
                    dlen = pd.length(("d", s.rid))
                    per = (pd.pages_for(dlen + 1 + gb)
                           - pd.pages_for(dlen) + 1)
                    d_extra += k * per
                    t_ups.append((("t", s.rid),
                                  len(s.tgt.pending) + len(s.chunk)))
            return (pd.would_need(d_ups) + d_extra <= pd.free_pages
                    and self.pools["t"].has_room(t_ups))

        preempted = self._make_room(seqs, fits)

        serial = [s for s in seqs if s.mode == "draft"]
        branchers = [s for s in seqs if s.mode == "branch"]
        B = self.max_batch
        n_d = self.dft_dec.n_rows
        V = self.dcfg.vocab_size

        # ---- dispatch the branch-stage verification FIRST: its chunks were
        # drafted last round, so the target forward + fused verdict overlap
        # the draft ticks below (asynchronous dispatch)
        bsets: Dict[int, _BranchSet] = {}
        packet_dev = None
        pends: Dict[int, List[int]] = {}
        ks: Dict[int, int] = {}
        if branchers:
            zero_v = torch.zeros((V,), device=dev)
            qb_stack = torch.stack([s.q_b for s in branchers]
                                   + [zero_v] * (B - len(branchers)))
            rid_l = np.zeros(B, np.int32)
            ctr_l = np.zeros(B, np.int32)
            for i, s in enumerate(branchers):
                rid_l[i] = s.rid
                ctr_l[i] = s.ctr
                ks[s.rid] = self._branch_k(s)
            cands = self._fetch(DL.draw_cands(
                qb_stack, rid_l, ctr_l, self._key, K=K, stemp=self._st,
                mode=self.ecfg.branch_mode))
            if self.ecfg.branch_mode != "topk":
                for s in branchers:
                    s.ctr += ks[s.rid]
            for i, s in enumerate(branchers):
                bset = _BranchSet(cands=cands[i, :ks[s.rid]].astype(np.int64))
                for bi in range(ks[s.rid]):
                    row = self.dft_dec.free_rows.pop()
                    self.dft_dec.copy_row(s.dft.row, row)
                    self.pools["d"].fork(("d", s.rid), self._bkey(s.rid, bi))
                    self.dft_dec.bind_row(row, self._bkey(s.rid, bi))
                    bset.streams.append(_Stream(row=row, ing=s.dft.ing))
                    bset.conts.append([])
                    bset.cont_q.append([])
                    bset.confs.append([])
                    bset.final_sig.append(None)
                    bset.final_conf.append(0.0)
                bsets[s.rid] = bset
            pends = {s.rid: list(s.tgt.pending) for s in branchers}
            tlg = self._ingest(
                self.tgt_dec,
                [(s.tgt, ("t", s.rid), s.tgt.pending + s.chunk)
                 for s in branchers])
            npend_l = np.zeros(B, np.int32)
            gch_l = np.zeros(B, np.int32)
            ks_l = np.ones(B, np.int32)
            trows = np.full(B, self.tgt_dec.n_rows, np.int32)  # OOB pad
            ctr_v = np.zeros(B, np.int32)
            cq_rows = []
            ct = np.zeros((B, CH), np.int32)
            zero_q = torch.zeros((CH, V), device=dev)
            for i, s in enumerate(branchers):
                npend_l[i] = len(pends[s.rid])
                gch_l[i] = len(s.chunk)
                ks_l[i] = ks[s.rid]
                trows[i] = s.tgt.row
                ctr_v[i] = s.ctr
                cq_rows.append(
                    torch.stack(list(s.chunk_q) + [s.chunk_q[-1]]
                                * (CH - len(s.chunk_q)))
                    if s.chunk_q else zero_q)
                ct[i, :len(s.chunk)] = s.chunk
            cq_rows += [zero_q] * (B - len(branchers))
            packet_dev = DL.branch_verify(
                tlg, trows, npend_l, gch_l, torch.stack(cq_rows), ct,
                cands, ks_l, qb_stack, rid_l, ctr_v, self._key, CH=CH, K=K,
                ttemp=self._tt, dtemp=self._dt, stemp=self._st,
                kernel=self._use_kernel)
            for s in branchers:
                s.ctr += self._W

        # ---- PHASE A: all draft-model work, interleaved batched ticks ----
        # (H-RAD's prior signal is 1 without H-RAD parameters: every
        # DRAFT-mode request runs the confidence-threshold stop rule)
        for s in serial:
            s.chunk, s.chunk_q = [], []

        # tick 0: serial rows ingest pending; branch rows their candidates
        triples = []
        for s in serial:
            triples.append((s.dft, ("d", s.rid), list(s.dft.pending)))
            s.dft.pending = []
        for s in branchers:
            bset = bsets[s.rid]
            for i, st in enumerate(bset.streams):
                triples.append((st, self._bkey(s.rid, i),
                                [int(bset.cands[i])]))
            s.stats.draft_tokens += 1      # batched candidate ingest step
        lg = self._ingest(self.dft_dec, triples)
        last = np.zeros(n_d, np.int32)
        for st, _, toks in triples:
            last[st.row] = len(toks) - 1
        ticks = 1

        # double-buffered tick pipeline: tick t is dispatched before tick
        # t-1's packet is fetched; epsilon stops land one tick late and
        # the optimistically ingested token is pruned like any rollback
        live = {s.rid: True for s in serial}
        reads = {s.rid: 0 for s in serial}     # ticks staged so far
        ctr0 = {s.rid: s.ctr for s in serial}
        b_ctr0 = {s.rid: s.ctr for s in branchers}
        branch_j = {s.rid: 0 for s in branchers}

        def resolve(p) -> None:
            """Apply one fetched tick packet: keep/stop serial chunks
            (pruning an optimistic over-ingest on epsilon stops), record
            branch continuations."""
            _, qsl_p, packed_p, srd, brd = p
            pkt = self._fetch(packed_p)         # (n_d, 2) f32 — tiny
            for s, i in srd:
                if not live[s.rid]:
                    continue            # trailing read past its own stop
                row = s.dft.row
                conf = float(pkt[row, 1])
                over = False
                if i >= g:
                    stop = True                  # deterministic: no ingest
                elif conf < eps:
                    stop = True
                    over = True                  # token i rode optimism
                else:
                    stop = False
                if stop:
                    s.q_b = qsl_p[row]
                    s.q_b_conf = conf
                    s.stats.draft_tokens += len(s.chunk) + 1
                    live[s.rid] = False
                    if over:
                        # rollback-aware un-ingest of the speculative token
                        self.pools["d"].truncate(("d", s.rid),
                                                 s.dft.ing - 1, "prune")
                        s.dft.ing -= 1
                        self.dft_dec.row_pos[s.dft.row] = s.dft.ing
                    continue
                s.chunk.append(int(pkt[row, 0]))
                s.chunk_q.append(qsl_p[row])
                s.ctr += 1
            for s, j in brd:
                bset = bsets[s.rid]
                if j == gb:
                    for i, st in enumerate(bset.streams):
                        bset.final_sig[i] = qsl_p[st.row]
                        bset.final_conf[i] = float(pkt[st.row, 1])
                    continue
                for i, st in enumerate(bset.streams):
                    row = st.row
                    bset.conts[i].append(int(pkt[row, 0]))
                    bset.cont_q[i].append(qsl_p[row])
                    bset.confs[i].append(float(pkt[row, 1]))
                s.stats.draft_tokens += 1
                s.ctr += len(bset.streams)

        pend = None        # the dispatched-but-unresolved tick
        while True:
            readers = [s for s in serial
                       if live[s.rid] and reads[s.rid] <= g]
            br_read = [s for s in branchers if branch_j[s.rid] <= gb]
            if not readers and not br_read:
                if pend is not None:
                    resolve(pend)               # drain the pipeline
                    pend = None
                    continue
                break
            entries = []
            srd = []
            for s in readers:
                i = reads[s.rid]
                entries.append((s.dft.row, s.rid, ctr0[s.rid] + i))
                srd.append((s, i))
                reads[s.rid] = i + 1
            brd = []
            for s in br_read:
                j = branch_j[s.rid]
                k_s = len(bsets[s.rid].streams)
                for i, st in enumerate(bsets[s.rid].streams):
                    # branch lane i draws uniform (rid, base + j*k + i)
                    entries.append((st.row, s.rid, b_ctr0[s.rid] + j * k_s
                                    + i))
                brd.append((s, j))
                branch_j[s.rid] = j + 1
            rids, ctrs = self._by_row(n_d, entries)
            toks_dev, qsl, packed = DL.tick_sample(
                lg, last, rids, ctrs, self._key, dtemp=self._dt,
                stemp=self._st)
            # fetch the PREVIOUS tick's packet while this tick computes
            if pend is not None:
                resolve(pend)
            pend = (toks_dev, qsl, packed, srd, brd)
            # optimistic ingest: every row still (believed) drafting
            # chains its sample straight into the next forward
            ingest_pairs = []
            for s, i in srd:
                if live[s.rid] and i < g:
                    ingest_pairs.append((s.dft, ("d", s.rid)))
            for s, j in brd:
                if j < gb:
                    for i, st in enumerate(bsets[s.rid].streams):
                        ingest_pairs.append((st, self._bkey(s.rid, i)))
            if ingest_pairs:
                lg = self._ingest_dev(self.dft_dec, ingest_pairs, toks_dev)
                last[:] = 0
                ticks += 1

        # ---- PHASE B: fetch the verdict packet, commit per brancher ----
        committed: Dict[int, int] = {}
        n_target = 1 if branchers else 0
        kind = "parallel" if (branchers and self.ecfg.use_branch) \
            else "serial"
        now = self.clock + self.cost.round_cost((kind, ticks, n_target))
        if branchers:
            pk = self._fetch(packet_dev)
            for i, s in enumerate(branchers):
                s.tgt.pending = []
                before = min(len(s.out), s.max_new)
                self._branch_verdict(s, bsets[s.rid], pk[i], now)
                committed[s.rid] = min(len(s.out), s.max_new) - before
        for s in serial:
            s.mode = "branch"
        self._finish_round(kind, ticks, n_target)
        return {"committed": committed, "preempted": preempted}

    # --------------------------------------------------- verdict (packet)
    def _branch_verdict(self, s: _Seq, bset: _BranchSet, pk_row,
                        now: float) -> None:
        """Commit/rollback bookkeeping from the (5,) int32 verdict packet
        [n_acc, chain_next, all_acc, accepted_branch, branch_token]."""
        gb = self.ecfg.gamma_branch
        gchunk = len(s.chunk)
        n_acc, chain_next, all_acc, acc_b, tok_b = (int(x) for x in pk_row)
        s.stats.target_calls += 1

        if not all_acc:
            # mid-chunk rejection: every branch is doomed (Fig. 1a)
            self._commit(s, s.chunk[:n_acc] + [chain_next], now)
            s.stats.run_extend(n_acc)
            s.stats.run_break()
            s.stats.rollback_tokens += (gchunk - n_acc) + gb
            self._free_branches(s, bset, "rollback")
            self._rollback_streams(s)
            s.mode, s.chunk, s.chunk_q, s.q_b = "draft", [], [], None
            return

        if acc_b < 0:
            # no branch survives: emit the residual, drop continuations
            self._commit(s, s.chunk + [tok_b], now)
            s.stats.run_extend(gchunk)
            s.stats.run_break()
            s.stats.rollback_tokens += gb
            self._free_branches(s, bset, "branch")
            self._rollback_streams(s)
            s.mode, s.chunk, s.chunk_q, s.q_b = "draft", [], [], None
            return

        i = acc_b
        self._commit(s, s.chunk + [tok_b], now)
        s.stats.run_extend(gchunk + 1)
        s.tgt.pending = [tok_b]
        # adopt the winning branch: its page table replaces the parent's
        # (the shared prefix transfers refcounts)
        win = bset.streams[i]
        self.dft_dec.copy_row(win.row, s.dft.row)
        s.dft.ing = win.ing
        s.dft.pending = []
        self.pools["d"].adopt(("d", s.rid), self._bkey(s.rid, i))
        self._free_branches(s, bset, "branch", keep=i)
        self.dft_dec.unbind_row(win.row)
        self.dft_dec.free_rows.append(win.row)

        # the continuation is cut at its first low-confidence token (the
        # posterior H-RAD signal is 1 without H-RAD parameters)
        cont, q_i, confs = bset.conts[i], bset.cont_q[i], bset.confs[i]
        j = next((jj for jj in range(gb) if confs[jj] < self.ecfg.epsilon),
                 gb)
        if j == gb:
            s.chunk, s.chunk_q = list(cont), list(q_i)
            s.q_b = bset.final_sig[i]
            s.q_b_conf = bset.final_conf[i]
        else:
            s.chunk, s.chunk_q = list(cont[:j]), list(q_i[:j])
            s.q_b = q_i[j]
            s.q_b_conf = confs[j]
            s.stats.pruned_tokens += gb - j
            self._prune_draft(s, s.committed + j)
        s.mode = "branch"

    def _prune_draft(self, s: _Seq, keep: int) -> None:
        """Pre-verify pruning: positional reset of the draft stream."""
        if s.dft.ing > keep:
            self.pools["d"].truncate(("d", s.rid), keep, "prune")
            s.dft.ing = keep
        self.dft_dec.row_pos[s.dft.row] = s.dft.ing
        s.dft.pending = []

"""Batched serving over dense or paged KV (port of
``repro.serving.batched_engine``: ``BatchedDecoder``, the engine base,
``BatchedSpSEngine`` and ``BatchedSpecBranchEngine``).

``BatchedDecoder`` is one model plus a decode state with per-row
positions, so requests at different lengths share every forward: pad
writes land at or beyond a row's logical length (causally masked until
overwritten on the dense backend, routed to the trash page on the paged
one), and rollback is positional (shrink the row and reclaim the rejected
tokens' pages in the pool, which keeps the accounting on both backends).
``attn_backend="dense"`` (the default, as in the reference) keeps N-row
ring caches and attends through the flash-attention kernel; SpecBranch
branch forks are then row copies of the draft decoder.  ``"paged"``
scatters KV across the pool's pages and attends in place through the
paged-attention kernel; branch forks share pages copy-on-write.  SSM and
hybrid configs batch on both: every mamba slot carries a per-row
position-indexed checkpoint ring (its scan runs the selective-scan
kernel), so per-row rollback is positional for both halves of the cache;
a preempted paged hybrid row swaps its attention half through the paged
store and its rings ride one snapshot, a dense hybrid row recomputes its
prefix at re-admission.

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

H-RAD (``hrad_params``, ``core.hrad``): the target decoder then captures
the hidden states of its last ``hrad_k_layers`` feature points (every
position of a step, each lane's last prompt position of a prefill), each
request keeps those of its newest verification (``_Seq.feats_last``),
and every signal costs one 4-byte host fetch, as in the reference.

Observability (``obs.trace``): ``set_recorder`` installs a recorder; the
rounds emit the reference's spec, span and round events, admission its
request and prefill events, and the pools their reclaim and COW events,
every field from host values the loop already holds (no extra device
sync).  ``device_loop.annotate`` brackets the verify dispatches with
profiler ranges when annotations are on.

Single-pass parallel drafting (``draft_mode="parallel"``, DESIGN.md
§7.12): a round's draft ticks collapse into ONE draft forward
(``BatchedDecoder.step_draft``: each row's pending tokens plus masked
slot columns, the slots' keys invisible) and one fused sampling pass
(``device_loop.draft_chunk``) through the multi-position draft heads;
the verify frame, verdict packets and PRNG coordinates are the
sequential rounds'.  The draft caches then hold only the committed
prefix: drafted tokens re-enter as pending after an accept.  The round
tuples carry the measured dispatch count.  The history predictor
(``spec_predictor`` "on" / "oracle", ``runtime.predictor``) gives each
request its own gamma, branch cap and epsilon per round.

The cross-request prefix cache (``prefix_cache=True``, paged only,
``serving.prefix_cache``, DESIGN.md §7.13): a retired or preempted
request publishes the page-aligned prompt prefix its prefill wrote (with
the rings' snapshot at that length for SSM-bearing decoders); an
admission whose prompt starts with a published run binds its pages
zero-copy (``PagedKVPool.fork_prefix``), restores the snapshot, and
prefills only the uncached suffix (``BatchedDecoder.prefill_rows_at``,
on a rung sized to the suffix).  Cache runs no live request holds are
admission headroom and are evicted LRU before a live request is
preempted.  Off (the default) no cache object exists and every path is
the cache-less one.

Mesh serving (``mesh=``, a ``launch.mesh.ServingMesh``, DESIGN.md
§7.10): one process per mesh position runs this same host loop.  Each
decoder slices its rank's block of the full parameter tree
(``sharding.rules.tp_shard_params``) and allocates its cache shard
(``DecodeState``); the forward runs tensor-parallel over the rank's
"model" group and returns full-vocabulary logits, so every rank samples,
verifies and commits the same tokens.  On the dense backend with rows
over "data" each rank forwards its own rows and the logits (and H-RAD
features) are gathered over "data" (``device_loop.replicated``); the
paged backend keeps every row on every rank, so a dp-only paged forward
issues no collective.  A 1x1 mesh is the unmeshed engine bit for bit; a
larger one is greedy-lossless.  With ``debug_check`` every round's
committed tokens are compared across the ranks.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hrad as H
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, check_decodes
from repro_torch.obs.trace import NULL_RECORDER
from repro_torch.runtime import predictor as PRED
from repro_torch.runtime import prng
from repro_torch.runtime import sampling as S
from repro_torch.runtime.cost_model import CostModel
from repro_torch.runtime.engines import EngineConfig, GenResult, GenStats
from repro_torch.serving import device_loop as DL
from repro_torch.serving.decode_state import DecodeState
from repro_torch.serving.kv_pool import (PagedKVPool, PagedStore,
                                         PoolExhausted, PoolGroup)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.sharding import rules


def _count_fetch(owner, arr: torch.Tensor) -> np.ndarray:
    """THE device -> host gate: every byte that crosses lands in
    ``owner``'s ``xfer_bytes`` / ``xfer_fetches`` tally."""
    a = arr.cpu().numpy()
    owner.xfer_bytes += a.nbytes
    owner.xfer_fetches += 1
    return a


def _snap_bytes(snap: List[Dict[str, torch.Tensor]]) -> int:
    """Host bytes of a ring snapshot (what its restore stages)."""
    return sum(a.numel() * a.element_size() for d in snap
               for a in d.values())


# ---------------------------------------------------------------------------
# multi-row decoder
# ---------------------------------------------------------------------------

class BatchedDecoder:
    """One model + an N-row decode state (dense rows, or paged attention
    when ``paged`` is a pool) with per-row positions.

    ``step`` runs one batched forward at caller-supplied per-row start
    positions and returns DEVICE logits; ``prefill_rows`` ingests a group
    of prompts into fresh rows with one forward per prefill-ladder rung.
    Pad tokens land beyond a row's logical length (causally masked, or on
    the trash page), so ladder padding never touches live KV.  With
    ``feature_points`` > 0 both also return the hidden states of the last
    that many feature points (H-RAD's input), else None."""

    def __init__(self, params, cfg: ModelConfig, *, n_rows: int,
                 max_len: int, paged: Optional[PagedKVPool], device,
                 ssm_ring: int = 0, prefill_lanes: int = 0,
                 prefill_quantum: int = 8, feature_points: int = 0,
                 mesh=None):
        self.cfg = cfg
        self.feature_points = feature_points
        self.n_rows, self.max_len = n_rows, max_len
        self.device = device
        # on a mesh: the rank's block of every weight, and the "model"
        # axis the forward sums its partial products over (None at tp 1)
        self.mesh = mesh
        self.tp = None if mesh is None else mesh.tp
        if mesh is not None:
            params = rules.tp_shard_params(params, cfg, mesh, mesh.coords,
                                           device)
        self.params = params
        # checkpoint-ring depth of the mamba slots: bounds how far ahead
        # of a row's logical length writes may land and how far back a
        # rollback may reach
        self.state = DecodeState(cfg, n_rows=n_rows, max_len=max_len,
                                 paged=paged, device=device,
                                 ssm_ring=ssm_ring, mesh=mesh)
        self.prefill_lanes = prefill_lanes or DL.bucket(n_rows)
        self.prefill_quantum = prefill_quantum
        # forwards, their real tokens and prefill shapes, as the
        # reference counts them
        self.n_calls = 0
        self.n_call_tokens = 0
        self.prefill_shapes: set = set()

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

    @property
    def has_ssm(self) -> bool:
        return self.state.has_ssm

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
        """Branch fork: row-axis state (dense KV, rings) copies; paged
        attention moves zero bytes (page-table sharing in the pool; the
        caller binds dst to the forked stream key)."""
        self.state.fork(src, dst)

    @torch.no_grad()
    def _forward(self, tokens, positions, rows=None, feature_index=None,
                 pdraft=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One forward.  ``rows`` (a prefill's lanes, -1 for a pad lane):
        paged, the lanes' table view and ring rows over the live cache;
        dense, a fresh ``len(rows)``-lane view scattered into the listed
        rows afterwards.  None: every row of the cache, in place.  With
        ``pdraft`` (a parallel-draft frame) the features returned are the
        last point's at every position, (n_rows, T, D).  With the dense
        rows split over "data" a full-cache forward runs the rank's rows
        and gathers the logits and features of every row."""
        dev = self.device
        cache, paged, ring_rows = self.cache, None, None
        tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.int64)
        data = self.state.data if rows is None else None
        if data is not None:
            mine = slice(self.state.row_lo,
                         self.state.row_lo + self.state.n_local)
            tokens, positions = tokens[mine], positions[mine]
            if pdraft is not None:
                pdraft = {k: v if k == "embed" else v[mine]
                          for k, v in pdraft.items()}
        if self.state.paged is not None:
            tab, lens = self.state.table_view(rows)
            paged = (torch.from_numpy(tab).to(dev),
                     torch.from_numpy(lens).to(dev))
            if rows is not None and self.has_ssm:
                ring_rows = torch.tensor(rows, dtype=torch.int64, device=dev)
        elif rows is not None:
            cache = self.state.prefill_view(len(rows))
        points = 1 if pdraft is not None else self.feature_points
        capture = points > 0
        mode = None if not capture else (
            "all" if feature_index is None else "at")
        logits, aux = M.forward(
            self.params, self.cfg, tokens,
            cache=cache, positions=positions, paged=paged,
            ring_rows=ring_rows, feature_mode=mode, feature_points=points,
            feature_index=(None if feature_index is None
                           else torch.from_numpy(feature_index).to(dev)),
            pdraft=pdraft, tp=self.tp)
        if cache is not self.cache:
            self.state.prefill_merge(cache, [r for r in rows if r >= 0])
        logits = DL.replicated(logits, data, 0)
        if pdraft is not None:
            return logits, DL.replicated(aux["features"][-1], data, 0)
        return logits, (DL.replicated(aux["features"], data, 1) if capture
                        else None)

    def step(self, tokens, pos
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Batched forward: tokens (n_rows, T) (numpy OR device — sampled
        tokens chain straight back in), pos (n_rows,) start positions.
        Returns DEVICE (logits (n_rows, T, V), features (K, n_rows, T, D)
        or None)."""
        assert tokens.shape[0] == self.n_rows
        T = tokens.shape[1]
        positions = (torch.from_numpy(np.asarray(pos, np.int32)).to(
            self.device)[:, None]
            + torch.arange(T, dtype=torch.int32, device=self.device)[None])
        self.n_calls += 1
        self.n_call_tokens += int(np.prod(tokens.shape))
        return self._forward(tokens, positions)

    def step_draft(self, tokens, pos, nreal, mask_embed: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Parallel-draft forward (DESIGN.md §7.12): per row, ``nreal[b]``
        real tokens followed by draft-slot columns (their ids are ignored:
        the slot embedding rides there) up to the padded width.  Slot keys
        are stored invisible (dense: position -1; paged: positions >= lens
        go to the trash page) and slot queries see only the row's real
        prefix, so one dispatch yields every slot's hidden state as a
        function of the committed stream alone.  Rows with nreal 0 are all
        slots: their writes are invisible and their lanes compute garbage
        the host ignores.  Returns DEVICE (logits (n_rows, T, V),
        last-point features (n_rows, T, D))."""
        assert tokens.shape[0] == self.n_rows
        positions, pdraft = M.pdraft_frame(
            torch.from_numpy(np.asarray(pos, np.int32)).to(self.device),
            torch.from_numpy(np.asarray(nreal, np.int32)),
            tokens.shape[1], mask_embed)
        self.n_calls += 1
        self.n_call_tokens += int(np.prod(tokens.shape))
        return self._forward(tokens, positions, pdraft=pdraft)

    def prefill_rows(self, parts: Sequence[Tuple[int, Sequence[int]]]
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Batched bucketed prefill: each ``(row, tokens)`` prompt into its
        fresh row with ONE forward at a fixed ``(prefill_lanes,
        ladder-width)`` shape.  Lane i of the returned device (logits,
        features) is ``parts[i]``'s — its features (K, lanes, D) at the
        prompt's last position; pad lanes and pad positions write the
        trash page, and lane i's ring writes land in row ``parts[i][0]``
        (pad lanes' are dropped)."""
        assert parts and len(parts) <= self.prefill_lanes
        G = self.prefill_lanes
        Tb = DL.prefill_bucket(max(len(t) for _, t in parts),
                               self.prefill_quantum)
        if Tb > self.max_len:
            raise RuntimeError(
                f"prefill bucket {Tb} overflows max_len={self.max_len}")
        toks = np.zeros((G, Tb), np.int32)
        last = np.zeros(G, np.int64)
        for i, (_row, t) in enumerate(parts):
            L = len(t)
            assert 1 <= L <= Tb
            toks[i, :L] = t
            if L < Tb:
                toks[i, L:] = t[-1]
            last[i] = L - 1
        positions = torch.arange(Tb, dtype=torch.int32,
                                 device=self.device).expand(G, Tb)
        out = self._forward(
            toks, positions,
            [row for row, _ in parts] + [-1] * (G - len(parts)),
            feature_index=last)
        for row, t in parts:
            self.state.row_pos[row] = len(t)
        self.n_calls += 1
        self.n_call_tokens += sum(len(t) for _, t in parts)
        self.prefill_shapes.add((G, Tb))
        return out

    def prefill_rows_at(self, parts: Sequence[Tuple[int, Sequence[int]]],
                        starts: Sequence[int]
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Bucketed SUFFIX prefill (prefix-cache admission, paged only):
        ``parts[i]`` ingests only the uncached tail of its prompt, from
        the page-aligned cached length ``starts[i]`` on; its row's pool
        stream already holds the bound prefix pages plus room for the
        suffix.  The rung is the suffix length's ladder bucket, whatever
        the prefix's length.  Queries sit at ``start + arange(Tb)`` and
        attend to the shared prefix pages through the table; each lane's
        rings load their start state from slot ``start % ring`` of the
        lane's row (the snapshot the hit restored), so the paged forward
        over the live cache needs no gathered view.  Pad overshoot past a
        row's length stays under the ladder quantum, as in
        ``prefill_rows``.  Returns device (logits, features at each
        suffix's last position) like ``prefill_rows``."""
        assert self.state.paged is not None, "suffix prefill needs page runs"
        assert parts and len(parts) <= self.prefill_lanes
        assert len(starts) == len(parts)
        G = self.prefill_lanes
        Tb = DL.prefill_bucket(max(len(t) for _, t in parts),
                               self.prefill_quantum)
        if max(starts) + Tb > self.max_len:
            raise RuntimeError(
                f"suffix bucket {Tb} overflows max_len={self.max_len}")
        toks = np.zeros((G, Tb), np.int32)
        last = np.zeros(G, np.int64)
        s0 = np.zeros(G, np.int32)
        for i, ((_row, t), start) in enumerate(zip(parts, starts)):
            L = len(t)
            assert 1 <= L <= Tb and start >= 0
            toks[i, :L] = t
            if L < Tb:
                toks[i, L:] = t[-1]
            last[i] = L - 1
            s0[i] = start
        positions = (torch.from_numpy(s0).to(self.device)[:, None]
                     + torch.arange(Tb, dtype=torch.int32,
                                    device=self.device)[None])
        out = self._forward(
            toks, positions,
            [row for row, _ in parts] + [-1] * (G - len(parts)),
            feature_index=last)
        for (row, t), start in zip(parts, starts):
            self.state.row_pos[row] = start + len(t)
        self.n_calls += 1
        self.n_call_tokens += sum(len(t) for _, t in parts)
        self.prefill_shapes.add((G, Tb))
        return out

    def pack_row(self, row: int, length: int) -> torch.Tensor:
        """The row's first ``length`` KV slots as (L, swap_dim) float32 rows
        on the device (dense rows sliced, paged rows gathered page by page
        through the table)."""
        return self.state.pack_row(row, length)

    def unpack_row(self, row: int, rows: torch.Tensor) -> None:
        """Restore a row from packed token rows (inverse of pack_row)."""
        self.state.unpack_row(row, rows)

    def snapshot(self, row: int, step: int,
                 fetch: Callable[[torch.Tensor], np.ndarray]
                 ) -> List[Dict[str, torch.Tensor]]:
        """Host copy of one row's recurrent state at stream length
        ``step`` (one {h, conv} dict per mamba slot), flattened on the
        device and brought over in ONE ``fetch``.  Preemption uses it as
        the rings' swap side-channel; ordinary rollback never needs it."""
        return self.state.snapshot_split(
            fetch(self.state.snapshot_flat(row, step)))

    def restore(self, row: int, step: int,
                snap: List[Dict[str, torch.Tensor]]) -> None:
        """Write a ``snapshot`` back into the rings at ``step``; a forward
        starting at position ``step`` then resumes from it."""
        self.state.restore(row, step, snap)


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
    # H-RAD input: the target's last K feature points at the newest
    # verified position, (K, 1, D) on the device; None without H-RAD
    feats_last: Optional[torch.Tensor] = None
    # SpecBranch carried state — distributions stay on the device
    mode: str = "draft"
    chunk: List[int] = dataclasses.field(default_factory=list)
    chunk_q: List[torch.Tensor] = dataclasses.field(default_factory=list)
    q_b: Optional[torch.Tensor] = None       # (V,) signal LOGITS, device
    q_b_conf: float = 0.0                    # host copy of max signal prob
    # this round's history-predictor decision; None with the predictor off
    pdec: Optional[Any] = None
    # prefix-cache publish candidate (set at admission, prefix cache on):
    # the page-aligned prefill-written prompt prefix this request may hand
    # to the cache at retire or preemption, and the rings' snapshot at
    # that length for SSM-bearing decoders
    pub_len: int = 0
    pub_snaps: Optional[Dict[str, Any]] = None

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
                 attn_backend: str = "dense",
                 prefix_cache: bool = False,
                 debug_check: bool = False,
                 mesh=None,
                 device=None):
        if attn_backend not in ("dense", "paged"):
            raise ValueError(f"unknown attn_backend {attn_backend!r}")
        check_decodes(target_cfg)       # NoDecodeError for encoder-only
        check_decodes(draft_cfg)
        if prefix_cache and attn_backend != "paged":
            raise ValueError(
                "prefix_cache=True requires attn_backend='paged': dense "
                "rows have no page runs to share — drop prefix_cache or "
                "switch to the paged backend")
        if mesh is not None:
            # the rank's device comes with the mesh
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device={device!r} but the mesh binds "
                                 f"{mesh.device}")
            device = mesh.device
        if ecfg.draft_mode not in ("sequential", "parallel"):
            raise ValueError(f"unknown draft_mode {ecfg.draft_mode!r}")
        if ecfg.draft_mode == "parallel":
            if draft_heads is None:
                raise ValueError(
                    "draft_mode='parallel' needs draft_heads "
                    "(models.init_draft_heads / training.pairs)")
            if any(m == "mamba" for m, _ in draft_cfg.pattern):
                raise ValueError(
                    "parallel drafting needs an attention-only draft model; "
                    f"pattern has mamba mixers: {draft_cfg.pattern}")
            need = max(ecfg.gamma, ecfg.gamma_branch)
            have = int(draft_heads["heads"].shape[0])
            if have < need:
                raise ValueError(
                    f"draft_heads has {have} positions; "
                    f"need >= max(gamma, gamma_branch) = {need}")
        self.device = resolve_device("cuda" if device is None else device)
        self.mesh = mesh
        # single-pass parallel drafting: the draft heads on the device, the
        # head stack in float32 once (the head product runs in f32, as the
        # reference's does, and a per-round conversion of a full-width
        # stack would move its bytes three times a round)
        self.draft_heads = (None if draft_heads is None else {
            k: v.to(self.device, torch.float32 if k == "heads" else v.dtype)
            for k, v in draft_heads.items()})
        self.dp, self.dcfg = draft_params, draft_cfg
        self.tp, self.tcfg = target_params, target_cfg
        self.ecfg = ecfg
        # the H-RAD MLP in float32 on the device; the target decoder then
        # captures the points it reads
        self.hrad_params = (None if hrad_params is None else
                            {k: v.to(device=self.device, dtype=torch.float32)
                             for k, v in hrad_params.items()})
        hrad_points = (ecfg.hrad_k_layers if ecfg.use_hrad
                       and self.hrad_params is not None else 0)
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
        # the history predictor (None for "off": every predictor branch of
        # the rounds is guarded on that).  Its gammas stay on the bucket
        # ladder <= ecfg.gamma, so _CH and the admission headroom hold.
        self.predictor = PRED.make_predictor(
            ecfg.spec_predictor, ecfg.gamma, ecfg.k_max, ecfg.epsilon)
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
        # checkpoint ring deep enough for one worst-case round of forward
        # progress (pending + chunk + branch continuation + bucket-ladder
        # and prefill-ladder padding) plus the rollback span back across
        # it, with slack
        ssm_ring = (4 * (ecfg.gamma + ecfg.gamma_branch)
                    + 2 * DL.bucket(ecfg.gamma + 2) + 16 + self._pq)
        if ecfg.draft_mode == "parallel":
            # parallel rounds re-ingest the committed tail after a reject
            # and stage slot columns past it: widen the ring (and the
            # windowed layers' slack) in this mode only, as the reference
            # does
            ssm_ring += 2 * DL.bucket(2 * (ecfg.gamma + ecfg.gamma_branch)
                                      + 4)
        paged = attn_backend == "paged"
        lanes = DL.bucket(max_batch)   # admission groups are <= max_batch
        self.tgt_dec = BatchedDecoder(target_params, target_cfg,
                                      n_rows=max_batch, max_len=ecfg.max_len,
                                      paged=self.pools["t"] if paged
                                      else None,
                                      device=self.device, ssm_ring=ssm_ring,
                                      prefill_lanes=lanes,
                                      prefill_quantum=self._pq,
                                      feature_points=hrad_points, mesh=mesh)
        self.dft_dec = BatchedDecoder(draft_params, draft_cfg,
                                      n_rows=max_batch
                                      * self.draft_rows_per_seq,
                                      max_len=ecfg.max_len,
                                      paged=self.pools["d"] if paged
                                      else None,
                                      device=self.device, ssm_ring=ssm_ring,
                                      prefill_lanes=lanes,
                                      prefill_quantum=self._pq, mesh=mesh)
        if mesh is not None:
            # the rank keeps its shards only, not the full trees it was
            # given (the H-RAD embedding and the draft's final norm read
            # them)
            self.tp, self.dp = self.tgt_dec.params, self.dft_dec.params
        if paged:
            # accounting COW (pool) -> physical COW, each in its own buffer
            self.pools["t"].cow_listeners.append(self.tgt_dec.copy_page)
            self.pools["d"].cow_listeners.append(self.dft_dec.copy_page)
        # the cross-request prefix cache: None (the default) keeps every
        # admission and retire path the cache-less one — no lookups, no
        # publishes, no extra snapshots or fetches
        self.prefix_cache: Optional[PrefixCache] = \
            PrefixCache(self.pools) if prefix_cache else None
        self.swap: Optional[PagedStore] = None
        if swap_pages > 0 and self.tgt_dec.swappable:
            self.swap = PagedStore(swap_pages, page_size,
                                   self.tgt_dec.swap_dim, device=self.device)
        self._swapped: Dict[int, dict] = {}      # rid -> swap metadata
        self._pending_admits: List[Tuple[_Seq, List[int], bool, int]] = []
        self.cost = CostModel(c=ecfg.c)
        self.clock = 0.0
        self.timeline: List[Tuple[str, int, int]] = []
        self.active: List[_Seq] = []
        self._admit_counter = 0
        # observability (obs.trace): NULL_RECORDER keeps every hook a
        # no-op; an enabled recorder sees only host values the loop
        # already holds, so tracing adds no device sync
        self.rec = NULL_RECORDER

    def set_recorder(self, rec) -> None:
        """Install a trace recorder.  An enabled one also taps the pools'
        reclaim and COW listeners (host accounting already in flight)."""
        self.rec = rec
        if rec.enabled:
            for which, pool in self.pools.items():
                pool.reclaim_listeners.append(
                    functools.partial(self._on_reclaim, which))
                pool.cow_listeners.append(
                    functools.partial(self._on_cow, which))

    def _on_cow(self, which: str, old: int, new: int) -> None:
        self.rec.cow(which)

    def _on_reclaim(self, which: str, reason: str, freed: int) -> None:
        self.rec.reclaim(which, reason, freed)

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
        """Host -> device admission traffic (prefill token frames, ring
        snapshot restores)."""
        self.xfer_bytes += int(nbytes)
        self.xfer_fetches += 1

    @property
    def host_transfer_bytes(self) -> int:
        """Bytes moved across the host boundary: packets, ring snapshots
        and their restores, plus prefill staging.  The attention half of
        a swap is device-to-device here (the swap store lives on the
        device) and does not count."""
        return self.xfer_bytes

    @property
    def host_fetches(self) -> int:
        return self.xfer_fetches

    # ------------------------------------------------------------ H-RAD
    def _embed_of(self, token: int) -> torch.Tensor:
        t = torch.tensor([token], device=self.device)
        if self.mesh is None:
            return H.token_embedding(self.tp, t)
        return M.token_rows(self.tp["embed"], t, self.tcfg.vocab_size,
                            self.tgt_dec.tp).float()

    def _hrad_signal(self, seq: _Seq, token: int) -> int:
        """s_t from the H-RAD MLP on the request's newest features and the
        embedding of ``token``: one 4-byte fetch; 1 without H-RAD."""
        if (not self.ecfg.use_hrad or self.hrad_params is None
                or seq.feats_last is None):
            return 1
        z = H.build_feature(seq.feats_last, self._embed_of(token),
                            self.ecfg.hrad_k_layers)
        s = int(self._fetch(H.predict(self.hrad_params, z))[0])
        seq.stats.hrad_signals.append(s)
        return s

    def _by_row(self, n_rows: int, entries
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(rids, ctrs) indexed by decoder row for the tick functions;
        rows not listed keep (0, 0) and compute garbage the host ignores."""
        rids = np.zeros(n_rows, np.int32)
        ctrs = np.zeros(n_rows, np.int32)
        for row, rid, ctr in entries:
            rids[row] = rid
            ctrs[row] = ctr
        return rids, ctrs

    # ---------------------------------------------------------- batched fwd
    def _batched(self, dec: BatchedDecoder,
                 parts: List[Tuple[int, List[int], int]]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
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
        out = dec.step(toks, pos)
        for row, t, p0 in parts:
            dec.row_pos[row] = p0 + len(t)
        return out

    def _ingest(self, dec: BatchedDecoder,
                triples: List[Tuple[_Stream, Any, List[int]]]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Batched ingest of per-stream token lists + pool accounting;
        returns the step's device (logits, features)."""
        for st, pool_key, toks in triples:
            self._pool_of(pool_key).extend(pool_key, len(toks))
        out = self._batched(dec, [(st.row, toks, st.ing)
                                  for st, _, toks in triples])
        for st, _, toks in triples:
            st.ing += len(toks)
        return out

    def _ingest_dev(self, dec: BatchedDecoder,
                    pairs: List[Tuple[_Stream, Any]],
                    tokens_by_row: torch.Tensor
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
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
        out = dec.step(DL.masked_token_column(tokens_by_row, mask), pos)
        for st, _ in pairs:
            st.ing += 1
            dec.row_pos[st.row] = st.ing
        return out

    # ----------------------------------------------------------- admission
    def _pool_keys(self, rid: int) -> Tuple[Any, Any]:
        return ("t", rid), ("d", rid)

    def admit_cost_pages(self, prompt_len: int) -> int:
        """Pages an admission takes from EACH pool."""
        return self.pools["t"].pages_for(prompt_len - 1)

    def _max_len_headroom(self) -> int:
        """Worst-case tokens a live row can hold beyond prompt + max_new:
        one round of overshoot plus a branch continuation plus bucket and
        prefill-ladder padding (and, in parallel draft mode, a frame of
        the re-ingested committed tail plus its slot columns)."""
        extra = 0
        if self.ecfg.draft_mode == "parallel":
            extra = DL.bucket(2 * (self.ecfg.gamma
                                   + self.ecfg.gamma_branch) + 4)
        return (2 * (DL.bucket(self.ecfg.gamma + 2)
                     + DL.bucket(self.ecfg.gamma_branch + 2) + 4)
                + self._pq + extra)

    def can_admit(self, prompt_len: int, max_new: int = 0) -> bool:
        if not self.tgt_dec.free_rows or len(self.active) >= self.max_batch:
            return False
        if len(self.dft_dec.free_rows) < self.draft_rows_per_seq:
            return False
        if (prompt_len + max_new + self._max_len_headroom()
                > self.ecfg.max_len):
            return False
        need = self.admit_cost_pages(prompt_len)
        # pages only prefix-cache runs hold count as free: reserve evicts
        # them on demand (and a hit shrinks the need by the pages it
        # pins, so the arithmetic holds hit or miss)
        pc = self.prefix_cache
        return all(need + self._round_slack_pages(which)
                   <= pool.free_pages
                   + (pc.reclaimable(which) if pc is not None else 0)
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
        pc = self.prefix_cache
        # prefix-cache lookup: the longest cached page-aligned prefix,
        # capped so that at least one suffix token is left to prefill
        # (the pending seed and the features need it).  A swap
        # re-admission unpacks into every page of its stream, which must
        # not be shared, so it skips the lookup.
        ent, hit = None, 0
        if pc is not None and (meta is None
                               or meta.get("swap_key") is None):
            need_snaps = self.tgt_dec.has_ssm or self.dft_dec.has_ssm
            found = pc.lookup(toks, L - 1, need_snaps=need_snaps)
            if found is not None:
                ent, hit = found
            if self.rec.enabled:
                self.rec.prefix("hit" if hit else "miss", rid=rid,
                                tokens=hit, prompt_len=len(toks),
                                t=self.clock)
        if hit:
            # zero-copy bind: the streams share the run's pages (the
            # branch fork's COW contract: an append onto a shared tail
            # page splits it first)
            self.pools["t"].fork_prefix(ent.stream, tk, hit)
            self.pools["d"].fork_prefix(ent.stream, dk, hit)
        else:
            self.pools["t"].open(tk)
            self.pools["d"].open(dk)
        try:
            for which, key in (("t", tk), ("d", dk)):
                while True:
                    try:
                        self.pools[which].extend(key, L - hit)
                        break
                    except PoolExhausted:
                        # realize the headroom can_admit counted: evict
                        # LRU runs (the run just bound is pinned) until
                        # the suffix fits
                        if pc is None or not pc.evict_lru():
                            raise
                        if self.rec.enabled:
                            self.rec.prefix("evict", t=self.clock)
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
        if hit and ent.snaps:
            # the SSM half of a hit: restore the rings' snapshot at the
            # shared length; the suffix forward from position ``hit``
            # resumes from it
            for which, dec, row in (("t", self.tgt_dec, t_row),
                                    ("d", self.dft_dec, d_row)):
                snap = ent.snaps.get(which)
                if snap is not None and dec.has_ssm:
                    dec.restore(row, hit, snap)
                    self._count_staged(_snap_bytes(snap))
        restored = False
        if meta is not None and meta.get("swap_key") is not None:
            self.tgt_dec.unpack_row(t_row, self.swap.get(meta["swap_key"]))
            if meta.get("ssm_snap") is not None:
                # the rings' swap side-channel: restore the checkpoint the
                # preemption took at the packed length
                self.tgt_dec.restore(t_row, L, meta["ssm_snap"])
                self._count_staged(_snap_bytes(meta["ssm_snap"]))
            self.swap.drop(meta["swap_key"])
            seq.feats_last = meta["feats_last"]
            restored = True
        seq.tgt = _Stream(row=t_row, ing=L, pending=[toks[-1]])
        seq.dft = _Stream(row=d_row, ing=L, pending=[toks[-1]])
        seq.mode, seq.chunk, seq.chunk_q, seq.q_b = "draft", [], [], None
        if self.predictor is not None:
            # keyed by rid: the history survives preemption (idempotent)
            self.predictor.start(rid)
        seq.admit_order = self._admit_counter
        self._admit_counter += 1
        self.active.append(seq)
        self._pending_admits.append((seq, toks[:-1], restored, hit))
        if self.rec.enabled:
            self.rec.request("admit", rid, prompt_len=len(toks),
                             restored=restored, t=self.clock)
            if restored:
                self.rec.request("swap_in", rid, t=self.clock)
        return seq

    def commit_admissions(self) -> None:
        """Run the deferred prefills of the current admission group: one
        forward per decoder per prefill-ladder rung (swap-restored target
        rows skip theirs).  Prompts bucket by their UNCACHED suffix: a
        prefix-cache hit rides a rung sized to its suffix
        (``prefill_rows_at``), a miss by its whole prompt.  With a priced
        prefill (``cost.t_prefill > 0``) the round's staged tokens and
        forwards go on the modeled clock as one "prefill" round."""
        pending, self._pending_admits = self._pending_admits, []
        if not pending:
            return
        buckets: Dict[int, List[Tuple[_Seq, List[int], bool, int]]] = {}
        for seq, toks, restored, hit in pending:
            width = DL.prefill_bucket(len(toks) - hit, self._pq)
            buckets.setdefault(width, []).append((seq, toks, restored, hit))
        lanes = self.tgt_dec.prefill_lanes
        n_fwd, staged_tokens = 0, 0

        def staged(width: int, used: int, tokens: int) -> None:
            # the (lanes, width) int32 token frame crosses host -> device
            # once per prefill forward
            nonlocal n_fwd, staged_tokens
            self._count_staged(lanes * width * 4)
            n_fwd += 1
            staged_tokens += lanes * width
            if self.rec.enabled:
                self.rec.prefill(width=width, lanes=lanes, used=used,
                                 tokens=tokens, t=self.clock)

        for width in sorted(buckets):
            grp = buckets[width]
            for i in range(0, len(grp), lanes):
                chunk = grp[i:i + lanes]
                tparts = [(seq.tgt.row, toks)
                          for seq, toks, restored, hit in chunk
                          if not restored and not hit]
                if tparts:
                    _, feats = self.tgt_dec.prefill_rows(tparts)
                    lane = 0
                    for seq, _toks, restored, hit in chunk:
                        if restored or hit:
                            continue
                        if feats is not None:
                            seq.feats_last = feats[:, lane:lane + 1]
                        seq.stats.target_calls += 1
                        lane += 1
                    staged(width, len(tparts),
                           sum(len(t) for _, t in tparts))
                hgrp = [(seq, toks, hit)
                        for seq, toks, restored, hit in chunk if hit]
                if hgrp:
                    # the suffix over the zero-copy-bound prefix pages
                    _, feats = self.tgt_dec.prefill_rows_at(
                        [(seq.tgt.row, toks[hit:]) for seq, toks, hit
                         in hgrp],
                        [hit for _, _, hit in hgrp])
                    for lane, (seq, _toks, _hit) in enumerate(hgrp):
                        if feats is not None:
                            seq.feats_last = feats[:, lane:lane + 1]
                        seq.stats.target_calls += 1
                    staged(width, len(hgrp),
                           sum(len(t) - h for _, t, h in hgrp))
                dparts = [(seq.dft.row, toks)
                          for seq, toks, _, hit in chunk if not hit]
                if dparts:
                    self.dft_dec.prefill_rows(dparts)
                    staged(width, len(dparts),
                           sum(len(t) for _, t in dparts))
                if hgrp:
                    self.dft_dec.prefill_rows_at(
                        [(seq.dft.row, toks[hit:]) for seq, toks, hit
                         in hgrp],
                        [hit for _, _, hit in hgrp])
                    staged(width, len(hgrp),
                           sum(len(t) - h for _, t, h in hgrp))
        if self.prefix_cache is not None:
            self._capture_publish_candidates(pending)
        # admission pricing: with t_prefill at its default 0 no round is
        # appended and the clock does not move
        if self.cost.t_prefill > 0.0 and n_fwd:
            rnd = ("prefill", staged_tokens, n_fwd)
            self.timeline.append(rnd)
            self.clock += self.cost.round_cost(rnd)
        if self.debug_check:
            self.pool.check()
            if self.prefix_cache is not None:
                self.prefix_cache.check()

    def _capture_publish_candidates(
            self, pending: List[Tuple[_Seq, List[int], bool, int]]) -> None:
        """Record what each fresh admission may hand to the prefix cache
        at retire or preemption: its page-aligned prefill-written prompt
        prefix and, for SSM-bearing decoders, the rings' snapshot at
        exactly that length.  The snapshot is taken now: the prefill has
        just written the checkpoints up to the prompt's length, and the
        decode loop's ring writes could lap that slot before retirement.
        Swap-restored re-admissions skip their prefill and keep the
        candidate of their first admission."""
        ps = self.pool.page_size
        for seq, toks, restored, _hit in pending:
            if restored:
                continue
            seq.pub_len = (len(toks) // ps) * ps
            seq.pub_snaps = None
            if not seq.pub_len:
                continue
            snaps: Dict[str, Any] = {}
            for which, dec, st in (("t", self.tgt_dec, seq.tgt),
                                   ("d", self.dft_dec, seq.dft)):
                if dec.has_ssm:
                    snaps[which] = dec.snapshot(st.row, seq.pub_len,
                                                self._fetch)
            seq.pub_snaps = snaps or None

    # ----------------------------------------------------------- preemption
    def preempt_youngest(self) -> _Seq:
        """Evict the most recently admitted request (FIFO-preserving) and
        release its rows and pages; its target KV is parked in the swap
        store when possible (a hybrid row's rings as one snapshot beside
        it), else recomputed at re-admission."""
        victim = max(self.active, key=lambda s: s.admit_order)
        self.active.remove(victim)
        meta = {"seq": victim, "swap_key": None, "ssm_snap": None,
                "feats_last": victim.feats_last}
        if self.swap is not None and victim.tgt.ing > 0:
            key = ("swap", victim.rid, victim.admit_order)
            try:
                self.swap.put(key, self.tgt_dec.pack_row(victim.tgt.row,
                                                         victim.tgt.ing))
                meta["swap_key"] = key
                if self.tgt_dec.has_ssm:
                    meta["ssm_snap"] = self.tgt_dec.snapshot(
                        victim.tgt.row, victim.tgt.ing, self._fetch)
            except PoolExhausted:
                pass
        self._publish_prefix(victim)
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
        if self.rec.enabled:
            self.rec.request("preempt", victim.rid, t=self.clock,
                             swapped=meta["swap_key"] is not None)
            if meta["swap_key"] is not None:
                self.rec.request("swap_out", victim.rid, t=self.clock)
        return victim

    def _make_room(self, seqs: List[_Seq],
                   fits: Callable[[List[_Seq]], bool]) -> List[_Seq]:
        """Preempt youngest-first until this round's worst case fits, but
        spill the prefix cache first: LRU runs no live request holds are
        cheaper to give up than a live request's rows."""
        preempted = []
        while not fits(seqs):
            if (self.prefix_cache is not None
                    and self.prefix_cache.evict_lru()):
                if self.rec.enabled:
                    self.rec.prefix("evict", t=self.clock)
                continue
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
            # the committed tail past the kept prefix: one token after a
            # sequential round; in parallel draft mode the draft stream
            # holds only the committed prefix, so its tail may be longer
            st.pending = [int(t) for t in full[st.ing:]]

    # ----------------------------------------------------- prefix publish
    def _publish_prefix(self, seq: _Seq) -> None:
        """Hand the request's prefill-written prompt prefix to the prefix
        cache: a refcount bump on its first ``pub_len`` tokens' pages in
        both pools, before the streams close at retire or preemption.
        Safe because the engines never truncate below committed - 1 >=
        ``pub_len`` and never write below a stream's length (an append
        onto the now-shared last page goes through the COW split)."""
        pc = self.prefix_cache
        if pc is None or seq.pub_len <= 0:
            return
        tk, dk = self._pool_keys(seq.rid)
        created = pc.publish(seq.prompt + seq.out, seq.pub_len,
                             {"t": tk, "d": dk}, snaps=seq.pub_snaps)
        if self.rec.enabled:
            self.rec.prefix("publish", rid=seq.rid, tokens=seq.pub_len,
                            created=created, t=self.clock)

    # -------------------------------------------------------------- retire
    def retire_done(self) -> List[Tuple[_Seq, GenResult]]:
        out = []
        for seq in [s for s in self.active if s.done]:
            self.active.remove(seq)
            self._publish_prefix(seq)
            tk, dk = self._pool_keys(seq.rid)
            self.pools["t"].close(tk, "retire")
            self.pools["d"].close(dk, "retire")
            self.tgt_dec.unbind_row(seq.tgt.row)
            self.dft_dec.unbind_row(seq.dft.row)
            self.tgt_dec.free_rows.append(seq.tgt.row)
            self.dft_dec.free_rows.append(seq.dft.row)
            if self.predictor is not None:
                self.predictor.drop(seq.rid)
            seq.stats.finish()
            if self.rec.enabled:
                self.rec.finish(seq.rid, emitted=seq.stats.emitted,
                                rollback_tokens=seq.stats.rollback_tokens,
                                pruned_tokens=seq.stats.pruned_tokens,
                                t=self.clock)
            out.append((seq, GenResult(seq.out[:seq.max_new], seq.stats,
                                       [])))
        if self.debug_check:
            self.pool.check()
        return out

    # --------------------------------------------------------------- round
    def step_round(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _decide(self, seqs: List[_Seq]
                ) -> Tuple[Dict[int, int], Dict[int, float]]:
        """One history-predictor decision per request per round: (gamma
        by rid, epsilon by rid), the static knobs without a predictor.
        SpS drafts and verifies its own gamma; SpecBranch's DRAFT-mode
        rows take gamma and epsilon for their stop rules, its BRANCH-mode
        rows the k cap (``_branch_k``) and epsilon (the posterior cut)."""
        pred = self.predictor
        for s in seqs:
            s.pdec = pred.decide(s.rid) if pred is not None else None
        g_of = {s.rid: (s.pdec.gamma if s.pdec is not None
                        else self.ecfg.gamma) for s in seqs}
        eps_of = {s.rid: (s.pdec.epsilon if s.pdec is not None
                          else self.ecfg.epsilon) for s in seqs}
        return g_of, eps_of

    def _finish_round(self, kind: str, draft_steps: int,
                      target_calls: int,
                      dispatches: Optional[int] = None) -> float:
        # parallel-draft rounds append the measured dispatch count
        rnd = (kind, draft_steps, target_calls) if dispatches is None \
            else (kind, draft_steps, target_calls, dispatches)
        self.timeline.append(rnd)
        self.clock += self.cost.round_cost(rnd)
        if self.debug_check:
            self.pool.check()
            if self.mesh is not None:
                self._check_ranks()
        return self.clock

    def _check_ranks(self) -> None:
        """Every rank of the mesh must have committed the same tokens:
        one all-reduce of a 23-bit hash of the active streams."""
        h = 0
        for s in sorted(self.active, key=lambda s: s.rid):
            h = zlib.crc32(np.asarray([s.rid, len(s.out)] + s.out,
                                      np.int64).tobytes(), h)
        if not self.mesh.agree(h & 0x7FFFFF):
            raise RuntimeError(
                f"mesh rank {self.mesh.rank} disagrees with its peers on "
                f"the committed tokens after round {len(self.timeline)}")


# ---------------------------------------------------------------------------
# batched SpS
# ---------------------------------------------------------------------------

class BatchedSpSEngine(BatchedEngineBase):
    """Vanilla speculative decoding, continuous-batched: gamma batched
    draft ticks then one batched target verification per round, all on
    the device.  Draft tokens chain from tick to tick as device tensors
    (the host never sees them mid-round); the round's only fetch is the
    (B, 3 + gamma) verdict packet.  In parallel draft mode the ticks are
    one draft forward plus ``draft_chunk`` (two dispatches a round, the
    verify included).  With the history predictor each request drafts and
    verifies its own g_i <= gamma: the round runs max(g_i) ticks with
    exhausted rows parked, and the verify takes per-row ``glens``."""
    name = "batched-sps"

    @torch.no_grad()
    def step_round(self) -> Dict[str, Any]:
        if self.ecfg.draft_mode == "parallel":
            return self._step_round_parallel()
        seqs = [s for s in self.active if not s.done]
        if not seqs:
            return {"committed": {}, "preempted": []}
        g_of, _ = self._decide(seqs)
        g = (self.ecfg.gamma if self.predictor is None
             else max(g_of.values()))
        wall0 = self.rec.now()

        def fits(ss):
            return (self.pools["d"].has_room(
                        [(("d", s.rid),
                          len(s.dft.pending) + g_of[s.rid] - 1)
                         for s in ss])
                    and self.pools["t"].has_room(
                        [(("t", s.rid), len(s.tgt.pending) + g_of[s.rid])
                         for s in ss]))

        preempted = self._make_room(seqs, fits)
        if not seqs:
            return {"committed": {}, "preempted": preempted}
        n_d = self.dft_dec.n_rows

        # ---- draft stage: batched pending ingest + gamma sampling ticks,
        # sampled ids chained on the device tick to tick
        lg, _ = self._ingest(
            self.dft_dec,
            [(s.dft, ("d", s.rid), list(s.dft.pending)) for s in seqs])
        # pending lengths differ (1 after a reject, 2 after an all-accept):
        # each row's logits are read at its REAL last token
        last = np.zeros(n_d, np.int32)
        for s in seqs:
            last[s.dft.row] = len(s.dft.pending) - 1
            s.dft.pending = []
        tok_ticks, q_ticks = [], []
        for i in range(g):
            # rows whose own g_i is exhausted park (rid/ctr 0: their lane
            # computes garbage that glens masks out of the verify)
            ticking = [s for s in seqs if g_of[s.rid] > i]
            rids, ctrs = self._by_row(
                n_d, [(s.dft.row, s.rid, s.ctr) for s in ticking])
            toks, qsl, _ = DL.tick_sample(lg, last, rids, ctrs, self._key,
                                          dtemp=self._dt, stemp=self._st)
            tok_ticks.append(toks)
            q_ticks.append(qsl)
            for s in ticking:
                s.ctr += 1
                s.stats.draft_tokens += 1
            if i < g - 1:
                pairs = [(s.dft, ("d", s.rid)) for s in ticking
                         if g_of[s.rid] > i + 1]
                if pairs:
                    lg, _ = self._ingest_dev(self.dft_dec, pairs, toks)
                    last[:] = 0
        # (g, n_d) tokens and (g, n_d, V) q slices, on the device
        return self._verify_commit(seqs, g_of, g, torch.stack(tok_ticks),
                                   torch.stack(q_ticks), wall0, preempted)

    @torch.no_grad()
    def _step_round_parallel(self) -> Dict[str, Any]:
        """Single-pass parallel drafting round (DESIGN.md §7.12): the
        gamma ticks collapse into ONE draft forward (each row's pending
        tokens followed by g masked slots) and ``DL.draft_chunk``, which
        reads every position's proposal off it.  Token i of a row is drawn
        at (rid, ctr0 + i), as by the ticks, and verification is the
        sequential round's.  Drafted tokens never enter the draft cache,
        so an accept re-feeds the chunk as next round's pending and a
        reject replays the committed tail (``_rollback_streams``)."""
        seqs = [s for s in self.active if not s.done]
        if not seqs:
            return {"committed": {}, "preempted": []}
        g_of, _ = self._decide(seqs)
        g = (self.ecfg.gamma if self.predictor is None
             else max(g_of.values()))
        wall0 = self.rec.now()

        def fits(ss):
            # the draft pool grows by the pending re-ingest only
            return (self.pools["d"].has_room(
                        [(("d", s.rid), len(s.dft.pending)) for s in ss])
                    and self.pools["t"].has_room(
                        [(("t", s.rid), len(s.tgt.pending) + g_of[s.rid])
                         for s in ss]))

        preempted = self._make_room(seqs, fits)
        if not seqs:
            return {"committed": {}, "preempted": preempted}
        n_d = self.dft_dec.n_rows
        calls0 = self.dft_dec.n_calls + self.tgt_dec.n_calls

        # ---- draft stage: ONE forward (pending ++ g slots a row), then
        # one fused chunk-sampling pass over its logits and features
        P = {s.rid: len(s.dft.pending) for s in seqs}
        T = DL.bucket(max(P.values()) + g)
        toks = np.zeros((n_d, T), np.int32)
        nreal = np.zeros(n_d, np.int32)
        last = np.zeros(n_d, np.int32)
        pos = np.minimum(self.dft_dec.row_pos,
                         self.dft_dec.max_len - T).astype(np.int32)
        for s in seqs:
            p_i = P[s.rid]
            self.pools["d"].extend(("d", s.rid), p_i)
            if s.dft.ing + T > self.dft_dec.max_len:
                raise RuntimeError(f"row {s.dft.row} overflows max_len")
            toks[s.dft.row, :p_i] = s.dft.pending
            nreal[s.dft.row] = p_i
            last[s.dft.row] = p_i - 1
            pos[s.dft.row] = s.dft.ing
            s.dft.pending = []
        lg, dfeats = self.dft_dec.step_draft(
            toks, pos, nreal, self.draft_heads["mask_embed"])
        for s in seqs:
            s.dft.ing += P[s.rid]
            self.dft_dec.row_pos[s.dft.row] = s.dft.ing
        rids, ctrs = self._by_row(
            n_d, [(s.dft.row, s.rid, s.ctr) for s in seqs])
        tok_stack, q_full, _ = DL.draft_chunk(
            lg, dfeats, self.dp["final_norm"], self.draft_heads["heads"],
            last, rids, ctrs, self._key, g=g, dtemp=self._dt,
            stemp=self._st, eps=self.dcfg.norm_eps,
            cap=self.dcfg.final_softcap)
        # rows with g_i < g drew garbage at ctr0 + g_i .. ctr0 + g - 1,
        # discarded unread (glens masks them out of the verify)
        for s in seqs:
            s.ctr += g_of[s.rid]
            s.stats.draft_tokens += g_of[s.rid]
        return self._verify_commit(seqs, g_of, g, tok_stack, q_full[:g],
                                   wall0, preempted, calls0=calls0)

    def _verify_commit(self, seqs: List[_Seq], g_of: Dict[int, int], g: int,
                       tok_stack: torch.Tensor, q_stack: torch.Tensor,
                       wall0: float, preempted: List[_Seq],
                       calls0: Optional[int] = None) -> Dict[str, Any]:
        """The verify stage of a round: ONE batched target call over
        pending ++ drafted tokens, the fused verdict and its packet (the
        round's only fetch), then commit or roll back each request.
        ``calls0`` (parallel draft mode) is the decoders' forward count at
        the round's start: the round then records its dispatches."""
        pred = self.predictor
        rec = self.rec
        rnd_idx = len(self.timeline)
        B = self.max_batch
        wall_draft = rec.now()
        pends = {s.rid: list(s.tgt.pending) for s in seqs}
        npend = np.zeros(B, np.int32)
        pend_arr = np.zeros((B, 2), np.int32)
        trows = np.full(B, self.tgt_dec.n_rows, np.int32)  # OOB = pad lane
        drows = np.zeros(B, np.int32)
        rid_l = np.zeros(B, np.int32)
        ctr_l = np.zeros(B, np.int32)
        glens = np.zeros(B, np.int32)      # pad lanes: 0 (garbage, unread)
        for i, s in enumerate(seqs):
            p = pends[s.rid]
            npend[i] = len(p)
            pend_arr[i, :len(p)] = p
            trows[i] = s.tgt.row
            drows[i] = s.dft.row
            rid_l[i] = s.rid
            ctr_l[i] = s.ctr
            glens[i] = g_of[s.rid]
        Tb = DL.bucket(int((npend + glens).max()) if pred is not None
                       else int(npend.max()) + g)
        toks_full = DL.compose_verify_tokens(
            pend_arr, npend, tok_stack, drows, trows,
            n_rows=self.tgt_dec.n_rows, Tb=Tb)
        # staging mirrors _ingest/_batched for a device-composed frame:
        # pool-extend by the REAL count, overflow-check the PADDED width
        pos = np.minimum(self.tgt_dec.row_pos,
                         self.tgt_dec.max_len - Tb).astype(np.int32)
        for s in seqs:
            self.pools["t"].extend(("t", s.rid),
                                   len(pends[s.rid]) + g_of[s.rid])
            if s.tgt.ing + Tb > self.tgt_dec.max_len:
                raise RuntimeError(f"row {s.tgt.row} overflows max_len")
            pos[s.tgt.row] = s.tgt.ing
        tlg, feats = self.tgt_dec.step(toks_full, pos)
        for s in seqs:
            s.tgt.ing += len(pends[s.rid]) + g_of[s.rid]
            self.tgt_dec.row_pos[s.tgt.row] = s.tgt.ing
        with DL.annotate("sps_verify", self.device):
            packet_dev = DL.sps_verify(
                tlg, q_stack, tok_stack, trows, drows, npend, rid_l, ctr_l,
                self._key, glens if pred is not None else None, g=g,
                ttemp=self._tt, dtemp=self._dt, kernel=self._use_kernel)
        for s in seqs:
            s.ctr += g_of[s.rid] + 1
        pk = self._fetch(packet_dev)       # the round's ONLY host fetch
        wall_verify = rec.now()
        ndisp = (None if calls0 is None else
                 self.dft_dec.n_calls + self.tgt_dec.n_calls - calls0)
        rnd = ("serial", g, 1) if ndisp is None else ("serial", g, 1, ndisp)
        now = self.clock + self.cost.round_cost(rnd)
        committed: Dict[int, int] = {}
        for i, s in enumerate(seqs):
            g_i = g_of[s.rid]
            n, nxt, all_acc = int(pk[i, 0]), int(pk[i, 1]), bool(pk[i, 2])
            dr = [int(x) for x in pk[i, 3:3 + g_i]]
            before = min(len(s.out), s.max_new)
            s.stats.target_calls += 1
            if feats is not None:
                s.feats_last = feats[:, s.tgt.row:s.tgt.row + 1,
                                     len(pends[s.rid]) + g_i - 1]
            s.tgt.pending = []
            pobs = s.pdec.obs() if s.pdec is not None else None
            if pred is not None:
                # from the packet already on the host: no extra sync
                pred.update(s.rid, all_acc, n / max(g_i, 1))
            if all_acc:
                self._commit(s, dr + [nxt], now)
                s.stats.run_extend(g_i + 1)
                s.tgt.pending = [nxt]
                # parallel mode: the chunk never entered the draft cache,
                # so it is re-fed whole
                s.dft.pending = (dr + [nxt] if ndisp is not None
                                 else [dr[-1], nxt])
                if rec.enabled:
                    rec.spec(rid=s.rid, round=rnd_idx, stage="sps",
                             committed=g_i + 1, accepted=g_i, drafted=g_i,
                             cause="accept", gamma=g_i, bonus=True,
                             dispatches=ndisp, pred=pobs, t=now)
            else:
                self._commit(s, dr[:n] + [nxt], now)
                s.stats.run_extend(n)
                s.stats.run_break()
                s.stats.rollback_tokens += g_i - n
                self._rollback_streams(s)
                if rec.enabled:
                    rec.spec(rid=s.rid, round=rnd_idx, stage="sps",
                             committed=n + 1, accepted=n, drafted=g_i,
                             rolled_back=g_i - n, cause="chunk-reject",
                             gamma=g_i, dispatches=ndisp, pred=pobs, t=now)
            committed[s.rid] = min(len(s.out), s.max_new) - before
        if rec.enabled:
            wall1 = rec.now()
            rec.span("draft", wall0, wall_draft, engine=self.name)
            rec.span("verify", wall_draft, wall_verify, engine=self.name,
                     batch=len(seqs))
            rec.span("commit", wall_verify, wall1, engine=self.name)
            rec.round(engine=self.name, index=rnd_idx, mode="serial",
                      draft_steps=g, target_calls=1, batch=len(seqs),
                      dispatches=ndisp, wall0=wall0, wall1=wall1,
                      t0=self.clock, t1=now)
        self._finish_round("serial", g, 1, ndisp)
        return {"committed": committed, "preempted": preempted}


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
        # the history predictor caps the hedge count; Eq. 7's adaptive k
        # applies under the cap (no decision: the k_max cap)
        cap = self.ecfg.k_max if seq.pdec is None \
            else min(self.ecfg.k_max, max(1, seq.pdec.k_cap))
        return min(cap, S.adaptive_k(seq.q_b_conf, cap))

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

    # --------------------------------------------------------------- round
    @torch.no_grad()
    def step_round(self) -> Dict[str, Any]:
        if self.ecfg.draft_mode == "parallel":
            return self._step_round_parallel()
        seqs = [s for s in self.active if not s.done]
        if not seqs:
            return {"committed": {}, "preempted": []}
        gb = self.ecfg.gamma_branch
        g_of, eps_of = self._decide(seqs)
        rec = self.rec
        wall0 = rec.now()
        rnd_idx = len(self.timeline)

        # has_room can't price not-yet-forked branch streams; count their
        # worst case (suffix pages + one COW tail copy each) by hand
        def fits(ss):
            d_ups, t_ups, d_extra = [], [], 0
            pd = self.pools["d"]
            for s in ss:
                if s.mode == "draft":
                    d_ups.append((("d", s.rid),
                                  len(s.dft.pending) + g_of[s.rid]))
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
        n_d = self.dft_dec.n_rows
        verify = self._dispatch_verify(branchers)
        bsets = verify[0]
        wall_disp = rec.now()

        # ---- PHASE A: all draft-model work, interleaved batched ticks ----
        # H-RAD's prior signal decides each DRAFT-mode request's stop rule
        # (1, the confidence threshold, without H-RAD parameters)
        sig: Dict[int, int] = {}
        for s in serial:
            e_tok = s.dft.pending[0] if s.dft.pending else s.tgt.pending[0]
            sig[s.rid] = self._hrad_signal(s, e_tok)
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
        lg, _ = self._ingest(self.dft_dec, triples)
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
                if sig[s.rid] == 0 or i >= g_of[s.rid]:
                    stop = True                  # deterministic: no ingest
                elif sig[s.rid] == 1 and conf < eps_of[s.rid]:
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
                    if rec.enabled:
                        rec.spec(rid=s.rid, round=rnd_idx, stage="draft",
                                 drafted=len(s.chunk) + 1,
                                 gamma=g_of[s.rid], eps_stop=over,
                                 hrad=(sig[s.rid] if self.ecfg.use_hrad
                                       else None),
                                 pred=(s.pdec.obs() if s.pdec is not None
                                       else None),
                                 t=self.clock)
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
                       if live[s.rid] and reads[s.rid] <= g_of[s.rid]
                       and not (sig[s.rid] == 0 and reads[s.rid] >= 1)]
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
                if live[s.rid] and sig[s.rid] != 0 and i < g_of[s.rid]:
                    ingest_pairs.append((s.dft, ("d", s.rid)))
            for s, j in brd:
                if j < gb:
                    for i, st in enumerate(bsets[s.rid].streams):
                        ingest_pairs.append((st, self._bkey(s.rid, i)))
            if ingest_pairs:
                lg, _ = self._ingest_dev(self.dft_dec, ingest_pairs,
                                         toks_dev)
                last[:] = 0
                ticks += 1
        return self._finish_branch_round(seqs, serial, branchers, verify,
                                         ticks, wall0, wall_disp, preempted)

    @torch.no_grad()
    def _step_round_parallel(self) -> Dict[str, Any]:
        """Single-pass parallel drafting round (DESIGN.md §7.12): the tick
        pipeline collapses into ONE shared draft forward — a serial row's
        frame is its pending tokens plus G masked slots, a branch lane's
        the parent's chunk and its candidate plus G slots (the chunk never
        entered the parent's cache) — and ``DL.draft_chunk`` reads every
        proposal off it.  Stop rules (H-RAD prior, epsilon, gamma) are
        applied on the fetched [token, conf] packet, which holds every
        position's confidence, so nothing is ingested optimistically.  The
        branch verification is the sequential round's.

        PRNG: serial chunk token i draws at (rid, ctr0 + i), as the ticks
        do; branch lane i draws its continuation as the contiguous block
        (rid, b_ctr0 + i*gb + j), the same coordinate set as the ticks'
        j*k + i interleaving."""
        seqs = [s for s in self.active if not s.done]
        if not seqs:
            return {"committed": {}, "preempted": []}
        gb = self.ecfg.gamma_branch
        G = max(self.ecfg.gamma, gb)
        g_of, eps_of = self._decide(seqs)
        rec = self.rec
        wall0 = rec.now()
        rnd_idx = len(self.timeline)

        def fits(ss):
            # serial draft streams grow by the pending re-ingest only;
            # branch lanes ingest chunk + candidate each (gb kept as a
            # margin)
            d_ups, t_ups, d_extra = [], [], 0
            pd = self.pools["d"]
            for s in ss:
                if s.mode == "draft":
                    d_ups.append((("d", s.rid), len(s.dft.pending)))
                else:
                    k = self._branch_k(s)
                    dlen = pd.length(("d", s.rid))
                    per = (pd.pages_for(dlen + 1 + len(s.chunk) + gb)
                           - pd.pages_for(dlen) + 1)
                    d_extra += k * per
                    t_ups.append((("t", s.rid),
                                  len(s.tgt.pending) + len(s.chunk)))
            return (pd.would_need(d_ups) + d_extra <= pd.free_pages
                    and self.pools["t"].has_room(t_ups))

        preempted = self._make_room(seqs, fits)

        serial = [s for s in seqs if s.mode == "draft"]
        branchers = [s for s in seqs if s.mode == "branch"]
        n_d = self.dft_dec.n_rows
        calls0 = self.dft_dec.n_calls + self.tgt_dec.n_calls
        verify = self._dispatch_verify(branchers)
        bsets = verify[0]
        wall_disp = rec.now()

        # ---- PHASE A: ONE shared draft forward for every row ----
        sig: Dict[int, int] = {}
        for s in serial:
            e_tok = s.dft.pending[-1] if s.dft.pending else s.tgt.pending[-1]
            sig[s.rid] = self._hrad_signal(s, e_tok)
            s.chunk, s.chunk_q = [], []
        reals: List[Tuple[_Stream, Any, List[int]]] = []
        for s in serial:
            reals.append((s.dft, ("d", s.rid), list(s.dft.pending)))
            s.dft.pending = []
        for s in branchers:
            bset = bsets[s.rid]
            for i, st in enumerate(bset.streams):
                # each lane ingests the chunk plus its own candidate, so
                # an adopted lane's ing is the committed count
                reals.append((st, self._bkey(s.rid, i),
                              list(s.chunk) + [int(bset.cands[i])]))
            s.stats.draft_tokens += 1      # candidate ingest
        T = DL.bucket(max(len(t) for _, _, t in reals) + G)
        toks = np.zeros((n_d, T), np.int32)
        nreal = np.zeros(n_d, np.int32)
        last = np.zeros(n_d, np.int32)
        pos = np.minimum(self.dft_dec.row_pos,
                         self.dft_dec.max_len - T).astype(np.int32)
        for st, key, t in reals:
            self._pool_of(key).extend(key, len(t))
            if st.ing + T > self.dft_dec.max_len:
                raise RuntimeError(f"row {st.row} overflows max_len")
            toks[st.row, :len(t)] = t
            nreal[st.row] = len(t)
            last[st.row] = len(t) - 1
            pos[st.row] = st.ing
        lg, dfeats = self.dft_dec.step_draft(
            toks, pos, nreal, self.draft_heads["mask_embed"])
        for st, _, t in reals:
            st.ing += len(t)
            self.dft_dec.row_pos[st.row] = st.ing
        entries = [(s.dft.row, s.rid, s.ctr) for s in serial]
        for s in branchers:
            for i, st in enumerate(bsets[s.rid].streams):
                entries.append((st.row, s.rid, s.ctr + i * gb))
        rids, ctrs = self._by_row(n_d, entries)
        _, q_full, packed = DL.draft_chunk(
            lg, dfeats, self.dp["final_norm"], self.draft_heads["heads"],
            last, rids, ctrs, self._key, g=G, dtemp=self._dt,
            stemp=self._st, eps=self.dcfg.norm_eps,
            cap=self.dcfg.final_softcap)
        pkt = self._fetch(packed)          # (n_d, G+1, 2) [token, conf]

        # serial rows: the stop point straight from the packet
        for s in serial:
            row = s.dft.row
            g_i = g_of[s.rid]
            if sig[s.rid] == 0:
                stop_j = 0
            elif sig[s.rid] == 1:
                stop_j = next((j for j in range(g_i)
                               if float(pkt[row, j, 1]) < eps_of[s.rid]),
                              g_i)
            else:
                stop_j = g_i
            s.chunk = [int(pkt[row, j, 0]) for j in range(stop_j)]
            s.chunk_q = [q_full[j, row] for j in range(stop_j)]
            s.q_b = q_full[stop_j, row]
            s.q_b_conf = float(pkt[row, stop_j, 1])
            s.ctr += stop_j
            s.stats.draft_tokens += stop_j + 1
            if rec.enabled:
                rec.spec(rid=s.rid, round=rnd_idx, stage="draft",
                         drafted=stop_j + 1, gamma=g_i,
                         eps_stop=(sig[s.rid] == 1 and stop_j < g_i),
                         hrad=(sig[s.rid] if self.ecfg.use_hrad else None),
                         pred=(s.pdec.obs() if s.pdec is not None
                               else None),
                         t=self.clock)
        # branch lanes: continuation tokens and confidences, same packet
        for s in branchers:
            bset = bsets[s.rid]
            for i, st in enumerate(bset.streams):
                row = st.row
                bset.conts[i] = [int(pkt[row, j, 0]) for j in range(gb)]
                bset.cont_q[i] = [q_full[j, row] for j in range(gb)]
                bset.confs[i] = [float(pkt[row, j, 1]) for j in range(gb)]
                bset.final_sig[i] = q_full[gb, row]
                bset.final_conf[i] = float(pkt[row, gb, 1])
            s.stats.draft_tokens += gb
            s.ctr += len(bset.streams) * gb
        return self._finish_branch_round(seqs, serial, branchers, verify,
                                         1, wall0, wall_disp, preempted,
                                         calls0=calls0)

    def _dispatch_verify(self, branchers: List[_Seq]):
        """Dispatch the BRANCH-mode requests' verification before the
        draft work of the round: draw each one's branch candidates (one
        small fetch), fork its branch lanes (zero-copy page sharing), run
        the target over pending ++ chunk and the fused chain + branch
        verdict, whose packet is fetched after the draft phase (the chunk
        under verification was drafted last round, so on the card the
        verdict overlaps the drafting).  Returns (branch sets by rid, the
        verdict packet on the device, the target's features, pending
        tokens by rid)."""
        bsets: Dict[int, _BranchSet] = {}
        if not branchers:
            return bsets, None, None, {}
        K, CH = self._K, self._CH
        B = self.max_batch
        V = self.dcfg.vocab_size
        dev = self.device
        ks: Dict[int, int] = {}
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
        tlg, tfeats = self._ingest(
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
        with DL.annotate("branch_verify", self.device):
            packet_dev = DL.branch_verify(
                tlg, trows, npend_l, gch_l, torch.stack(cq_rows), ct,
                cands, ks_l, qb_stack, rid_l, ctr_v, self._key, CH=CH,
                K=K, ttemp=self._tt, dtemp=self._dt, stemp=self._st,
                kernel=self._use_kernel)
        for s in branchers:
            s.ctr += self._W
        return bsets, packet_dev, tfeats, pends

    def _finish_branch_round(self, seqs, serial, branchers, verify,
                             ticks: int, wall0: float, wall_disp: float,
                             preempted: List[_Seq],
                             calls0: Optional[int] = None
                             ) -> Dict[str, Any]:
        """PHASE B of a round: fetch the verdict packet and commit each
        BRANCH-mode request; DRAFT-mode requests move to BRANCH.
        ``calls0`` (parallel draft mode) records the round's dispatches."""
        bsets, packet_dev, tfeats, pends = verify
        rec = self.rec
        rnd_idx = len(self.timeline)
        wall_draft1 = rec.now()
        committed: Dict[int, int] = {}
        n_target = 1 if branchers else 0
        kind = "parallel" if (branchers and self.ecfg.use_branch) \
            else "serial"
        ndisp = (None if calls0 is None else
                 self.dft_dec.n_calls + self.tgt_dec.n_calls - calls0)
        rnd = ((kind, ticks, n_target) if ndisp is None
               else (kind, ticks, n_target, ndisp))
        now = self.clock + self.cost.round_cost(rnd)
        wall_vfetch = wall_draft1
        if branchers:
            pk = self._fetch(packet_dev)
            wall_vfetch = rec.now()
            for i, s in enumerate(branchers):
                s.tgt.pending = []
                before = min(len(s.out), s.max_new)
                self._branch_verdict(s, bsets[s.rid], pk[i], tfeats,
                                     len(pends[s.rid]), now)
                committed[s.rid] = min(len(s.out), s.max_new) - before
        for s in serial:
            s.mode = "branch"
        if rec.enabled:
            wall1 = rec.now()
            rec.span("draft", wall_disp, wall_draft1, engine=self.name,
                     ticks=ticks)
            if branchers:
                # dispatched before the draft phase and fetched after it:
                # the verify span overlapping the draft span is the
                # hidden verification
                rec.span("verify", wall0, wall_vfetch, engine=self.name,
                         batch=len(branchers))
                rec.span("commit", wall_vfetch, wall1, engine=self.name)
            rec.round(engine=self.name, index=rnd_idx, mode=kind,
                      draft_steps=ticks, target_calls=n_target,
                      batch=len(seqs), dispatches=ndisp, wall0=wall0,
                      wall1=wall1, t0=self.clock, t1=now)
        self._finish_round(kind, ticks, n_target, ndisp)
        return {"committed": committed, "preempted": preempted}

    # --------------------------------------------------- verdict (packet)
    def _branch_verdict(self, s: _Seq, bset: _BranchSet, pk_row,
                        feats: Optional[torch.Tensor], npend: int,
                        now: float) -> None:
        """Commit/rollback bookkeeping from the (5,) int32 verdict packet
        [n_acc, chain_next, all_acc, accepted_branch, branch_token]."""
        gb = self.ecfg.gamma_branch
        gchunk = len(s.chunk)
        n_acc, chain_next, all_acc, acc_b, tok_b = (int(x) for x in pk_row)
        s.stats.target_calls += 1
        if feats is not None:
            s.feats_last = feats[:, s.tgt.row:s.tgt.row + 1,
                                 npend + gchunk - 1]
        pred = self.predictor
        pobs = s.pdec.obs() if s.pdec is not None else None
        eps_i = s.pdec.epsilon if s.pdec is not None else self.ecfg.epsilon
        if pred is not None:
            # both outcomes from the verdict packet already on the host
            if gchunk > 0:
                pred.update(s.rid, bool(all_acc), n_acc / gchunk)
            if all_acc:
                pred.update(s.rid, acc_b >= 0)

        if not all_acc:
            # mid-chunk rejection: every branch is doomed (Fig. 1a)
            self._commit(s, s.chunk[:n_acc] + [chain_next], now)
            s.stats.run_extend(n_acc)
            s.stats.run_break()
            s.stats.rollback_tokens += (gchunk - n_acc) + gb
            self._free_branches(s, bset, "rollback")
            self._rollback_streams(s)
            if self.rec.enabled:
                self.rec.spec(rid=s.rid, round=len(self.timeline),
                              stage="branch", committed=n_acc + 1,
                              accepted=n_acc,
                              rolled_back=(gchunk - n_acc) + gb,
                              cause="chunk-reject", gamma=gchunk,
                              k=len(bset.streams), pred=pobs, t=now)
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
            if self.rec.enabled:
                self.rec.spec(rid=s.rid, round=len(self.timeline),
                              stage="branch", committed=gchunk + 1,
                              accepted=gchunk, rolled_back=gb,
                              cause="branch-miss", gamma=gchunk,
                              k=len(bset.streams), pred=pobs, t=now)
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

        # posterior H-RAD on THIS verification's features (Sec. 5.2)
        sgn = self._hrad_signal(s, tok_b)
        cont, q_i, confs = bset.conts[i], bset.cont_q[i], bset.confs[i]
        pruned = 0
        if sgn == 2:
            s.chunk, s.chunk_q = list(cont), list(q_i)
            s.q_b = bset.final_sig[i]
            s.q_b_conf = bset.final_conf[i]
        elif sgn == 0:
            # prune the whole continuation; branch at its first token
            s.chunk, s.chunk_q = [], []
            s.q_b = q_i[0]
            s.q_b_conf = confs[0]
            s.stats.pruned_tokens += gb
            pruned = gb
            self._prune_draft(s, s.committed)
        else:
            # cut at the continuation's first low-confidence token
            j = next((jj for jj in range(gb) if confs[jj] < eps_i), gb)
            if j == gb:
                s.chunk, s.chunk_q = list(cont), list(q_i)
                s.q_b = bset.final_sig[i]
                s.q_b_conf = bset.final_conf[i]
            else:
                s.chunk, s.chunk_q = list(cont[:j]), list(q_i[:j])
                s.q_b = q_i[j]
                s.q_b_conf = confs[j]
                s.stats.pruned_tokens += gb - j
                pruned = gb - j
                self._prune_draft(s, s.committed + j)
        s.mode = "branch"
        if self.rec.enabled:
            self.rec.spec(rid=s.rid, round=len(self.timeline),
                          stage="branch", committed=gchunk + 1,
                          accepted=gchunk + 1, pruned=pruned,
                          cause="branch-adopt", gamma=gchunk,
                          k=len(bset.streams),
                          hrad=sgn if self.ecfg.use_hrad else None,
                          pred=pobs, t=now)

    def _prune_draft(self, s: _Seq, keep: int) -> None:
        """H-RAD pre-verify pruning: positional reset of the draft
        stream."""
        if s.dft.ing > keep:
            self.pools["d"].truncate(("d", s.rid), keep, "prune")
            s.dft.ing = keep
        self.dft_dec.row_pos[s.dft.row] = s.dft.ing
        s.dft.pending = []

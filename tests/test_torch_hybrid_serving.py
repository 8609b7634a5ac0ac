"""Batched SpecBranch on the SSM-bearing pairs: the port against the
reference engine on the reference's ``hybrid_pair`` weights (falcon-shaped:
Mamba only; jamba-shaped: Mamba + attention + MoE), paged backend, 3
requests x 16 new tokens at max_batch 2 — greedy, temperature 1, and a
jamba-shaped pool small enough to preempt and swap (attention half
through the paged store, rings through one snapshot).  Streams, GenStats,
pool stats, timelines and the host-transfer counters must be equal (the
port's swap store lives on the device, so the reference's counters carry
exactly the attention half of each swap on top of the port's); greedy
streams must equal the port's own greedy decode."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import ZipfMarkov
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.serving import BatchedSpecBranchEngine as JEngine
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.training import pairs as JP
from repro_torch.launch import serve as SV
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engines import EngineConfig
from repro_torch.serving import (BatchedSpecBranchEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.serving.decode_state import DecodeState
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.training.checkpoint import from_numpy_params

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores (eight threads in each of six
# workers slow every small op here many times over).
torch.set_num_threads(1)

N_REQ, N_NEW = 3, 16
PREEMPT = dict(page_size=4, pool_pages=110, swap_pages=64)
CASES = {
    "falcon-greedy": ("falcon-shaped", 0.0, {}),
    "falcon-temp1": ("falcon-shaped", 1.0, {}),
    "jamba-greedy": ("jamba-shaped", 0.0, {}),
    "jamba-temp1": ("jamba-shaped", 1.0, {}),
    "jamba-preempt-swap": ("jamba-shaped", 0.0, PREEMPT),
}


def _port(jpair):
    dp, dcfg, tp, tcfg = jpair
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tdc = ModelConfig(**dataclasses.asdict(dcfg))
    ttc = ModelConfig(**dataclasses.asdict(tcfg))
    return (from_numpy_params(to_np(dp), tdc, "cpu"), tdc,
            from_numpy_params(to_np(tp), ttc, "cpu"), ttc)


@pytest.fixture(scope="module")
def pairs():
    zm = ZipfMarkov(vocab=JP.VOCAB, seed=7)
    prompts = [list(map(int, p)) for p in zm.prompts(N_REQ, 16, seed=3)]
    out = {}
    for kind in JP.HYBRID_KINDS:
        jpair = JP.hybrid_pair(kind)
        out[kind] = (jpair, _port(jpair))
    return out, prompts


def _stats(r):
    s = r.stats
    return (s.emitted, s.draft_tokens, s.target_calls, s.rollback_tokens,
            s.pruned_tokens, list(s.accept_runs))


@pytest.fixture(scope="module")
def runs(pairs):
    """Each case served by both engines once (module-scoped: the reference
    engine compiles its jits per engine)."""
    by_kind, prompts = pairs
    out = {}
    for name, (kind, temp, eng_kw) in CASES.items():
        jpair, tpair = by_kind[kind]
        kw = dict(gamma=4, c=10.0, temperature=temp, max_len=512)
        je = JEngine(*jpair, JEngineConfig(**kw), attn_backend="paged",
                     debug_check=True, max_batch=2, **eng_kw)
        js = JScheduler(je)
        jres = js.run([JRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                       for i, p in enumerate(prompts)])
        te = BatchedSpecBranchEngine(*tpair, EngineConfig(**kw),
                                     device="cpu", debug_check=True,
                                     max_batch=2, attn_backend="paged",
                                     **eng_kw)
        ts = ContinuousBatchScheduler(te)
        tres = ts.run([ServeRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                       for i, p in enumerate(prompts)])
        out[name] = (je, js, jres, te, ts, tres)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_streams_and_stats_equal_reference(runs, name):
    je, js, jres, te, ts, tres = runs[name]
    assert sorted(tres) == sorted(jres) == list(range(N_REQ))
    for rid in range(N_REQ):
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert len(tres[rid].tokens) == N_NEW
        assert _stats(tres[rid]) == _stats(jres[rid]), rid


@pytest.mark.parametrize("name", list(CASES))
def test_pool_rounds_and_host_counters_equal_reference(runs, name):
    je, js, jres, te, ts, tres = runs[name]
    assert te.pool.stats.as_dict() == je.pool.stats.as_dict()
    assert te.timeline == je.timeline
    jr, tr = js.report(), ts.report()
    for key in ("rounds", "preemptions", "total_tokens", "total_cost",
                "ttft_p50", "itl_p50"):
        assert tr[key] == jr[key], key
    assert te.pool.pages_in_use == 0
    te.pool.check()
    # the reference's target-decoder tally holds, per swap, the packed
    # attention rows and the ring snapshot; its engine tally the readback
    # of those rows and the snapshot's restore.  The port counts the
    # snapshots and restores alike but keeps the attention half of a swap
    # on the device: one pack and one readback per swap fewer.
    n_swaps, snap_bytes = _swaps(je, te)
    pack_bytes = je.tgt_dec.xfer_bytes - snap_bytes
    assert je.host_fetches == te.host_fetches + 2 * n_swaps
    assert je.host_transfer_bytes == te.host_transfer_bytes + 2 * pack_bytes


def _swaps(je, te):
    """(swaps, bytes of their ring snapshots): each snapshot holds the
    target's mamba slots at (stack, E, N) + (stack, Cv-1, E) float32."""
    n = je.tgt_dec.xfer_fetches // 2          # a pack and a snapshot each
    cfg = te.tcfg
    per = sum(c["h_ring"].shape[0] * (cfg.d_inner * cfg.ssm_state
                                      + (cfg.ssm_conv - 1) * cfg.d_inner)
              * 4 for c in TM.iter_slots(te.tgt_dec.cache) if "h_ring" in c)
    return n, n * per


def test_preemption_swaps_attention_and_restores_rings(runs):
    je, js, jres, te, ts, tres = runs["jamba-preempt-swap"]
    assert ts.report()["preemptions"] > 0
    assert te.swap is not None and te.swap.pool.pages_in_use == 0
    assert te.pool.stats.reclaimed_preempt_pages > 0
    assert _swaps(je, te)[0] > 0          # swapped out and back in
    plain = runs["jamba-greedy"][5]
    assert [tres[i].tokens for i in range(N_REQ)] == \
        [plain[i].tokens for i in range(N_REQ)]


@pytest.mark.parametrize("name", ["falcon-greedy", "jamba-greedy",
                                  "jamba-preempt-swap"])
def test_greedy_streams_equal_port_greedy_decode(pairs, runs, name):
    by_kind, prompts = pairs
    tpair = by_kind[CASES[name][0]][1]
    ref = TM.greedy_reference(tpair[2], tpair[3], prompts, N_NEW)
    tres = runs[name][5]
    assert [tres[i].tokens for i in range(N_REQ)] == ref


@pytest.mark.parametrize("kind", ["falcon-shaped", "jamba-shaped"])
def test_swap_layout_matches_reference(pairs, kind):
    """falcon-shaped has no attention leaves: swap_dim 0, not swappable,
    its prefix is recomputed on preemption; jamba-shaped swaps its
    attention half."""
    by_kind, _ = pairs
    jpair, tpair = by_kind[kind]
    ecfg = dict(gamma=4, c=10.0, max_len=256)
    je = JEngine(*jpair, JEngineConfig(**ecfg), attn_backend="paged",
                 max_batch=2, **PREEMPT)
    te = BatchedSpecBranchEngine(*tpair, EngineConfig(**ecfg), device="cpu",
                                 max_batch=2, attn_backend="paged",
                                 **PREEMPT)
    for jd, td in ((je.tgt_dec, te.tgt_dec), (je.dft_dec, te.dft_dec)):
        assert (td.swap_dim, td.swappable, td.has_ssm) == \
            (jd.state.swap_dim, jd.state.swappable, jd.state.has_ssm)
        assert td.state.ssm.ring == jd.state.ssm.ring
    assert (te.swap is None) == (je.swap is None) == (kind == "falcon-shaped")


def test_ring_snapshot_restore_and_fork_roundtrip(pairs):
    tcfg = pairs[0]["jamba-shaped"][1][3]
    ds = DecodeState(tcfg, n_rows=3, max_len=64, paged=PagedKVPool(8, 4),
                     device="cpu", ssm_ring=6)
    rings = ds.ssm.slots(ds.cache)
    g = torch.Generator().manual_seed(0)
    for c in rings:
        for a in c.values():
            a.copy_(torch.randn(a.shape, generator=g))
    buf = ds.snapshot_flat(1, 9).numpy()
    snap = ds.snapshot_split(buf)
    ds.fork(1, 2)
    for c in rings:
        for a in c.values():
            assert torch.equal(a[:, 2], a[:, 1])
            a[:, 0].zero_()
    ds.restore(0, 15, snap)          # 15 % 6 == 9 % 6: the same slot
    for c in rings:
        for a in c.values():
            assert torch.equal(a[:, 0, 3], a[:, 1, 3])
    with pytest.raises(ValueError, match="checkpoint ring"):
        DecodeState(tcfg, n_rows=3, max_len=64, paged=PagedKVPool(8, 4),
                    device="cpu")


def test_serve_cli_serves_the_hybrid_pairs(tmp_path, capsys):
    for mode in ("batched", "sequential"):
        out = tmp_path / f"{mode}.json"
        SV.main(["--device", "cpu", "--pair", "jamba-shaped", "--mode",
                 mode, "--requests", "2", "--new-tokens", "4", "--json",
                 str(out)])
        rep = __import__("json").loads(out.read_text())
        assert rep["total_tokens"] == 8
    assert "on jamba-shaped pair" in capsys.readouterr().out
    for pair in ("falcon-shaped", "falcon-mamba-7b"):
        with pytest.raises(SystemExit, match="attention-only draft"):
            SV.main(["--device", "cpu", "--pair", pair, "--draft-mode",
                     "parallel"])

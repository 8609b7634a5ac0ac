"""Helpers shared by the port's parity tests (``test_torch_*.py``).

``synchronous_reference_ticks`` steadies the reference's batched rounds.
``repro.serving.batched_engine`` dispatches each draft tick as
``DL.tick_sample(lg, jnp.asarray(last), ...)`` and then, after the next
ingest, clears ``last[:] = 0``.  JAX dispatches the tick asynchronously,
and on the CPU ``jnp.asarray`` of a numpy array may alias its buffer, so
the clear can reach the tick before it has read ``last``: a row with two
pending tokens then reads its logits at column 0, and the reference's
draft proposals (its GenStats, pool counters and, at temperature 1, its
streams) change with the machine's load.  While the context is active,
every reference tick blocks on its outputs before it returns, so the
aliased ``last`` has been read before the engine clears it.  Nothing in
the reference package is edited: the wrapper replaces the module
attribute the engines look up (``DL.tick_sample``) and restores it on
exit.  The port copies such inputs and has no such race.

Use it through a module-scoped autouse fixture, so that it is active
while the module's reference serves run::

    @pytest.fixture(scope="module", autouse=True)
    def _steady_reference():
        with synchronous_reference_ticks():
            yield
"""
import contextlib
import dataclasses

import jax
import numpy as np

from repro.serving import device_loop as JDL
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import from_numpy_params


@contextlib.contextmanager
def synchronous_reference_ticks():
    """Make the reference's ``device_loop.tick_sample`` synchronous."""
    orig = JDL.tick_sample

    def tick_sample(*args, **kwargs):
        return jax.block_until_ready(orig(*args, **kwargs))

    JDL.tick_sample = tick_sample
    try:
        yield
    finally:
        JDL.tick_sample = orig


def port_pair(jpair, device="cpu"):
    """The reference's (draft_params, draft_cfg, target_params,
    target_cfg) as the port's: the same weights, as tensors on
    ``device``."""
    dp, dcfg, tp, tcfg = jpair
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tdc = ModelConfig(**dataclasses.asdict(dcfg))
    ttc = ModelConfig(**dataclasses.asdict(tcfg))
    return (from_numpy_params(to_np(dp), tdc, device), tdc,
            from_numpy_params(to_np(tp), ttc, device), ttc)


def gen_stats(r):
    """The GenStats fields the parity tests compare."""
    s = r.stats
    return (s.emitted, s.draft_tokens, s.target_calls, s.rollback_tokens,
            s.pruned_tokens, list(s.accept_runs))


def stub_head_trainer(monkeypatch, calls):
    """Replace ``training.pairs.train_draft_heads`` (200 steps when a
    parallel-draft serve finds no trained heads) by one that records its
    call (K, steps, seed) and returns untrained heads."""
    import torch
    from repro_torch.models import model as TM
    from repro_torch.training import pairs as TP

    def stub(dp, dcfg, data, K, tc, seed=0, verbose=True, device="cpu"):
        calls.append((K, tc.steps, seed))
        gen = torch.Generator().manual_seed(seed)
        return TM.init_draft_heads(dcfg, K, gen, device), {}
    monkeypatch.setattr(TP, "train_draft_heads", stub)

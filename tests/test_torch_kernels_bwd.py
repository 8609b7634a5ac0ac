"""The plain backwards of the port's two training kernels
(``kernels.ref.flash_attention_bwd_ref`` and ``ssm_scan_bwd_ref``, the
versions the CUDA backward kernels are held against on the card), on the
CPU, against

* ``torch.autograd.grad`` of the plain forwards (``flash_attention_ref``,
  ``ssm_scan_ref``), and
* ``jax.vjp`` of the reference's functions (``repro.models.layers.attend``,
  the function its TPU flash kernel computes, and
  ``repro.kernels.ref.ssm_scan_ref``),

on the same numpy inputs, float32: rtol 1e-4, atol 1e-5; the scan's
plain backward starts from the plain forward's chunk checkpoints at
several chunk lengths, as the kernel does from the forward's.  The attention
cases cover the forward kernel's whole contract: GQA, causal and
bidirectional, a window with a softcap, and the parallel-draft frame
(slot queries clamped below their positions, slot keys at -1).  The CPU
routes of ``kernels.ops`` differentiate through the plain versions, and
the forward-only routes serve tensors that need no gradient.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.models import layers as JL
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5

# (B, T, S, H, KV, hd, causal, window, cap, frame)
ATTN_CASES = {
    "causal-gqa": (2, 7, 20, 4, 2, 16, True, 0, None, False),
    "window-cap": (2, 9, 24, 4, 2, 16, True, 6, 30.0, False),
    "bidirectional": (2, 11, 11, 4, 4, 16, False, 0, None, False),
    "draft-frame": (2, 14, 14, 4, 2, 16, True, 0, None, True),
}


def _attn_inputs(case, seed=0):
    B, T, S, H, KV, hd, causal, window, cap, frame = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = f(B, T, H, hd), f(B, S, KV, hd), f(B, S, KV, hd), \
        f(B, T, H, hd)
    q_pos = np.broadcast_to(np.arange(S - T, S, dtype=np.int32), (B, T))
    k_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    q_ctx = None
    if frame:
        # the last 4 columns are draft slots: keys invisible, queries
        # clamped to the last real position
        k_pos[:, -4:] = -1
        q_ctx = q_pos.copy()
        q_ctx[:, -4:] = S - 5
    return (q, k, v, do, np.ascontiguousarray(q_pos), k_pos, q_ctx,
            dict(causal=causal, window=window, cap=cap))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_bwd_ref(case):
    q, k, v, do, q_pos, k_pos, q_ctx, kw = _attn_inputs(case)
    # the reference's vjp of attend
    jq_ctx = None if q_ctx is None else jnp.asarray(q_ctx)

    def jfn(q_, k_, v_):
        return JL.attend(q_, k_, v_, jnp.asarray(q_pos), jnp.asarray(k_pos),
                         kv_chunk=8, q_ctx=jq_ctx, **kw)
    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    # autograd of the plain forward
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    o = ref.flash_attention_ref(tq, tk, tv, _t(q_pos), _t(k_pos),
                                kv_chunk=8, q_ctx=_t(q_ctx), **kw)
    agrads = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    # the plain backward, from the forward's output
    bgrads = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o.detach(),
                                         _t(do), _t(q_pos), _t(k_pos),
                                         q_ctx=_t(q_ctx), **kw)
    _close(o.detach().numpy(), jo)
    for b, a, j in zip(bgrads, agrads, jgrads):
        _close(b.numpy(), a.numpy())
        _close(b.numpy(), j)


def _scan_inputs(N, with_dhT):
    """The scan's inputs (x, dt, Bm, Cm, A, D, h0), dy and dhT at B=2,
    T=13, E=6, shaped like a Mamba layer's (dt in [0, 0.5), A < 0)."""
    B, T, E = 2, 13, 6
    rng = np.random.default_rng(N)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, Bm, Cm, D, h0 = f(B, T, E), f(B, T, N), f(B, T, N), f(E), f(B, E, N)
    dt = (rng.random((B, T, E)) * 0.5).astype(np.float32)
    A = -np.exp(f(E, N) * 0.5).astype(np.float32)
    dy = f(B, T, E)
    dhT = f(B, E, N) if with_dhT else np.zeros((B, E, N), np.float32)
    return (x, dt, Bm, Cm, A, D, h0), dy, dhT


@functools.lru_cache(maxsize=None)
def _scan_vjp(N, with_dhT):
    """``jax.vjp`` of the reference's ``ssm_scan_ref`` on
    ``_scan_inputs``: ((y, hT), grads), once per (N, with_dhT)."""
    ins, dy, dhT = _scan_inputs(N, with_dhT)
    (jy, jh), vjp = jax.vjp(lambda *a: JR.ssm_scan_ref(*a),
                            *map(jnp.asarray, ins))
    return (jy, jh), vjp((jnp.asarray(dy), jnp.asarray(dhT)))


# chunk lengths at T = 13: one that divides T (1), two that do not (4, 5)
# and one longer than T (16)
SCAN_CHUNKS = [1, 4, 5, 16]


@pytest.mark.parametrize("chunk", SCAN_CHUNKS)
@pytest.mark.parametrize("with_dhT", [False, True])
@pytest.mark.parametrize("N", [4, 16])
def test_ssm_scan_bwd_ref(N, with_dhT, chunk):
    """The plain backward from the chunk checkpoints ``hc`` against
    autograd of the plain forward and the reference's vjp."""
    ins, dy, dhT = _scan_inputs(N, with_dhT)
    (jy, jh), jgrads = _scan_vjp(N, with_dhT)
    tins = [_t(a).requires_grad_(True) for a in ins]
    y, hT, hc = ref.ssm_scan_ref(*tins, chunk=chunk)
    assert hc.shape[1] == -(-ins[0].shape[1] // chunk)
    agrads = torch.autograd.grad((y, hT), tins, (_t(dy), _t(dhT)))
    bgrads = ref.ssm_scan_bwd_ref(*map(_t, ins), hc.detach(), _t(dy),
                                  _t(dhT) if with_dhT else None, chunk=chunk)
    _close(y.detach().numpy(), jy)
    _close(hT.detach().numpy(), jh)
    assert len(bgrads) == len(ins)
    for b, a, j in zip(bgrads, agrads, jgrads):
        _close(b.numpy(), a.numpy())
        _close(b.numpy(), j)


@pytest.mark.parametrize("chunk", SCAN_CHUNKS)
def test_ssm_scan_ref_chunk_checkpoints_are_the_boundary_states(chunk):
    """``ssm_scan_ref(chunk=K)``'s hc is h0 then the states hs of
    ``return_states`` after steps K-1, 2K-1, ..., bit for bit, beside the
    same y and hT."""
    ins = [_t(a) for a in _scan_inputs(16, False)[0]]
    y, hT, hs = ref.ssm_scan_ref(*ins, return_states=True)
    yc, hTc, hc = ref.ssm_scan_ref(*ins, chunk=chunk)
    T = hs.shape[1]
    assert hc.shape == (hs.shape[0], -(-T // chunk)) + tuple(hs.shape[2:])
    assert torch.equal(hc[:, 0], ins[6])
    for k in range(1, hc.shape[1]):
        assert torch.equal(hc[:, k], hs[:, k * chunk - 1])
    assert torch.equal(yc, y) and torch.equal(hTc, hT)


def test_cpu_routes_differentiate_through_the_plain_versions():
    """``ops.flash_attention`` and ``ops.ssm_scan`` on CPU tensors carry
    autograd graphs; the serving routes take grad-free tensors as
    before."""
    q, k, v, do, q_pos, k_pos, q_ctx, kw = _attn_inputs("causal-gqa")
    tq = _t(q).requires_grad_(True)
    o = ops.flash_attention(tq, _t(k), _t(v), _t(q_pos), _t(k_pos), **kw)
    assert o.grad_fn is not None
    (g,) = torch.autograd.grad(o, tq, _t(do))
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    x = torch.randn(1, 5, 4, requires_grad=True)
    y, hT = ops.ssm_scan(x, torch.rand(1, 5, 4), torch.randn(1, 5, 4),
                         torch.randn(1, 5, 4), -torch.rand(4, 4),
                         torch.ones(4), torch.zeros(1, 4, 4))
    assert y.grad_fn is not None and hT.grad_fn is not None
    with torch.no_grad():
        out = ops.paged_gather(torch.randn(3, 2, 4), torch.tensor([2, 0]), 3)
    assert out.shape == (4, 4)

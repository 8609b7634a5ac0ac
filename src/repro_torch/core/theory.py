"""Closed-form latency models from Section 4 / Appendix B of the paper
(port of ``repro.core.theory``: numpy only, the reference's code
unchanged).

All times are per-token latencies in units of the draft model's per-token
time ``t`` (set t=1): the target model verification costs ``c`` per call.

  * ``t_ar``       — autoregressive decoding with the target model
  * ``t_sd``       — vanilla SD under full acceptance  (Sec. 4.1)
  * ``t_psd_ideal``— ideal parallel SD, Eq. (1)
  * ``t_psd_rollback`` — Theorem 1, Eq. (3)
  * ``expected_accepted_len`` — Lemma 1
  * ``truncated_geometric_pmf`` — Eq. (2)

A Monte-Carlo simulator of the two-round rollback process validates the
closed forms (tests/test_theory.py, tests/test_torch_theory.py).
"""
from __future__ import annotations

import numpy as np


def truncated_geometric_pmf(alpha: float, gamma: int) -> np.ndarray:
    """P(X = k) for k = 0..gamma (Eq. 2)."""
    k = np.arange(gamma + 1)
    pmf = (1 - alpha) * alpha ** k
    pmf[-1] = alpha ** gamma
    return pmf


def expected_accepted_len(alpha: float, gamma: int) -> float:
    """Lemma 1: E[X] = alpha (1 - alpha^gamma) / (1 - alpha)."""
    if alpha >= 1.0:
        return float(gamma)
    return alpha * (1.0 - alpha ** gamma) / (1.0 - alpha)


def t_ar(c: float) -> float:
    return float(c)


def t_sd(gamma: int, c: float) -> float:
    """Vanilla SD per-token latency under full acceptance: (gamma+c)/(gamma+1)."""
    return (gamma + c) / (gamma + 1.0)


def t_sd_rollback(gamma: int, c: float, alpha: float) -> float:
    """Vanilla SD with rollback: a round costs gamma*t + c*t and yields
    E[X] + 1 tokens (accepted prefix + the resampled/bonus token)."""
    ex = expected_accepted_len(alpha, gamma)
    return (gamma + c) / (ex + 1.0)


def t_psd_ideal(gamma: int, c: float) -> float:
    """Eq. (1): max(gamma, c)/gamma."""
    return max(gamma, c) / gamma


def t_psd_rollback(gamma: int, c: float, alpha: float) -> float:
    """Theorem 1, Eq. (3)."""
    ex = expected_accepted_len(alpha, gamma)
    if ex <= 0:
        return float("inf")
    return 2.0 * max(gamma, c) / ((1.0 + alpha ** gamma) * ex)


def optimal_gamma(c: float, alpha: float, gamma_max: int = 64) -> int:
    """argmin_gamma of Theorem 1 (Fig. 2 minimum)."""
    lat = [t_psd_rollback(g, c, alpha) for g in range(1, gamma_max + 1)]
    return int(np.argmin(lat)) + 1


def simulate_psd_rollback(gamma: int, c: float, alpha: float, *,
                          n_rounds: int = 20_000, seed: int = 0) -> float:
    """Monte-Carlo estimate of the Theorem 1 per-token latency.

    Mirrors the proof's process: a 2-round super-step costing
    2*max(gamma, c); round 1 yields gamma tokens if all accepted, else the
    retry round yields a truncated-geometric number of tokens; total token
    yield per super-step is (1 + alpha^gamma) * E[X] in expectation.
    """
    rng = np.random.default_rng(seed)
    accepts = rng.random((n_rounds, gamma)) < alpha
    # tokens accepted per round: index of first rejection (gamma if none)
    first_rej = np.where(accepts.all(axis=1), gamma,
                         np.argmin(accepts, axis=1))
    full = first_rej == gamma
    # pair rounds into super-steps (round1, retry) as in the proof:
    # a full round-1 banks gamma tokens plus an unconditional retry round;
    # a non-full round-1 banks only its own accepted prefix.
    r1 = first_rej[0::2]
    r2 = first_rej[1::2]
    tokens = np.where(full[0::2], gamma + r2, r1)
    time = 2.0 * max(gamma, c) * len(tokens)
    return time / max(tokens.sum(), 1)


def speedup_table(c: float, alphas, gammas) -> dict:
    """Convenience for benchmarks/theory.py (Fig. 2 reproduction)."""
    out = {}
    for a in alphas:
        out[a] = {g: t_psd_rollback(g, c, a) for g in gammas}
    return out

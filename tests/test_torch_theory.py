"""``repro_torch.core.theory`` (numpy only, a copy of the reference's):
the assertions of the reference's ``tests/test_theory.py`` hold for it,
and each function equals the reference's on the same inputs."""
import numpy as np
import pytest
import torch

from repro.core import theory as JT
from repro_torch.core import theory as T

# One intra-op thread, as in every port test file (this one computes in
# numpy, but shares its worker with files that run torch).
torch.set_num_threads(1)

ALPHAS = (0.0, 0.3, 0.6, 0.9, 1.0)
GAMMAS = (1, 2, 4, 8)


def test_lemma1_matches_pmf_expectation():
    for alpha in (0.3, 0.6, 0.9):
        for gamma in (1, 4, 8):
            pmf = T.truncated_geometric_pmf(alpha, gamma)
            np.testing.assert_allclose(pmf.sum(), 1.0, atol=1e-12)
            ex = (np.arange(gamma + 1) * pmf).sum()
            np.testing.assert_allclose(
                T.expected_accepted_len(alpha, gamma), ex, rtol=1e-10)


def test_ideal_psd_speedup_limits():
    c = 16
    ratio = T.t_sd(c, c) / T.t_psd_ideal(c, c)
    assert 1.8 < ratio < 2.0
    assert T.t_ar(c) / T.t_psd_ideal(c, c) == pytest.approx(c)


@pytest.mark.parametrize("alpha", [0.4, 0.7, 0.9])
@pytest.mark.parametrize("gamma", [2, 6])
def test_theorem1_matches_simulation(alpha, gamma):
    c = 8.0
    closed = T.t_psd_rollback(gamma, c, alpha)
    sim = T.simulate_psd_rollback(gamma, c, alpha, n_rounds=200_000)
    assert abs(sim - closed) / closed < 0.05, (closed, sim)


def test_tradeoff_minimum_in_gamma_le_c():
    c = 10.0
    for alpha in (0.5, 0.7, 0.9):
        assert T.optimal_gamma(c, alpha, gamma_max=40) <= c + 1


def test_rollback_penalty_monotone_in_alpha():
    c, gamma = 10.0, 8
    lats = [T.t_psd_rollback(gamma, c, a) for a in (0.3, 0.5, 0.7, 0.9)]
    assert all(a > b for a, b in zip(lats, lats[1:]))


@pytest.mark.parametrize("c", [1.0, 4.0, 10.0, 16.0])
def test_every_function_equals_reference(c):
    for a in ALPHAS:
        for g in GAMMAS:
            np.testing.assert_array_equal(T.truncated_geometric_pmf(a, g),
                                          JT.truncated_geometric_pmf(a, g))
            assert T.expected_accepted_len(a, g) == \
                JT.expected_accepted_len(a, g)
            assert T.t_sd_rollback(g, c, a) == JT.t_sd_rollback(g, c, a)
            assert T.t_psd_rollback(g, c, a) == JT.t_psd_rollback(g, c, a)
        assert T.optimal_gamma(c, a if a > 0 else 0.1) == \
            JT.optimal_gamma(c, a if a > 0 else 0.1)
    for g in GAMMAS:
        assert T.t_sd(g, c) == JT.t_sd(g, c)
        assert T.t_psd_ideal(g, c) == JT.t_psd_ideal(g, c)
    assert T.t_ar(c) == JT.t_ar(c)
    assert T.simulate_psd_rollback(4, c, 0.7, n_rounds=2000, seed=3) == \
        JT.simulate_psd_rollback(4, c, 0.7, n_rounds=2000, seed=3)
    assert T.speedup_table(c, (0.5, 0.8), GAMMAS) == \
        JT.speedup_table(c, (0.5, 0.8), GAMMAS)

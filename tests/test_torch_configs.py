"""The port's config registry against the reference's
(``tests/test_configs.py``, case for case): every assigned config, its
``reduced()`` and ``draft()`` variants and their arithmetic equal the
reference's; the applicability flags, ``get_config`` on the paper-pair
names and ``tiny_pair``; encoder-only hubert has no decode path."""
import dataclasses

import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs.paper_pairs import tiny_pair as j_tiny_pair
from repro_torch.configs import ARCH_IDS, all_assigned, get_config
from repro_torch.configs.paper_pairs import tiny_pair
from repro_torch.models import model as TM
from repro_torch.models.config import NoDecodeError
from repro_torch.runtime.engines import (AutoregressiveEngine, EngineConfig,
                                         SpSEngine)
from repro_torch.runtime.runner import ModelRunner
from repro_torch.serving import BatchedSpecBranchEngine

torch.set_num_threads(1)

PAPER_NAMES = ["llama-68m", "llama-7b", "vicuna-68m", "vicuna-13b",
               "deepseek-coder-1.3b", "deepseek-coder-33b", "llama-3.1-8b",
               "llama-3.1-70b"]


def _variants(cfg):
    return {"config": cfg, "reduced": cfg.reduced(), "draft": cfg.draft(),
            "reduced-draft": cfg.reduced().draft()}


def test_registry_complete():
    assert ARCH_IDS == J_ARCH_IDS
    cfgs = all_assigned()
    assert len(cfgs) == 10
    for a in ARCH_IDS:
        assert cfgs[a].name == a


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_configs_and_variants_equal_reference(arch):
    got, want = _variants(get_config(arch)), _variants(j_get_config(arch))
    for k in want:
        g, w = got[k], want[k]
        assert dataclasses.asdict(g) == dataclasses.asdict(w), (arch, k)
        assert g.param_count() == w.param_count(), (arch, k)
        assert g.active_param_count() == w.active_param_count(), (arch, k)
        assert g.layer_kinds() == w.layer_kinds(), (arch, k)
        assert (g.has_attention(), g.pure_full_attention(),
                g.supports_decode(), g.supports_long_context()) == \
            (w.has_attention(), w.pure_full_attention(),
             w.supports_decode(), w.supports_long_context()), (arch, k)
        assert (g.hd, g.period, g.n_periods, g.n_rem, g.expert_ff) == \
            (w.hd, w.period, w.n_periods, w.n_rem, w.expert_ff), (arch, k)


@pytest.mark.parametrize("name", PAPER_NAMES)
def test_get_config_paper_pair_names(name):
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(j_get_config(name))


def test_unknown_name_raises():
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("no-such-model")


def test_tiny_pair_equals_reference():
    for g, w in zip(tiny_pair(), j_tiny_pair()):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    for g, w in zip(tiny_pair(vocab=50, d_target=32, layers_target=2),
                    j_tiny_pair(vocab=50, d_target=32, layers_target=2)):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


@pytest.mark.parametrize("arch,lo,hi", [
    ("falcon-mamba-7b", 6.5e9, 7.8e9),
    ("jamba-1.5-large-398b", 380e9, 420e9),
    ("mistral-nemo-12b", 11.5e9, 13e9),
    ("gemma2-27b", 26e9, 29e9),
    ("qwen3-8b", 7.5e9, 9e9),
    ("grok-1-314b", 300e9, 330e9),
    ("gemma3-4b", 3.3e9, 4.5e9),
    ("hubert-xlarge", 0.9e9, 1.5e9),
    ("internvl2-2b", 1.6e9, 2.2e9),
    ("granite-moe-3b-a800m", 2.8e9, 3.8e9),
])
def test_param_counts_match_names(arch, lo, hi):
    n = get_config(arch).param_count()
    assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B outside [{lo/1e9},{hi/1e9}]"


def test_active_params_moe():
    g = get_config("grok-1-314b")
    assert g.active_param_count() < 0.35 * g.param_count()
    gr = get_config("granite-moe-3b-a800m")
    assert 0.6e9 < gr.active_param_count() < 1.2e9   # "a800m"


def test_layer_patterns():
    j = get_config("jamba-1.5-large-398b")
    kinds = j.layer_kinds()
    assert sum(1 for m, _ in kinds if m == "attn") == 9        # 1:7 over 72
    assert sum(1 for _, f in kinds if f == "moe") == 36        # every other
    g3 = get_config("gemma3-4b")
    kinds3 = g3.layer_kinds()
    assert sum(1 for m, _ in kinds3 if m == "attn") == 5       # 34 = 5*6+4
    assert g3.n_rem == 4


def test_reduced_variants_bounded():
    for a in ARCH_IDS:
        r = get_config(a).reduced()
        assert r.num_layers <= 2 * r.period
        assert r.d_model <= 512
        assert r.num_experts <= 4
        assert r.vocab_size <= 512


def test_applicability_flags():
    assert not get_config("hubert-xlarge").supports_decode()
    assert not get_config("mistral-nemo-12b").supports_long_context()
    assert not get_config("qwen3-8b").supports_long_context()
    assert not get_config("grok-1-314b").supports_long_context()
    assert not get_config("internvl2-2b").supports_long_context()
    assert get_config("falcon-mamba-7b").supports_long_context()
    assert get_config("jamba-1.5-large-398b").supports_long_context()
    assert get_config("gemma2-27b").supports_long_context()
    assert get_config("gemma3-4b").supports_long_context()


def test_draft_variants():
    for a in ARCH_IDS:
        cfg = get_config(a)
        d = cfg.draft()
        assert d.family == cfg.family
        assert d.vocab_size == cfg.vocab_size
        assert d.param_count() < cfg.param_count()


def test_encoder_only_has_no_decode_path():
    """hubert-xlarge: the cache-less forward runs; a decode cache, a
    decode step, a runner and every engine raise NoDecodeError (the
    reference has no decode path for it either)."""
    cfg = get_config("hubert-xlarge").reduced()
    p = TM.init_params(cfg, 0, "cpu")
    lg, _ = TM.forward(p, cfg, embeds=torch.zeros(1, 3, cfg.d_model))
    assert lg.shape == (1, 3, cfg.vocab_size)
    ecfg = EngineConfig(max_len=64)
    for make in (lambda: TM.init_cache(cfg, 1, 8, "cpu"),
                 lambda: TM.init_paged_cache(cfg, 4, 4, "cpu"),
                 lambda: TM.decode_step(p, cfg, torch.zeros(1, 1).long(),
                                        cache={}, pos=torch.zeros(1)),
                 lambda: ModelRunner(p, cfg),
                 lambda: AutoregressiveEngine(p, cfg, ecfg),
                 lambda: SpSEngine(p, cfg, p, cfg, ecfg),
                 lambda: BatchedSpecBranchEngine(p, cfg, p, cfg, ecfg,
                                                 device="cpu")):
        with pytest.raises(NoDecodeError, match="encoder-only"):
            make()


def test_serve_load_pair_takes_every_decoding_arch(monkeypatch):
    """``--pair <arch id>``: every assigned config that decodes, with its
    draft(), seeds 1 (draft) and 0 (target); falcon-mamba-7b as before.
    The weights are not drawn here (init_params is stubbed)."""
    from repro_torch.launch import serve as SV
    assert set(SV.ARCH_PAIRS) == set(ARCH_IDS) - {"hubert-xlarge"}
    assert set(SV.ARCH_PAIRS) <= set(SV.PAIRS)
    assert set(SV.SSM_PAIRS) >= {"falcon-mamba-7b", "jamba-1.5-large-398b"}
    monkeypatch.setattr(SV.M, "init_params",
                        lambda cfg, seed, device: (cfg.name, seed))
    for arch in SV.ARCH_PAIRS:
        dp, dcfg, tp, tcfg = SV.load_pair(arch, "cpu")
        assert tcfg is get_config(arch) and dcfg == tcfg.draft()
        assert (dp, tp) == ((dcfg.name, 1), (arch, 0))
    with pytest.raises(SystemExit):
        SV.main(["--device", "cpu", "--pair", "hubert-xlarge"])

"""The port's examples (``examples/torch_quickstart.py``,
``examples/torch_serve_requests.py``, ``examples/torch_train_tiny_lm.py``
and ``examples/torch_train_hrad.py``) run on the CPU at a small size:
their ``main`` with ``--device cpu``, in this process.  Without
``--device`` they default to the card, and without one they raise."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.core import hrad as H
from repro_torch.training import pairs as TP

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores.
torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_cpu(capsys):
    _load("torch_quickstart").main(["--device", "cpu", "--new-tokens", "8"])
    out = capsys.readouterr().out
    assert "sps" in out and "specbranch" in out
    assert out.count("output identical to target greedy decoding") == 2


def test_serve_requests_on_cpu(tmp_path, capsys, monkeypatch):
    mod = _load("torch_serve_requests")
    # without any trained H-RAD file: the port trains one into its own
    # cache (collect + train_mlp on the CPU), the reference's untouched
    monkeypatch.setattr(TP, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(TP, "TORCH_CACHE_DIR", str(tmp_path / "torch"))
    trace = tmp_path / "trace.json"
    mod.main(["2", str(trace), "--device", "cpu", "--new-tokens", "6"])
    out = capsys.readouterr().out
    assert "aggregate:" in out
    assert trace.exists()
    assert (tmp_path / "torch" / "hrad-misaligned-K4.npz").exists()
    assert not (tmp_path / "hrad-misaligned-K4.npz").exists()
    # with a cached MLP (here an untrained one saved where the reference
    # caches its trained MLP): loaded, and every signal comes from it
    gen = torch.Generator().manual_seed(0)
    cfg = TP.TARGET_CFG
    mlp = H.init_mlp(H.HRADConfig(d_model=cfg.d_model).d_in, generator=gen,
                     device="cpu")
    np.savez(tmp_path / "hrad-misaligned-K4.npz",
             **{k: v.numpy() for k, v in mlp.items()})
    mod.main(["2", "--device", "cpu", "--new-tokens", "6",
              "--prefix-cache", "on"])
    out = capsys.readouterr().out
    assert "prefix cache: hits=1/2 saved_tokens=32" in out


def test_train_examples_on_cpu(tmp_path, capsys):
    out_path = tmp_path / "tiny.npz"
    _load("torch_train_tiny_lm").main(
        ["--device", "cpu", "--arch", "qwen3-8b", "--steps", "2",
         "--batch", "2", "--seq", "16", "--out", str(out_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and "greedy sample" in out
    assert out_path.exists()
    _load("torch_train_hrad").main(["--device", "cpu", "--prompts", "2",
                                    "--new-tokens", "16", "--epochs", "1"])
    out = capsys.readouterr().out
    assert "with H-RAD:" in out and "without H-RAD:" in out


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch_quickstart", "torch_serve_requests",
                 "torch_train_tiny_lm", "torch_train_hrad"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main([])

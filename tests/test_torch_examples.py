"""The port's examples (``examples/torch_quickstart.py`` and
``examples/torch_serve_requests.py``) run on the CPU at a small size:
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
    # without the reference's trained H-RAD file: served without H-RAD
    monkeypatch.setattr(TP, "CACHE_DIR", str(tmp_path))
    trace = tmp_path / "trace.json"
    mod.main(["2", str(trace), "--device", "cpu", "--new-tokens", "6"])
    out = capsys.readouterr().out
    assert "serving without H-RAD" in out and "aggregate:" in out
    assert trace.exists()
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
    assert "serving without H-RAD" not in out
    assert "prefix cache: hits=1/2 saved_tokens=32" in out


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch_quickstart", "torch_serve_requests"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main([])

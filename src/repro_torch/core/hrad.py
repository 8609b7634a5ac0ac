"""H-RAD — Hybrid Rollback-Aware Draft structure (port of
``repro.core.hrad``, Sec. 5.1, Eq. 4-6), the inference half.

A 3-layer MLP maps

    z_t = concat(h_{t-1}^{1..K}, e_t)  in  R^{(K+1) * D}

(the target's hidden state after each of its last K feature points, at
the previous position, plus the embedding of the newest token) to a
3-class signal

    s_t = 0  all-reject   (branch at the first token of this round)
    s_t = 1  confidence   (branch where draft confidence < eps)
    s_t = 2  all-accept   (branch at the first token of the next round)

Parameters are float32 whatever the model's dtype.  Offline training
(SMOTE, gradient clipping, the optimizer loop) is a later slice of the
port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]

HIDDEN = (256, 64)
N_CLASSES = 3
DROPOUT = 0.4


@dataclasses.dataclass
class HRADConfig:
    k_layers: int = 4          # K — how many trailing feature points to use
    d_model: int = 0           # filled from the target ModelConfig
    lr: float = 5e-5
    weight_decay: float = 1e-4
    epochs: int = 20
    batch_size: int = 32
    label_smoothing: float = 0.1
    seed: int = 0

    @property
    def d_in(self) -> int:
        return (self.k_layers + 1) * self.d_model


def build_feature(features: torch.Tensor, embed: torch.Tensor,
                  k_layers: int) -> torch.Tensor:
    """features (n_points, B, D); embed (B, D) of the next token.  Returns
    z (B, (K+1) * D) float32 from the last K feature points (the deepest
    layers), padded by repeating the deepest when K > n_points."""
    n = features.shape[0]
    k = min(k_layers, n)
    sel = features[n - k:]                       # (k, B, D)
    if k < k_layers:
        sel = torch.cat([sel[-1:].expand((k_layers - k,) + sel.shape[1:]),
                         sel], dim=0)
    B = embed.shape[0]
    z = torch.cat([sel.permute(1, 0, 2).reshape(B, -1).float(),
                   embed.float()], dim=-1)
    return z


def token_embedding(model_params, token: torch.Tensor) -> torch.Tensor:
    """e_t for a (B,) token id batch, float32."""
    return model_params["embed"][token.long()].float()


def init_mlp(d_in: int, *, generator: torch.Generator,
             device="cuda") -> Params:
    """He-normal weights and zero biases, drawn on the generator's device
    (so one seed gives the same parameters on every device) and moved to
    ``device``."""
    dims = (d_in,) + HIDDEN + (N_CLASSES,)
    p: Params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((a, b), generator=generator,
                        device=generator.device) * math.sqrt(2.0 / a)
        p[f"w{i}"] = w.to(device)
        p[f"b{i}"] = torch.zeros((b,), device=device)
    return p


@torch.no_grad()
def apply_mlp(p: Params, z: torch.Tensor) -> torch.Tensor:
    """z (B, d_in) -> logits (B, 3), inference (no dropout)."""
    h = z
    n_layers = len([k for k in p if k.startswith("w")])
    for i in range(n_layers):
        h = h @ p[f"w{i}"] + p[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def predict(p: Params, z: torch.Tensor) -> torch.Tensor:
    """s_t = argmax softmax(MLP(z)) (Eq. 5): (B,) int32 in {0, 1, 2}."""
    return torch.argmax(apply_mlp(p, z), dim=-1).to(torch.int32)


def label_from_outcome(n_accepted: int, gamma: int) -> int:
    """Dataset label for a finished verification round: 0 = nothing
    accepted, 2 = everything accepted, 1 = partial."""
    if n_accepted <= 0:
        return 0
    if n_accepted >= gamma:
        return 2
    return 1

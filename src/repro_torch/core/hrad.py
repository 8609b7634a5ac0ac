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
(Sec. E.4: ``train_mlp``, with SMOTE minority oversampling, label
smoothing, dropout, raw-gradient clipping and decoupled weight decay)
follows the reference step for step: its numpy parts (splits, SMOTE,
batch order) are the reference's, and its dropout masks come from the
port's bit-exact threefry under the reference's key splits, so a step
from carried parameters equals the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime import prng

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


# ---------------------------------------------------------------------------
# offline training (Sec. E.4)
# ---------------------------------------------------------------------------

def _smote(x: np.ndarray, y: np.ndarray, seed: int = 0,
           k_neighbors: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal SMOTE: oversample minority classes to the majority count by
    interpolating each sample with one of its k nearest same-class
    neighbours (numpy; the reference's draws)."""
    rng = np.random.default_rng(seed)
    counts = np.bincount(y, minlength=N_CLASSES)
    target = counts.max()
    xs, ys = [x], [y]
    for c in range(N_CLASSES):
        xc = x[y == c]
        need = int(target - counts[c])
        if need <= 0 or len(xc) == 0:
            continue
        if len(xc) == 1:
            xs.append(np.repeat(xc, need, axis=0))
            ys.append(np.full(need, c, dtype=y.dtype))
            continue
        idx = rng.integers(0, len(xc), size=need)
        base = xc[idx]
        # nearest neighbours among a subsample (cheap approximate kNN)
        sub = xc[rng.integers(0, len(xc), size=(need, k_neighbors))]
        d = np.linalg.norm(sub - base[:, None], axis=-1)
        d[d == 0] = np.inf
        nn = sub[np.arange(need), np.argmin(d, axis=1)]
        lam = rng.random((need, 1))
        xs.append(base + lam * (nn - base))
        ys.append(np.full(need, c, dtype=y.dtype))
    return np.concatenate(xs), np.concatenate(ys)


def clip_by_global_norm(g: Params, max_norm: float = 1.0) -> Params:
    """Scale a gradient dict so its global L2 norm is at most ``max_norm``
    (E.4), applied to the RAW gradient before it enters the Adam moments;
    the norm sums the leaves in sorted-key order, as the reference's."""
    total = None
    for k in sorted(g):
        sq = (g[k] * g[k]).sum()
        total = sq if total is None else total + sq
    scale = torch.clamp(max_norm / torch.clamp(torch.sqrt(total), min=1e-8),
                        max=1.0)
    return {k: scale * a for k, a in g.items()}


def apply_mlp_train(p: Params, z: torch.Tensor, key: torch.Tensor
                    ) -> torch.Tensor:
    """z (B, d_in) -> logits (B, 3) with dropout after each hidden ReLU:
    ``key, sub = split(key)`` per layer and keep = uniform(sub, h.shape)
    < 1 - DROPOUT (``jax.random.bernoulli``), kept units scaled by
    1 / (1 - DROPOUT).  Differentiable."""
    keep_p = torch.tensor(1.0 - DROPOUT, dtype=torch.float32)
    h = z
    n_layers = len([k for k in p if k.startswith("w")])
    for i in range(n_layers):
        h = h @ p[f"w{i}"] + p[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
            ks = prng.split(key)
            key, sub = ks[0], ks[1]
            keep = (prng.uniform_shaped(sub, h.shape, device=h.device)
                    < keep_p.to(h.device))
            h = torch.where(keep, h / (1.0 - DROPOUT), torch.zeros_like(h))
    return h


def _bias_correction(b: float, t: int) -> float:
    return float(1 - torch.tensor(b, dtype=torch.float32) ** t)


def mlp_step(p: Params, m: Params, v: Params, zb: torch.Tensor,
             yb: torch.Tensor, key: torch.Tensor, t: int, lr: float,
             cfg: HRADConfig) -> Tuple[Params, Params, Params]:
    """One training step of ``train_mlp``: label-smoothed CE through the
    dropout forward under ``key``, gradient clipped to global norm 1, Adam
    moments (b1 0.9, b2 0.999, eps 1e-8) with bias correction at step t,
    decoupled weight decay.  Returns new (p, m, v)."""
    leaves = {k: x.detach().requires_grad_(True) for k, x in p.items()}
    with torch.enable_grad():
        logits = apply_mlp_train(leaves, zb, key)
        logp = torch.log_softmax(logits, dim=-1)
        onehot = torch.nn.functional.one_hot(yb.long(), N_CLASSES).float()
        eps_ls = cfg.label_smoothing
        smoothed = onehot * (1 - eps_ls) + eps_ls / N_CLASSES
        loss = -torch.mean(torch.sum(smoothed * logp, dim=-1))
        names = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    with torch.no_grad():
        g = clip_by_global_norm(dict(zip(names, grads)))
        b1, b2, e = 0.9, 0.999, 1e-8
        c1, c2 = _bias_correction(b1, t), _bias_correction(b2, t)
        m = {k: b1 * m[k] + (1 - b1) * g[k] for k in names}
        v = {k: b2 * v[k] + (1 - b2) * g[k] * g[k] for k in names}
        p = {k: p[k] - lr * ((m[k] / c1) / (torch.sqrt(v[k] / c2) + e)
                             + cfg.weight_decay * p[k]) for k in names}
    return p, m, v


def train_mlp(z: np.ndarray, labels: np.ndarray, cfg: HRADConfig,
              verbose: bool = False, device="cuda",
              init: Optional[Params] = None
              ) -> Tuple[Params, Dict[str, float]]:
    """Offline H-RAD training.  z (N, d_in) float32; labels (N,) in {0, 1,
    2}.  The reference's procedure: a seeded permutation, a held-out 10%
    split, standardised SMOTE on the rest, Adam with ReduceLROnPlateau
    (factor 0.5 after 2 flat epochs) and early stopping (5).  The MLP
    starts from ``init`` (float32 tensors, e.g. the reference's
    ``init_mlp`` carried over) or else ``init_mlp`` under
    ``torch.Generator(cfg.seed)`` on ``device``; dropout keys come from
    ``prng.PRNGKey(cfg.seed)`` as in the reference.  Returns (params,
    metrics) with metrics = the best validation accuracy, per-class
    recall on the held-out split and training accuracy on real rows."""
    dev = torch.device(device)
    rng = np.random.default_rng(cfg.seed)
    n = len(z)
    perm = rng.permutation(n)
    z, labels = z[perm], labels[perm]
    n_val = max(1, n // 10)
    zv, yv = z[:n_val], labels[:n_val]
    zt, yt = z[n_val:], labels[n_val:]

    # standardise (SMOTE in standardised space, per E.4); keep the real
    # pre-SMOTE training rows aside for the training accuracy
    zt_real, yt_real = zt, yt
    mu, sd = zt.mean(0), zt.std(0) + 1e-6
    zt_s = (zt - mu) / sd
    zt_s, yt = _smote(zt_s, yt, seed=cfg.seed)
    zt = zt_s * sd + mu

    key = prng.PRNGKey(cfg.seed)
    if init is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = init_mlp(z.shape[1], generator=gen, device=dev)
    else:
        params = {k: x.to(device=dev, dtype=torch.float32)
                  for k, x in init.items()}
    opt_m = {k: torch.zeros_like(x) for k, x in params.items()}
    opt_v = {k: torch.zeros_like(x) for k, x in params.items()}

    def as_t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    lr = cfg.lr
    best_val, patience, t = -1.0, 0, 0
    nb = max(1, len(zt) // cfg.batch_size)
    for epoch in range(cfg.epochs):
        order = rng.permutation(len(zt))
        for b in range(nb):
            sel = order[b * cfg.batch_size:(b + 1) * cfg.batch_size]
            t += 1
            ks = prng.split(key)
            key, dk = ks[0], ks[1]
            params, opt_m, opt_v = mlp_step(
                params, opt_m, opt_v, as_t(zt[sel]),
                as_t(yt[sel], torch.int64), dk, t, lr, cfg)
        val_acc = float(np.mean(predict(params, as_t(zv)).cpu().numpy()
                                == yv))
        if val_acc > best_val + 1e-4:
            best_val, patience = val_acc, 0
        else:
            patience += 1
            if patience >= 2:                 # ReduceLROnPlateau(factor=.5)
                lr *= 0.5
            if patience >= 5:                 # early stopping
                break
        if verbose:
            print(f"  epoch {epoch}: val_acc={val_acc:.3f} lr={lr:.2e}")

    pred_v = predict(params, as_t(zv)).cpu().numpy()
    recalls = {}
    for c in range(N_CLASSES):
        m = yv == c
        recalls[f"recall_{c}"] = (float((pred_v[m] == c).mean()) if m.any()
                                  else float("nan"))
    train_pred = predict(params, as_t(zt_real[:2048])).cpu().numpy()
    metrics = {"val_acc": best_val, **recalls,
               "train_acc": float(np.mean(train_pred == yt_real[:2048]))}
    return params, metrics

"""The gradient-accumulated train step (port of
``repro.launch.steps.make_train_step``), on one device.

The reference's module also holds the mesh-sharded serve steps, their
``input_specs`` and the distributed forward knobs; those belong to the
production programs of the mesh's dry run (ROADMAP.md queue A item 5b)
and are not here.  The serving mesh itself is ``launch.mesh``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.training import optim
from repro_torch.training.train import lm_loss, value_and_grad


def make_train_step(cfg: ModelConfig, n_micro: int,
                    ocfg: Optional[optim.AdamWConfig] = None):
    """step(params, opt_state, batch (B, T+1)) -> (params, opt_state,
    mean loss): ``n_micro`` micro-batches of B / n_micro rows, each a
    remat forward and backward, their gradients summed in the parameter
    dtype (as the reference accumulates: f32 accumulators would double a
    bf16 model's gradient memory) and divided by ``n_micro``, then one
    AdamW step (params updated in place)."""
    ocfg = ocfg or optim.AdamWConfig()

    def step(params, opt_state, batch):
        B = batch.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} is not a multiple of n_micro "
                             f"{n_micro}")
        micro = batch.reshape(n_micro, B // n_micro, batch.shape[1])
        gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                       device=batch.device)
        for mb in micro:
            loss, _, grads = value_and_grad(
                lambda p, b: lm_loss(p, cfg, b, remat=True), params, mb)
            lsum = lsum + loss
            if gsum is None:
                gsum = grads
            else:
                for a, g in zip(optim.tree_leaves(gsum),
                                optim.tree_leaves(grads)):
                    a.add_(g)
            del grads
        for a in optim.tree_leaves(gsum):
            a.div_(n_micro)
        params, opt_state = optim.apply(ocfg, params, gsum, opt_state)
        return params, opt_state, lsum / n_micro

    return step

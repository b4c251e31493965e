"""The train step (port of ``train/steps.py``): one home for its math.

Per-step noise is drawn from a generator seeded with ``fold(seed, step)``,
the role ``jax.random.fold_in(key, step)`` plays in the JAX package (its
lines 44-48), so a run is a function of its seed and the step index alone.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.train.optim import AdamW

Batch = tuple[torch.Tensor, ...]


def fold(seed: int, *path: int) -> int:
    """A 64-bit seed derived from ``seed`` and the integers of ``path``."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0])


def one_update(model: WorldModelNet, optimizer: AdamW, batch: Batch,
               generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """One optimizer step on ``batch``: the ELBO (of either family), its
    gradient, the update. Returns the step's metrics (detached, on the
    device)."""
    optimizer.zero_grad()
    metrics = model.shared_step(batch, generator=generator)
    metrics["loss"].backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: WorldModelNet,
                    optimizer: AdamW) -> Callable[[Batch, int, int], dict[str, torch.Tensor]]:
    """``(batch, seed, step) → metrics``: :func:`one_update` with the noise of
    ``fold(seed, step)``, drawn on the model's device."""
    generator = torch.Generator(device=next(model.parameters()).device)

    def train_step(batch: Batch, seed: int, step: int) -> dict[str, torch.Tensor]:
        generator.manual_seed(fold(seed, step))
        return one_update(model, optimizer, batch, generator)

    return train_step

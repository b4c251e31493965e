"""The train step (port of ``train/steps.py``): one home for its math.

Per-step noise is drawn from a generator seeded with ``fold(seed, step)``,
the role ``jax.random.fold_in(key, step)`` plays in the JAX package (its
lines 44-48), so a run is a function of its seed and the step index alone.
Gradient accumulation is :func:`accumulate_gradients` per batch, then
:func:`apply_accumulated` once a window (JAX ``trainer.py:290-305``).

Data parallel (``parallel.mesh``): a rank's step is given its rows
``(lo, hi, n)`` of a global batch of ``n``, which ``shared_step`` takes:
the model draws every noise tensor at the global batch, in its own order,
and keeps the rank's rows. The rank's loss is weighted by its share of the
rows, ``(hi - lo) / n``, and the optimizer sums the gradients over the
ranks. The step is then the same function of ``(seed, step, global batch)``
at any world size, as JAX's jit over a sharded batch is. A rank with no
rows computes nothing and adds a zero gradient (the generator is seeded
anew each step, so nothing after depends on its draws).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.models.mrssm import Rows
from multimodal_mtrssm_tpu_torch.train.optim import AdamW

Batch = tuple[torch.Tensor, ...]


def fold(seed: int, *path: int) -> int:
    """A 64-bit seed derived from ``seed`` and the integers of ``path``."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0])


def one_update(model: WorldModelNet, optimizer: AdamW, batch: Batch,
               generator: torch.Generator | None = None,
               rows: Rows | None = None) -> dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (this rank's ``rows`` of the global
    batch, where given): the ELBO (of any family), its gradient, the
    update. Returns the step's metrics over the rank's rows (detached, on
    the device; empty for a rank with no rows)."""
    optimizer.zero_grad()
    metrics = accumulate_gradients(model, batch, generator, rows=rows)
    optimizer.step()
    return metrics


def make_train_step(model: WorldModelNet, optimizer: AdamW) -> Callable[..., dict[str, torch.Tensor]]:
    """``(batch, seed, step, rows=None) → metrics``: :func:`one_update` with
    the noise of ``fold(seed, step)``, drawn on the model's device."""
    generator = torch.Generator(device=next(model.parameters()).device)

    def train_step(batch: Batch, seed: int, step: int,
                   rows: Rows | None = None) -> dict[str, torch.Tensor]:
        generator.manual_seed(fold(seed, step))
        return one_update(model, optimizer, batch, generator, rows)

    return train_step


def local_step(model: WorldModelNet, batch: Batch, rows: Rows | None,
               generator: torch.Generator | None,
               noise: dict | None = None) -> dict[str, torch.Tensor] | None:
    """``shared_step`` on ``batch``, this rank's ``rows`` of the global
    batch where given (the model draws the noise at the global batch), with
    ``noise`` and ``generator``; None for a rank with no rows."""
    if rows is not None and rows[1] == rows[0]:
        return None
    return model.shared_step(batch, noise, generator=generator, rows=rows)


def accumulate_gradients(model: WorldModelNet, batch: Batch,
                         generator: torch.Generator | None = None,
                         noise: dict | None = None,
                         rows: Rows | None = None) -> dict[str, torch.Tensor]:
    """Add ``batch``'s ELBO gradient to the parameters' ``.grad`` (the
    window's sum) and take no step. ``noise`` and ``generator`` go to
    ``shared_step``; with ``rows`` (:func:`local_step`) the gradient is
    weighted by the rank's share of the global batch. Returns the batch's
    metrics (detached; empty for a rank with no rows)."""
    metrics = local_step(model, batch, rows, generator, noise)
    if metrics is None:
        return {}
    loss = metrics["loss"]
    if rows is not None and rows[1] - rows[0] != rows[2]:
        loss = loss * ((rows[1] - rows[0]) / rows[2])
    loss.backward()
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def apply_accumulated(optimizer: AdamW, n_batches: int) -> None:
    """One clipped AdamW step on the mean of a window's ``n_batches``
    gradients (their sum, in ``.grad``, divided by ``n_batches``); the
    gradients are dropped after."""
    for p in optimizer.params:
        if p.grad is not None:
            p.grad.div_(float(n_batches))
    optimizer.step()
    optimizer.zero_grad()


def make_grad_step(model: WorldModelNet) -> Callable[..., dict[str, torch.Tensor]]:
    """``(batch, seed, step, rows=None) → metrics``:
    :func:`accumulate_gradients` with the noise of ``fold(seed, step)``,
    the train step's noise."""
    generator = torch.Generator(device=next(model.parameters()).device)

    def grad_step(batch: Batch, seed: int, step: int,
                  rows: Rows | None = None) -> dict[str, torch.Tensor]:
        generator.manual_seed(fold(seed, step))
        return accumulate_gradients(model, batch, generator, rows=rows)

    return grad_step

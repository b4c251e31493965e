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

K-step dispatch (JAX ``train/steps.py:53-76``, ``trainer.py:279-288``):
:func:`make_train_chunk` and :func:`make_val_chunk` run K steps on a
``[K, B, ...]`` chunk at steps ``step0 … step0+K-1``, each step's noise
that of its eager step, and add each step's sample-weighted metrics to the
caller's sums on the device, in step order, as the per-batch loop does. On
the card each step replays a captured CUDA graph (``train/graph.py``); on
the CPU, and on a process group whose backend no graph can capture
(gloo), they are plain eager loops.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable

import torch
import torch.distributed as dist

from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.models.mrssm import Rows
from multimodal_mtrssm_tpu_torch.train.graph import GraphedStep
from multimodal_mtrssm_tpu_torch.train.optim import AdamW
from multimodal_mtrssm_tpu_torch.utils import fold

Batch = tuple[torch.Tensor, ...]
# Path element of the validation noise seeds (the JAX trainer folds 0x5EED).
VAL = 0x5EED


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


def accumulate_metrics(acc: dict[str, Any], metrics: dict[str, torch.Tensor],
                       weight: int) -> None:
    """Add ``weight · metric`` on the device; the host reads once an epoch."""
    for k, v in metrics.items():
        acc[k] = acc.get(k, 0.0) + weight * v.detach()


def _eager_reason(device: torch.device, mesh: Any) -> str | None:
    """Why steps on ``device`` (on ``mesh``'s process group) run eagerly, or
    None where a CUDA graph can capture them: the CPU has no graphs, and
    gloo's collectives run on the host (which warns, as JAX warns where a
    setting has no effect)."""
    if device.type != "cuda":
        return "the CPU has no CUDA graphs"
    if mesh is not None and dist.get_backend() != "nccl":
        reason = f"the {dist.get_backend()} backend's collectives cannot be captured"
        # One place of issue, so the default filter shows it once, not once a chunk function.
        warnings.warn(f"steps_per_dispatch > 1 has no effect here: {reason}, so each step of a "
                      "chunk runs eagerly")
        return reason
    return None


def _replay(graphs: dict[tuple, GraphedStep], build: Callable[[Batch, Any], GraphedStep],
            chunk: Batch, seeds: list[int], sums: dict[str, Any], rows: Any) -> None:
    """Batch i of ``chunk`` through the graph of its shape and ``rows``
    (``build`` captures it the first time) with the noise of ``seeds[i]``,
    the weighted metrics added to ``sums``."""
    key = (tuple((tuple(x.shape[1:]), x.dtype) for x in chunk), rows)
    if key not in graphs:
        graphs[key] = build(tuple(x[0] for x in chunk), rows)
    graph = graphs[key]
    graph.load_sums(sums)
    for i, seed in enumerate(seeds):
        graph.replay(tuple(x[i] for x in chunk), seed)
    graph.store_sums(sums)


def make_train_chunk(model: WorldModelNet, optimizer: AdamW,
                     train_step: Callable[..., dict[str, torch.Tensor]] | None = None
                     ) -> Callable[..., None]:
    """``(chunk, seed, step0, sums, rows=None) → None``: K optimizer steps on
    ``chunk``, a ``[K, b, ...]`` tuple of this rank's ``rows`` of K global
    batches (all of each without rows), step ``step0 + i`` on batch i with
    the noise of ``fold(seed, step0 + i)``, as ``train_step`` (default
    :func:`make_train_step`) takes it; each step's metrics, weighted by
    ``b``, are added to ``sums`` in step order. On the card every step
    replays one captured graph of the step; elsewhere each calls
    ``train_step``. The function's ``graphs`` holds its captured steps by
    batch shape and rows (None where it runs eagerly)."""
    device = next(model.parameters()).device
    eager = _eager_reason(device, optimizer.mesh)
    step_fn = train_step or make_train_step(model, optimizer)
    generator = torch.Generator(device=device)

    def build(batch: Batch, rows: Any) -> GraphedStep:
        return GraphedStep(lambda b: one_update(model, optimizer, b, generator, rows), batch,
                           generator, batch[0].shape[0], optimizer)

    def train_chunk(chunk: Batch, seed: int, step0: int, sums: dict[str, Any],
                    rows: Rows | None = None) -> None:
        k, weight = chunk[0].shape[:2]
        if eager is None:
            _replay(train_chunk.graphs, build, chunk, [fold(seed, step0 + i) for i in range(k)],
                    sums, rows)
            return
        for i in range(k):
            accumulate_metrics(sums, step_fn(tuple(x[i] for x in chunk), seed, step0 + i, rows),
                               weight)

    train_chunk.graphs = {} if eager is None else None  # type: ignore[attr-defined]
    return train_chunk


def make_val_chunk(model: WorldModelNet, mesh: Any = None,
                   capture: bool = True) -> Callable[..., None]:
    """``(chunk, seed, i0, sums, rows=None, eager=False) → None``: the
    validation counterpart of :func:`make_train_chunk`, batch ``i0 + i`` of
    the split with the noise of ``fold(seed, VAL, i0 + i)`` (the trainer's
    ``_validate``), no gradient; each batch's metrics, weighted by its rows,
    added to ``sums``. Batches replay a captured graph where ``capture``
    asks for one and the device takes it, unless the call says ``eager``
    (a ragged tail); the rest run one by one."""
    device = next(model.parameters()).device
    eager = _eager_reason(device, mesh) if capture else "no capture asked"
    generator = torch.Generator(device=device)

    def val_step(batch: Batch, rows: Any) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            return local_step(model, batch, rows, generator) or {}

    def build(batch: Batch, rows: Any) -> GraphedStep:
        return GraphedStep(lambda b: val_step(b, rows), batch, generator, batch[0].shape[0])

    def val_chunk(chunk: Batch, seed: int, i0: int, sums: dict[str, Any],
                  rows: Rows | None = None, eager: bool = False) -> None:
        k, weight = chunk[0].shape[:2]
        seeds = [fold(seed, VAL, i0 + i) for i in range(k)]
        if val_chunk.graphs is not None and not eager:
            _replay(val_chunk.graphs, build, chunk, seeds, sums, rows)
            return
        for i in range(k):
            generator.manual_seed(seeds[i])
            accumulate_metrics(sums, val_step(tuple(x[i] for x in chunk), rows), weight)

    val_chunk.graphs = {} if eager is None else None  # type: ignore[attr-defined]
    return val_chunk

"""A train (or validation) step captured as a CUDA graph and replayed per
batch: the route of :func:`.steps.make_train_chunk` on the card.

JAX compiles its step once and ``lax.scan``s it over a ``[K, B, ...]``
chunk (``train/steps.py:53-76``), so K steps cost one dispatch. PyTorch's
counterpart of a compiled step is a captured ``torch.cuda.CUDAGraph``:
:class:`GraphedStep` captures one step (``shared_step``, its backward and
``AdamW.step``; or the validation forward) on static batch buffers and
replays it once per batch of a chunk. A replay is one launch from the
host where the eager step makes hundreds.

- **Warm-up.** Before capture the step runs three times on a side stream,
  as PyTorch's whole-network capture recipe does (it builds the kernels and
  the libraries' handles and workspaces); the parameters and the
  optimizer's state are then put back as they were, so a graphed fit is
  the eager fit bit for bit. The warm-up runs on the stream the capture
  then records from (PyTorch's capture stream, which every graph shares):
  warmed up on another, the first capture of a process could meet state
  first made for that stream inside the capture and fail.
- **Noise.** The step's generator is registered with the graph
  (``CUDAGraph.register_generator_state``): a replay reads the seed and
  Philox offset that ``generator.manual_seed(fold(seed, step))`` set just
  before it, so each replay draws the eager step's noise.
- **Metrics.** The graph adds ``weight · metric`` to its own sum buffers,
  the trainer's per-step accumulation in the same order; the trainer's sums
  go in (:meth:`GraphedStep.load_sums`) before a chunk and come out after.
- **Launch counts.** A replay launches what the capture recorded, with no
  Python wrapper in the way: each replay adds the capture's launches to
  the kernels' counters (``ops.kernels.add_launch_counts``), and the
  capture itself, which launches nothing, leaves them as they were.
- **No fallback.** A capture or replay that fails raises; nothing retries
  the step eagerly.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from multimodal_mtrssm_tpu_torch.ops import kernels

Batch = tuple[torch.Tensor, ...]

WARMUP_STEPS = 3


class GraphedStep:
    """``body(batch) → metrics`` captured once on static copies of
    ``batch``'s tensors. ``optimizer`` (an ``AdamW`` the body steps): its
    parameters and state are restored after the warm-up and its host step
    count advanced once a replay. ``weight`` multiplies each metric as it
    is added to the sums (the batch's rows)."""

    def __init__(self, body: Callable[[Batch], dict[str, torch.Tensor]], batch: Batch,
                 generator: torch.Generator, weight: int, optimizer: Any = None):
        dev = batch[0].device
        self.generator, self.optimizer = generator, optimizer
        self.static = tuple(x.clone() for x in batch)
        state = [*optimizer.params, *optimizer.device_state()] if optimizer is not None else []
        # Detached: a clone on autograd's tape would keep each parameter's
        # gradient accumulator alive on this stream, and the capture's
        # backward would then make it wait on the capturing stream.
        saved = [t.detach().clone() for t in state]
        count = optimizer.count if optimizer is not None else 0
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph)  # records nothing before ``with``
        side = capture.capture_stream  # PyTorch's one capture stream, shared by every graph
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                generator.manual_seed(0)
                metrics = body(self.static)
        torch.cuda.current_stream(dev).wait_stream(side)
        if optimizer is not None:
            with torch.no_grad():
                torch._foreach_copy_(state, saved)
            optimizer.count = count
        self.sums = {k: torch.zeros_like(v) for k, v in metrics.items()}
        self.graph.register_generator_state(generator)
        before = kernels.launch_counts()
        t1 = time.perf_counter()
        with capture:
            metrics = body(self.static)
            for k, v in metrics.items():
                self.sums[k].add_(weight * v)
        torch.cuda.synchronize(dev)
        after = kernels.launch_counts()
        kernels.set_launch_counts(before)
        if optimizer is not None:
            optimizer.count = count
        self.launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1

    def load_sums(self, sums: dict[str, Any]) -> None:
        """Set the graph's sum buffers to the trainer's ``sums`` (0 where a
        key is missing; a host number from a resumed checkpoint filled in)."""
        for k, buf in self.sums.items():
            v = sums.get(k)
            if v is None:
                buf.zero_()
            elif isinstance(v, torch.Tensor):
                buf.copy_(v)
            else:
                buf.fill_(v)

    def store_sums(self, sums: dict[str, Any]) -> None:
        """Write the graph's sums back into the trainer's ``sums``."""
        for k, buf in self.sums.items():
            sums[k] = buf.clone()

    def replay(self, batch: Batch, seed: int) -> None:
        """One step on ``batch`` (shaped as the captured one) with the
        noise of a generator seeded ``seed``."""
        torch._foreach_copy_(list(self.static), list(batch))
        self.generator.manual_seed(seed)
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        if self.optimizer is not None:
            self.optimizer.advance_host_count()

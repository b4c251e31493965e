"""Host→device staging of the pipeline's items: pinned host buffers and a
copy stream, one item ahead (JAX's ``_device_prefetch``,
``data/pipeline.py:700-704``; its docstring calls ``jax.device_put``
double-buffering the replacement for pinned-memory prefetch, and this is
that pinned prefetch).

- **The ring.** :class:`Staging` allocates, on the consumer's thread, a few
  pinned host buffers for each item shape of a stream (``RING``), each a
  tuple of pinned tensors and their numpy views. The assembly thread takes
  a free buffer (:meth:`Staging.take`) and writes the item into its numpy
  views; it makes no CUDA call, so a CUDA graph captured on the consumer's
  thread meanwhile sees none.
- **The copy.** :func:`staged_items` issues each item's copy
  (``non_blocking`` from pinned memory) on the stream's own copy stream
  when the consumer asks for the item, after enqueueing the previous
  item's steps: the copy runs while the card works through those, one
  item ahead of the step that reads it. The consumer's stream waits on the
  copy's event, and each device tensor is marked used there
  (``record_stream``: the allocator made it on the copy stream). All of
  this runs between the consumer's steps, never inside a capture. (Issuing
  it before the previous item's steps would hold those steps back until
  the next item is assembled.)
- **The hand-back.** A buffer goes back to the ring only after its copy's
  event has completed, so the worker never refills a buffer the card is
  still reading.
- **Rows.** ``rows(n) → (lo, hi)`` moves only rows ``lo:hi`` of each
  batch of ``n`` (a mesh rank's); the items then carry ``(lo, hi, n)``.
- **Ends.** An exception of the assembly is raised after the items before
  it (the prefetch iterator raises it in order); closing the stream early
  stops and joins the worker before the ring is dropped, so no thread and
  no pinned buffer stays behind.
"""

from __future__ import annotations

import queue
import threading
from collections import Counter
from typing import Callable, Iterator

import numpy as np
import torch

Lead = tuple[int, ...]
# A buffer of the ring: pinned tensors and their numpy views.
Buffers = tuple[tuple[torch.Tensor, ...], tuple[np.ndarray, ...]]
RowsFn = Callable[[int], tuple[int, int]]
# Buffers a ring holds for one item shape: the prefetch queue's 2 items,
# the one the worker has assembled and not yet queued, the consumer's.
RING = 4


class Closed(Exception):
    """The stream was closed while the worker waited for a buffer."""


class Staging:
    """The pinned ring and the copy stream of one stream of items on
    ``device``: ``leads`` counts the items of each leading shape (``(K, B)``
    or ``(B,)``), ``frames`` gives each output's per-row shape and dtype."""

    def __init__(self, device: torch.device, leads: Counter,
                 frames: list[tuple[tuple, np.dtype]]):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.closed = threading.Event()
        self._free: dict[Lead, queue.Queue] = {}
        for lead, n in leads.items():
            ring = self._free[lead] = queue.Queue()
            for _ in range(min(n, RING)):
                pinned = tuple(torch.empty((*lead, *shape), dtype=_torch_dtype(dtype),
                                           pin_memory=True) for shape, dtype in frames)
                ring.put((pinned, tuple(t.numpy() for t in pinned)))

    def take(self, lead: Lead) -> Buffers:
        """A free buffer for an item of ``lead`` (the worker's thread: it
        waits for one, and raises :class:`Closed` once the stream closed)."""
        while True:
            if self.closed.is_set():
                raise Closed
            try:
                return self._free[lead].get(timeout=0.2)
            except queue.Empty:
                continue

    def upload(self, bufs: Buffers, rows: tuple[int, int] | None,
               scan: bool) -> tuple[tuple[torch.Tensor, ...], torch.cuda.Event]:
        """Issue the copy of ``bufs`` (rows ``lo:hi`` of each batch, where
        given) on the copy stream; its device tensors and its event."""
        with torch.cuda.stream(self.stream):
            out = tuple(self._copy(t, rows, scan) for t in bufs[0])
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def _copy(self, host: torch.Tensor, rows: tuple[int, int] | None,
              scan: bool) -> torch.Tensor:
        if rows is None or rows == (0, host.shape[1 if scan else 0]):
            return self._h2d(torch.empty(host.shape, dtype=host.dtype, device=self.device), host)
        lo, hi = rows
        if not scan:
            return self._copy(host[lo:hi], None, False)
        # A scan item's rows are strided over its K batches: a copy a batch,
        # each contiguous (a strided pinned source would be staged pageably).
        dev = torch.empty((host.shape[0], hi - lo, *host.shape[2:]), dtype=host.dtype,
                          device=self.device)
        for i in range(host.shape[0]):
            self._h2d(dev[i], host[i, lo:hi])
        return dev

    def _h2d(self, dev: torch.Tensor, host: torch.Tensor) -> torch.Tensor:
        """One asynchronous copy of a contiguous pinned ``host`` into ``dev``."""
        dev.copy_(host, non_blocking=True)
        return dev

    def hand_over(self, batch: tuple[torch.Tensor, ...], event: torch.cuda.Event) -> None:
        """Make the consumer's stream wait for ``batch``'s copy."""
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for x in batch:
            x.record_stream(compute)

    def give_back(self, lead: Lead, bufs: Buffers, event: torch.cuda.Event) -> None:
        """Return ``bufs`` to the ring once its copy has completed."""
        event.synchronize()
        self._free[lead].put(bufs)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def staged_items(items: Iterator[tuple[str, Lead, Buffers]], staging: Staging,
                 rows: RowsFn | None = None) -> Iterator[tuple]:
    """``(kind, batch)`` (``(kind, batch, (lo, hi, n))`` with ``rows``) on
    the card for each host item ``(kind, lead, buffers)`` of ``items`` (a
    prefetch iterator, whose worker fills the ring's buffers). Each item's
    copy is issued when the consumer comes back for it, that is once the
    previous item's steps are enqueued, so it runs while the card works
    through them; the consumer's stream waits on it, and the previous
    item's buffer goes back to the ring. Closing it closes ``staging`` and
    ``items``."""
    prev = None
    try:
        for kind, lead, bufs in items:
            span = None if rows is None else rows(lead[-1])
            batch, event = staging.upload(bufs, span, kind == "scan")
            if prev is not None:
                staging.give_back(*prev)
            prev = lead, bufs, event
            staging.hand_over(batch, event)
            yield (kind, batch) if rows is None else (kind, batch, (*span, lead[-1]))
        if prev is not None:
            staging.give_back(*prev)
    finally:
        staging.closed.set()
        staging.stream.synchronize()  # no copy outlives its buffer
        items.close()

"""The training loop (port of ``train/trainer.py``): ``Trainer(model,
datamodule, config, callbacks).fit()``.

Per epoch: the optimizer steps (:mod:`.steps`), validation on ``val/loss``,
the plateau LR scheduler (or another kind), early stopping, the ``best``
checkpoint (selected on ``val/loss``) and the ``last`` one, and a halt with
a ``diverged`` checkpoint when a metric goes non-finite. Metrics are
sample-weighted epoch means, summed on the device and read once an epoch.

As in the JAX trainer: ``accumulate_grad_batches`` steps on the mean of a
window's gradients; SIGTERM stops the run after the step in flight with
an exact-resume ``last`` checkpoint; ``fit(resume=..., resume_from=...)``
resumes mid-epoch or at an epoch boundary, or warm-starts from weights
alone; ``profile_epoch`` traces one epoch with ``torch.profiler``;
callbacks run after each epoch and at the end, with the ``best`` weights.
``use_wandb`` raises when set.

K-step dispatch (JAX ``trainer.py:97-98``, ``:315-328``, ``:455-523``):
with ``steps_per_dispatch`` K > 1 (``"auto"``: :meth:`Trainer._resolve_spd`)
and ``accumulate_grad_batches == 1``, an epoch trains from the datamodule's
chunked stream: each ``[K, B, ...]`` chunk, and each full batch left over,
goes to :func:`.steps.make_train_chunk`, which on the card replays one
captured CUDA graph of the step per batch (``train/graph.py``); a ragged
tail runs eagerly. Validation takes validation chunks the same way. The fit
equals the K=1 fit bit for bit. SIGTERM is polled once a chunk, so the
chunk in flight completes before the exact-resume checkpoint; its
``items_done`` counts batches at any K, and its aux records K (``spd``).

Data parallel (JAX ``trainer.py:180-257``): where a ``torch.distributed``
process group is up (``parallel.mesh.init_from_env``), the trainer builds
its mesh from ``dcn_size`` (``make_hybrid_mesh``: flat on one node unless
``dcn_size`` says otherwise) and shards the optimizer's moments over its
``data`` axis with ``zero1``. Each rank trains on its rows of every batch
(``parallel.mesh.mesh_rows``; the datamodule assembles the whole batch and
stages only those rows to the card), the noise drawn at the global batch
(``shared_step``'s ``rows``), the gradient summed over the ranks; the epoch's
sums are all-reduced once an epoch, so every rank takes the same scheduler,
early-stop, divergence and checkpoint decisions, and a SIGTERM on any rank
stops every rank after the same step. Rank 0 alone writes checkpoints,
metrics, charts and runs the callbacks. Unlike JAX, which trims its mesh to
the devices that divide the batch, a configured batch size the world does
not divide raises: a process group cannot shrink.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import signal
import time
import warnings
from pathlib import Path
from typing import Any, Iterable, Iterator

import torch
import torch.distributed as dist

from multimodal_mtrssm_tpu_torch.data.pipeline import EpisodeDataModule
from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.parallel.mesh import (
    Mesh,
    agree,
    barrier,
    make_hybrid_mesh,
    make_mesh,
    mesh_rows,
    replicate,
)
from multimodal_mtrssm_tpu_torch.train.checkpoint import CheckpointManager
from multimodal_mtrssm_tpu_torch.train.metrics import MetricLogger
from multimodal_mtrssm_tpu_torch.train.optim import (
    AdamW,
    EarlyStopping,
    make_scheduler,
    scheduler_from_state_dict,
    set_learning_rate,
)
from multimodal_mtrssm_tpu_torch.train.steps import (
    Batch,
    Rows,
    accumulate_metrics as _accumulate,
    apply_accumulated,
    fold,
    make_grad_step,
    make_train_chunk,
    make_train_step,
    make_val_chunk,
)

# Auto steps-per-dispatch sizing, JAX's constants (``trainer.py:97-98``):
# chunks up to 1 GB, K up to 256.
SPD_CHUNK_BUDGET_BYTES = 1 << 30
SPD_MAX_STEPS = 256
# An epoch-boundary resume reseeds its noise at seed + epoch · 9973, as JAX
# (``trainer.py:433-434``).
_RESEED = 9973


class _PreemptionGuard:
    """SIGTERM sets ``flagged``, and nothing clears it; the fit loop polls
    after each batch (:meth:`poll`) and saves an exact-resume ``last``
    checkpoint once ``stop`` is set. ``stop`` is the flag agreed over the
    ranks, latched: every branch of the loop reads it, never the raw flag,
    so a signal that lands between two polls, or while a rank waits in
    one, stops every rank at the same poll. The previous handler is
    restored on exit; off the main thread (where no handler can be
    installed) the guard does nothing."""

    def __init__(self):
        self.flagged = False
        self.stop = False
        self._prev = None
        # signal.signal returns None both on failure and for a handler set
        # outside Python, so whether one was installed is kept apart.
        self._installed = False

    def poll(self, mesh: Mesh | None) -> bool:
        """Whether a SIGTERM has reached any rank by this poll, the same on
        every rank (``agree``); once True it stays True."""
        self.stop = self.stop or agree(self.flagged, mesh)
        return self.stop

    def __enter__(self) -> "_PreemptionGuard":
        def handler(signum, frame):
            self.flagged = True

        try:
            self._prev = signal.signal(signal.SIGTERM, handler)
            self._installed = True
        except ValueError:  # not the main thread
            self._installed = False
        return self

    def __exit__(self, *exc) -> bool:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev if self._prev is not None else signal.SIG_DFL)
        return False


@dataclasses.dataclass
class TrainerConfig:
    """Trainer hyperparameters: the JAX ``TrainerConfig``'s fields and defaults.

    ``steps_per_dispatch``: ``"auto"`` or an integer K. K > 1 trains from
    ``[K, B, ...]`` chunks, each step a replay of one captured CUDA graph on
    the card (eager steps on the CPU, and where a graph cannot be captured),
    bit for bit the K=1 fit; ``"auto"`` sizes K as JAX does (chunks up to
    1 GB, K up to 256 and to the epoch's full batches). JAX scans K steps in
    one dispatch to amortise a TPU's dispatch round trip; the graph saves
    the card the eager step's hundreds of launches from the host."""

    max_epochs: int = 100
    seed: int = 42
    learning_rate: float = 1e-3
    grad_clip: float = 10.0
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    plateau_factor: float = 0.5
    plateau_patience: int = 50
    plateau_min_lr: float = 0.0
    plateau_threshold: float = 1e-4
    early_stop_patience: int = 200
    early_stop_min_delta: float = 0.0
    log_dir: str = "runs/default"
    use_wandb: bool = False
    wandb_project: str | None = None
    profile_epoch: int | None = None
    checkpoint_every_n_epochs: int = 10
    lr_scheduler: dict | None = None
    accumulate_grad_batches: int = 1
    zero1: bool = False
    dcn_size: int | None = None
    steps_per_dispatch: int | str = "auto"
    halt_on_non_finite: bool = True

    def __post_init__(self):
        if self.use_wandb:
            raise ValueError("TrainerConfig fields not supported by the port yet: ['use_wandb']")
        if self.dcn_size is not None and int(self.dcn_size) < 1:
            raise ValueError(f"dcn_size must be >= 1, got {self.dcn_size}")
        if int(self.accumulate_grad_batches) < 1:
            raise ValueError(f"accumulate_grad_batches must be >= 1, got "
                             f"{self.accumulate_grad_batches}")
        spd = self.steps_per_dispatch
        if spd != "auto" and (isinstance(spd, str) or int(spd) < 1):
            raise ValueError(f"steps_per_dispatch must be 'auto' or an integer >= 1, got {spd!r}")


@dataclasses.dataclass
class _EpochProgress:
    """An epoch's training so far, as a mid-epoch checkpoint keeps it: the
    sample-weighted metric sums (on the device), the episodes trained,
    the batches applied and the batches of a window not yet applied."""

    sums: dict[str, Any] = dataclasses.field(default_factory=dict)
    n_train: int = 0
    items_done: int = 0
    window: int = 0

    @classmethod
    def resumed(cls, aux: dict[str, Any], accum: int) -> "_EpochProgress":
        """The progress a mid-epoch checkpoint's ``aux`` saved. Its stream
        positions hold only under the accumulation it was saved with."""
        saved = int(aux.get("accum", accum))
        if saved != accum:
            raise ValueError(f"mid-epoch resume checkpoint was saved with accumulate_grad_batches="
                             f"{saved} but the trainer is configured with {accum}; resume with "
                             "the original value (the stream's skip offset holds only under it)")
        return cls(sums=dict(aux.get("partial_metrics", {})),
                   n_train=int(aux.get("n_train_eps", 0)), items_done=int(aux["items_done"]))

    def aux(self, accum: int, spd: int) -> dict[str, Any]:
        """The mid-epoch checkpoint's fields beside ``last``'s."""
        return {"mid_epoch": True, "items_done": self.items_done, "accum": accum, "spd": spd,
                "n_train_eps": self.n_train,
                "partial_metrics": {k: float(v) for k, v in self.sums.items()}}


class Trainer:
    """Epoch-driven trainer for any family (``MoPoEMRSSM``,
    ``WeightedMoPoEMRSSM``, ``MoPoEMMTRSSM``, the unimodal ``RSSM`` on
    4-tuple batches), on the device its parameters are on (CUDA: the
    family's kernels; CPU: their plain versions). It calls only
    the model's ``init``, ``shared_step``, ``parameters`` and
    ``state_dict``, and logs every metric ``shared_step`` returns.

    ``callbacks``: each is called ``cb(trainer, epoch, model, row)`` after
    every epoch (JAX passes the parameters; the port's live in the model),
    and, where it has one, ``cb.on_train_end(trainer, best_model)`` once
    at the end, with the ``best`` weights. During ``fit`` they may log to
    ``trainer.logger``, the run's :class:`MetricLogger`."""

    def __init__(self, model: WorldModelNet, datamodule: EpisodeDataModule,
                 config: TrainerConfig | None = None, callbacks: list | None = None):
        self.model = model
        self.dm = datamodule
        self.cfg = config or TrainerConfig()
        self.callbacks = list(callbacks or [])
        self.device = next(model.parameters()).device
        self.mesh: Mesh | None = _trainer_mesh(self.cfg)
        self.rank0 = self.mesh is None or self.mesh.rank == 0
        self._check_batches()
        self.ckpt = CheckpointManager(Path(self.cfg.log_dir) / "checkpoints", create=self.rank0)
        self.logger: MetricLogger | None = None

    def _optimizer(self) -> AdamW:
        c = self.cfg
        return AdamW(self.model.parameters(), c.learning_rate, c.grad_clip, c.weight_decay,
                     c.adam_b1, c.adam_b2, c.adam_eps, mesh=self.mesh, zero1=c.zero1)

    def _say(self, text: str) -> None:
        if self.rank0:
            print(text)

    def _check_batches(self) -> None:
        """Raise where the world does not divide the configured batch size
        (JAX trims its mesh instead; a process group cannot shrink). A
        ragged tail, or a split smaller than a batch, splits unevenly over
        the ranks and stays exact (``shared_step``'s ``rows``)."""
        if self.mesh is None:
            return
        bs, world = self.dm.cfg.batch_size, self.mesh.world
        if bs % world:
            fits = max(w for w in range(1, world + 1) if bs % w == 0)
            raise ValueError(f"batch size {bs} is not divisible by the world size {world}; the "
                             f"largest world that divides it is {fits}")

    def _rows(self, n: int) -> tuple[int, int]:
        """This rank's rows of a batch of ``n`` (all of them on one process):
        the rows the datamodule moves to the card."""
        return mesh_rows(n, self.mesh)

    def _items(self, items: Iterable[tuple]) -> Iterator[tuple[Batch, Rows | None, int]]:
        """The datamodule's items of this rank's rows (``rows=self._rows``)
        as ``(chunk, rows, b)``: a ``[K, b, ...]`` chunk (a step item's
        batch with K=1), its rows ``(lo, hi, n)`` of the global batch (None
        on one process) and their count."""
        for kind, batch, (lo, hi, n) in items:
            chunk = batch if kind == "scan" else tuple(x[None] for x in batch)
            yield chunk, (None if self.mesh is None else (lo, hi, n)), hi - lo

    def _resolve_spd(self) -> int:
        """Steps per dispatch (JAX ``Trainer._resolve_spd``): an integer as
        given; ``"auto"`` the most batches whose chunk stays within
        ``SPD_CHUNK_BUDGET_BYTES``, at most ``SPD_MAX_STEPS`` and the
        epoch's full batches (a chunk that cannot fill would never run)."""
        spd = self.cfg.steps_per_dispatch
        if spd != "auto":
            return max(1, int(spd))
        bs = self.dm.train_batch_size
        n_full = self.dm.n_train // max(bs, 1)
        by_mem = SPD_CHUNK_BUDGET_BYTES // max(1, self.dm.batch_nbytes(bs))
        return max(1, min(SPD_MAX_STEPS, by_mem, n_full))

    def _reduce(self, sums: dict[str, Any], n: int) -> tuple[dict[str, float], int]:
        """Sample-weighted sums and their row count over every rank (one
        all-reduce, in float64), as host numbers. The keys are rank 0's,
        which holds rows of every batch that any rank does."""
        if self.mesh is None:
            return {k: float(v) for k, v in sums.items()}, n
        keys = [list(sums)]
        dist.broadcast_object_list(keys, src=0, group=self.mesh.host_group)
        vec = torch.tensor([0.0] * (len(keys[0]) + 1), dtype=torch.float64, device=self.device)
        for i, k in enumerate(keys[0]):
            if k in sums:
                vec[i] = torch.as_tensor(sums[k], device=self.device).double()
        vec[-1] = float(n)
        dist.all_reduce(vec)
        out = vec.tolist()
        return dict(zip(keys[0], out[:-1])), int(round(out[-1]))

    def _save(self, name: str, model: WorldModelNet, optimizer: AdamW | None,
              aux: dict) -> None:
        """A checkpoint written by rank 0: the moments are gathered on every
        rank first (ZeRO-1), the other ranks wait for the write."""
        state = optimizer.state_dict() if optimizer is not None else None
        if self.rank0:
            self.ckpt.save(name, model, state, aux)
        barrier(self.mesh)

    def _resume_source(self, resume: bool,
                       resume_from: str | Path | None) -> tuple[CheckpointManager, str] | None:
        """The checkpoint to start from: ``resume_from`` (a checkpoints
        directory, ``last`` preferred over ``best``, or one checkpoint's
        ``.ckpt`` path or name), else this run's ``last`` with ``resume``."""
        if resume_from is not None:
            p = Path(resume_from)
            if p.is_dir():
                mgr = CheckpointManager(p)
                if mgr.exists("last") or mgr.exists("best"):
                    return mgr, "last" if mgr.exists("last") else "best"
                raise FileNotFoundError(f"no 'last' or 'best' checkpoint under {p}")
            name = p.name[:-len(".ckpt")] if p.name.endswith(".ckpt") else p.name
            mgr = CheckpointManager(p.parent)
            if not mgr.exists(name):
                raise FileNotFoundError(f"resume_from checkpoint not found: {p}")
            return mgr, name
        if resume and self.ckpt.exists("last"):
            return self.ckpt, "last"
        return None

    @contextlib.contextmanager
    def _profile(self, epoch: int) -> Iterator[None]:
        """Trace epoch ``profile_epoch`` with ``torch.profiler`` (the card's
        kernels too, on CUDA) into ``<log_dir>/profile``."""
        if self.cfg.profile_epoch is None or epoch != self.cfg.profile_epoch or not self.rank0:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        out = Path(self.cfg.log_dir) / "profile"
        out.mkdir(parents=True, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        path = out / f"epoch_{epoch}.trace.json"
        prof.export_chrome_trace(str(path))
        print(f"profile: epoch {epoch} traced into {path}")

    def fit(self, resume: bool = False, resume_from: str | Path | None = None) -> dict[str, Any]:
        """Train from the seed's initial weights. ``resume=True`` continues
        from this run's ``last`` checkpoint (from scratch when there is
        none); ``resume_from`` takes any checkpoints directory or
        checkpoint (:meth:`_resume_source`). A full-state checkpoint
        resumes exactly, mid-epoch too; a weights-only one, or a full one
        whose optimizer state does not fit, warm-starts the weights with a
        fresh optimizer and scheduler from epoch 0 (the reason printed).

        Returns JAX ``Trainer.fit``'s keys: ``params`` (the model's
        ``state_dict``: the port's parameters live in the model),
        ``opt_state`` (the optimizer's ``state_dict``), ``history`` (one row
        per epoch), ``best_val`` and ``preempted`` (a SIGTERM stopped the
        run; ``resume=True`` continues it); and beside them ``global_step``
        (batches trained) and ``train_seconds`` (wall time of the training
        loops, validation excluded)."""
        cfg, model = self.cfg, self.model
        replicate(model.init(torch.Generator().manual_seed(cfg.seed)), self.mesh)
        optimizer = self._optimizer()
        scheduler = make_scheduler(cfg.lr_scheduler or {
            "kind": "plateau", "factor": cfg.plateau_factor, "patience": cfg.plateau_patience,
            "min_lr": cfg.plateau_min_lr, "threshold": cfg.plateau_threshold,
        }, cfg.learning_rate)
        early_stop = EarlyStopping(cfg.early_stop_patience, min_delta=cfg.early_stop_min_delta)
        seed_base, start_epoch, global_step = cfg.seed, 0, 0
        best_val, resume_mid = float("inf"), None
        src = self._resume_source(resume, resume_from)
        if src is not None:
            mgr, name = src
            try:
                aux = mgr.restore(name, model, optimizer)
                has_full = "scheduler" in aux
            except Exception as exc:  # noqa: BLE001 — any failed restore is reported
                if resume_from is None:
                    raise
                self._say(f"full-state restore failed ({type(exc).__name__}: {exc}); falling "
                          "back to a params-only warm start")
                aux = mgr.restore_params(name, model)
                has_full = False
            if not has_full:
                optimizer = self._optimizer()
                self._say(f"warm start: weights from {mgr.path(name)}")
            else:
                scheduler = scheduler_from_state_dict(aux["scheduler"])
                early_stop = EarlyStopping.from_state_dict(aux["early_stop"])
                if aux.get("mid_epoch"):
                    # Continue the interrupted epoch after its last applied
                    # step, on the interrupted run's noise basis.
                    start_epoch, resume_mid = aux["epoch"], aux
                    seed_base = int(aux.get("seed_base", cfg.seed))
                else:
                    start_epoch = aux["epoch"] + 1
                    seed_base = cfg.seed + start_epoch * _RESEED
                best_val = aux.get("best_val", float("inf"))
                global_step = int(aux.get("global_step", 0))

        train_step = make_train_step(model, optimizer)
        grad_step = make_grad_step(model)
        accum = cfg.accumulate_grad_batches
        spd = self._resolve_spd()
        # The fit's (train, validation) chunk steps; no train chunk at K=1 or
        # with accumulation, which train batch by batch.
        chunks = self.chunk_steps = (
            make_train_chunk(model, optimizer, train_step) if spd > 1 and accum == 1 else None,
            make_val_chunk(model, self.mesh, capture=spd > 1))
        history: list[dict[str, float]] = []
        train_seconds = 0.0

        def save_last(epoch_: int, step_: int, name: str = "last", **extra) -> None:
            """Every full-state save (``last``, mid-epoch, ``diverged``)
            writes this one aux shape, which the resume path reads."""
            self._save(name, model, optimizer, {
                "epoch": epoch_, "global_step": step_, "best_val": best_val,
                "seed_base": seed_base, "scheduler": scheduler.state_dict(),
                "early_stop": early_stop.state_dict(), **extra})

        logger = self.logger = MetricLogger(cfg.log_dir) if self.rank0 else None
        preempt = _PreemptionGuard()
        try:
            with preempt:
                for epoch in range(start_epoch, cfg.max_epochs):
                    with self._profile(epoch):
                        epoch_seed = fold(seed_base, epoch)
                        t0 = time.perf_counter()
                        if resume_mid is not None:
                            prog = _EpochProgress.resumed(resume_mid, accum)
                            resume_mid = None
                            if not self.rank0:  # rank 0 carries the saved global sums
                                prog.sums, prog.n_train = {}, 0
                        else:
                            prog = _EpochProgress()
                        model.train()
                        global_step = self._train_epoch(epoch, epoch_seed, global_step, prog,
                                                        train_step, grad_step, optimizer,
                                                        preempt, spd, chunks[0])
                        if preempt.stop:
                            # After the last applied step: a partial window is dropped.
                            optimizer.zero_grad()
                            prog.sums, prog.n_train = self._reduce(prog.sums, prog.n_train)
                            save_last(epoch, global_step - prog.window, **prog.aux(accum, spd))
                            self._say(f"preemption: saved a mid-epoch resume checkpoint (epoch "
                                      f"{epoch}, {prog.items_done} batches applied), stopping")
                            break
                        sums, n_train = self._reduce(prog.sums, prog.n_train)
                        row = {f"train/{k}": v / max(n_train, 1) for k, v in sums.items()}
                        epoch_time = time.perf_counter() - t0  # float() waited for the device
                        train_seconds += epoch_time
                        row.update(self._validate(epoch_seed, chunks[1], spd))
                        row.update({"epoch": epoch, "lr": scheduler.lr,
                                    "seq_per_sec": n_train / max(epoch_time, 1e-9)})
                        if logger is not None:
                            logger.log(row, step=epoch)
                        history.append(row)

                        bad = [k for k, v in row.items()
                               if k.startswith(("train/", "val/")) and not math.isfinite(v)]
                        if cfg.halt_on_non_finite and bad:
                            save_last(epoch, global_step, name="diverged", non_finite=bad)
                            advice = ("resume from 'last' with a lower learning rate"
                                      if self.ckpt.exists("last") else
                                      "restart with a lower learning rate (no 'last' "
                                      "checkpoint exists yet)")
                            self._say(f"divergence: non-finite metrics {bad} at epoch {epoch}; "
                                      f"saved 'diverged' and halting; {advice}")
                            break
                        monitored = row.get("val/loss", row.get("train/loss", float("inf")))
                        set_learning_rate(optimizer, scheduler.step(monitored))
                        if monitored < best_val:
                            best_val = monitored
                            self._save("best", model, None,
                                       {"epoch": epoch, "val_loss": monitored})
                        if ((epoch + 1) % cfg.checkpoint_every_n_epochs == 0
                                or epoch == cfg.max_epochs - 1):
                            save_last(epoch, global_step)
                        for cb in self.callbacks if self.rank0 else ():
                            cb(self, epoch, model, row)
                        if early_stop.step(monitored):
                            save_last(epoch, global_step)
                            break
                        if preempt.poll(self.mesh):
                            # SIGTERM during validation or the callbacks: the epoch
                            # is whole, so resume at the next one.
                            save_last(epoch, global_step)
                            self._say(f"preemption: saved a resume checkpoint after epoch {epoch}, "
                                      "stopping")
                            break
            for cb in self.callbacks if self.rank0 else ():
                hook = getattr(cb, "on_train_end", None)
                if hook is not None:
                    hook(self, self.load_best_params(model))
            if logger is not None:
                _render_charts(logger)
        finally:
            if logger is not None:
                logger.close()
        return {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                "history": history, "best_val": best_val, "preempted": preempt.stop,
                "global_step": global_step, "train_seconds": train_seconds}

    def _train_epoch(self, epoch: int, seed: int, step: int, prog: _EpochProgress,
                     train_step, grad_step, optimizer: AdamW,
                     preempt: _PreemptionGuard, spd: int = 1, train_chunk=None) -> int:
        """Train epoch ``epoch`` on from ``prog`` (the batches it has
        applied are skipped) to its end or a SIGTERM, with the noise of
        ``fold(seed, step)`` at each batch's global step; updates ``prog``
        and returns the global step after it. With a chunk step
        (``train_chunk``: K > 1 and no accumulation) it trains from the
        chunked stream, polling for SIGTERM once an item."""
        accum = self.cfg.accumulate_grad_batches
        if train_chunk is not None:
            full = self.dm.train_batch_size
            for chunk, rows, n in self._items(self.dm.train_batches_chunked(
                    epoch, spd, self.device, skip=prog.items_done, rows=self._rows)):
                k = chunk[0].shape[0]
                if (rows[2] if rows else n) == full:
                    train_chunk(chunk, seed, step, prog.sums, rows)
                else:  # the ragged tail
                    _accumulate(prog.sums, train_step(tuple(x[0] for x in chunk), seed, step,
                                                      rows), n)
                prog.n_train += n * k
                step += k
                prog.items_done += k
                if preempt.poll(self.mesh):
                    break
            return step
        batches = ((batch, None if self.mesh is None else rows, rows[1] - rows[0])
                   for batch, rows in self.dm.train_batches(epoch, self.device,
                                                            prog.items_done, self._rows))
        if accum == 1:
            for batch, rows, k in batches:
                _accumulate(prog.sums, train_step(batch, seed, step, rows), k)
                prog.n_train += k
                step += 1
                prog.items_done += 1
                if preempt.poll(self.mesh):
                    break
            return step
        # A window's metrics count once its step applies, so a preempted
        # partial window is replayed, not counted twice.
        window: list[tuple[dict, int]] = []
        for batch, rows, k in batches:
            window.append((grad_step(batch, seed, step, rows), k))
            step += 1
            if len(window) == accum:
                _apply_window(optimizer, window, prog)
                window = []
            if preempt.poll(self.mesh):
                break
        if window and not preempt.stop:
            # The epoch's leftover window steps too (Lightning).
            _apply_window(optimizer, window, prog)
            window = []
        prog.window = len(window)
        return step

    @torch.no_grad()
    def _validate(self, seed: int, val_chunk, spd: int = 1) -> dict[str, float]:
        """The ``val/`` means of the validation batches, batch i's noise from
        ``fold(seed, 0x5EED, i)`` (drawn at the global batch on a mesh),
        through ``val_chunk`` (:func:`.steps.make_val_chunk`) from the
        validation chunks of ``spd`` batches, a ragged tail eagerly."""
        self.model.eval()
        sums: dict[str, Any] = {}
        n, i, full = 0, 0, self.dm.val_batch_size
        for chunk, rows, k in self._items(self.dm.val_batches_chunked(spd, self.device,
                                                                      self._rows)):
            val_chunk(chunk, seed, i, sums, rows, eager=(rows[2] if rows else k) != full)
            n += k * chunk[0].shape[0]
            i += chunk[0].shape[0]
        sums, n = self._reduce(sums, n)
        return {f"val/{k}": v / max(n, 1) for k, v in sums.items()}

    def load_best_params(self, model: WorldModelNet) -> WorldModelNet:
        """A copy of ``model`` holding the ``best`` checkpoint's weights
        (reference ``load_best_model_checkpoint``), or ``model`` itself
        where ``best`` cannot be loaded."""
        try:
            best = copy.deepcopy(model)
            self.ckpt.restore_params("best", best)
            return best
        except (OSError, RuntimeError, ValueError, KeyError):
            return model


def _trainer_mesh(cfg: TrainerConfig) -> Mesh | None:
    """The trainer's mesh over the process group, None without one. As
    JAX's trainer does, ``dcn_size`` above the device (here rank) count
    warns and trains on a flat mesh, and a detected node layout that a
    hybrid mesh cannot take falls back to a flat one; an explicit
    ``dcn_size`` that does not divide the world raises."""
    dcn = cfg.dcn_size
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if dcn is not None and world < dcn:
        warnings.warn(f"dcn_size={dcn} exceeds the {world} rank(s); training on a flat data "
                      "mesh", stacklevel=3)
        dcn = None
    if not initialized:
        return None
    if dcn is not None:
        mesh = make_hybrid_mesh(dcn)
    else:
        try:
            mesh = make_hybrid_mesh(None)
        except ValueError as exc:
            warnings.warn(f"{exc}; using a flat data mesh instead of a hybrid (dcn, data) "
                          "mesh", stacklevel=3)
            mesh = make_mesh()
    if mesh.rank == 0:
        print("trainer mesh: " + " × ".join(f"{n} {a}" for a, n in mesh.shape.items()))
    return mesh


def _apply_window(optimizer: AdamW, window: list[tuple[dict, int]],
                  prog: _EpochProgress) -> None:
    """Step on an accumulation window's mean gradient and count its
    buffered metrics, episodes and batches."""
    apply_accumulated(optimizer, len(window))
    for metrics, n in window:
        _accumulate(prog.sums, metrics, n)
        prog.n_train += n
    prog.items_done += len(window)


def _render_charts(logger: MetricLogger) -> None:
    """The combined train/val charts of the run's metrics (``viz.charts``),
    each PNG's path logged. A chart that cannot be drawn never fails a run:
    one line says why."""
    try:
        from multimodal_mtrssm_tpu_torch.viz.charts import render_combined_charts

        pngs = render_combined_charts(logger.path)
    except Exception as exc:  # noqa: BLE001 — any failure only costs the charts
        print(f"charts: none drawn ({type(exc).__name__}: {exc})")
        return
    for png in pngs:
        logger.log_image(f"charts/{png.stem}", png)


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
An integer ``steps_per_dispatch`` is accepted and trains batch by batch
(:class:`TrainerConfig`). ``zero1``, ``dcn_size`` and ``use_wandb`` raise when set.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import signal
import time
from pathlib import Path
from typing import Any, Iterator

import torch

from multimodal_mtrssm_tpu_torch.data.pipeline import EpisodeDataModule
from multimodal_mtrssm_tpu_torch.models import WorldModelNet
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
    apply_accumulated,
    fold,
    make_grad_step,
    make_train_step,
)

# Path element of the validation noise seeds (the JAX trainer folds 0x5EED).
_VAL = 0x5EED
# An epoch-boundary resume reseeds its noise at seed + epoch · 9973, as JAX
# (``trainer.py:433-434``).
_RESEED = 9973


class _PreemptionGuard:
    """SIGTERM sets ``flagged``; the fit loop polls it after each batch
    and saves an exact-resume ``last`` checkpoint. The previous
    handler is restored on exit; off the main thread (where no handler can
    be installed) the guard does nothing."""

    def __init__(self):
        self.flagged = False
        self._prev = None
        # signal.signal returns None both on failure and for a handler set
        # outside Python, so whether one was installed is kept apart.
        self._installed = False

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

    ``steps_per_dispatch``: ``"auto"`` or an integer K, accepted so a
    YAML that sets it loads, but every value trains batch by batch. JAX
    scans K steps in one dispatch (its auto K: chunks up to 1 GB, K up to
    256) to amortise a TPU's dispatch round trip; in eager PyTorch a
    K-batch chunk would still be K separate updates, so K would change no
    work. Chunks return with a graphed K-step update."""

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
        unsupported = {"zero1": self.zero1, "dcn_size": self.dcn_size is not None,
                       "use_wandb": self.use_wandb}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"TrainerConfig fields not supported by the port yet: {bad}")
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

    def aux(self, accum: int) -> dict[str, Any]:
        """The mid-epoch checkpoint's fields beside ``last``'s."""
        return {"mid_epoch": True, "items_done": self.items_done, "accum": accum, "n_train_eps": self.n_train,
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
        self.ckpt = CheckpointManager(Path(self.cfg.log_dir) / "checkpoints")
        self.logger: MetricLogger | None = None

    def _optimizer(self) -> AdamW:
        c = self.cfg
        return AdamW(self.model.parameters(), c.learning_rate, c.grad_clip, c.weight_decay,
                     c.adam_b1, c.adam_b2, c.adam_eps)

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
        if self.cfg.profile_epoch is None or epoch != self.cfg.profile_epoch:
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
        model.init(torch.Generator().manual_seed(cfg.seed))
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
                print(f"full-state restore failed ({type(exc).__name__}: {exc}); falling back "
                      "to a params-only warm start")
                aux = mgr.restore_params(name, model)
                has_full = False
            if not has_full:
                optimizer = self._optimizer()
                print(f"warm start: weights from {mgr.path(name)}")
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
        val_gen = torch.Generator(device=self.device)
        history: list[dict[str, float]] = []
        train_seconds = 0.0

        def save_last(epoch_: int, step_: int, name: str = "last", **extra) -> None:
            """Every full-state save (``last``, mid-epoch, ``diverged``)
            writes this one aux shape, which the resume path reads."""
            self.ckpt.save(name, model, optimizer, {
                "epoch": epoch_, "global_step": step_, "best_val": best_val,
                "seed_base": seed_base, "scheduler": scheduler.state_dict(),
                "early_stop": early_stop.state_dict(), **extra})

        logger = self.logger = MetricLogger(cfg.log_dir)
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
                        else:
                            prog = _EpochProgress()
                        model.train()
                        global_step = self._train_epoch(epoch, epoch_seed, global_step, prog,
                                                        train_step, grad_step, optimizer,
                                                        preempt)
                        if preempt.flagged:
                            # After the last applied step: a partial window is dropped.
                            optimizer.zero_grad()
                            save_last(epoch, global_step - prog.window, **prog.aux(accum))
                            print(f"preemption: saved a mid-epoch resume checkpoint (epoch "
                                  f"{epoch}, {prog.items_done} batches applied), stopping")
                            break
                        row = {f"train/{k}": float(v) / max(prog.n_train, 1)
                               for k, v in prog.sums.items()}
                        epoch_time = time.perf_counter() - t0  # float() waited for the device
                        train_seconds += epoch_time
                        row.update(self._validate(epoch_seed, val_gen))
                        row.update({"epoch": epoch, "lr": scheduler.lr,
                                    "seq_per_sec": prog.n_train / max(epoch_time, 1e-9)})
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
                            print(f"divergence: non-finite metrics {bad} at epoch {epoch}; "
                                  f"saved 'diverged' and halting; {advice}")
                            break
                        monitored = row.get("val/loss", row.get("train/loss", float("inf")))
                        set_learning_rate(optimizer, scheduler.step(monitored))
                        if monitored < best_val:
                            best_val = monitored
                            self.ckpt.save("best", model,
                                           aux={"epoch": epoch, "val_loss": monitored})
                        if ((epoch + 1) % cfg.checkpoint_every_n_epochs == 0
                                or epoch == cfg.max_epochs - 1):
                            save_last(epoch, global_step)
                        for cb in self.callbacks:
                            cb(self, epoch, model, row)
                        if early_stop.step(monitored):
                            save_last(epoch, global_step)
                            break
                        if preempt.flagged:
                            # SIGTERM during validation or the callbacks: the epoch
                            # is whole, so resume at the next one.
                            save_last(epoch, global_step)
                            print(f"preemption: saved a resume checkpoint after epoch {epoch}, "
                                  "stopping")
                            break
            for cb in self.callbacks:
                hook = getattr(cb, "on_train_end", None)
                if hook is not None:
                    hook(self, self.load_best_params(model))
            _render_charts(logger)
        finally:
            logger.close()
        return {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                "history": history, "best_val": best_val, "preempted": preempt.flagged,
                "global_step": global_step, "train_seconds": train_seconds}

    def _train_epoch(self, epoch: int, seed: int, step: int, prog: _EpochProgress,
                     train_step, grad_step, optimizer: AdamW,
                     preempt: _PreemptionGuard) -> int:
        """Train epoch ``epoch`` on from ``prog`` (the batches it has
        applied are skipped) to its end or a SIGTERM, with the noise of
        ``fold(seed, step)`` at each batch's global step; updates ``prog``
        and returns the global step after it."""
        accum = self.cfg.accumulate_grad_batches
        skip = prog.items_done
        if accum == 1:
            for batch in self.dm.train_batches(epoch, self.device, skip=skip):
                _accumulate(prog.sums, train_step(batch, seed, step), batch[0].shape[0])
                prog.n_train += batch[0].shape[0]
                step += 1
                prog.items_done += 1
                if preempt.flagged:
                    break
            return step
        # A window's metrics count once its step applies, so a preempted
        # partial window is replayed, not counted twice.
        window: list[tuple[dict, int]] = []
        for batch in self.dm.train_batches(epoch, self.device, skip=skip):
            window.append((grad_step(batch, seed, step), batch[0].shape[0]))
            step += 1
            if len(window) == accum:
                _apply_window(optimizer, window, prog)
                window = []
            if preempt.flagged:
                break
        if window and not preempt.flagged:
            # The epoch's leftover window steps too (Lightning).
            _apply_window(optimizer, window, prog)
            window = []
        prog.window = len(window)
        return step

    @torch.no_grad()
    def _validate(self, seed: int, generator: torch.Generator) -> dict[str, float]:
        """The ``val/`` means of the validation batches, batch i's noise from
        ``fold(seed, 0x5EED, i)``."""
        self.model.eval()
        sums: dict[str, Any] = {}
        n = 0
        for i, batch in enumerate(self.dm.val_batches(self.device)):
            generator.manual_seed(fold(seed, _VAL, i))
            _accumulate(sums, self.model.shared_step(batch, generator=generator),
                        batch[0].shape[0])
            n += batch[0].shape[0]
        return {f"val/{k}": float(v) / max(n, 1) for k, v in sums.items()}

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


def _accumulate(acc: dict[str, Any], metrics: dict[str, torch.Tensor], weight: int) -> None:
    """Add ``weight · metric`` on the device; the host reads once an epoch."""
    for k, v in metrics.items():
        acc[k] = acc.get(k, 0.0) + weight * v.detach()


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


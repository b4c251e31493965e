"""The training loop (port of ``train/trainer.py``): ``Trainer(model,
datamodule, config).fit()``.

Per epoch: one optimizer step per batch (:mod:`.steps`), validation on
``val/loss``, the plateau LR scheduler (or another kind), early stopping,
the ``best`` checkpoint (selected on ``val/loss``) and the ``last`` one,
and a halt with a ``diverged`` checkpoint when a metric goes non-finite.
Metrics are sample-weighted epoch means, summed on the device and read
once an epoch.

Fields of the JAX ``TrainerConfig`` that this slice does not support raise
when set to anything but their default: ``zero1``, ``dcn_size``,
``accumulate_grad_batches > 1``, an integer ``steps_per_dispatch`` above 1,
``profile_epoch`` and ``use_wandb``; so does ``fit(resume=...)``.
``steps_per_dispatch="auto"`` is the per-step loop, which the JAX package
pins as numerically identical to its K-step scan (``trainer.py:145-151``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Any

import torch

from multimodal_mtrssm_tpu_torch.data.pipeline import EpisodeDataModule
from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.train.checkpoint import CheckpointManager
from multimodal_mtrssm_tpu_torch.train.metrics import MetricLogger
from multimodal_mtrssm_tpu_torch.train.optim import (
    AdamW,
    EarlyStopping,
    make_scheduler,
    set_learning_rate,
)
from multimodal_mtrssm_tpu_torch.train.steps import fold, make_train_step

# Path element of the validation noise seeds (the JAX trainer folds 0x5EED).
_VAL = 0x5EED


@dataclasses.dataclass
class TrainerConfig:
    """Trainer hyperparameters: the JAX ``TrainerConfig``'s fields and defaults."""

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
        unsupported = {
            "zero1": self.zero1,
            "dcn_size": self.dcn_size is not None,
            "accumulate_grad_batches": self.accumulate_grad_batches != 1,
            "steps_per_dispatch": self.steps_per_dispatch not in ("auto", 1),
            "profile_epoch": self.profile_epoch is not None,
            "use_wandb": self.use_wandb,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"TrainerConfig fields not supported by the port yet: {bad}")


class Trainer:
    """Epoch-driven trainer for either family, ``MoPoEMRSSM`` or
    ``MoPoEMMTRSSM``, on the device its parameters are on (CUDA: the
    family's recurrence kernels; CPU: their plain versions). It calls only
    the model's ``init``, ``shared_step``, ``parameters`` and
    ``state_dict``, and logs every metric ``shared_step`` returns."""

    def __init__(self, model: WorldModelNet, datamodule: EpisodeDataModule,
                 config: TrainerConfig | None = None):
        self.model = model
        self.dm = datamodule
        self.cfg = config or TrainerConfig()
        self.device = next(model.parameters()).device
        self.ckpt = CheckpointManager(Path(self.cfg.log_dir) / "checkpoints")

    def fit(self, resume: bool = False, resume_from: str | Path | None = None) -> dict[str, Any]:
        """Train from the seed's initial weights. Returns JAX ``Trainer.fit``'s
        keys: ``params`` (the model's ``state_dict``: the port's parameters
        live in the model), ``opt_state`` (the optimizer's ``state_dict``),
        ``history`` (one row per epoch), ``best_val`` and ``preempted``
        (always False: the port has no preemption handling until resume
        lands); and beside them ``global_step`` (optimizer steps) and
        ``train_seconds`` (wall time of the training loops, validation
        excluded)."""
        if resume or resume_from is not None:
            raise ValueError("resuming a run is not supported by the port yet")
        cfg, model = self.cfg, self.model
        model.init(torch.Generator().manual_seed(cfg.seed))
        optimizer = AdamW(model.parameters(), cfg.learning_rate, cfg.grad_clip, cfg.weight_decay,
                          cfg.adam_b1, cfg.adam_b2, cfg.adam_eps)
        scheduler = make_scheduler(cfg.lr_scheduler or {
            "kind": "plateau", "factor": cfg.plateau_factor, "patience": cfg.plateau_patience,
            "min_lr": cfg.plateau_min_lr, "threshold": cfg.plateau_threshold,
        }, cfg.learning_rate)
        early_stop = EarlyStopping(cfg.early_stop_patience, min_delta=cfg.early_stop_min_delta)
        train_step = make_train_step(model, optimizer)
        val_gen = torch.Generator(device=self.device)
        history: list[dict[str, float]] = []
        best_val, global_step, train_seconds = float("inf"), 0, 0.0
        logger = MetricLogger(cfg.log_dir)
        try:
            for epoch in range(cfg.max_epochs):
                epoch_seed = fold(cfg.seed, epoch)
                t0 = time.perf_counter()
                model.train()
                train_sums, n_train = {}, 0
                for batch in self.dm.train_batches(epoch, self.device):
                    metrics = train_step(batch, epoch_seed, global_step)
                    _accumulate(train_sums, metrics, batch[0].shape[0])
                    n_train += batch[0].shape[0]
                    global_step += 1
                row = {f"train/{k}": float(v) / max(n_train, 1) for k, v in train_sums.items()}
                epoch_time = time.perf_counter() - t0  # float() above waited for the device
                train_seconds += epoch_time
                model.eval()
                val_sums, n_val = {}, 0
                with torch.no_grad():
                    for i, batch in enumerate(self.dm.val_batches(self.device)):
                        val_gen.manual_seed(fold(epoch_seed, _VAL, i))
                        _accumulate(val_sums, model.shared_step(batch, generator=val_gen),
                                    batch[0].shape[0])
                        n_val += batch[0].shape[0]
                row.update({f"val/{k}": float(v) / max(n_val, 1) for k, v in val_sums.items()})
                row.update({"epoch": epoch, "lr": scheduler.lr,
                            "seq_per_sec": n_train / max(epoch_time, 1e-9)})
                logger.log(row, step=epoch)
                history.append(row)

                aux = {"epoch": epoch, "global_step": global_step, "best_val": best_val,
                       "scheduler": scheduler.state_dict(), "early_stop": early_stop.state_dict()}
                bad = [k for k, v in row.items()
                       if k.startswith(("train/", "val/")) and not math.isfinite(v)]
                if cfg.halt_on_non_finite and bad:
                    self.ckpt.save("diverged", model, optimizer, {**aux, "non_finite": bad})
                    print(f"divergence: non-finite metrics {bad} at epoch {epoch}; saved "
                          "'diverged' and halting")
                    break
                monitored = row.get("val/loss", row.get("train/loss", float("inf")))
                set_learning_rate(optimizer, scheduler.step(monitored))
                if monitored < best_val:
                    best_val = monitored
                    self.ckpt.save("best", model, aux={"epoch": epoch, "val_loss": monitored})
                stop = early_stop.step(monitored)
                if stop or (epoch + 1) % cfg.checkpoint_every_n_epochs == 0 \
                        or epoch == cfg.max_epochs - 1:
                    self.ckpt.save("last", model, optimizer, {**aux, "best_val": best_val})
                if stop:
                    break
        finally:
            logger.close()
        return {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                "history": history, "best_val": best_val, "preempted": False,
                "global_step": global_step, "train_seconds": train_seconds}


def _accumulate(acc: dict[str, torch.Tensor], metrics: dict[str, torch.Tensor],
                weight: int) -> None:
    """Add ``weight · metric`` on the device; the host reads once an epoch."""
    for k, v in metrics.items():
        acc[k] = acc.get(k, 0.0) + weight * v.detach()

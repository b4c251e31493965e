"""The trainer's rollout-GIF callback (port of ``viz/callback.py``; reference
``LogMoPoEMRSSMOutput`` / ``LogMoPoEMMTRSSMOutput``,
``mopoe_mrssm/callback.py:12-37`` and ``mopoe_mmtrssm/callback.py:12-133``).

Every ``every_n_epochs`` epochs, epoch 0 skipped (reference
``callback.py:178-192``), the first ≤ 7 episodes of each stage's host
batches are reconstructed as one batch (one recurrence and one rollout
launch a stage) and drawn into ``log_dir/viz/epoch_NNNN/{train,val}/
episode_i.gif``; at the end of the fit the same with the best weights into
``viz/final_best`` (reference ``callback.py:194-210``). A unimodal run's
4-tuple batches render nothing. Each GIF's path is logged to the run's
metrics JSONL (JAX mirrors it to W&B, not ported).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from multimodal_mtrssm_tpu_torch.viz.rollout import MAX_EPISODES, log_rollout_gifs


class LogRSSMOutput:
    """Every-N-epochs rollout-GIF callback (reference callback.py:126-210),
    on the trainer's contract ``cb(trainer, epoch, model, row)`` and
    ``cb.on_train_end(trainer, best_model)``."""

    def __init__(self, every_n_epochs: int = 10, indices=(0, 1, 2), query_length: int = 10,
                 fps: float = 10.0):
        self.every_n_epochs = every_n_epochs
        # Accepted for the YAML surface and unused, as in the reference: it
        # stores ``indices`` (callback.py:139) and renders all_episodes[:7].
        self.indices = tuple(indices)
        self.query_length = query_length
        self.fps = fps

    def __call__(self, trainer: Any, epoch: int, model: Any, row: dict) -> None:
        if epoch == 0 or epoch % self.every_n_epochs != 0:
            return
        self._render(trainer, model, f"epoch_{epoch:04d}", epoch)

    def on_train_end(self, trainer: Any, best_model: Any) -> None:
        """The final render with the best weights, also after early stopping."""
        self._render(trainer, best_model, "final_best", 0)

    def _collect_stage_batch(self, trainer: Any, stage: str) -> tuple[np.ndarray, ...] | None:
        """The first ≤ 7 episodes of a stage's host batches (epoch 0's
        order), as one batch; None where the stage has none, and for
        unimodal 4-tuple batches: the GIF grid draws both modalities (JAX
        ``viz/callback.py:61-62``)."""
        parts, have = [], 0
        for batch in trainer.dm.host_batches(stage):
            if len(batch) != 6:
                return None
            parts.append(batch)
            have += batch[0].shape[0]
            if have >= MAX_EPISODES:
                break
        if not parts:
            return None
        n = min(have, MAX_EPISODES)
        return tuple(np.concatenate([p[i] for p in parts], axis=0)[:n] for i in range(6))

    def _render(self, trainer: Any, model: Any, name: str, seed: int) -> None:
        for stage in ("train", "val"):
            batch = self._collect_stage_batch(trainer, stage)
            if batch is None:
                continue
            out_dir = Path(trainer.cfg.log_dir) / "viz" / name / stage
            q = min(self.query_length, batch[0].shape[1] - 1)
            paths = log_rollout_gifs(model, batch, out_dir, q, self.fps, seed,
                                     range(batch[0].shape[0]))
            for i, p in enumerate(paths):
                trainer.logger.log_video(f"{stage}/rollout_{name}_ep{i}", p, self.fps)


# Reference-named aliases (class_path targets in YAML configs).
LogMoPoEMRSSMOutput = LogRSSMOutput
LogMoPoEMMTRSSMOutput = LogRSSMOutput


def make_viz_callback(exp: Any) -> LogRSSMOutput:
    """The callback of an ``Experiment``'s ``VizConfig``."""
    v = exp.viz
    return LogRSSMOutput(v.every_n_epochs, v.indices, v.query_length, v.fps)

"""Metric logging to JSONL (port of ``train/metrics.py`` without its W&B sink).

The metric names are the JAX package's (``train/loss``, ``val/loss``,
``train/kl``, ``train/recon/audio``, ...): one JSON object per epoch in
``<log_dir>/metrics.jsonl``, one per chart image (``image``, ``path``) and
one per rollout GIF (``video``, ``path``, ``fps``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricLogger:
    """Appends one JSON record per :meth:`log` call; close it when done."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "metrics.jsonl"
        self._fh = open(self.path, "a")

    def _write(self, step: int | None, fields: dict) -> None:
        self._fh.write(json.dumps({"step": step, "time": time.time(), **fields}) + "\n")
        self._fh.flush()

    def log(self, metrics: dict[str, float], step: int) -> None:
        self._write(step, {k: float(v) for k, v in metrics.items()})

    def log_image(self, key: str, png_path: str | Path, step: int | None = None) -> None:
        """Record a rendered image's path under ``key`` (JAX mirrors it to
        W&B, which the port has not)."""
        self._write(step, {"image": key, "path": str(png_path)})

    def log_video(self, key: str, gif_path: str | Path, fps: float = 10.0) -> None:
        """Record a rendered rollout GIF's path under ``key`` (JAX mirrors
        it to W&B)."""
        self._write(None, {"video": key, "path": str(gif_path), "fps": float(fps)})

    def close(self) -> None:
        self._fh.close()

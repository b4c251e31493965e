"""Metric logging to JSONL (port of ``train/metrics.py`` without its W&B sink).

The metric names are the JAX package's (``train/loss``, ``val/loss``,
``train/kl``, ``train/recon/audio``, ...): one JSON object per epoch in
``<log_dir>/metrics.jsonl``, and one per chart image (``image``, ``path``).
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

    def log(self, metrics: dict[str, float], step: int) -> None:
        record = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def log_image(self, key: str, png_path: str | Path, step: int | None = None) -> None:
        """Record a rendered image's path under ``key`` (JAX mirrors it to
        W&B, which the port has not)."""
        record = {"step": step, "time": time.time(), "image": key, "path": str(png_path)}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

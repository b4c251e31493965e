"""Host-side data transforms in numpy (port of ``data/transforms.py``, the
ones the in-memory pipeline uses; reference ``transform.py:55-132``)."""

from __future__ import annotations

import numpy as np


class GaussianNoise:
    """Additive Gaussian noise, std 0.1 (reference ``transform.py:55-72``)."""

    def __init__(self, std: float = 0.1) -> None:
        self.std = std

    def __call__(self, data: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return data + rng.normal(0.0, self.std, size=data.shape).astype(data.dtype, copy=False)


class NormalizeVisionImage:
    """[0, 255] → [-1, 1] (reference ``transform.py:75-97``)."""

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return (data.astype(np.float32) / 255.0) * 2.0 - 1.0


class NormalizeAudioMelSpectrogram:
    """Min-max [min, max] → [-1, 1] (reference ``transform.py:100-132``)."""

    def __init__(self, min_value: float = -80.0, max_value: float = 0.1) -> None:
        self.min_value = min_value
        self.max_value = max_value
        self.range = max_value - min_value

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return ((data.astype(np.float32) - self.min_value) / self.range) * 2.0 - 1.0

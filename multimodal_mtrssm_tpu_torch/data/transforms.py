"""Host-side data transforms in numpy (port of ``data/transforms.py``;
reference ``transform.py:8-132``): the normalisers and the noise the
pipeline applies, and the transforms a config's ``*_preprocess`` node may
name (``TRANSFORMS``), ``ZeroOut`` among them (modality dropout)."""

from __future__ import annotations

import numpy as np


class Compose:
    """Apply transforms in order (torchvision ``Compose`` contract)."""

    def __init__(self, transforms: list) -> None:
        self.transforms = list(transforms)

    def __call__(self, data: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        for t in self.transforms:
            if not getattr(t, "needs_rng", False):
                data = t(data)
            elif rng is None:
                # An unseeded draw would make batches that no seed reproduces.
                raise ValueError(f"{type(t).__name__} draws noise and needs a seeded generator; "
                                 "the preprocess transforms get none")
            else:
                data = t(data, rng)
        return data


class Identity:
    """No-op transform (the default when a stream has no transform configured)."""

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return data


class RemoveDim:
    """Drop indices along an axis (reference ``transform.py:8-28``)."""

    def __init__(self, axis: int, indices_to_remove: list[int]) -> None:
        self.axis = axis
        self.remove = set(indices_to_remove)

    def __call__(self, data: np.ndarray) -> np.ndarray:
        keep = [i for i in range(data.shape[self.axis]) if i not in self.remove]
        return np.take(data, keep, axis=self.axis)


class TakeFirstN:
    """Truncate the time axis to the first N steps (reference ``transform.py:31-52``)."""

    def __init__(self, n: int, axis: int = 0) -> None:
        self.n = n
        self.axis = axis

    def __call__(self, data: np.ndarray) -> np.ndarray:
        sl = [slice(None)] * data.ndim
        sl[self.axis] = slice(0, self.n)
        return data[tuple(sl)]


class GaussianNoise:
    """Additive Gaussian noise, std 0.1 (reference ``transform.py:55-72``)."""

    needs_rng = True

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


class ZeroOut:
    """Replace the whole stream with a constant (default -1): modality
    dropout, the fill the rollout GIFs label "(missing)" (reference
    ``mrssm/callback.py:122-125``; the reference ships no such transform)."""

    def __init__(self, fill_value: float = -1.0) -> None:
        self.fill_value = fill_value

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return np.full_like(data, self.fill_value)


TRANSFORMS = {
    "Identity": Identity,
    "RemoveDim": RemoveDim,
    "TakeFirstN": TakeFirstN,
    "GaussianNoise": GaussianNoise,
    "NormalizeVisionImage": NormalizeVisionImage,
    "NormalizeAudioMelSpectrogram": NormalizeAudioMelSpectrogram,
    "ZeroOut": ZeroOut,
    "Compose": Compose,
}


def affine_of(transform: object) -> tuple[float, float] | None:
    """``(scale, shift)`` where ``transform`` is one of the affine
    normalisers (``y = x · scale + shift``), else None (JAX
    ``data/native.py::affine_of``): a pack's batches are normalised so."""
    if isinstance(transform, Identity):
        return 1.0, 0.0
    if isinstance(transform, NormalizeVisionImage):
        return 2.0 / 255.0, -1.0
    if isinstance(transform, NormalizeAudioMelSpectrogram):
        scale = 2.0 / transform.range
        return scale, -transform.min_value * scale - 1.0
    return None

"""Input pipeline: episode store → preprocessed host arrays → batches on the
device (port of ``data/pipeline.py``, its in-memory host path).

``setup`` loads every episode once, normalises it (audio min-max and vision
[0, 255] to [-1, 1]) and splits the sorted episodes 0.8 / 0.2 (reference
``dataset.py:69-81``). A training epoch shuffles with
``default_rng((seed, epoch))``, so its batch order is the JAX module's.
Validation batches, in split order, draw from ``default_rng((seed,
987654321))``, as JAX's and the reference's val DataLoader do. Each batch
takes one seed from its generator and noises each input stream with
``GaussianNoise(noise_std)`` from ``default_rng(seed ^ (k + 1))`` (k = 0, 1, 2
for action, audio, vision): the draws of the JAX module's numpy path
(``data/native.py::gather_noise``; its optional native build draws from a
generator of its own). The targets stay clean. Batches keep the reference's
6-tuple order (``mrssm/dataset.py:168-183``): (action_input, audio_input,
vision_input, action_target, audio_target, vision_target).

``train_batches`` takes a ``skip`` for a mid-epoch resume: the batches
after it and their noise are those of the whole epoch.

Not ported: the memory-mapped pack mode, ``native/fastbatch.cc``, the
device-resident mode, unimodal batches, custom transforms and
``drop_modality``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.data import episodes as ep
from multimodal_mtrssm_tpu_torch.data.transforms import (
    GaussianNoise,
    NormalizeAudioMelSpectrogram,
    NormalizeVisionImage,
)

Batch = tuple[torch.Tensor, ...]


@dataclasses.dataclass
class DataModuleConfig:
    """The fields of the JAX ``DataModuleConfig`` that this pipeline serves."""

    data_dir: str | Path = "data/audio_mnist"
    batch_size: int = 8
    sequence_length: int = 30  # TakeFirstN n (configs :180-220)
    noise_std: float = 0.1  # GaussianNoise on the inputs, not the targets
    train_ratio: float = 0.8
    audio_min: float = -80.0
    audio_max: float = 0.0
    seed: int = 42
    # False: the ragged tail batch trains and validates too (reference
    # DataLoader drop_last=False).
    drop_last: bool = False


class EpisodeDataModule:
    """Loads episodes, preprocesses once, serves batches on a device."""

    def __init__(self, config: DataModuleConfig):
        self.cfg = config
        self._arrays: dict[str, np.ndarray] | None = None
        self._split: tuple[np.ndarray, np.ndarray] | None = None

    def setup(self) -> None:
        """Load and normalise every episode of ``data_dir`` and split them."""
        cfg = self.cfg
        paths = ep.list_episodes(cfg.data_dir)
        if not paths:
            raise FileNotFoundError(
                f"no episodes under {cfg.data_dir}; generate some with "
                "multimodal_mtrssm_tpu_torch.data.generate_synthetic_audio_mnist")
        norm_audio = NormalizeAudioMelSpectrogram(cfg.audio_min, cfg.audio_max)
        norm_vision = NormalizeVisionImage()
        streams: dict[str, list[np.ndarray]] = {"action": [], "audio": [], "vision": []}
        for p in paths:
            e = ep.load_episode(p)
            streams["action"].append(e.action)
            streams["audio"].append(norm_audio(e.audio))
            streams["vision"].append(norm_vision(e.vision))
        self._arrays = {k: np.stack(v).astype(np.float32) for k, v in streams.items()}
        n_train = len(ep.split_paths(paths, cfg.train_ratio)[0])
        self._split = (np.arange(n_train), np.arange(n_train, len(paths)))

    def _require_setup(self) -> None:
        if self._arrays is None:
            self.setup()

    @property
    def n_train(self) -> int:
        self._require_setup()
        return len(self._split[0])

    @property
    def n_val(self) -> int:
        self._require_setup()
        return len(self._split[1])

    @property
    def train_batch_size(self) -> int:
        """Effective train batch: clamped so small datasets still train."""
        return max(1, min(self.cfg.batch_size, self.n_train))

    @property
    def val_batch_size(self) -> int:
        return max(1, min(self.cfg.batch_size, self.n_val)) if self.n_val else 0

    def _make_batch(self, idx: np.ndarray,
                    rng: np.random.Generator | None) -> tuple[np.ndarray, ...]:
        """The 6-tuple of numpy arrays; with ``rng`` and ``noise_std > 0`` the
        inputs get the Gaussian noise, stream k from ``default_rng(seed ^ (k +
        1))`` after one seed drawn from ``rng`` (module docstring)."""
        cfg = self.cfg
        T = cfg.sequence_length
        clean = [self._arrays[s][idx, :T] for s in ("action", "audio", "vision")]
        if rng is None or cfg.noise_std <= 0:
            return (*clean, *clean)
        seed = int(rng.integers(0, 2**62))
        noise = GaussianNoise(cfg.noise_std)
        inputs = [noise(x, np.random.default_rng(seed ^ (k + 1))) for k, x in enumerate(clean)]
        return (*inputs, *clean)

    def _batched_indices(self, idx: np.ndarray, bs: int) -> list[np.ndarray]:
        """Full batches, then (unless ``drop_last``) the ragged tail."""
        if bs <= 0:
            return []
        n_full = len(idx) // bs
        out = [idx[i * bs:(i + 1) * bs] for i in range(n_full)]
        if not self.cfg.drop_last and len(idx) % bs:
            out.append(idx[n_full * bs:])
        return out

    @staticmethod
    def _to_device(batch: tuple[np.ndarray, ...], device: torch.device | str) -> Batch:
        return tuple(torch.as_tensor(np.ascontiguousarray(x), device=device) for x in batch)

    def _batch_consumes_rng(self, rng: np.random.Generator | None) -> bool:
        """Whether ``_make_batch(idx, rng)`` draws from ``rng``: the test a
        mid-epoch skip keys off (skipping at the index level is exact only
        when no batch draws). It must mirror ``_make_batch``'s draws."""
        return rng is not None and self.cfg.noise_std > 0

    def train_batches(self, epoch: int, device: torch.device | str = "cpu",
                      skip: int = 0) -> Iterator[Batch]:
        """Shuffled, noised train batches of one epoch. ``skip`` drops the
        first batches (a mid-epoch resume) and leaves the rest as the whole
        epoch serves them: skipped batches still draw their noise, or are
        dropped at the index level when no batch draws (JAX
        ``data/pipeline.py:354-376``)."""
        self._require_setup()
        rng = np.random.default_rng((self.cfg.seed, epoch))
        idx = rng.permutation(self._split[0])
        groups = self._batched_indices(idx, self.train_batch_size)
        if skip and not self._batch_consumes_rng(rng):
            groups, skip = groups[skip:], 0
        for i, group in enumerate(groups):
            batch = self._make_batch(group, rng)
            if i >= skip:
                yield self._to_device(batch, device)

    def val_batches(self, device: torch.device | str = "cpu") -> Iterator[Batch]:
        """Validation batches in split order, the inputs noised from
        ``default_rng((seed, 987654321))`` (JAX ``data/pipeline.py:653-664``)."""
        self._require_setup()
        rng = np.random.default_rng((self.cfg.seed, 987654321))
        for group in self._batched_indices(self._split[1], self.val_batch_size):
            yield self._to_device(self._make_batch(group, rng), device)

"""Audio-MNIST episode storage and synthetic generation (port of the parts of
``data/episodes.py`` the training slice uses).

One ``.npz`` file per episode with keys ``action`` [T, A], ``audio`` and
``vision`` [T, H, W, C] (NHWC). 180 frames an episode; audio mel-spec dB in
[-80, 0]; vision in [0, 255]; action a 6-dim speaker one-hot.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Episode:
    """One Audio-MNIST episode: aligned action/audio/vision streams of equal length T."""

    action: np.ndarray  # [T, A]
    audio: np.ndarray  # [T, H, W, C]
    vision: np.ndarray  # [T, H, W, C]

    def __post_init__(self):
        t = self.action.shape[0]
        if self.audio.shape[0] != t or self.vision.shape[0] != t:
            raise ValueError(
                f"stream lengths differ: action {t}, audio {self.audio.shape[0]}, "
                f"vision {self.vision.shape[0]}")


def save_episode(directory: Path | str, index: int, episode: Episode) -> Path:
    """Write one episode as ``episode_<index>.npz`` under ``directory``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"episode_{index:04d}.npz"
    np.savez(path, action=episode.action, audio=episode.audio, vision=episode.vision)
    return path


def load_episode(path: Path | str) -> Episode:
    """Load an ``.npz`` episode as float32 (both packages store NHWC)."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"unknown episode format: {path}")
    with np.load(path) as z:
        return Episode(*(z[k].astype(np.float32) for k in ("action", "audio", "vision")))


def list_episodes(directory: Path | str) -> list[Path]:
    """Sorted ``episode_*.npz`` paths (the sorted order defines the split)."""
    return sorted(Path(directory).glob("episode_*.npz"))


def split_paths(paths: list[Path], train_ratio: float = 0.8) -> tuple[list[Path], list[Path]]:
    """Sorted-order head/tail split (reference ``dataset.py:69-81``)."""
    split = int(len(paths) * train_ratio)
    return paths[:split], paths[split:]


def generate_synthetic_audio_mnist(out_dir: Path | str, n_episodes: int = 10,
                                   episode_length: int = 180, hw: int = 32,
                                   n_speakers: int = 6, seed: int = 0) -> list[Path]:
    """Audio-MNIST-shaped synthetic episodes in the raw value ranges; the
    same arrays as the JAX package's generator for the same arguments."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_episodes):
        speaker = rng.integers(0, n_speakers, size=episode_length)
        action = np.eye(n_speakers, dtype=np.float32)[speaker]
        tt = np.arange(episode_length, dtype=np.float32)[:, None, None, None]
        yy = np.linspace(0, 1, hw, dtype=np.float32)[None, :, None, None]
        xx = np.linspace(0, 1, hw, dtype=np.float32)[None, None, :, None]
        phase = rng.uniform(0, 2 * np.pi)
        audio = -40.0 + 40.0 * np.sin(0.2 * tt + 6.0 * yy + phase) * np.cos(4.0 * xx)
        audio = np.clip(audio + rng.normal(0, 2.0, audio.shape), -80.0, 0.0).astype(np.float32)
        vision = 127.5 + 127.5 * np.cos(0.15 * tt + 5.0 * xx - phase) * np.sin(3.0 * yy)
        vision = np.clip(vision + rng.normal(0, 5.0, vision.shape), 0.0, 255.0).astype(np.float32)
        paths.append(save_episode(out_dir, i, Episode(action=action, audio=audio, vision=vision)))
    return paths

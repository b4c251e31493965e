"""Audio-MNIST episode storage, conversion and synthetic generation (port
of ``data/episodes.py``; its gdrive download is not ported: no network).

One ``.npz`` file per episode with keys ``action`` [T, A], ``audio`` and
``vision`` [T, H, W, C] (NHWC). 180 frames an episode; audio mel-spec dB in
[-80, 0]; vision in [0, 255]; action a 6-dim speaker one-hot. The
converters read the audio-mnist generator's ``.npz`` files and the
reference's processed ``act_*/audio_obs_*/vision_obs_*`` triplets. The
labeled synthetic episodes also write the evaluation's layout
(``sample_*.npz`` with ``audio``, ``image``, ``label`` and ``speaker``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

EPISODE_KEYS = ("action", "audio", "vision")


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


def _to_nhwc(obs: np.ndarray) -> np.ndarray:
    """A ``[T, ...]`` observation as ``[T, H, W, C]``: ``[T, H, W]`` gains a
    channel, ``[T, C, H, W]`` (a small axis 1) is moved to NHWC, NHWC stays."""
    if obs.ndim == 3:
        return obs[..., None]
    if obs.ndim != 4:
        raise ValueError(f"expected 3-D or 4-D observation, got shape {obs.shape}")
    # Channel counts are tiny (1..4); spatial dims are larger.
    if obs.shape[1] <= 4 < obs.shape[-1]:
        return np.moveaxis(obs, 1, -1)
    return obs


def save_episode(directory: Path | str, index: int, episode: Episode) -> Path:
    """Write one episode as ``episode_<index>.npz`` under ``directory``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"episode_{index:04d}.npz"
    np.savez(path, action=episode.action, audio=episode.audio, vision=episode.vision)
    return path


def load_episode(path: Path | str) -> Episode:
    """Load an ``.npz`` episode as float32, observations as NHWC (:func:`_to_nhwc`)."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"unknown episode format: {path}")
    with np.load(path) as z:
        return Episode(action=z["action"].astype(np.float32),
                       audio=_to_nhwc(z["audio"]).astype(np.float32),
                       vision=_to_nhwc(z["vision"]).astype(np.float32))


def list_episodes(directory: Path | str) -> list[Path]:
    """Sorted ``episode_*.npz`` paths (the sorted order defines the split)."""
    return sorted(Path(directory).glob("episode_*.npz"))


def split_paths(paths: list[Path], train_ratio: float = 0.8) -> tuple[list[Path], list[Path]]:
    """Sorted-order head/tail split (reference ``dataset.py:69-81``)."""
    split = int(len(paths) * train_ratio)
    return paths[:split], paths[split:]


def convert_audio_mnist_npz(source_files: list[Path | str], out_dir: Path | str,
                            start_index: int = 0) -> int:
    """Convert audio-mnist-generator ``.npz`` files (``audio`` (T, 32, 32),
    ``image`` (T, 1, 32, 32), ``speaker`` (T, 6)) into episodes, numbered on
    from ``start_index`` in sorted file order (reference
    ``scripts/convert_audio_mnist_data.py:28-56,83-88``). Returns the next
    free index."""
    idx = start_index
    for f in sorted(str(p) for p in source_files):
        with np.load(f) as z:
            audio = _to_nhwc(z["audio"].astype(np.float32))
            vision = _to_nhwc(z["image"].astype(np.float32))
            action = z["speaker"].astype(np.float32)
        save_episode(out_dir, idx, Episode(action=action, audio=audio, vision=vision))
        idx += 1
    return idx


def _load_array(p: Path) -> np.ndarray:
    """A ``.npy`` array, or the tensor of a ``.pt`` file (loaded with
    ``weights_only``: a processed dump holds tensors only)."""
    if p.suffix == ".npy":
        return np.load(p)
    if p.suffix == ".pt":
        return torch.load(p, weights_only=True).numpy()
    raise ValueError(f"unknown file extension: {p.suffix}")


def convert_reference_processed_dir(src_dir: Path | str, out_dir: Path | str) -> int:
    """Convert a reference-format processed directory (``act_*``,
    ``audio_obs_*``, ``vision_obs_*`` ``.pt``/``.npy`` triplets, reference
    ``mrssm/dataset.py:105-153``) into episodes; returns their count."""
    src = Path(src_dir)
    # Underscored patterns: a stray act-/audio-prefixed file (a pack's
    # action.npy) must not join, or misalign, the triplets.
    acts = sorted(src.glob("act_*"))
    audios = sorted(src.glob("audio_obs_*"))
    visions = sorted(src.glob("vision_obs_*"))
    if not len(acts) == len(audios) == len(visions):
        raise ValueError(f"triplet mismatch: {len(acts)} act / {len(audios)} audio / "
                         f"{len(visions)} vision")
    for i, (a, au, vi) in enumerate(zip(acts, audios, visions)):
        save_episode(out_dir, i, Episode(action=_load_array(a).astype(np.float32),
                                         audio=_to_nhwc(_load_array(au)).astype(np.float32),
                                         vision=_to_nhwc(_load_array(vi)).astype(np.float32)))
    return len(acts)


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


def generate_synthetic_labeled_audio_mnist(
    episodes_dir: Path | str, eval_dir: Path | str, n_episodes: int = 24,
    episode_length: int = 180, frames_per_word: int = 18, hw: int = 32, n_speakers: int = 6,
    seed: int = 0, n_successors: int = 2,
) -> tuple[list[Path], list[Path]]:
    """Synthetic labeled Audio-MNIST; the same arrays as the JAX package's
    generator for the same arguments. Digit ``d`` is a bright vertical
    stripe at column ``3d`` in vision and a horizontal band at row ``3d``
    in audio. Words follow a sparse transition graph (``n_successors``
    equally likely successors of each digit), so p(w'|w) is not uniform.
    Writes training episodes into ``episodes_dir`` and the evaluation's
    ``sample_*.npz`` (``audio`` (T, 32, 32), ``image`` (T, 1, 32, 32),
    ``label``, ``speaker``) into ``eval_dir``."""
    rng = np.random.default_rng(seed)
    # Ceil: a length that is no multiple still labels every frame.
    n_words = -(-episode_length // frames_per_word)
    offsets = (1, 3, 5, 7, 9)
    if not 1 <= n_successors <= len(offsets):
        raise ValueError(f"n_successors must be in [1, {len(offsets)}], got {n_successors}")
    successors = {d: tuple((d + off) % 10 for off in offsets[:n_successors]) for d in range(10)}
    train_paths, eval_paths = [], []
    eval_dir = Path(eval_dir)
    eval_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n_episodes):
        speaker_idx = i % n_speakers
        words = [int(rng.integers(0, 10))]
        for _ in range(n_words - 1):
            nxt = successors[words[-1]]
            words.append(int(nxt[rng.integers(0, len(nxt))]))
        label = np.repeat(np.asarray(words, np.int64), frames_per_word)[:episode_length]
        speaker = np.zeros((episode_length, n_speakers), np.float32)
        speaker[:, speaker_idx] = 1.0
        vision = np.full((episode_length, hw, hw, 1), 20.0, np.float32)
        audio = np.full((episode_length, hw, hw, 1), -70.0, np.float32)
        for t in range(episode_length):
            d = int(label[t])
            vision[t, :, 3 * d:3 * d + 3, 0] = 235.0
            audio[t, 3 * d:3 * d + 3, :, 0] = -10.0
        vision += rng.normal(0, 4.0, vision.shape).astype(np.float32)
        audio += rng.normal(0, 1.5, audio.shape).astype(np.float32)
        vision = np.clip(vision, 0.0, 255.0)
        audio = np.clip(audio, -80.0, 0.0)
        train_paths.append(
            save_episode(episodes_dir, i, Episode(action=speaker, audio=audio, vision=vision)))
        p = eval_dir / f"sample_{i:04d}.npz"
        np.savez(p, audio=audio[..., 0], image=np.moveaxis(vision, -1, 1), label=label,
                 speaker=speaker)
        eval_paths.append(p)
    return train_paths, eval_paths

"""Episode data (port of ``multimodal_mtrssm_tpu.data``): the episode store
and its converters, the memory-mapped pack (``data.pack``), the numpy
transforms and the host-side pipeline. The JAX package's modules cannot be
imported here (its ``data/__init__.py`` pulls in ``pipeline.py``, which
imports ``jax``), so these are numpy copies that make the same episodes and
batches from the same seed."""

from multimodal_mtrssm_tpu_torch.data.episodes import (
    Episode,
    convert_audio_mnist_npz,
    convert_reference_processed_dir,
    generate_synthetic_audio_mnist,
    generate_synthetic_labeled_audio_mnist,
    list_episodes,
    load_episode,
    save_episode,
    split_paths,
)
from multimodal_mtrssm_tpu_torch.data.pipeline import DataModuleConfig, EpisodeDataModule
from multimodal_mtrssm_tpu_torch.data.transforms import (
    TRANSFORMS,
    Compose,
    GaussianNoise,
    Identity,
    NormalizeAudioMelSpectrogram,
    NormalizeVisionImage,
    RemoveDim,
    TakeFirstN,
    ZeroOut,
)

__all__ = [
    "TRANSFORMS",
    "Compose",
    "DataModuleConfig",
    "Episode",
    "EpisodeDataModule",
    "GaussianNoise",
    "Identity",
    "NormalizeAudioMelSpectrogram",
    "NormalizeVisionImage",
    "RemoveDim",
    "TakeFirstN",
    "ZeroOut",
    "convert_audio_mnist_npz",
    "convert_reference_processed_dir",
    "generate_synthetic_audio_mnist",
    "generate_synthetic_labeled_audio_mnist",
    "list_episodes",
    "load_episode",
    "save_episode",
    "split_paths",
]

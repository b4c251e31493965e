"""Episode data (port of ``multimodal_mtrssm_tpu.data``): the episode store,
the numpy transforms and the host-side in-memory pipeline. The JAX
package's modules cannot be imported here (its ``data/__init__.py`` pulls in
``pipeline.py``, which imports ``jax``), so these are numpy copies that make
the same episodes and batches from the same seed."""

from multimodal_mtrssm_tpu_torch.data.episodes import (
    Episode,
    generate_synthetic_audio_mnist,
    generate_synthetic_labeled_audio_mnist,
    list_episodes,
    load_episode,
    save_episode,
    split_paths,
)
from multimodal_mtrssm_tpu_torch.data.pipeline import DataModuleConfig, EpisodeDataModule

__all__ = [
    "DataModuleConfig",
    "Episode",
    "EpisodeDataModule",
    "generate_synthetic_audio_mnist",
    "generate_synthetic_labeled_audio_mnist",
    "list_episodes",
    "load_episode",
    "save_episode",
    "split_paths",
]

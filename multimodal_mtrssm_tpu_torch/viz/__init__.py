"""Visualisation (port of ``multimodal_mtrssm_tpu.viz``): the rollout GIFs
(``viz/rollout.py``) and the trainer callback that draws them
(``viz/callback.py``), and the combined train/val metric charts."""

from multimodal_mtrssm_tpu_torch.viz.callback import (
    LogMoPoEMMTRSSMOutput,
    LogMoPoEMRSSMOutput,
    LogRSSMOutput,
    make_viz_callback,
)
from multimodal_mtrssm_tpu_torch.viz.charts import GROUPS, load_metrics, render_combined_charts
from multimodal_mtrssm_tpu_torch.viz.rollout import (
    compute_reconstructions,
    log_rollout_gifs,
    reconstruction_states,
    render_episode_gif,
)

__all__ = [
    "GROUPS",
    "LogMoPoEMMTRSSMOutput",
    "LogMoPoEMRSSMOutput",
    "LogRSSMOutput",
    "compute_reconstructions",
    "load_metrics",
    "log_rollout_gifs",
    "make_viz_callback",
    "reconstruction_states",
    "render_combined_charts",
    "render_episode_gif",
]

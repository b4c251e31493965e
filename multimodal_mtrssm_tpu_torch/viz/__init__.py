"""Visualisation (port of ``multimodal_mtrssm_tpu.viz``): the combined
train/val metric charts. The rollout GIFs (``viz/rollout.py``,
``viz/callback.py``) are not ported yet."""

from multimodal_mtrssm_tpu_torch.viz.charts import GROUPS, load_metrics, render_combined_charts

__all__ = ["GROUPS", "load_metrics", "render_combined_charts"]

"""Cross-modal (missing-modality) inference evaluation (port of
``evaluation/crossmodal.py``).

MoPoE fusion's headline claim is robustness when a modality drops out: the
posterior is a mixture over modality subsets, so with one input stream
zeroed the joint state should still reconstruct the missing modality from
the other. :func:`build_normalized_batch` makes a normalised model batch of
evaluation episodes with one input stream dropped (the ZeroOut fill -1) and
clean targets; :func:`reconstruction_report` scores, for each condition
(both / audio dropped / vision dropped), the posterior and prior
reconstruction MSE of each modality against the clean targets, beside the
constant(-1) and dataset-mean-frame baselines. Its reconstructions run on
the model's device (``viz.rollout.compute_reconstructions``: one recurrence
and one rollout launch a condition), each condition on the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.data.episodes import _to_nhwc
from multimodal_mtrssm_tpu_torch.data.transforms import (
    NormalizeAudioMelSpectrogram,
    NormalizeVisionImage,
)
from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.viz.rollout import compute_reconstructions

DROPS = (None, "audio", "vision")


def build_normalized_batch(test_data: list[dict], *, n_episodes: int = 8, T: int = 30,
                           audio_min: float = -80.0, audio_max: float = 0.0,
                           drop: str | None = None) -> tuple[torch.Tensor, ...]:
    """The normalised ``(act_in, aud_in, vis_in, act, aud, vis)`` batch (CPU
    tensors) of the first ``n_episodes`` evaluation episodes (the layout of
    ``word_transitions.load_test_data_with_labels``), ``T`` frames each.
    ``drop`` ∈ {None, "audio", "vision"} replaces that input stream with -1;
    the targets stay clean."""
    if drop not in DROPS:
        raise ValueError(f"drop={drop!r} not in {DROPS}")
    if not test_data:
        raise ValueError("no eval episodes")
    audio_t = NormalizeAudioMelSpectrogram(audio_min, audio_max)
    vision_t = NormalizeVisionImage()
    eps = test_data[:n_episodes]
    act = np.stack([e["speaker"][:T] for e in eps]).astype(np.float32)
    aud = np.stack([audio_t(_to_nhwc(e["audio"][:T])) for e in eps])
    vis = np.stack([vision_t(_to_nhwc(e["image"][:T])) for e in eps])
    aud_in = np.full_like(aud, -1.0) if drop == "audio" else aud
    vis_in = np.full_like(vis, -1.0) if drop == "vision" else vis
    return tuple(torch.from_numpy(x) for x in (act, aud_in, vis_in, act, aud, vis))


def _mse(pred: torch.Tensor, target: torch.Tensor) -> float:
    return float(torch.mean((pred.float() - target.float()) ** 2))


def reconstruction_report(model: WorldModelNet, test_data: list[dict], *, query_length: int = 15,
                          n_episodes: int = 8, T: int = 30, audio_min: float = -80.0,
                          audio_max: float = 0.0, seed: int = 0) -> dict:
    """Reconstruction MSE (on the normalised [-1, 1] scale) of both
    modalities under each input condition, JSON-ready, JAX's structure::

        {"conditions": {"both"|"drop_audio"|"drop_vision":
             {"posterior/audio", "posterior/vision", "prior/audio", "prior/vision"}},
         "baselines": {"constant_-1/audio", "mean_frame/audio", ... /vision},
         "config": {"n_episodes", "T", "query_length", "seed"}}

    The decisive cells are ``drop_audio → posterior/audio`` (audio inferred
    from vision alone) and ``drop_vision → posterior/vision``: cross-modal
    inference shows where they beat both baselines and sit near the
    both-modality MSE."""
    device = next(model.parameters()).device
    kw = dict(n_episodes=n_episodes, T=T, audio_min=audio_min, audio_max=audio_max)
    clean = build_normalized_batch(test_data, **kw)
    targets = {"audio": clean[4].to(device), "vision": clean[5].to(device)}
    conditions: dict[str, dict[str, float]] = {}
    for drop in DROPS:
        batch = clean if drop is None else build_normalized_batch(test_data, drop=drop, **kw)
        # One seed for every condition: the same sampling noise, so the MSE
        # deltas isolate the dropped input.
        recons = compute_reconstructions(model, batch, query_length, seed)
        conditions["both" if drop is None else f"drop_{drop}"] = {
            k: _mse(v, targets[k.split("/")[1]]) for k, v in recons.items()}
    baselines: dict[str, float] = {}
    for mod, tgt in targets.items():
        baselines[f"constant_-1/{mod}"] = _mse(torch.full_like(tgt, -1.0), tgt)
        mean_frame = torch.mean(tgt, dim=(0, 1), keepdim=True)
        baselines[f"mean_frame/{mod}"] = _mse(mean_frame.expand_as(tgt), tgt)
    return {"conditions": conditions, "baselines": baselines,
            "config": {"n_episodes": min(n_episodes, len(test_data)), "T": T,
                       "query_length": query_length, "seed": seed}}

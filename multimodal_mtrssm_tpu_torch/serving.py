"""Serving API (port of ``serving.py``): world-model inference on one device.

- ``WorldModel.observe``: filter a ``[B, T]`` observation sequence into
  posterior and prior latents.
- ``WorldModel.imagine``: prior-only rollout from a latent under an action
  plan, through the rollout kernel.
- ``WorldModel.decode``: reconstruct both modalities from latents.

Either family: ``MoPoEMRSSM`` (``State`` latents) or the hierarchical
``MoPoEMMTRSSM`` (``MTState``, whose integrators make a chained imagine
exact). An integer seed takes the place of the JAX key. Observe draws its
Gumbel noise (``model.draw_noise``) from a CPU ``torch.Generator`` seeded
with it and moves the noise to the device; imagine keys the rollout
kernel's Philox stream with it. Either way a seed gives the same trajectory
on the CPU and the card. No mesh, and no Orbax ``from_checkpoint``: weights
come from the model's ``init`` or ``train.weights``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.models.state import AnyState

ArrayLike = torch.Tensor | np.ndarray


class WorldModel:
    """A model on ``device`` behind inference entry points that take and
    return tensors on that device (numpy inputs are accepted too). The
    device is the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default raises."""

    def __init__(self, model: WorldModelNet, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("WorldModel runs on the CUDA device by default and none is "
                               "available; pass device='cpu' to run on the CPU")
        self.model = model.to(self.device).eval()

    def _tensor(self, x: Any, ndim: int, name: str) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if t.ndim != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
        return t

    @torch.no_grad()
    def observe(self, actions: ArrayLike, audio_obs: ArrayLike, vision_obs: ArrayLike,
                seed: int = 0) -> tuple[AnyState, AnyState]:
        """Filter observations → (posterior, prior) latent sequences ``[B, T]``.
        Frames are NHWC ``[B, T, H, W, C]``."""
        cfg = self.model.cfg
        actions = self._tensor(actions, 3, "actions")
        audio = self._tensor(audio_obs, 5, "audio")
        vision = self._tensor(vision_obs, 5, "vision")
        B, T, A = actions.shape
        if A != cfg.action_size:
            raise ValueError(f"actions have width {A}, the model takes {cfg.action_size}")
        if T == 0:
            raise ValueError("observe needs at least one timestep")
        for name, x, enc in (("audio", audio, cfg.audio_encoder),
                             ("vision", vision, cfg.vision_encoder)):
            if tuple(x.shape) != (B, T, *enc.in_hw, enc.in_channels):
                raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                                 f"{(B, T, *enc.in_hw, enc.in_channels)}")
        noise = self.model.draw_noise(B, T, torch.Generator().manual_seed(seed))
        return self.model.observe(actions, audio, vision,
                                  {k: v.to(self.device) for k, v in noise.items()})

    @torch.no_grad()
    def imagine(self, actions: ArrayLike, prev_state: AnyState, seed: int = 0) -> AnyState:
        """Prior-only rollout from ``prev_state`` (``[B]`` latents) under an
        action plan ``[B, T, A]``."""
        cfg = self.model.cfg
        actions = self._tensor(actions, 3, "actions")
        if actions.shape[2] != cfg.action_size:
            raise ValueError(
                f"actions have width {actions.shape[2]}, the model takes {cfg.action_size}")
        if actions.shape[1] == 0:
            raise ValueError("imagine needs at least one timestep")
        if prev_state.batch_size != actions.shape[0]:
            raise ValueError(f"state batch {prev_state.batch_size} != action batch "
                             f"{actions.shape[0]}")
        return self.model.rollout_transition(actions, prev_state.to(self.device), seed)

    @torch.no_grad()
    def decode(self, state: AnyState) -> dict[str, torch.Tensor]:
        """Reconstruct both modalities from latents → NHWC frames."""
        return self.model.decode_state(state.to(self.device))

    def imagine_frames(self, actions: ArrayLike, prev_state: AnyState,
                       seed: int = 0) -> dict[str, torch.Tensor]:
        """Imagine and decode in one call → dict of ``[B, T, H, W, C]`` frames."""
        return self.decode(self.imagine(actions, prev_state, seed))

"""Serving API (port of ``serving.py``): world-model inference on one device.

- ``WorldModel.observe``: filter a ``[B, T]`` observation sequence into
  posterior and prior latents.
- ``WorldModel.imagine``: prior-only rollout from a latent under an action
  plan, through the rollout kernel.
- ``WorldModel.decode``: reconstruct both modalities from latents.
- ``WorldModel.observe_many`` / ``imagine_many``: several requests as one
  device call (the server's request coalescing), each request's rows
  exactly what it gets alone.
- ``WorldModel.from_checkpoint``: a YAML config (or a model config) and a
  run's checkpoints directory → a ready model.

A multimodal family: ``MoPoEMRSSM`` and ``WeightedMoPoEMRSSM`` (``State``
latents) or the hierarchical ``MoPoEMMTRSSM`` (``MTState``, whose
integrators make a chained imagine exact); the unimodal ``RSSM`` is
refused. An integer seed takes the place of the JAX key. Observe draws its
Gumbel noise (``model.draw_noise``) from a CPU ``torch.Generator`` seeded
with it and moves the noise to the device; imagine keys the rollout
kernel's Philox stream with it. Either way a seed gives the same trajectory
on the CPU and the card. Unlike JAX's coalescing, which folds every
co-occupant's seed into one key, a coalesced request keeps its own draws:
its observe noise is its own generator's, placed in its rows, and its
imagine rows carry its seed and their index inside the request
(``ops.kernels.rollout.row_keys``). No mesh.
"""

from __future__ import annotations

import inspect
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.models.state import AnyState, cat_states
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import row_keys
from multimodal_mtrssm_tpu_torch.utils import require_device

ArrayLike = torch.Tensor | np.ndarray


class WorldModel:
    """A model on ``device`` behind inference entry points that take and
    return tensors on that device (numpy inputs are accepted too). The
    device is the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default raises. Imagination
    runs through the rollout kernel on the card and its plain version on
    the CPU (``ops.kernels._route``)."""

    def __init__(self, model: WorldModelNet, device: torch.device | str = "cuda"):
        # The observe/imagine surface is multimodal: initial_state(audio,
        # vision, noise...). A unimodal model's initial_state(obs, noise)
        # would bind its noise to the vision frames (JAX serving.py:46-60).
        if len(inspect.signature(model.initial_state).parameters) < 3:
            raise TypeError(
                f"WorldModel serves the multimodal families (MoPoEMRSSM / MoPoEMMTRSSM / "
                f"WeightedMoPoEMRSSM); got {type(model).__name__}, whose initial_state takes a "
                "single observation: call the unimodal model's rollout methods directly")
        self.device = require_device(device, "WorldModel")
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, config: Any, checkpoint_dir: str | Path,
                        device: torch.device | str = "cuda") -> "WorldModel":
        """The model of ``config`` (a YAML path, read by
        ``train.config.load_experiment``, or an ``MRSSMConfig`` /
        ``MMTRSSMConfig``) with the weights of a run's checkpoints directory
        (``<log_dir>/checkpoints``, as ``train.Trainer`` writes it): ``best``,
        else ``last`` (a full ``last`` gives its weights only)."""
        from multimodal_mtrssm_tpu_torch.train.checkpoint import CheckpointManager
        from multimodal_mtrssm_tpu_torch.train.config import build_model

        directory = Path(checkpoint_dir)
        if not directory.is_dir():
            raise FileNotFoundError(f"no checkpoints directory {directory}; point --checkpoint "
                                    "at a run's checkpoints directory")
        ckpt = CheckpointManager(directory)
        name = "best" if ckpt.exists("best") else "last"
        if not ckpt.exists(name):
            raise FileNotFoundError(f"no 'best' or 'last' checkpoint under {directory}; point "
                                    "--checkpoint at a run's checkpoints directory")
        model = build_model(config)
        ckpt.restore_params(name, model)
        return cls(model, device)

    def _tensor(self, x: Any, ndim: int, name: str) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if t.ndim != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
        return t

    def _observation(self, actions: ArrayLike, audio_obs: ArrayLike,
                     vision_obs: ArrayLike) -> tuple[torch.Tensor, ...]:
        """An observe request's three streams as float32 tensors on the
        model's device, their shapes checked."""
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
        return actions, audio, vision

    def _plan(self, actions: ArrayLike, prev_state: AnyState) -> torch.Tensor:
        """An imagine request's action plan as a float32 tensor on the
        model's device, checked against the state."""
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
        return actions

    def observe(self, actions: ArrayLike, audio_obs: ArrayLike, vision_obs: ArrayLike,
                seed: int = 0) -> tuple[AnyState, AnyState]:
        """Filter observations → (posterior, prior) latent sequences ``[B, T]``.
        Frames are NHWC ``[B, T, H, W, C]``."""
        return self.observe_many([(actions, audio_obs, vision_obs, seed)])

    @torch.no_grad()
    def observe_many(self, requests: Sequence[tuple[ArrayLike, ArrayLike, ArrayLike, int]]
                     ) -> tuple[AnyState, AnyState]:
        """Observe requests ``(actions, audio, vision, seed)`` as one device
        call: their rows concatenated in order and every stream zero-padded
        to the longest T. Each request's rows and steps hold its own noise,
        ``draw_noise`` from a generator seeded with its seed, so rows ``o ..
        o + B_i`` and steps ``.. T_i`` of the returned ``[sum B_i, max T_i]``
        (posterior, prior) are what the request gets alone: the recurrence
        is causal and its rows independent."""
        streams = [self._observation(*r[:3]) for r in requests]
        bs = [x[0].shape[0] for x in streams]
        ts = [x[0].shape[1] for x in streams]
        B, T = sum(bs), max(ts)
        shapes = self.model.noise_shapes(B, T)
        noise = {k: torch.zeros(shape) for k, shape in shapes.items()}
        off = 0
        for (*_, seed), b, t in zip(requests, bs, ts):
            own = self.model.draw_noise(b, t, torch.Generator().manual_seed(int(seed)))
            for k, n in own.items():
                if len(shapes[k]) == 3:  # [T, B, ·]
                    noise[k][:t, off:off + b] = n
                else:  # [B, ·]
                    noise[k][off:off + b] = n
            off += b
        return self.model.observe(*(_batch(list(x), T) for x in zip(*streams)),
                                  {k: v.to(self.device) for k, v in noise.items()})

    def imagine(self, actions: ArrayLike, prev_state: AnyState, seed: int = 0) -> AnyState:
        """Prior-only rollout from ``prev_state`` (``[B]`` latents) under an
        action plan ``[B, T, A]``."""
        return self.imagine_many([(actions, prev_state, seed)])

    @torch.no_grad()
    def imagine_many(self, requests: Sequence[tuple[ArrayLike, AnyState, int]]) -> AnyState:
        """Imagine requests ``(actions, prev_state, seed)`` as one rollout:
        states concatenated in order, plans zero-padded to the longest T.
        Each request's rows keep its seed and their index inside it
        (``row_keys``), so rows ``o .. o + B_i`` and steps ``.. T_i`` of the
        returned ``[sum B_i, max T_i]`` state are what it gets alone."""
        plans = [self._plan(a, s) for a, s, _ in requests]
        keys = [row_keys(int(seed), p.shape[0], self.device)
                for (*_, seed), p in zip(requests, plans)]
        state = cat_states([s.to(self.device) for _, s, _ in requests], 0)
        return self.model.rollout_transition(
            _batch(plans, max(p.shape[1] for p in plans)), state,
            tuple(torch.cat(k) for k in zip(*keys)))

    @torch.no_grad()
    def decode(self, state: AnyState) -> dict[str, torch.Tensor]:
        """Reconstruct both modalities from latents → NHWC frames."""
        return self.model.decode_state(state.to(self.device))

    def imagine_frames(self, actions: ArrayLike, prev_state: AnyState,
                       seed: int = 0) -> dict[str, torch.Tensor]:
        """Imagine and decode in one call → dict of ``[B, T, H, W, C]`` frames."""
        return self.decode(self.imagine(actions, prev_state, seed))


def _batch(xs: list[torch.Tensor], T: int) -> torch.Tensor:
    """Requests' ``[B_i, T_i, ...]`` tensors zero-padded to ``T`` steps and
    concatenated on the batch axis."""
    xs = [x if x.shape[1] == T else
          torch.cat([x, x.new_zeros((x.shape[0], T - x.shape[1], *x.shape[2:]))], 1) for x in xs]
    return xs[0] if len(xs) == 1 else torch.cat(xs)

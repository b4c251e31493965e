"""Unimodal RSSM (port of ``models/rssm.py``): one encoder, one posterior
head (no fusion), one decoder, on MoPoE-MRSSM's transition.

Batch contract (one modality): ``(action_input, obs_input, action_target,
obs_target)``, frames NHWC ``[B, T, H, W, C]``; ``data.modality`` audio or
vision serves it. The ``state_dict`` names follow JAX's RSSM params under
the reference's module names: ``transition.*`` (MoPoE-MRSSM's),
``representation.rnn_to_post_projector.{0,2}.*``, ``encoder.*``,
``decoder.*`` and ``init_proj.*``.

The representation recurrence is a step loop in plain PyTorch, the port of
JAX's ``rssm.py:137-165``: no kernel exists for one posterior head without
fusion, in either package. Imagination is MoPoE-MRSSM's transition (JAX
shares ``nn/core.py::rssm_transition_core`` between both families), so it
runs the rollout kernel on the card. Two differences from JAX, whose RSSM
scans with ``jax.random`` keys and has no such field: the config carries
``use_pallas_train`` (``"auto"``/True: the rollout kernel; False/None: the
plain rollout, on any device; ``"stacked"`` raises, as for MMTRSSM), and
imagination samples from the kernel's Philox stream keyed by a seed.
"""

from __future__ import annotations

import dataclasses
import torch
from torch import nn

from multimodal_mtrssm_tpu_torch.models.mrssm import (
    MoPoEMRSSM,
    Representation,
    Rows,
    add_input_noise,
    run_steps,
)
from multimodal_mtrssm_tpu_torch.models.state import State
from multimodal_mtrssm_tpu_torch.nn.conv import Decoder, DecoderConfig, Encoder, EncoderConfig
from multimodal_mtrssm_tpu_torch.nn.core import Transition, activation, mlp, transition_step
from multimodal_mtrssm_tpu_torch.ops.distributions import gumbel_noise, kl_balanced, st_sample
from multimodal_mtrssm_tpu_torch.ops.kernels import resolve_train_kernel_mode
from multimodal_mtrssm_tpu_torch.ops.likelihood import gaussian_nll


@dataclasses.dataclass(frozen=True)
class RSSMConfig:
    """Static hyperparameters, JAX's ``RSSMConfig`` fields and
    ``use_pallas_train``."""

    deterministic_size: int = 32
    hidden_size: int = 32
    obs_embed_size: int = 64
    class_size: int = 4
    category_size: int = 4
    action_size: int = 6
    activation_name: str = "ELU"
    init_proj_cells: int = 200
    init_proj_activation: str = "Tanh"  # torchrl's default (see MRSSMConfig)
    kl_coeff: float = 1.0
    use_kl_balancing: bool = True
    # Gaussian noise on the two input streams inside shared_step: one std
    # for both or (action, obs); 0 leaves the inputs as the pipeline made them.
    input_noise_std: float | tuple[float, float] = 0.0
    # JAX's jax.checkpoint of the scan step: each step of the loop runs
    # under torch.utils.checkpoint.
    remat: bool = False
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    decoder: DecoderConfig | None = None
    # float32 or torch.bfloat16 (JAX's compute_dtype): at bf16 shared_step
    # casts its two input streams to bf16, so the encoder, the step loop and
    # the decoder run in bf16 on float32 masters, the sampling, KL and NLL
    # in float32. No kernel computes the step loop, so "auto" needs no
    # refusal; imagination from served (float32) states is unchanged.
    compute_dtype: torch.dtype = torch.float32
    # Imagination's route: "auto" or True, the rollout kernel; False or
    # None, the plain rollout on any device. "stacked" raises.
    use_pallas_train: bool | str | None = "auto"

    def __post_init__(self):
        if not isinstance(self.remat, bool):
            raise ValueError(f"remat must be a bool, got {self.remat!r}")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("compute_dtype must be torch.float32 or torch.bfloat16, got "
                             f"{self.compute_dtype!r}")
        resolve_train_kernel_mode(self.use_pallas_train, "rssm")

    @property
    def stoch_size(self) -> int:
        """Flat width of the categorical latent."""
        return self.class_size * self.category_size

    @property
    def feature_size(self) -> int:
        """Decoder input width, deter + stoch."""
        return self.deterministic_size + self.stoch_size

    def decoder_cfg(self) -> DecoderConfig:
        """The decoder config (its default at ``feature_size``)."""
        return self.decoder if self.decoder is not None else DecoderConfig(
            in_features=self.feature_size)


class RSSM(nn.Module):
    """Single-modality DreamerV2-style world model."""

    def __init__(self, config: RSSMConfig | None = None):
        super().__init__()
        cfg = self.cfg = config or RSSMConfig()
        self.plain = resolve_train_kernel_mode(cfg.use_pallas_train, "rssm") == "plain"
        S, D, H, E = cfg.stoch_size, cfg.deterministic_size, cfg.hidden_size, cfg.obs_embed_size
        self.transition = Transition(cfg.action_size, S, H, D, cfg.activation_name)
        self.representation = Representation(D + E, S, H, cfg.activation_name)
        self.encoder = Encoder(cfg.encoder)
        self.decoder = Decoder(cfg.decoder_cfg())
        self.init_proj = mlp(E, D, cfg.init_proj_cells, act=cfg.init_proj_activation)

    # MoPoE-MRSSM's: the same transition, State and noise sites.
    init = MoPoEMRSSM.init
    _dist = MoPoEMRSSM._dist
    noise_shapes = MoPoEMRSSM.noise_shapes
    draw_noise = MoPoEMRSSM.draw_noise
    initial_state_from_embed = MoPoEMRSSM.initial_state_from_embed
    # Imagination through the rollout kernel, as MoPoE-MRSSM's; ``seed``
    # keys its Philox stream.
    rollout_transition = MoPoEMRSSM.rollout_transition

    def encode_observation(self, obs: torch.Tensor) -> torch.Tensor:
        """The embedding of NHWC frames ``[..., H, W, C]``."""
        return self.encoder(obs)

    def initial_state(self, obs0: torch.Tensor, gumbel: torch.Tensor) -> State:
        """Initial latent from frame-0 observations ``[B, H, W, C]``."""
        return self.initial_state_from_embed(self.encode_observation(obs0), gumbel)

    # ---- the recurrence / imagination / decode --------------------------------
    def rollout_representation(
        self, actions: torch.Tensor, obs: torch.Tensor, prev_state: State,
        g_prior: torch.Tensor | None = None, g_post: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[State, State]:
        """Posterior and prior over ``[B, T]``; ``g_prior``/``g_post`` are
        ``[T, B, S]`` Gumbel noise, any not given drawn from ``generator``.
        Returns ``(posterior, prior)``, time on axis 1."""
        B, T = actions.shape[:2]
        noise = [g if g is not None else gumbel_noise((T, B, self.cfg.stoch_size), generator).to(
            actions.device) for g in (g_prior, g_post)]
        return self._rollout_from_embed(actions, self.encode_observation(obs), prev_state,
                                        *noise)

    def _rollout_from_embed(self, actions: torch.Tensor, embed: torch.Tensor,
                            prev_state: State, g_prior: torch.Tensor,
                            g_post: torch.Tensor) -> tuple[State, State]:
        """The step loop on an embedding sequence ``[B, T, E]``: transition,
        prior sample, the posterior head, posterior sample."""
        cfg = self.cfg
        act = activation(cfg.activation_name)
        tw = self.transition.weights()
        head = self.representation.rnn_to_post_projector

        def step(carry, x_t):
            prev_deter, prev_stoch = carry
            action_t, emb_t, gp, gq = x_t
            deter, prior_logits = transition_step(tw, action_t, prev_stoch, prev_deter, act)
            prior_stoch = st_sample(prior_logits, gp, cfg.class_size, cfg.category_size)
            post_logits = head(torch.cat([deter, emb_t], -1))
            post_stoch = st_sample(post_logits, gq, cfg.class_size, cfg.category_size)
            # The f32 sample carried in the deter's dtype (JAX rssm.py:155).
            return (deter, post_stoch.to(deter.dtype)), (deter, prior_logits, prior_stoch,
                                                         post_logits, post_stoch)

        xs = (actions.transpose(0, 1), embed.transpose(0, 1), g_prior, g_post)
        deter, prior_logits, prior_stoch, post_logits, post_stoch = run_steps(
            step, (prev_state.deter, prev_state.stoch.to(prev_state.deter.dtype)), xs, cfg.remat)
        posterior = State(deter=deter, stoch=post_stoch, logits=post_logits)
        prior = State(deter=deter, stoch=prior_stoch, logits=prior_logits)
        return posterior, prior

    def decode_state(self, state: State) -> dict[str, torch.Tensor]:
        """Reconstruct the modality as NHWC frames: ``{"recon": ...}``."""
        return {"recon": self.decoder(state.feature)}

    # ---- the ELBO -----------------------------------------------------------
    def shared_step(self, batch: tuple[torch.Tensor, ...],
                    noise: dict[str, torch.Tensor | tuple[torch.Tensor, ...]] | None = None,
                    generator: torch.Generator | None = None,
                    rows: Rows | None = None) -> dict[str, torch.Tensor]:
        """The ELBO of one 4-tuple batch ``(action_input, obs_input,
        action_target, obs_target)`` (JAX ``rssm.py:190-213``): input noise
        on the two input streams, one encoder pass that serves the initial
        state (frame 0) and the recurrence, the Gaussian NLL (event_ndims=3)
        and the balanced KL. ``noise`` may give ``g_init``, ``g_prior``,
        ``g_post`` and ``input`` (two standard-normal tensors shaped like
        the input streams); the rest is drawn from ``generator``, at the
        global batch where ``rows`` gives the batch's rows of one
        (``MoPoEMRSSM.shared_step``). Returns ``loss``, ``recon`` and
        ``kl``."""
        cfg = self.cfg
        _, posterior, prior, _ = self._observe_batch(batch, noise or {}, generator, rows)
        recon = gaussian_nll(self.decode_state(posterior)["recon"], batch[3], 3)
        kl_bt = kl_balanced(self._dist(posterior.logits), self._dist(prior.logits),
                            use_balancing=cfg.use_kl_balancing)
        kl = torch.mean(torch.sum(kl_bt, dim=-1)) * cfg.kl_coeff
        return {"recon": recon, "kl": kl, "loss": recon + kl}

    def _observe_batch(self, batch: tuple[torch.Tensor, ...], noise: dict,
                       generator: torch.Generator | None, rows: Rows | None = None
                       ) -> tuple[State, State, State, tuple[torch.Tensor, ...]]:
        """``shared_step``'s filtering half, as MoPoE-MRSSM's: input noise,
        one encoder pass for the initial state and the recurrence. Returns
        ``(initial, posterior, prior, (g_init, g_prior, g_post))``."""
        action_in, obs_in = batch[:2]
        B, T = action_in.shape[:2]
        gumbels = tuple(self.draw_noise(B, T, generator, action_in.device, noise, rows).values())
        action_in, obs_in = (x.to(self.cfg.compute_dtype) for x in add_input_noise(
            self.cfg.input_noise_std, (action_in, obs_in), noise, generator, rows))
        embed = self.encode_observation(obs_in)
        init = self.initial_state_from_embed(embed[:, 0], gumbels[0])
        posterior, prior = self._rollout_from_embed(action_in, embed, init, *gumbels[1:])
        return init, posterior, prior, gumbels

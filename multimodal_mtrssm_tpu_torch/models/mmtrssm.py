"""MoPoE-MMTRSSM (port of ``models/mmtrssm.py``): serving and the dual-KL ELBO.

The hierarchical multiple-timescale multimodal RSSM: MoPoE fusion on the
lower (fast, ``l_tau``) layer of a two-level MTRNN hierarchy, whose higher
(slow, ``h_tau``) layer's posterior sees both deterministic paths.
``MMTRSSMConfig`` defaults are the reference config
(``configs/mopoe_mmtrssm.yaml``). The model's ``state_dict`` carries exactly
the reference Lightning names that ``train/torch_export.py::
export_reference_mmtrssm_state_dict`` writes (120 tensors at the reference
config), so an exported JAX checkpoint loads with ``strict=True``; like the
JAX package it has no vestigial ``transition.*`` and no dead
``l_posterior``.

Observe and ``shared_step`` run the hierarchical recurrence kernel
(``ops.kernels.fused_mt_train_recurrence``, differentiable: forward and
backward kernels) on bulk Gumbel noise, ``[T, B, ·]`` per sample site as in
the JAX kernel path (``models/mmtrssm.py:442-448``); imagine runs the
hierarchical rollout kernel, which draws its own Philox noise from a seed.
With ``conv_layout="fused_enc"`` both encoders run the fused encoder
kernels instead of cuDNN (``models/mmtrssm.py:196-201``). On the CPU each
takes its plain version. ``shared_step`` is the ELBO:
Gaussian NLL of both reconstructions plus the balanced KL of each layer
(``models/mmtrssm.py:576-617``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch
from torch import nn

from multimodal_mtrssm_tpu_torch.models.mrssm import (
    Representation,
    Rows,
    add_input_noise,
    check_compute_route,
    check_precision_fields,
    decode_pair,
    draw_gumbels,
    encode_pair,
)
from multimodal_mtrssm_tpu_torch.models.state import MTState
from multimodal_mtrssm_tpu_torch.nn.conv import (
    Decoder,
    DecoderConfig,
    Encoder,
    EncoderConfig,
    cast_conv_out,
)
from multimodal_mtrssm_tpu_torch.nn.core import MTRNN, init_fan_in_uniform_, mlp
from multimodal_mtrssm_tpu_torch.ops.distributions import MultiOneHot, kl_balanced, st_sample
from multimodal_mtrssm_tpu_torch.ops.kernels import (
    MTSpec,
    Seed,
    fused_mt_rollout_transition,
    fused_mt_train_recurrence,
    resolve_conv_layout,
    resolve_train_kernel_mode,
)
from multimodal_mtrssm_tpu_torch.ops.likelihood import gaussian_nll


@dataclasses.dataclass(frozen=True)
class MMTRSSMConfig:
    """Static hyperparameters; the defaults are ``configs/mopoe_mmtrssm.yaml``."""

    action_size: int = 6
    obs_embed_size: int = 64
    hd_dim: int = 32
    hs_class: int = 2
    hs_category: int = 8
    ld_dim: int = 32
    ls_class: int = 4
    ls_category: int = 4
    l_tau: float = 2.0
    h_tau: float = 4.0
    # Width of the l/h prior and h-posterior MLPs.
    prior_cells: int = 32
    # Width of the audio and vision posterior heads.
    rep_hidden_size: int = 32
    activation_name: str = "ELU"
    init_proj_cells: int = 200
    # torchrl's default hidden activation (see MRSSMConfig).
    init_proj_activation: str = "Tanh"
    kl_coeff: float = 1.0
    use_kl_balancing: bool = True
    # The reference YAML's GaussianNoise input transforms, added on the
    # device in shared_step (see MRSSMConfig).
    input_noise_std: float | tuple[float, float, float] = 0.1
    # Weight of the higher layer's KL.
    w_kl_h: float = 1.0
    audio_encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    vision_encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    audio_decoder: DecoderConfig | None = None
    vision_decoder: DecoderConfig | None = None
    # "auto" or True: the hierarchical recurrence kernels; False or None:
    # the plain route, as MRSSMConfig's. "stacked" is MRSSM-only and raises
    # here, as do the JAX package's debug modes
    # (ops.kernels.resolve_train_kernel_mode).
    use_pallas_train: bool | str | None = "auto"
    # As MRSSMConfig.conv_layout: "fused_enc" runs the fused encoder
    # kernels; "auto", "nhwc" and "s2d" the canonical cuDNN layout.
    conv_layout: str = "auto"
    # As MRSSMConfig's: remat (both routes recompute a step from the saved
    # carries already), scan_unroll (accepted and unused), compute_dtype
    # (float32, or torch.bfloat16 on the plain route) and conv_dtype (None
    # or torch.bfloat16, trainer.precision 16-mixed).
    remat: bool = False
    scan_unroll: int = 1
    compute_dtype: torch.dtype = torch.float32
    conv_dtype: torch.dtype | None = None

    def __post_init__(self):
        check_precision_fields(self)

    @property
    def hs_dim(self) -> int:
        """Flat width of the higher latent."""
        return self.hs_class * self.hs_category

    @property
    def ls_dim(self) -> int:
        """Flat width of the lower latent."""
        return self.ls_class * self.ls_category

    @property
    def feature_size(self) -> int:
        """Decoder input width, ``hd + hs + ld + ls`` (reference ``core.py:196-204``)."""
        return self.hd_dim + self.hs_dim + self.ld_dim + self.ls_dim

    @property
    def spec(self) -> MTSpec:
        """The kernels' static sizes."""
        return MTSpec(self.l_tau, self.h_tau, self.ls_class, self.ls_category, self.hs_class,
                      self.hs_category)

    def decoder_cfg(self, which: str) -> DecoderConfig:
        """The decoder config for ``"audio"`` or ``"vision"``."""
        cfg = getattr(self, f"{which}_decoder")
        return cfg if cfg is not None else DecoderConfig(in_features=self.feature_size)


class MoPoEMMTRSSM(nn.Module):
    """Hierarchical multimodal MTRSSM with a MoPoE posterior on the lower layer."""

    def __init__(self, config: MMTRSSMConfig | None = None):
        super().__init__()
        cfg = self.cfg = config or MMTRSSMConfig()
        self.fused_enc = resolve_conv_layout(
            cfg.conv_layout, (cfg.audio_encoder, cfg.vision_encoder)) == "fused_enc"
        mode = resolve_train_kernel_mode(cfg.use_pallas_train, "mmtrssm")
        check_compute_route(cfg, mode)
        self.plain = mode == "plain"
        A, E, act = cfg.action_size, cfg.obs_embed_size, cfg.activation_name
        HD, LD, HS, LS, C = cfg.hd_dim, cfg.ld_dim, cfg.hs_dim, cfg.ls_dim, cfg.prior_cells
        self.l_rnn = MTRNN(A + LS + HS, LD, cfg.l_tau)
        self.h_rnn = MTRNN(HS, HD, cfg.h_tau)
        self.l_prior = mlp(LD, LS, C, act=act)
        self.h_prior = mlp(HD, HS, C, act=act)
        self.h_posterior = mlp(LD + HD, HS, C, act=act)
        self.audio_representation = Representation(LD + E, LS, cfg.rep_hidden_size, act)
        self.vision_representation = Representation(LD + E, LS, cfg.rep_hidden_size, act)
        self.audio_encoder = Encoder(cfg.audio_encoder)
        self.vision_encoder = Encoder(cfg.vision_encoder)
        self.audio_decoder = Decoder(cfg.decoder_cfg("audio"))
        self.vision_decoder = Decoder(cfg.decoder_cfg("vision"))
        self.init_proj = mlp(E, HD + LD, cfg.init_proj_cells, act=cfg.init_proj_activation)

    def init(self, generator: torch.Generator) -> "MoPoEMMTRSSM":
        """Fill every parameter with torch's fan-in uniform init, drawn from
        ``generator`` (a CPU generator: the draw is the same on any device)."""
        init_fan_in_uniform_(self, generator)
        return self

    # ---- weight views for the kernels -------------------------------------
    def recurrence_weights(self) -> tuple[torch.Tensor, ...]:
        """The recurrence kernel's 28 tensors (``train_step_mt.py:39-54``):
        both MTRNNs, the l-prior, h-prior and h-posterior MLPs, the audio and
        vision heads (w1, b1, w2, b2 each). The first 16 are the rollout's."""
        heads = []
        for seq in (self.l_prior, self.h_prior, self.h_posterior,
                    self.audio_representation.rnn_to_post_projector,
                    self.vision_representation.rnn_to_post_projector):
            heads += [seq[0].weight, seq[0].bias, seq[2].weight, seq[2].bias]
        return (*self.l_rnn.weights(), *self.h_rnn.weights(), *heads)

    def rollout_weights(self) -> tuple[torch.Tensor, ...]:
        """The rollout kernel's 16 tensors: both MTRNNs and both priors."""
        return self.recurrence_weights()[:16]

    # ---- encode / initial state ---------------------------------------------
    def encode_embeds(self, audio_obs: torch.Tensor,
                      vision_obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-modality embeddings of NHWC frames ``[..., H, W, C]``, in the
        conv dtype (``encode_pair``)."""
        return encode_pair(self, audio_obs, vision_obs)

    def encode_observation(self, audio_obs: torch.Tensor, vision_obs: torch.Tensor) -> torch.Tensor:
        """Mean-fused embedding (reference ``mopoe_mrssm/core.py:165-182``)."""
        a, v = self.encode_embeds(audio_obs, vision_obs)
        return cast_conv_out(self.cfg, (a + v) / 2.0)

    def initial_state_from_embed(self, embed: torch.Tensor, g_init_h: torch.Tensor,
                                 g_init_l: torch.Tensor) -> MTState:
        """Initial hierarchical latent from a fused embedding ``[B, E]``
        (reference ``core.py:321-362``): ``init_proj(embed)`` split into its
        ``[hd | ld]`` halves seeds both deters and both integrators; each
        stoch is the straight-through sample of its prior for the given
        ``[B, ·]`` Gumbel noise."""
        cfg = self.cfg
        h = self.init_proj(embed)
        higher, lower = h[..., :cfg.hd_dim], h[..., cfg.hd_dim:]
        h_logits, l_logits = self.h_prior(higher), self.l_prior(lower)
        return MTState(
            deter_h=higher, deter_l=lower,
            stoch_h=st_sample(h_logits, g_init_h, cfg.hs_class, cfg.hs_category),
            stoch_l=st_sample(l_logits, g_init_l, cfg.ls_class, cfg.ls_category),
            logits_h=h_logits, logits_l=l_logits, hidden_h=higher, hidden_l=lower)

    def initial_state(self, audio_obs0: torch.Tensor, vision_obs0: torch.Tensor,
                      g_init_h: torch.Tensor, g_init_l: torch.Tensor) -> MTState:
        """Initial latent from frame-0 observations."""
        return self.initial_state_from_embed(self.encode_observation(audio_obs0, vision_obs0),
                                             g_init_h, g_init_l)

    # ---- observe / imagine / decode -----------------------------------------
    def noise_shapes(self, B: int, T: int) -> dict[str, tuple[int, ...]]:
        """Shapes of the observe path's Gumbel noise, in draw order: both
        initial samples, then the four ``[T, B, ·]`` sites of the recurrence
        (``train_step_mt.py:443-448``)."""
        LS, HS = self.cfg.ls_dim, self.cfg.hs_dim
        return {"g_init_h": (B, HS), "g_init_l": (B, LS), "g_lprior": (T, B, LS),
                "g_lpost": (T, B, LS), "g_hprior": (T, B, HS), "g_hpost": (T, B, HS)}

    def draw_noise(self, B: int, T: int, generator: torch.Generator | None = None,
                   device: torch.device | str | None = None,
                   given: Mapping[str, torch.Tensor] | None = None,
                   rows: Rows | None = None) -> dict[str, torch.Tensor]:
        """The observe path's noise (:meth:`noise_shapes`): each tensor of
        ``given`` as it is, the rest drawn from ``generator`` in order; with
        ``rows`` drawn at the global batch and cut to them (``draw_gumbels``)."""
        return draw_gumbels(self.noise_shapes(rows[2] if rows else B, T), generator, device,
                            given, rows)

    def observe(self, actions: torch.Tensor, audio_obs: torch.Tensor, vision_obs: torch.Tensor,
                noise: Mapping[str, torch.Tensor]) -> tuple[MTState, MTState]:
        """Initial state from frame 0, then the posterior and prior over
        ``[B, T]`` on the given noise (:meth:`draw_noise`'s keys)."""
        init = self.initial_state(audio_obs[:, 0], vision_obs[:, 0], noise["g_init_h"],
                                  noise["g_init_l"])
        return self.rollout_representation(actions, audio_obs, vision_obs, init, noise)

    def rollout_representation(
        self, actions: torch.Tensor, audio_obs: torch.Tensor, vision_obs: torch.Tensor,
        prev_state: MTState, noise: Mapping[str, torch.Tensor] | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[MTState, MTState]:
        """Posterior and prior over ``[B, T]`` (reference ``core.py:364-494``)
        through the recurrence kernel. ``noise`` may give the four sites'
        ``[T, B, ·]`` Gumbel noise (:meth:`noise_shapes`' keys); what it does
        not give is drawn from ``generator``. Returns ``(posterior, prior)``
        with time on axis 1."""
        B, T = actions.shape[:2]
        noise = self.draw_noise(B, T, generator, actions.device, noise)
        return self._rollout_from_embeds(actions, *self.encode_embeds(audio_obs, vision_obs),
                                         prev_state, noise)

    def _rollout_from_embeds(self, actions: torch.Tensor, a_emb: torch.Tensor,
                             v_emb: torch.Tensor, prev_state: MTState,
                             noise: Mapping[str, torch.Tensor]) -> tuple[MTState, MTState]:
        """The recurrence on per-modality embeddings ``[B, T, E]`` (in the
        conv dtype) and the sites' ``[T, B, ·]`` noise; returns
        ``(posterior, prior)``, time on axis 1."""
        cfg = self.cfg
        tm = lambda x: x.transpose(0, 1).contiguous()  # noqa: E731
        p = prev_state
        init6 = tuple(x.contiguous() for x in (p.deter_h, p.deter_l, p.stoch_h, p.stoch_l,
                                               p.hidden_h, p.hidden_l))
        gumbels = tuple(noise[k].contiguous() for k in ("g_lprior", "g_lpost", "g_hprior",
                                                        "g_hpost"))
        outs = fused_mt_train_recurrence(
            self.recurrence_weights(), tm(actions), tm(cast_conv_out(cfg, a_emb)),
            tm(cast_conv_out(cfg, v_emb)), init6, gumbels, cfg.spec, cfg.activation_name,
            self.plain)
        (h_deter, l_deter, hid_h, hid_l, lp_logits, lp_stoch, mixed, l_stoch,
         hp_logits, hp_stoch, hq_logits, h_stoch) = (x.transpose(0, 1) for x in outs)
        prior = MTState(deter_h=h_deter, deter_l=l_deter, stoch_h=hp_stoch, stoch_l=lp_stoch,
                        logits_h=hp_logits, logits_l=lp_logits, hidden_h=hid_h, hidden_l=hid_l)
        posterior = MTState(deter_h=h_deter, deter_l=l_deter, stoch_h=h_stoch, stoch_l=l_stoch,
                            logits_h=hq_logits, logits_l=mixed, hidden_h=hid_h, hidden_l=hid_l)
        return posterior, prior

    def rollout_transition(self, actions: torch.Tensor, prev_state: MTState,
                           seed: Seed) -> MTState:
        """Prior-only imagination over ``[B, T]`` actions (reference
        ``core.py:496-544``) through the rollout kernel; stochs are one-hot
        samples from the seed's Philox stream (an ``int`` or per-row keys, as
        ``MoPoEMRSSM.rollout_transition``). The integrator trajectories make
        a continuation from ``[:, -1]`` exact."""
        cfg = self.cfg
        p = prev_state
        init6 = tuple(x.contiguous() for x in (p.deter_h, p.deter_l, p.stoch_h, p.stoch_l,
                                               p.hidden_h, p.hidden_l))
        (h_deter, l_deter, h_logits, l_logits, h_stoch, l_stoch, hid_h,
         hid_l) = fused_mt_rollout_transition(self.rollout_weights(), actions.contiguous(), init6,
                                              seed, cfg.spec, cfg.activation_name, self.plain)
        return MTState(deter_h=h_deter, deter_l=l_deter, stoch_h=h_stoch, stoch_l=l_stoch,
                       logits_h=h_logits, logits_l=l_logits, hidden_h=hid_h, hidden_l=hid_l)

    def decode_state(self, state: MTState) -> dict[str, torch.Tensor]:
        """Reconstruct both modalities as NHWC frames from the 96-wide
        feature (reference ``core.py:546-561``)."""
        return decode_pair(self, state.feature)

    # ---- the ELBO -----------------------------------------------------------
    def _l_dist(self, logits: torch.Tensor) -> MultiOneHot:
        return MultiOneHot(logits, self.cfg.ls_class, self.cfg.ls_category)

    def _h_dist(self, logits: torch.Tensor) -> MultiOneHot:
        return MultiOneHot(logits, self.cfg.hs_class, self.cfg.hs_category)

    def compute_reconstruction_loss(self, reconstructions: dict[str, torch.Tensor],
                                    targets: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Per-modality Gaussian NLL, summed (event_ndims=3)."""
        audio = gaussian_nll(reconstructions["recon/audio"], targets["recon/audio"], 3)
        vision = gaussian_nll(reconstructions["recon/vision"], targets["recon/vision"], 3)
        return {"recon": audio + vision, "recon/audio": audio, "recon/vision": vision}

    def shared_step(self, batch: tuple[torch.Tensor, ...],
                    noise: Mapping[str, torch.Tensor | tuple[torch.Tensor, ...]] | None = None,
                    generator: torch.Generator | None = None,
                    rows: Rows | None = None) -> dict[str, torch.Tensor]:
        """The dual-KL ELBO of one batch (reference ``core.py:563-606``).

        ``batch`` is the 6-tuple (action_input, audio_in, vision_in,
        action_target, audio_target, vision_target), frames NHWC
        ``[B, T, H, W, C]``. ``noise`` may give the Gumbel tensors of
        :meth:`noise_shapes` and ``input``, three standard-normal tensors
        shaped like the input streams (used where ``input_noise_std`` > 0);
        what it does not give is drawn from ``generator`` (a generator on the
        model's device; torch's default generator of that device if None),
        at the global batch where ``rows`` gives the batch's rows of one
        (``MoPoEMRSSM.shared_step``). Returns ``loss``, ``recon``,
        ``recon/audio``, ``recon/vision``, ``kl`` (the lower layer's) and
        ``kl_h``."""
        cfg = self.cfg
        _, posterior, prior, _ = self._observe_batch(batch, noise or {}, generator, rows)
        losses = self.compute_reconstruction_loss(
            self.decode_state(posterior), {"recon/audio": batch[4], "recon/vision": batch[5]})
        # Each KL summed over time, then the batch mean.
        kl_l = kl_balanced(self._l_dist(posterior.logits_l), self._l_dist(prior.logits_l),
                           use_balancing=cfg.use_kl_balancing)
        kl_h = kl_balanced(self._h_dist(posterior.logits_h), self._h_dist(prior.logits_h),
                           use_balancing=cfg.use_kl_balancing)
        losses["kl"] = torch.mean(torch.sum(kl_l, dim=-1)) * cfg.kl_coeff
        losses["kl_h"] = torch.mean(torch.sum(kl_h, dim=-1)) * (cfg.kl_coeff * cfg.w_kl_h)
        losses["loss"] = losses["recon"] + losses["kl"] + losses["kl_h"]
        return losses

    def _observe_batch(self, batch: tuple[torch.Tensor, ...], noise: Mapping,
                       generator: torch.Generator | None, rows: Rows | None = None
                       ) -> tuple[MTState, MTState, MTState, dict[str, torch.Tensor]]:
        """``shared_step``'s filtering half: input noise, one encoder pass
        that serves the initial state (frame 0) and the recurrence, as in
        the JAX package. Returns ``(initial, posterior, prior, gumbels)``."""
        action_in, audio_in, vision_in = batch[:3]
        B, T = action_in.shape[:2]
        gumbels = self.draw_noise(B, T, generator, action_in.device, noise, rows)
        action_in, audio_in, vision_in = (x.to(self.cfg.compute_dtype) for x in add_input_noise(
            self.cfg.input_noise_std, (action_in, audio_in, vision_in), noise, generator, rows))
        a_emb, v_emb = self.encode_embeds(audio_in, vision_in)
        init = self.initial_state_from_embed(
            cast_conv_out(self.cfg, (a_emb[:, 0] + v_emb[:, 0]) / 2.0), gumbels["g_init_h"],
            gumbels["g_init_l"])
        posterior, prior = self._rollout_from_embeds(action_in, a_emb, v_emb, init, gumbels)
        return init, posterior, prior, gumbels

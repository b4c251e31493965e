"""MoPoE-MRSSM (port of ``models/mrssm.py``): serving and the ELBO.

``MRSSMConfig`` defaults are the reference config (``configs/mopoe_mrssm.yaml``).
The model is an ``nn.Module`` whose ``state_dict`` carries the reference
Lightning names that ``train/torch_export.py`` writes, so a JAX checkpoint
exported there loads with ``strict=True`` (``train/weights.py``).

Observe and ``shared_step`` run the representation recurrence kernel
(``ops.kernels``, differentiable: forward and backward kernels) on bulk
Gumbel noise, ``[T, B, S]`` per sample site as in the JAX package's kernel
path (``models/mrssm.py:491-500``), or with ``use_pallas_train="stacked"``
the stacked-layout kernels on the same noise; imagine runs the rollout
kernel, which draws its own Philox noise from a seed. With
``conv_layout="fused_enc"`` both encoders run the fused encoder kernels
instead of cuDNN (``models/mrssm.py:270-289``). On the CPU each takes its
plain version. ``shared_step`` is the ELBO: Gaussian NLL of both reconstructions
plus the balanced KL (``models/mrssm.py:597-642``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodal_mtrssm_tpu_torch.models.state import State
from multimodal_mtrssm_tpu_torch.nn.conv import (
    Decoder,
    DecoderConfig,
    Encoder,
    EncoderConfig,
    cast_conv_in,
    cast_conv_out,
)
from multimodal_mtrssm_tpu_torch.nn.core import Transition, init_fan_in_uniform_, mlp
from multimodal_mtrssm_tpu_torch.ops.distributions import (
    MultiOneHot,
    gumbel_noise,
    kl_balanced,
    st_sample,
)
from multimodal_mtrssm_tpu_torch.ops.kernels import (
    PLAIN_ROUTE,
    Seed,
    fused_encoder_apply,
    fused_rollout_transition,
    fused_train_recurrence,
    fused_train_recurrence_stacked,
    resolve_conv_layout,
    resolve_train_kernel_mode,
)
from multimodal_mtrssm_tpu_torch.ops.likelihood import gaussian_nll

# A data-parallel rank's rows ``(lo, hi, n)`` of a global batch of ``n`` rows.
Rows = tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class MRSSMConfig:
    """Static hyperparameters; the defaults are ``configs/mopoe_mrssm.yaml``."""

    deterministic_size: int = 32
    hidden_size: int = 32
    obs_embed_size: int = 64
    class_size: int = 4
    category_size: int = 4
    action_size: int = 6
    activation_name: str = "ELU"
    init_proj_cells: int = 200
    # torchrl's default hidden activation: the reference config names none
    # for init_proj (the JAX package's ``mrssm.py:63-67``).
    init_proj_activation: str = "Tanh"
    kl_coeff: float = 1.0
    use_kl_balancing: bool = True
    # Gaussian noise on the three input streams inside shared_step, one std
    # for all or (action, audio, vision); 0 leaves the inputs as the data
    # pipeline made them. The reference YAML's GaussianNoise input
    # transforms land here (JAX train/config.py), with the pipeline's
    # noise_std then 0.
    input_noise_std: float | tuple[float, float, float] = 0.1
    audio_encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    vision_encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    audio_decoder: DecoderConfig | None = None
    vision_decoder: DecoderConfig | None = None
    # The representation recurrence's kernels: "auto" or True, the
    # recurrence kernels; "stacked", the stacked-layout kernels (fewer,
    # wider products a step); False or None, the plain route: the
    # recurrence and the rollout as their plain versions on any device, for
    # any activation and shape (JAX's XLA scan; unlike JAX it also selects
    # imagination's route). The JAX package's debug modes raise
    # (ops.kernels.resolve_train_kernel_mode).
    use_pallas_train: bool | str | None = "auto"
    # JAX's jax.checkpoint of the scan step. Both of the port's routes
    # already recompute a step in the backward from the saved carries (the
    # backward kernels, and RecurrenceFunction, which saves the inputs and
    # the carries only), so True and False train alike.
    remat: bool = False
    # JAX's lax.scan unroll factor: accepted and unused (no scan here).
    scan_unroll: int = 1
    # The model's dtype, float32 or torch.bfloat16 (JAX's compute_dtype):
    # at bf16 shared_step casts its three input streams to bf16, so the
    # encoders, the recurrence and the decoders run in bf16 on float32
    # masters, with fusion, sampling, the KL and the NLL in float32. No
    # kernel computes a bf16 recurrence (JAX gates its kernel off), so bf16
    # needs use_pallas_train=False or None, the plain route. Serving
    # observes float32 frames in float32, as JAX's WorldModel does.
    compute_dtype: torch.dtype = torch.float32
    # The conv stacks' dtype: None (the compute dtype) or torch.bfloat16,
    # which trainer.precision 16-mixed selects: bf16 encoders and decoders,
    # their outputs cast back to the compute dtype (nn.conv.cast_conv_in/out).
    conv_dtype: torch.dtype | None = None
    # "fused_enc": both encoders run the fused encoder kernels, and
    # construction raises if an encoder is not eligible; "auto", "nhwc" and
    # "s2d" run the canonical cuDNN layout (s2d is a TPU lane layout of the
    # same math, not ported). ops.kernels.resolve_conv_layout.
    conv_layout: str = "auto"

    def __post_init__(self):
        check_precision_fields(self)

    @property
    def stoch_size(self) -> int:
        """Flat width of the categorical latent."""
        return self.class_size * self.category_size

    @property
    def feature_size(self) -> int:
        """Decoder input width, deter + stoch."""
        return self.deterministic_size + self.stoch_size

    def decoder_cfg(self, which: str) -> DecoderConfig:
        """The decoder config for ``"audio"`` or ``"vision"``."""
        cfg = getattr(self, f"{which}_decoder")
        return cfg if cfg is not None else DecoderConfig(in_features=self.feature_size)


class Representation(nn.Module):
    """A posterior head: MLP over ``cat(deter, obs_embed)`` (reference
    ``networks.py:18-84``)."""

    def __init__(self, in_dim: int, stoch_size: int, hidden_size: int, activation_name: str):
        super().__init__()
        self.rnn_to_post_projector = mlp(in_dim, stoch_size, hidden_size, act=activation_name)


class MoPoEMRSSM(nn.Module):
    """Multimodal RSSM with a MoPoE posterior over audio and vision."""

    # Whether use_pallas_train "auto"/True trains on the recurrence kernels
    # (and so refuses a bf16 compute dtype): not the weighted model's.
    trains_on_kernels = True

    def __init__(self, config: MRSSMConfig | None = None):
        super().__init__()
        cfg = self.cfg = config or MRSSMConfig()
        self.fused_enc = resolve_conv_layout(
            cfg.conv_layout, (cfg.audio_encoder, cfg.vision_encoder)) == "fused_enc"
        mode = resolve_train_kernel_mode(cfg.use_pallas_train, "mrssm")
        if self.trains_on_kernels:
            check_compute_route(cfg, mode)
        self.stacked, self.plain = mode == "stacked", mode == "plain"
        S, D, H, E = cfg.stoch_size, cfg.deterministic_size, cfg.hidden_size, cfg.obs_embed_size
        self.transition = Transition(cfg.action_size, S, H, D, cfg.activation_name)
        self.audio_representation = Representation(D + E, S, H, cfg.activation_name)
        self.vision_representation = Representation(D + E, S, H, cfg.activation_name)
        self.audio_encoder = Encoder(cfg.audio_encoder)
        self.vision_encoder = Encoder(cfg.vision_encoder)
        self.audio_decoder = Decoder(cfg.decoder_cfg("audio"))
        self.vision_decoder = Decoder(cfg.decoder_cfg("vision"))
        self.init_proj = mlp(E, D, cfg.init_proj_cells, act=cfg.init_proj_activation)

    def init(self, generator: torch.Generator) -> "MoPoEMRSSM":
        """Fill every parameter with torch's fan-in uniform init, drawn from
        ``generator`` (a CPU generator: the draw is the same on any device)."""
        init_fan_in_uniform_(self, generator)
        return self

    # ---- weight views for the kernels -------------------------------------
    def representation_weights(self) -> tuple[torch.Tensor, ...]:
        """The recurrence kernel's 20 tensors: the transition's 12, then the
        audio and vision posterior heads (w1, b1, w2, b2 each)."""
        heads = []
        for rep in (self.audio_representation, self.vision_representation):
            seq = rep.rnn_to_post_projector
            heads += [seq[0].weight, seq[0].bias, seq[2].weight, seq[2].bias]
        return (*self.transition.weights(), *heads)

    # ---- encode / initial state ---------------------------------------------
    def encode_embeds(self, audio_obs: torch.Tensor,
                      vision_obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-modality embeddings of NHWC frames ``[..., H, W, C]``, in the
        conv dtype (:func:`encode_pair`)."""
        return encode_pair(self, audio_obs, vision_obs)

    def encode_observation(self, audio_obs: torch.Tensor, vision_obs: torch.Tensor) -> torch.Tensor:
        """Mean-fused embedding (reference ``mopoe_mrssm/core.py:165-182``)."""
        a, v = self.encode_embeds(audio_obs, vision_obs)
        return cast_conv_out(self.cfg, (a + v) / 2.0)

    def initial_state_from_embed(self, embed: torch.Tensor, gumbel: torch.Tensor) -> State:
        """Initial latent from a fused embedding ``[B, E]``; the stoch is the
        straight-through sample for the given ``[B, S]`` Gumbel noise."""
        deter = self.init_proj(embed)
        logits = self.transition.rnn_to_prior_projector(deter)
        stoch = st_sample(logits, gumbel, self.cfg.class_size, self.cfg.category_size)
        return State(deter=deter, stoch=stoch, logits=logits)

    def initial_state(self, audio_obs0: torch.Tensor, vision_obs0: torch.Tensor,
                      gumbel: torch.Tensor) -> State:
        """Initial latent from frame-0 observations (reference ``core.py:121-135``)."""
        return self.initial_state_from_embed(self.encode_observation(audio_obs0, vision_obs0),
                                             gumbel)

    # ---- observe / imagine / decode -----------------------------------------
    def noise_shapes(self, B: int, T: int) -> dict[str, tuple[int, ...]]:
        """Shapes of the observe path's Gumbel noise, in draw order: the
        initial sample, then the ``[T, B, S]`` prior and posterior sites."""
        S = self.cfg.stoch_size
        return {"g_init": (B, S), "g_prior": (T, B, S), "g_post": (T, B, S)}

    def draw_noise(self, B: int, T: int, generator: torch.Generator | None = None,
                   device: torch.device | str | None = None,
                   given: Mapping[str, torch.Tensor] | None = None,
                   rows: Rows | None = None) -> dict[str, torch.Tensor]:
        """The observe path's noise (:meth:`noise_shapes`): each tensor of
        ``given`` as it is, the rest drawn from ``generator`` in order; with
        ``rows`` drawn at the global batch and cut to them (:func:`draw_gumbels`)."""
        return draw_gumbels(self.noise_shapes(rows[2] if rows else B, T), generator, device,
                            given, rows)

    def observe(self, actions: torch.Tensor, audio_obs: torch.Tensor, vision_obs: torch.Tensor,
                noise: Mapping[str, torch.Tensor]) -> tuple[State, State]:
        """Initial state from frame 0, then the posterior and prior over
        ``[B, T]`` on the given noise (:meth:`draw_noise`'s keys)."""
        init = self.initial_state(audio_obs[:, 0], vision_obs[:, 0], noise["g_init"])
        return self.rollout_representation(actions, audio_obs, vision_obs, init,
                                           noise["g_prior"], noise["g_post"])

    def rollout_representation(
        self, actions: torch.Tensor, audio_obs: torch.Tensor, vision_obs: torch.Tensor,
        prev_state: State, g_prior: torch.Tensor | None = None,
        g_post: torch.Tensor | None = None, generator: torch.Generator | None = None,
    ) -> tuple[State, State]:
        """Posterior and prior over ``[B, T]`` (reference
        ``mopoe_mrssm/core.py:184-260``), through the recurrence kernel.

        ``g_prior``/``g_post`` are ``[T, B, S]`` Gumbel noise; any not given
        is drawn from ``generator`` (torch's default generator if None).
        Returns ``(posterior, prior)`` with time on axis 1."""
        B, T = actions.shape[:2]
        noise = [g if g is not None else gumbel_noise((T, B, self.cfg.stoch_size), generator).to(
            actions.device) for g in (g_prior, g_post)]
        return self._rollout_from_embeds(actions, *self.encode_embeds(audio_obs, vision_obs),
                                         prev_state, *noise)

    def _rollout_from_embeds(self, actions: torch.Tensor, a_emb: torch.Tensor,
                             v_emb: torch.Tensor, prev_state: State, g_prior: torch.Tensor,
                             g_post: torch.Tensor) -> tuple[State, State]:
        """The recurrence on per-modality embeddings ``[B, T, E]`` (in the
        conv dtype) and ``[T, B, S]`` noise; returns ``(posterior, prior)``,
        time on axis 1."""
        cfg = self.cfg
        tm = lambda x: x.transpose(0, 1).contiguous()  # noqa: E731
        args = (self.representation_weights(), tm(actions), tm(cast_conv_out(cfg, a_emb)),
                tm(cast_conv_out(cfg, v_emb)), prev_state.deter.contiguous(),
                prev_state.stoch.contiguous(), g_prior.contiguous(), g_post.contiguous(),
                cfg.class_size, cfg.category_size, cfg.activation_name)
        if self.stacked:
            outs = fused_train_recurrence_stacked(*args)
        else:
            outs = fused_train_recurrence(*args, plain=self.plain)
        deter, prior_logits, prior_stoch, mixed, post_stoch = (x.transpose(0, 1) for x in outs)
        posterior = State(deter=deter, stoch=post_stoch, logits=mixed)
        prior = State(deter=deter, stoch=prior_stoch, logits=prior_logits)
        return posterior, prior

    def rollout_transition(self, actions: torch.Tensor, prev_state: State, seed: Seed) -> State:
        """Prior-only imagination over ``[B, T]`` actions (reference
        ``core.py:170-185``) through the rollout kernel; stochs are one-hot
        samples from the seed's Philox stream, as in the JAX kernel path.
        ``seed`` is one request's ``int`` or each row's ``(row_seed,
        row_index)`` (``ops.kernels.rollout.row_keys``)."""
        cfg = self.cfg
        deters, logits, stochs = fused_rollout_transition(
            self.transition.weights(), actions.contiguous(), prev_state.deter.contiguous(),
            prev_state.stoch.contiguous(), seed, cfg.class_size, cfg.category_size,
            cfg.activation_name, self.plain,
        )
        return State(deter=deters, stoch=stochs, logits=logits)

    def decode_state(self, state: State) -> dict[str, torch.Tensor]:
        """Reconstruct both modalities as NHWC frames (reference
        ``mopoe_mrssm/core.py:262-277``)."""
        return decode_pair(self, state.feature)

    # ---- the ELBO -----------------------------------------------------------
    def _dist(self, logits: torch.Tensor) -> MultiOneHot:
        return MultiOneHot(logits, self.cfg.class_size, self.cfg.category_size)

    def compute_reconstruction_loss(self, reconstructions: dict[str, torch.Tensor],
                                    targets: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Per-modality Gaussian NLL, summed (reference
        ``mopoe_mrssm/core.py:279-308``; event_ndims=3)."""
        audio = gaussian_nll(reconstructions["recon/audio"], targets["recon/audio"], 3)
        vision = gaussian_nll(reconstructions["recon/vision"], targets["recon/vision"], 3)
        return {"recon": audio + vision, "recon/audio": audio, "recon/vision": vision}

    def shared_step(self, batch: tuple[torch.Tensor, ...],
                    noise: dict[str, torch.Tensor | tuple[torch.Tensor, ...]] | None = None,
                    generator: torch.Generator | None = None,
                    rows: Rows | None = None) -> dict[str, torch.Tensor]:
        """The ELBO of one batch (reference ``core.py:187-221``).

        ``batch`` is the 6-tuple (action_input, audio_in, vision_in,
        action_target, audio_target, vision_target), frames NHWC
        ``[B, T, H, W, C]``. ``noise`` may give ``g_init`` ``[B, S]``,
        ``g_prior`` and ``g_post`` ``[T, B, S]`` (Gumbel) and ``input``, three
        standard-normal tensors shaped like the input streams (used where
        ``input_noise_std`` > 0); what it does not give is drawn from
        ``generator`` (a generator on the model's device; torch's default
        generator of that device if None). With ``rows`` (``(lo, hi, n)``:
        ``batch`` is rows ``[lo, hi)`` of a global batch of ``n``, as a
        data-parallel rank holds it) what is drawn is drawn at ``n`` rows in
        the same order and cut to the batch's, so the noise is the global
        batch's whatever the world size. Returns ``loss``, ``recon``,
        ``recon/audio``, ``recon/vision`` and ``kl``."""
        _, posterior, prior, _ = self._observe_batch(batch, noise or {}, generator, rows)
        losses = self.compute_reconstruction_loss(
            self.decode_state(posterior), {"recon/audio": batch[4], "recon/vision": batch[5]})
        # KL summed over time, then the batch mean (reference core.py:212-218).
        kl_bt = kl_balanced(self._dist(posterior.logits), self._dist(prior.logits),
                            use_balancing=self.cfg.use_kl_balancing)
        losses["kl"] = torch.mean(torch.sum(kl_bt, dim=-1)) * self.cfg.kl_coeff
        losses["loss"] = losses["recon"] + losses["kl"]
        return losses

    def _observe_batch(self, batch: tuple[torch.Tensor, ...], noise: dict,
                       generator: torch.Generator | None, rows: Rows | None = None
                       ) -> tuple[State, State, State, tuple[torch.Tensor, ...]]:
        """``shared_step``'s filtering half: input noise, one encoder pass
        that serves the initial state (frame 0) and the recurrence, as in
        the JAX package. Returns ``(initial, posterior, prior, (g_init,
        g_prior, g_post))``."""
        cfg = self.cfg
        action_in, audio_in, vision_in = batch[:3]
        dev = action_in.device
        B, T = action_in.shape[:2]
        gumbels = tuple(self.draw_noise(B, T, generator, dev, noise, rows).values())
        action_in, audio_in, vision_in = (x.to(cfg.compute_dtype) for x in add_input_noise(
            cfg.input_noise_std, (action_in, audio_in, vision_in), noise, generator, rows))
        a_emb, v_emb = self.encode_embeds(audio_in, vision_in)
        init = self.initial_state_from_embed(
            cast_conv_out(cfg, (a_emb[:, 0] + v_emb[:, 0]) / 2.0), gumbels[0])
        posterior, prior = self._rollout_from_embeds(action_in, a_emb, v_emb, init, *gumbels[1:])
        return init, posterior, prior, gumbels


def run_steps(step: Callable, carry: tuple[torch.Tensor, ...], xs: tuple[torch.Tensor, ...],
              remat: bool = False) -> tuple[torch.Tensor, ...]:
    """A step loop over time-major ``xs`` (each ``[T, ...]``), the plain
    PyTorch form of JAX's ``lax.scan``: ``step(carry, x_t) → (carry, ys)``,
    and the ``ys`` of every step stacked on axis 1 (``[B, T, ...]``). With
    ``remat`` each step runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward, as JAX's ``jax.checkpoint`` of the step."""
    n = len(carry)
    outs = []
    for t in range(xs[0].shape[0]):
        x_t = tuple(x[t] for x in xs)
        if remat:
            carry, ys = checkpoint(lambda *a: step(a[:n], a[n:]), *carry, *x_t,
                                   use_reentrant=False)
        else:
            carry, ys = step(carry, x_t)
        outs.append(ys)
    return tuple(torch.stack(seq, 1) for seq in zip(*outs))


def check_precision_fields(cfg) -> None:
    """Either family's ``remat``, ``scan_unroll``, ``compute_dtype`` and
    ``conv_dtype``."""
    if not isinstance(cfg.remat, bool):
        raise ValueError(f"remat must be a bool, got {cfg.remat!r}")
    if isinstance(cfg.scan_unroll, bool) or not isinstance(cfg.scan_unroll, int) \
            or cfg.scan_unroll < 1:
        raise ValueError(f"scan_unroll must be an int >= 1, got {cfg.scan_unroll!r}")
    if cfg.conv_dtype not in (None, torch.bfloat16):
        raise ValueError(f"conv_dtype must be None or torch.bfloat16, got {cfg.conv_dtype!r}")
    if cfg.compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute_dtype must be torch.float32 or torch.bfloat16, got "
                         f"{cfg.compute_dtype!r}")


def check_compute_route(cfg, mode: str) -> None:
    """Refuse a bf16 ``compute_dtype`` on the recurrence kernels (``mode``
    "kernel" or "stacked"): they compute in float32, and JAX's silent switch
    to its scan is a plain path the caller did not name."""
    if cfg.compute_dtype != torch.float32 and mode != "plain":
        raise ValueError(
            f"compute_dtype={cfg.compute_dtype} runs the recurrence in bf16, which no kernel "
            f"computes (use_pallas_train={cfg.use_pallas_train!r} selects the float32 "
            f"recurrence kernels): {PLAIN_ROUTE}")


def encode_pair(model: nn.Module, audio_obs: torch.Tensor,
                vision_obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both encoders of either family on NHWC frames, in the model's conv
    dtype (``cast_conv_in``; the caller casts out): the fused encoder
    kernels when ``model.fused_enc``, else the canonical cuDNN modules
    (JAX ``models/mrssm.py::_encode_embeds``)."""
    audio_obs, vision_obs = cast_conv_in(model.cfg, audio_obs), cast_conv_in(model.cfg, vision_obs)
    if model.fused_enc:
        return (fused_encoder_apply(model.audio_encoder, audio_obs),
                fused_encoder_apply(model.vision_encoder, vision_obs))
    return model.audio_encoder(audio_obs), model.vision_encoder(vision_obs)


def decode_pair(model: nn.Module, feature: torch.Tensor) -> dict[str, torch.Tensor]:
    """Both decoders of either family on ``[..., feature]``, through the
    conv-dtype casts: NHWC frames in the feature's dtype (float32 from
    serving, the compute dtype in ``shared_step``)."""
    x = cast_conv_in(model.cfg, feature)
    return {"recon/audio": cast_conv_out(model.cfg, model.audio_decoder(x)),
            "recon/vision": cast_conv_out(model.cfg, model.vision_decoder(x))}


def draw_gumbels(shapes: Mapping[str, tuple[int, ...]], generator: torch.Generator | None,
                 device: torch.device | str | None,
                 given: Mapping[str, torch.Tensor] | None = None,
                 rows: Rows | None = None) -> dict[str, torch.Tensor]:
    """Gumbel noise for each named shape: ``given[name]`` where it is given,
    else drawn from ``generator`` (on its device; torch's default generator
    of ``device`` if None), in the order of ``shapes``. With ``rows``
    (``(lo, hi, n)``) the shapes are a global batch of ``n`` rows: each
    draw keeps rows ``[lo, hi)`` of its batch axis, the second from last
    (``[B, S]``, ``[T, B, S]``); ``given`` tensors are the rows' already."""
    given = given or {}
    out = {}
    for k, shape in shapes.items():
        if k in given:
            out[k] = given[k]
        elif rows is None:
            out[k] = gumbel_noise(shape, generator, device)
        else:
            lo, hi, _ = rows
            out[k] = gumbel_noise(shape, generator, device).narrow(-2, lo, hi - lo).contiguous()
    return out


def _stream_stds(std: float | tuple[float, ...]) -> tuple[float, ...]:
    """A noise-std config value as per-stream (action, audio, vision) floats."""
    if isinstance(std, (tuple, list)):
        return tuple(float(s) for s in std)
    return (float(std),) * 3


def add_input_noise(std: float | tuple[float, ...], streams: tuple[torch.Tensor, ...],
                    noise: Mapping, generator: torch.Generator | None,
                    rows: Rows | None = None) -> tuple[torch.Tensor, ...]:
    """``x + std * n`` per input stream (action, audio, vision; reference
    ``transform.py:55-72``, applied on the device as the JAX package does):
    ``n`` is ``noise["input"]`` where given, else standard normals from
    ``generator`` (with ``rows``, ``(lo, hi, n)``, drawn at ``n`` rows and
    cut to rows ``[lo, hi)``); a std of 0 leaves its stream clean, and with
    every std 0 nothing is drawn."""
    stds = _stream_stds(std)
    if not any(s > 0 for s in stds):
        return streams
    lo, hi, total = rows or (0, streams[0].shape[0], streams[0].shape[0])
    normals = noise.get("input") or tuple(
        torch.randn((total, *x.shape[1:]), generator=generator, device=x.device)[lo:hi]
        for x in streams)
    return tuple(x if s == 0 else x + s * n for s, n, x in zip(stds, normals, streams))

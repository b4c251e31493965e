"""WeightedMoPoE-MRSSM (port of ``models/weighted_mopoe.py``): learned
per-subset mixture weights.

The MoE mixture over the subsets {audio}, {vision}, {audio+vision} uses
weights that a head predicts from the deterministic state, ``log_softmax``
of ``moe_weight_head(deter)`` in float32, instead of the fixed 1/3. The
PoE term, the sampling and the ELBO are MoPoE-MRSSM's.

The representation recurrence is a step loop in plain PyTorch, the port of
JAX's ``MoPoEMRSSM._scan_representation`` (``models/mrssm.py:378-423``).
This loop is not a fallback: no kernel in either package computes learned
subset weights. The recurrence kernels hard-code equal 1/3 weights, so JAX
always takes its XLA scan for this model (``weighted_mopoe.py:49-66``).
Unlike JAX, which warns and ignores the value, ``use_pallas_train=True``
or ``"stacked"`` raises here; ``"auto"``, False and None are accepted.
The flag still routes imagination, which is the inherited
``rollout_transition``: ``"auto"`` runs the rollout kernel on the card,
False the plain rollout, as for MoPoE-MRSSM.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig, run_steps
from multimodal_mtrssm_tpu_torch.models.state import State
from multimodal_mtrssm_tpu_torch.nn.conv import cast_conv_out
from multimodal_mtrssm_tpu_torch.nn.core import activation, mlp, transition_step
from multimodal_mtrssm_tpu_torch.ops.distributions import gumbel_noise, st_sample
from multimodal_mtrssm_tpu_torch.ops.fusion import mopoe_mix_log_probs


@dataclasses.dataclass(frozen=True)
class WeightedMRSSMConfig(MRSSMConfig):
    """``MRSSMConfig`` and the width of the subset-weight head."""

    weight_head_cells: int = 32  # MLP deter → 3 subset logits


class WeightedMoPoEMRSSM(MoPoEMRSSM):
    """MoPoE-MRSSM with a learned 3-way subset-mixture weight head."""

    # It trains on its step loop whatever use_pallas_train says, so a bf16
    # compute dtype is taken at "auto" too.
    trains_on_kernels = False

    def __init__(self, config: WeightedMRSSMConfig | None = None):
        cfg = config or WeightedMRSSMConfig()
        v = cfg.use_pallas_train
        if v is True or v == "stacked":
            raise ValueError(
                f"use_pallas_train={v!r}: the recurrence kernels hard-code equal 1/3 subset "
                "weights, which are not WeightedMoPoEMRSSM's; it trains on its step loop, so "
                "use 'auto' (imagination on the rollout kernel) or False (the plain route)")
        super().__init__(cfg)
        self.moe_weight_head = mlp(cfg.deterministic_size, 3, cfg.weight_head_cells,
                                   act=cfg.activation_name)

    def _posterior_mix(self, deter: torch.Tensor, a_logits: torch.Tensor,
                       v_logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The learned-weight mixture of one step: the mixed logits
        (``mopoe_mix_log_probs`` with the head's log-weights) and the
        weights ``[..., 3]``."""
        log_w = F.log_softmax(self.moe_weight_head(deter).float(), dim=-1)
        return mopoe_mix_log_probs(a_logits, v_logits, log_weights=log_w), log_w.exp()

    def _scan_representation(self, actions: torch.Tensor, a_emb: torch.Tensor,
                             v_emb: torch.Tensor, prev_state: State, g_prior: torch.Tensor,
                             g_post: torch.Tensor) -> tuple[State, State, torch.Tensor]:
        """The recurrence on ``[B, T, ·]`` inputs and ``[T, B, S]`` noise, a
        step at a time: transition, prior sample, both posterior heads, the
        learned mixture, posterior sample. Returns ``(posterior, prior,
        weights [B, T, 3])``."""
        cfg = self.cfg
        act = activation(cfg.activation_name)
        tw = self.transition.weights()
        heads = (self.audio_representation.rnn_to_post_projector,
                 self.vision_representation.rnn_to_post_projector)

        def step(carry, x_t):
            prev_deter, prev_stoch = carry
            action_t, a_t, v_t, gp, gq = x_t
            deter, prior_logits = transition_step(tw, action_t, prev_stoch, prev_deter, act)
            prior_stoch = st_sample(prior_logits, gp, cfg.class_size, cfg.category_size)
            a_logits = heads[0](torch.cat([deter, a_t], -1))
            v_logits = heads[1](torch.cat([deter, v_t], -1))
            mixed, weights = self._posterior_mix(deter, a_logits, v_logits)
            post_stoch = st_sample(mixed, gq, cfg.class_size, cfg.category_size)
            # The f32 sample carried in the deter's dtype (JAX mrssm.py:403).
            return (deter, post_stoch.to(deter.dtype)), (deter, prior_logits, prior_stoch, mixed,
                                                         post_stoch, weights)

        tm = lambda x: x.transpose(0, 1)  # noqa: E731
        xs = (tm(actions), tm(cast_conv_out(cfg, a_emb)), tm(cast_conv_out(cfg, v_emb)),
              g_prior, g_post)
        deter, prior_logits, prior_stoch, mixed, post_stoch, weights = run_steps(
            step, (prev_state.deter, prev_state.stoch.to(prev_state.deter.dtype)), xs, cfg.remat)
        posterior = State(deter=deter, stoch=post_stoch, logits=mixed)
        prior = State(deter=deter, stoch=prior_stoch, logits=prior_logits)
        return posterior, prior, weights

    def _rollout_from_embeds(self, actions: torch.Tensor, a_emb: torch.Tensor,
                             v_emb: torch.Tensor, prev_state: State, g_prior: torch.Tensor,
                             g_post: torch.Tensor) -> tuple[State, State]:
        """The recurrence of every caller (observe, ``shared_step``, the
        reconstructions): the step loop, ``(posterior, prior)``."""
        posterior, prior, _ = self._scan_representation(actions, a_emb, v_emb, prev_state,
                                                         g_prior, g_post)
        return posterior, prior

    def rollout_representation_with_weights(
        self, actions: torch.Tensor, audio_obs: torch.Tensor, vision_obs: torch.Tensor,
        prev_state: State, g_prior: torch.Tensor | None = None,
        g_post: torch.Tensor | None = None, generator: torch.Generator | None = None,
    ) -> tuple[State, State, torch.Tensor]:
        """``rollout_representation`` that also returns the learned subset
        weights over time, ``[B, T, 3]`` (audio, vision, audio+vision)."""
        B, T = actions.shape[:2]
        noise = [g if g is not None else gumbel_noise((T, B, self.cfg.stoch_size), generator).to(
            actions.device) for g in (g_prior, g_post)]
        return self._scan_representation(actions, *self.encode_embeds(audio_obs, vision_obs),
                                         prev_state, *noise)


def plot_weights_timeseries(weights: torch.Tensor, out_path: str | Path,
                            episode: int = 0) -> Path:
    """One episode's learned subset weights ``[B, T, 3]`` over time as a PNG
    at ``out_path``. matplotlib is imported only to draw."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    w = torch.as_tensor(weights)[episode].detach().cpu().numpy()  # [T, 3]
    fig, ax = plt.subplots(figsize=(6, 3))
    for i, label in enumerate(("audio", "vision", "audio+vision")):
        ax.plot(w[:, i], label=label)
    ax.set_xlabel("t")
    ax.set_ylabel("mixture weight")
    ax.set_ylim(0, 1)
    ax.legend()
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path

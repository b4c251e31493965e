"""MoPoE fusion (port of ``ops/fusion.py``).

Both reference quirks are kept, since they define the trained objective:
``log_softmax`` runs over the FULL flat logit axis, not per category block,
and the PoE term inside the mixture is the unnormalised sum of the two
log-probabilities. ``MultiOneHot``'s per-block softmax is the only
normalisation downstream.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# -log(3) rounded to f32, the value the JAX package and the CUDA kernel use.
LOG_THIRD = float(torch.tensor(-math.log(3.0), dtype=torch.float32))


def poe_fuse_log_probs(audio_logits: torch.Tensor, vision_logits: torch.Tensor) -> torch.Tensor:
    """PoE fusion: the unnormalised sum of full-axis log-softmaxed logits."""
    return F.log_softmax(audio_logits.float(), dim=-1) + F.log_softmax(vision_logits.float(), dim=-1)


def mopoe_mix_log_probs(audio_logits: torch.Tensor, vision_logits: torch.Tensor,
                        log_weights: torch.Tensor | None = None) -> torch.Tensor:
    """MoE ``logsumexp`` over the subsets {A}, {V}, {A+V}: equal weights, or
    the log-space per-subset weights ``log_weights`` ``[..., 3]``
    (``WeightedMoPoEMRSSM``'s learned ones), broadcast over the logits'
    batch dims. The one home of the mixture for every model that mixes."""
    a = F.log_softmax(audio_logits.float(), dim=-1)
    v = F.log_softmax(vision_logits.float(), dim=-1)
    stacked = torch.stack([a, v, a + v], dim=-2)
    if log_weights is None:
        stacked = stacked + LOG_THIRD
    else:
        stacked = stacked + log_weights.float()[..., None]
    return torch.logsumexp(stacked, dim=-2)

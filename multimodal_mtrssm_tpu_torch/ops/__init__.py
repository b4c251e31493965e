"""Distribution, fusion, likelihood and kernel ops (port of ``multimodal_mtrssm_tpu.ops``)."""

from multimodal_mtrssm_tpu_torch.ops.distributions import (
    KL_BALANCE_ALPHA,
    MultiOneHot,
    block_probs,
    gumbel_noise,
    kl_balanced,
    kl_categorical,
    onehot_blocks,
    st_sample,
)
from multimodal_mtrssm_tpu_torch.ops.fusion import (
    LOG_THIRD,
    mopoe_mix_log_probs,
    poe_fuse_log_probs,
)
from multimodal_mtrssm_tpu_torch.ops.likelihood import gaussian_nll

__all__ = [
    "KL_BALANCE_ALPHA",
    "LOG_THIRD",
    "MultiOneHot",
    "block_probs",
    "gaussian_nll",
    "gumbel_noise",
    "kl_balanced",
    "kl_categorical",
    "mopoe_mix_log_probs",
    "onehot_blocks",
    "poe_fuse_log_probs",
    "st_sample",
]

"""Distribution, fusion and kernel ops (port of ``multimodal_mtrssm_tpu.ops``)."""

from multimodal_mtrssm_tpu_torch.ops.distributions import (
    MultiOneHot,
    block_probs,
    gumbel_noise,
    onehot_blocks,
    st_sample,
)
from multimodal_mtrssm_tpu_torch.ops.fusion import (
    LOG_THIRD,
    mopoe_mix_log_probs,
    poe_fuse_log_probs,
)

__all__ = [
    "LOG_THIRD",
    "MultiOneHot",
    "block_probs",
    "gumbel_noise",
    "mopoe_mix_log_probs",
    "onehot_blocks",
    "poe_fuse_log_probs",
    "st_sample",
]

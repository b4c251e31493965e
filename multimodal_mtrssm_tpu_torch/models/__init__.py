"""World models (port of ``multimodal_mtrssm_tpu.models``): MoPoE-MRSSM, its
learned-weight variant WeightedMoPoE-MRSSM, the hierarchical MoPoE-MMTRSSM
and the unimodal RSSM."""

from multimodal_mtrssm_tpu_torch.models.mmtrssm import MMTRSSMConfig, MoPoEMMTRSSM
from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.models.rssm import RSSM, RSSMConfig
from multimodal_mtrssm_tpu_torch.models.state import MTState, State, cat_states, stack_states
from multimodal_mtrssm_tpu_torch.models.weighted_mopoe import (
    WeightedMoPoEMRSSM,
    WeightedMRSSMConfig,
)

# Any family: what the trainer takes (the serving API takes the multimodal
# three; WeightedMoPoEMRSSM is a MoPoEMRSSM).
WorldModelNet = MoPoEMRSSM | MoPoEMMTRSSM | RSSM

__all__ = ["MMTRSSMConfig", "MRSSMConfig", "MTState", "MoPoEMMTRSSM", "MoPoEMRSSM", "RSSM",
           "RSSMConfig", "State", "WeightedMRSSMConfig", "WeightedMoPoEMRSSM", "WorldModelNet",
           "cat_states", "stack_states"]

"""World models (port of ``multimodal_mtrssm_tpu.models``): MoPoE-MRSSM and
the hierarchical MoPoE-MMTRSSM."""

from multimodal_mtrssm_tpu_torch.models.mmtrssm import MMTRSSMConfig, MoPoEMMTRSSM
from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.models.state import MTState, State, cat_states, stack_states

# Either family: what the serving API and the trainer take.
WorldModelNet = MoPoEMRSSM | MoPoEMMTRSSM

__all__ = ["MMTRSSMConfig", "MRSSMConfig", "MTState", "MoPoEMMTRSSM", "MoPoEMRSSM", "State",
           "WorldModelNet", "cat_states", "stack_states"]

"""World models (port of ``multimodal_mtrssm_tpu.models``)."""

from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.models.state import State

__all__ = ["MRSSMConfig", "MoPoEMRSSM", "State"]

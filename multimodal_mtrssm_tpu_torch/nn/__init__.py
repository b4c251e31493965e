"""Neural-network building blocks (port of ``multimodal_mtrssm_tpu.nn``)."""

from multimodal_mtrssm_tpu_torch.nn.conv import Decoder, DecoderConfig, Encoder, EncoderConfig
from multimodal_mtrssm_tpu_torch.nn.core import (
    MTRNN,
    Transition,
    activation,
    gru_cell,
    mlp,
    mtrnn_step,
    rssm_transition_core,
    transition_step,
)

__all__ = [
    "Decoder",
    "DecoderConfig",
    "Encoder",
    "EncoderConfig",
    "MTRNN",
    "Transition",
    "activation",
    "gru_cell",
    "mlp",
    "mtrnn_step",
    "rssm_transition_core",
    "transition_step",
]

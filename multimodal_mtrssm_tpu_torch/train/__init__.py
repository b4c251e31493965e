"""Training-side utilities (port of ``multimodal_mtrssm_tpu.train``); so far
the weight bridge from the JAX package."""

from multimodal_mtrssm_tpu_torch.train.weights import (
    load_lightning_checkpoint,
    load_reference_state_dict,
)

__all__ = ["load_lightning_checkpoint", "load_reference_state_dict"]

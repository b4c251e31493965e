"""The weight bridge from the JAX package (layout of ``train/torch_export.py``).

The port's ``state_dict`` already uses the reference Lightning names and
torch layouts that ``export_reference_state_dict`` emits: ``transition.
rnn_cell.*``, torchrl MLPs with Linears at even indices, ``{audio,vision}_
representation.rnn_to_post_projector.*``, ``init_proj.*``, and the conv
stacks under their slot paths in ``_leaf_slots`` order. So loading is a
``load_state_dict(strict=True)``: a missing, extra or misshapen tensor
raises instead of leaving a layer at its init.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn


def load_reference_state_dict(model: nn.Module, state_dict: Mapping[str, object]) -> nn.Module:
    """Load a reference-named state dict of numpy arrays or tensors into
    ``model`` (strict), keeping the model's device. Returns the model."""
    device = next(model.parameters()).device
    tensors = {
        k: torch.as_tensor(np.array(v, np.float32) if not isinstance(v, torch.Tensor) else v,
                           dtype=torch.float32, device=device)
        for k, v in state_dict.items()
    }
    model.load_state_dict(tensors, strict=True)
    return model


def load_lightning_checkpoint(model: nn.Module, path: str | Path) -> nn.Module:
    """Load a Lightning-style ``.ckpt`` (``{"state_dict": {...}}``), such as
    ``train/torch_export.py::save_lightning_checkpoint`` writes. Only tensors
    are unpickled (``weights_only``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return load_reference_state_dict(model, ckpt.get("state_dict", ckpt))

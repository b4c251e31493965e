"""Small shared utilities (port of ``utils/__init__.py``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def fold(seed: int, *path: int) -> int:
    """A 64-bit seed derived from ``seed`` and the integers of ``path``: the
    role ``jax.random.fold_in`` plays in the JAX package."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0])


def count_params(module: nn.Module) -> int:
    """Total number of scalar parameters of a module."""
    return sum(p.numel() for p in module.parameters())


def require_device(device: torch.device | str, who: str,
                   cpu_hint: str = "device='cpu'") -> torch.device:
    """``device`` as a ``torch.device``. The port's entry points default to
    the card and never fall back to the CPU: a CUDA device without a card
    raises, naming ``who`` and how to ask for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on the CUDA device by default and none is available; "
                           f"pass {cpu_hint} to run on the CPU")
    return device

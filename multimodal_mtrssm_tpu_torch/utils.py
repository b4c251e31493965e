"""Small shared utilities (port of ``utils/__init__.py``)."""

from __future__ import annotations

from torch import nn


def count_params(module: nn.Module) -> int:
    """Total number of scalar parameters of a module."""
    return sum(p.numel() for p in module.parameters())

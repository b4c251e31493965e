"""Gaussian reconstruction likelihood (port of ``ops/likelihood.py``)."""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def gaussian_nll(prediction: torch.Tensor, target: torch.Tensor, event_ndims: int,
                 scale: float = 1.0) -> torch.Tensor:
    """``-mean(Independent(Normal(pred, scale), event_ndims).log_prob(target))``:
    the last ``event_ndims`` axes are summed, the leading axes averaged, in f32."""
    elem = (0.5 * torch.square((target.float() - prediction.float()) * (1.0 / scale))
            + math.log(scale) + _HALF_LOG_2PI)
    log_prob = -torch.sum(elem, dim=tuple(range(elem.ndim - event_ndims, elem.ndim)))
    return -torch.mean(log_prob)

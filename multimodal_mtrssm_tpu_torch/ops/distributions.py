"""Categorical latents over flat logits (port of ``ops/distributions.py``).

``class_size`` independent categorical blocks of ``category_size`` each,
parameterised by flat logits ``[..., class_size * category_size]``. Sampling
is Gumbel-argmax from a GIVEN noise tensor, so two implementations fed the
same noise draw the same sample: the first index wins a tie, as in the JAX
kernels' ``rollout.onehot_blocks``. KL and log-prob come with training.
"""

from __future__ import annotations

import dataclasses

import torch


def _blocks(x: torch.Tensor, class_size: int, category_size: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], class_size, category_size)


def block_probs(logits: torch.Tensor, class_size: int, category_size: int) -> torch.Tensor:
    """Per-block softmax, flat ``[..., class*category]``: ``e / sum(e)`` with
    ``e = exp(l - max)`` per block (the JAX kernels' ``_block_probs``)."""
    bl = _blocks(logits, class_size, category_size)
    e = torch.exp(bl - bl.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).reshape(logits.shape)


def onehot_blocks(scores: torch.Tensor, class_size: int, category_size: int) -> torch.Tensor:
    """First-index argmax one-hot per block, flat ``[..., class*category]``."""
    bl = _blocks(scores, class_size, category_size)
    is_max = bl >= bl.amax(dim=-1, keepdim=True)
    first = is_max & (torch.cumsum(is_max.to(torch.int32), dim=-1) == 1)
    return first.to(scores.dtype).reshape(scores.shape)


def st_sample(
    logits: torch.Tensor, gumbel: torch.Tensor, class_size: int, category_size: int
) -> torch.Tensor:
    """Straight-through sample VALUE from given Gumbel noise: ``(onehot + p) - p``.

    The association is kept as written: ``(1 + p) - p`` is not always exactly
    1 in f32, and the JAX package computes it in this order."""
    onehot = onehot_blocks(logits + gumbel, class_size, category_size)
    p = block_probs(logits, class_size, category_size)
    return (onehot + p) - p


def gumbel_noise(shape: tuple[int, ...], generator: torch.Generator | None = None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` on the generator's device (the
    CPU for torch's default generator), with ``u`` kept off 0 so no category
    becomes unreachable."""
    device = generator.device if generator is not None else "cpu"
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass(frozen=True)
class MultiOneHot:
    """Product of ``class_size`` categoricals over ``category_size`` categories."""

    logits: torch.Tensor
    class_size: int
    category_size: int

    def probs(self) -> torch.Tensor:
        """Per-block probabilities, flat ``[..., class*category]``."""
        return block_probs(self.logits, self.class_size, self.category_size)

    def mode(self) -> torch.Tensor:
        """Most likely one-hot blocks (first index on ties)."""
        return onehot_blocks(self.logits, self.class_size, self.category_size)

    def sample(self, gumbel: torch.Tensor) -> torch.Tensor:
        """Straight-through sample value from the given Gumbel noise."""
        return st_sample(self.logits, gumbel, self.class_size, self.category_size)

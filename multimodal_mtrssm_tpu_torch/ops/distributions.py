"""Categorical latents over flat logits (port of ``ops/distributions.py``).

``class_size`` independent categorical blocks of ``category_size`` each,
parameterised by flat logits ``[..., class_size * category_size]``. Sampling
is Gumbel-argmax from a GIVEN noise tensor, so two implementations fed the
same noise draw the same sample: the first index wins a tie, as in the JAX
kernels' ``rollout.onehot_blocks``. The KL (plain and DreamerV2-balanced,
α 0.8), log-probabilities and entropy are the ELBO's; all of it runs in f32,
bf16 logits included (the f32 islands of a full-bf16 model).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

# DreamerV2 KL-balancing mixing weight for the prior-training term.
KL_BALANCE_ALPHA = 0.8


def _blocks(x: torch.Tensor, class_size: int, category_size: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], class_size, category_size)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 where it is narrower (the bf16 logits of a full-bf16
    model), else as it is (float32; float64 in the tests' references)."""
    return x.float() if x.dtype.itemsize < 4 else x


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
    """Straight-through sample from given Gumbel noise: the value is
    ``(onehot + p) - p`` and the gradient is that of ``p``, the per-block
    softmax (JAX ``onehot + p - stop_gradient(p)``).

    The value's association is kept as written: ``(1 + p) - p`` is not
    always exactly 1 in f32, and the JAX package computes it in this order.
    ``x.detach() + (p - p.detach())`` adds an exact 0.0 to that value and
    routes the gradient through ``p``. Runs in f32 whatever the logits'
    dtype (JAX ``MultiOneHot.rsample``)."""
    logits = at_least_f32(logits)
    onehot = onehot_blocks(logits + gumbel, class_size, category_size)
    p = block_probs(logits, class_size, category_size)
    return ((onehot + p) - p).detach() + (p - p.detach())


def gumbel_noise(shape: tuple[int, ...], generator: torch.Generator | None = None,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` on the generator's device
    (``device``, or the CPU, for torch's default generator), with ``u`` kept
    off 0 so no category becomes unreachable."""
    if generator is not None:
        device = generator.device
    u = torch.rand(shape, generator=generator, device=device or "cpu")
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass(frozen=True)
class MultiOneHot:
    """Product of ``class_size`` categoricals over ``category_size`` categories."""

    logits: torch.Tensor
    class_size: int
    category_size: int

    def _block_logits(self) -> torch.Tensor:
        return _blocks(self.logits.float(), self.class_size, self.category_size)

    def log_probs(self) -> torch.Tensor:
        """Per-block log-probabilities, flat ``[..., class*category]``."""
        return F.log_softmax(self._block_logits(), dim=-1).reshape(self.logits.shape)

    def probs(self) -> torch.Tensor:
        """Per-block probabilities, flat ``[..., class*category]``."""
        return block_probs(at_least_f32(self.logits), self.class_size, self.category_size)

    def mode(self) -> torch.Tensor:
        """Most likely one-hot blocks (first index on ties)."""
        return onehot_blocks(at_least_f32(self.logits), self.class_size, self.category_size)

    def sample(self, gumbel: torch.Tensor) -> torch.Tensor:
        """Straight-through sample from the given Gumbel noise."""
        return st_sample(self.logits, gumbel, self.class_size, self.category_size)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """Log-probability of flat one-hot ``value``; shape = batch shape."""
        return torch.sum(self.log_probs() * value.float(), dim=-1)

    def entropy(self) -> torch.Tensor:
        """Entropy summed over classes; shape = batch shape."""
        lp = F.log_softmax(self._block_logits(), dim=-1)
        return -torch.sum(torch.exp(lp) * lp, dim=(-2, -1))

    def detach(self) -> "MultiOneHot":
        """The same distribution with its logits cut from the graph."""
        return dataclasses.replace(self, logits=self.logits.detach())


def kl_categorical(q: MultiOneHot, p: MultiOneHot) -> torch.Tensor:
    """KL(q || p) summed over the class blocks; shape = batch shape."""
    q_lp = F.log_softmax(q._block_logits(), dim=-1)
    p_lp = F.log_softmax(p._block_logits(), dim=-1)
    return torch.sum(torch.exp(q_lp) * (q_lp - p_lp), dim=(-2, -1))


def kl_balanced(q: MultiOneHot, p: MultiOneHot, *, use_balancing: bool,
                alpha: float = KL_BALANCE_ALPHA) -> torch.Tensor:
    """KL with optional DreamerV2 balancing,
    ``alpha * KL(sg(q) || p) + (1 - alpha) * KL(q || sg(p))``. The value is
    plain KL(q || p) either way; only the gradient mix differs."""
    if not use_balancing:
        return kl_categorical(q, p)
    return alpha * kl_categorical(q.detach(), p) + (1.0 - alpha) * kl_categorical(q, p.detach())

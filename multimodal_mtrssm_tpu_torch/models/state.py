"""Latent states (port of ``models/state.py``): ``State`` of the MRSSM
family, ``MTState`` of the hierarchical MMTRSSM family, and ``stack_states``
/ ``cat_states`` for either.

The reference's ``MTState.clone()`` assigns ``distribution_h`` from
``distribution_l`` (``mmtrssm/state.py:133``, ``PARITY.md``); ``clone``
here copies every field as itself.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class State:
    """Deterministic ``deter``, sampled ``stoch`` and the ``logits`` of the
    distribution it was sampled from. Any leading shape ([B] or [B, T])."""

    deter: torch.Tensor
    stoch: torch.Tensor
    logits: torch.Tensor

    @property
    def feature(self) -> torch.Tensor:
        """``cat(deter, stoch)``, the decoders' input."""
        return torch.cat([self.deter, self.stoch.to(self.deter.dtype)], dim=-1)

    @property
    def batch_size(self) -> int:
        """Size of the leading (batch) axis."""
        return self.deter.shape[0]

    def __getitem__(self, loc) -> "State":
        return _map(lambda x: x[loc], self)

    def to(self, device: torch.device | str) -> "State":
        """The same state with every tensor on ``device``."""
        return _map(lambda x: x.to(device), self)

    def clone(self) -> "State":
        """A copy that shares no storage (a slice of a sequence otherwise
        keeps the whole sequence alive)."""
        return _map(torch.clone, self)


@dataclasses.dataclass(frozen=True)
class MTState:
    """Hierarchical two-timescale latent (reference ``mmtrssm/state.py:11-51``):
    the higher (slow, ``_h``) and lower (fast, ``_l``) layers' deter, sampled
    stoch and the logits it was sampled from, and the MTRNN integrators
    ``hidden_h``/``hidden_l`` (``deter = tanh(hidden)``), which the reference
    keeps as mutable module state and which make a continuation exact."""

    deter_h: torch.Tensor
    deter_l: torch.Tensor
    stoch_h: torch.Tensor
    stoch_l: torch.Tensor
    logits_h: torch.Tensor
    logits_l: torch.Tensor
    hidden_h: torch.Tensor
    hidden_l: torch.Tensor

    @property
    def feature(self) -> torch.Tensor:
        """``cat(deter_h, stoch_h, deter_l, stoch_l)``, the decoders' input
        (reference ``state.py:51``)."""
        d = self.deter_h.dtype
        return torch.cat([self.deter_h, self.stoch_h.to(d), self.deter_l, self.stoch_l.to(d)],
                         dim=-1)

    @property
    def batch_size(self) -> int:
        """Size of the leading (batch) axis."""
        return self.deter_h.shape[0]

    def __getitem__(self, loc) -> "MTState":
        return _map(lambda x: x[loc], self)

    def to(self, device: torch.device | str) -> "MTState":
        """The same state with every tensor on ``device``."""
        return _map(lambda x: x.to(device), self)

    def clone(self) -> "MTState":
        """A copy that shares no storage, every field cloned from itself."""
        return _map(torch.clone, self)


AnyState = State | MTState


def _map(fn, state):
    return type(state)(*(fn(getattr(state, f.name)) for f in dataclasses.fields(state)))


def stack_states(states: list[AnyState], dim: int) -> AnyState:
    """Stack states of one type along a new axis (reference ``state.py:121-135``)."""
    return type(states[0])(*(torch.stack([getattr(s, f.name) for s in states], dim)
                             for f in dataclasses.fields(states[0])))


def cat_states(states: list[AnyState], dim: int) -> AnyState:
    """Concatenate states of one type along an existing axis (reference
    ``state.py:138-152``)."""
    return type(states[0])(*(torch.cat([getattr(s, f.name) for s in states], dim)
                             for f in dataclasses.fields(states[0])))

"""Latent state (port of ``models/state.py::State``; ``MTState`` waits for
the MMTRSSM family)."""

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

    def __getitem__(self, loc) -> "State":
        return State(deter=self.deter[loc], stoch=self.stoch[loc], logits=self.logits[loc])

    def to(self, device: torch.device | str) -> "State":
        """The same state with every tensor on ``device``."""
        return State(self.deter.to(device), self.stoch.to(device), self.logits.to(device))

    def clone(self) -> "State":
        """A copy that shares no storage (a slice of a sequence otherwise
        keeps the whole sequence alive)."""
        return State(self.deter.clone(), self.stoch.clone(), self.logits.clone())

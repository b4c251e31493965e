"""Checkpoints on ``torch.save`` (port of ``train/checkpoint.py``, which uses Orbax).

A checkpoint ``<name>.ckpt`` holds ``{"state_dict": ...}`` under the
reference Lightning names, the layout ``train/weights.py::
load_lightning_checkpoint`` reads, so a ``best`` checkpoint loads straight
into a serving model; a full one adds ``"optimizer"`` (moments, step count,
learning rate). Host counters go to a JSON sidecar ``<name>.json``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import torch
from torch import nn

from multimodal_mtrssm_tpu_torch.train.optim import AdamW
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict


def _cpu(x: Any) -> Any:
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


class CheckpointManager:
    """Named checkpoints in one directory."""

    def __init__(self, directory: str | Path, create: bool = True):
        """``create``: make the directory now (a data-parallel run's other
        ranks only read it)."""
        self.dir = Path(directory).resolve()
        if create:
            self.dir.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> Path:
        """The ``.ckpt`` file of checkpoint ``name``."""
        return self.dir / f"{name}.ckpt"

    def exists(self, name: str) -> bool:
        """Whether checkpoint ``name`` has been written."""
        return self.path(name).is_file()

    def _load(self, name: str) -> dict[str, Any]:
        ckpt = torch.load(self.path(name), map_location="cpu", weights_only=True)
        if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
            raise ValueError(f"checkpoint {self.path(name)} holds no 'state_dict'")
        return ckpt

    def aux(self, name: str) -> dict[str, Any]:
        """The JSON sidecar of checkpoint ``name``, or ``{}`` where there is none."""
        path = self.dir / f"{name}.json"
        return json.loads(path.read_text()) if path.is_file() else {}

    def restore_params(self, name: str, model: nn.Module) -> dict[str, Any]:
        """Load the weights of checkpoint ``name`` into ``model`` (strict),
        from a weights-only checkpoint (``best``) or a full one (``last``,
        ``diverged``: its optimizer state is left unread). Returns the JSON
        sidecar, or ``{}`` where there is none."""
        load_reference_state_dict(model, self._load(name)["state_dict"])
        return self.aux(name)

    def restore(self, name: str, model: nn.Module, optimizer: AdamW) -> dict[str, Any]:
        """Load the full training state of checkpoint ``name``: the weights
        into ``model`` (strict) and the optimizer's state into
        ``optimizer``. Returns the JSON sidecar. Raises when the checkpoint
        holds no optimizer state (a weights-only one) or its state does not
        fit ``optimizer``'s parameters."""
        ckpt = self._load(name)
        if "optimizer" not in ckpt:
            raise ValueError(f"checkpoint {self.path(name)} holds no optimizer state")
        optimizer.load_state_dict(ckpt["optimizer"])
        load_reference_state_dict(model, ckpt["state_dict"])
        return self.aux(name)

    def save(self, name: str, model: nn.Module, optimizer: AdamW | dict | None = None,
             aux: dict[str, Any] | None = None) -> Path:
        """Write the model's weights (and the optimizer's state, if given:
        the optimizer or its ``state_dict()``) under ``name``, replacing any
        earlier one atomically."""
        ckpt: dict[str, Any] = {"state_dict": {k: _cpu(v) for k, v in model.state_dict().items()}}
        if optimizer is not None:
            state = optimizer if isinstance(optimizer, dict) else optimizer.state_dict()
            ckpt["optimizer"] = {k: _cpu(v) for k, v in state.items()}
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.path(name)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
        if aux is not None:
            (self.dir / f"{name}.json").write_text(json.dumps(aux))
        return path

"""Optimizer, LR schedulers and early stopping (port of ``train/optim.py``).

:class:`AdamW` reproduces the JAX package's ``FusedAdamW`` (its lines
88-109) on one flat vector of every gradient: a global-norm clip
``min(1, clip / (norm + 1e-12))`` over ALL parameters, then AdamW with
decoupled weight decay, in f32 and in the same order of operations. The JAX
package runs this in XLA, not in a Pallas kernel, so here it is plain torch
ops (a handful of launches over one vector). The schedulers and early
stopping are host-side state, stepped once per epoch on ``val/loss``.

On a data-parallel mesh (``parallel.mesh``) the flat gradient is summed
over every rank by one ``all_reduce`` (each rank's share already weighted by
its rows), and with ``zero1`` the moments are JAX's ``shard_pad`` layout
(its lines 74-110): the flat vector padded to a multiple of the ``data``
axis, each rank holding its slice of m and v, updating that slice, and
``all_gather``-ing the parameter step within its ``data`` group. The clip
reads the whole, already-summed gradient, so the update equals the
replicated one element for element.

The step is graph-safe (``train/graph.py`` captures it in a CUDA graph):
it reads its step count and learning rate from device tensors, mirrors of
the host ``count`` and ``lr`` that checkpoints and the schedulers keep,
makes no tensor from a host number, and updates the moments in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from multimodal_mtrssm_tpu_torch.parallel.mesh import Mesh, ici_size


class AdamW:
    """AdamW with global-norm gradient clipping over a fixed parameter list;
    ``lr`` may be changed between steps (:func:`set_learning_rate`).

    ``mesh``: sum the gradient over its ranks before the clip. ``zero1``
    (with a mesh): keep only this rank's slice of the padded moments.

    ``count`` and ``lr`` are host numbers with device mirrors that
    :meth:`step` reads (``_n``, ``_lr``): setting ``lr`` or loading a state
    writes both, and a captured step's replay advances ``count`` by
    :meth:`advance_host_count`, since the graph advances only ``_n``."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float = 1e-3,
                 grad_clip: float = 10.0, weight_decay: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, mesh: Mesh | None = None,
                 zero1: bool = False):
        self.params = list(params)
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mesh = mesh
        self.n = sum(p.numel() for p in self.params)
        # ZeRO-1: ``shards`` slices of ``shard`` entries, this rank's at ``lo``.
        self.shards = ici_size(mesh) if zero1 and mesh is not None else 1
        self.shard = -(-self.n // self.shards)
        self.lo = mesh.data_rank * self.shard if self.shards > 1 else 0
        dev = self.params[0].device
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        self.m = torch.zeros(self.shard, dtype=torch.float32, device=dev)
        self.v = torch.zeros(self.shard, dtype=torch.float32, device=dev)
        # 1 - b is taken in double precision, as the JAX package's Python
        # floats are; b ** t in f32, as its weak-typed scalars are.
        self._consts = {"clip": f32(grad_clip), "b1": f32(b1), "b2": f32(b2),
                        "1-b1": f32(1.0 - b1), "1-b2": f32(1.0 - b2)}
        self._n = torch.zeros((), dtype=torch.int64, device=dev)
        self._lr = f32(learning_rate)
        self.count = 0
        self.lr = learning_rate

    def _get_lr(self) -> float:
        return self._host_lr

    def _set_lr(self, value: float) -> None:
        self._host_lr = value
        self._lr.fill_(value)

    lr = property(_get_lr, _set_lr, doc="The learning rate of the next steps (and its mirror).")

    def device_state(self) -> list[torch.Tensor]:
        """The tensors a step writes besides the parameters: the moments
        and the step count's mirror."""
        return [self.m, self.v, self._n]

    def advance_host_count(self, steps: int = 1) -> None:
        """Count ``steps`` steps that ran without Python (graph replays)."""
        self.count += steps

    def zero_grad(self) -> None:
        """Drop every parameter's gradient."""
        for p in self.params:
            p.grad = None

    def _slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a flat ``[n]`` vector, zero-padded as JAX pads."""
        if self.shards == 1:
            return x
        return torch.nn.functional.pad(x, (0, self.shard * self.shards - self.n))[
            self.lo:self.lo + self.shard]

    def _gather(self, part: torch.Tensor) -> torch.Tensor:
        """The whole ``[n]`` vector of every rank's slice (the ``data`` group's)."""
        if self.shards == 1:
            return part
        parts = [torch.empty_like(part) for _ in range(self.shards)]
        dist.all_gather(parts, part.contiguous(), group=self.mesh.data_group)
        return torch.cat(parts)[:self.n]

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (a missing grad is 0)."""
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                       for p in self.params])
        if self.mesh is not None:
            dist.all_reduce(g)
        p = torch.cat([p.reshape(-1) for p in self.params])
        c = self._consts
        norm = torch.sqrt(torch.sum(g * g))
        g = self._slice(g * torch.clamp(c["clip"] / (norm + 1e-12), max=1.0))
        self.count += 1
        self._n.add_(1)
        b1, b2, t = c["b1"], c["b2"], self._n.to(torch.float32)
        torch.add(b1 * self.m, c["1-b1"] * g, out=self.m)
        torch.add(b2 * self.v, c["1-b2"] * g * g, out=self.v)
        mh = self.m / (1.0 - b1 ** t)
        vh = self.v / (1.0 - b2 ** t)
        step = -self._lr * (mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * self._slice(p))
        step = self._gather(step)
        torch._foreach_add_(self.params, [s.view_as(q) for s, q in
                                          zip(step.split([q.numel() for q in self.params]),
                                              self.params)])

    def state_dict(self) -> dict:
        """Moments (whole: under ZeRO-1 every rank of the ``data`` group
        gathers them, so every rank must call this), step count and
        learning rate."""
        return {"m": self._gather(self.m).clone(), "v": self._gather(self.v).clone(),
                "count": self.count, "lr": self.lr}

    def load_state_dict(self, state: dict) -> "AdamW":
        """Restore :meth:`state_dict`'s moments (flat, whole, in this
        optimizer's parameter order; under ZeRO-1 this rank keeps its
        slice), step count and learning rate, on the parameters' device,
        into this optimizer's own tensors. Raises when the moments do not
        fit the parameters."""
        moments = {}
        for k in ("m", "v"):
            x = state[k]
            x = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))).reshape(-1)
            if x.numel() != self.n:
                raise ValueError(f"optimizer state {k!r} has {x.numel()} entries, the "
                                 f"parameters {self.n}")
            moments[k] = self._slice(x.to(self.m.device, torch.float32))
        self.m.copy_(moments["m"])
        self.v.copy_(moments["v"])
        self.count = int(state["count"])
        self._n.fill_(self.count)
        self.lr = float(state["lr"])
        return self


def set_learning_rate(optimizer: AdamW, learning_rate: float) -> AdamW:
    """Set the learning rate of the next steps."""
    optimizer.lr = learning_rate
    return optimizer


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau on a monitored value (min mode), reference
    ``configs/default.yaml:108-114``; torch's relative threshold."""

    base_lr: float
    factor: float = 0.5
    patience: int = 50
    min_lr: float = 0.0
    threshold: float = 1e-4
    best: float = float("inf")
    bad_epochs: int = 0
    lr: float | None = None

    def __post_init__(self):
        if self.lr is None:
            self.lr = self.base_lr

    def step(self, value: float) -> float:
        """Feed one epoch's monitored value; returns the (possibly reduced) LR."""
        if value < self.best * (1.0 - self.threshold):
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "PlateauScheduler":
        return cls(**d)


@dataclasses.dataclass
class CosineAnnealingScheduler:
    """torch ``CosineAnnealingLR`` epoch semantics (periodic past ``t_max``)."""

    base_lr: float
    t_max: int
    eta_min: float = 0.0
    epoch: int = 0
    lr: float | None = None

    def __post_init__(self):
        if self.lr is None:
            self.lr = self._at(self.epoch)

    def _at(self, t: int) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / self.t_max)) / 2

    def step(self, value: float) -> float:
        self.epoch += 1
        self.lr = self._at(self.epoch)
        return self.lr

    def state_dict(self) -> dict:
        return {"kind": "cosine", **dataclasses.asdict(self)}

    @classmethod
    def from_state_dict(cls, d: dict) -> "CosineAnnealingScheduler":
        return cls(**{k: v for k, v in d.items() if k != "kind"})


@dataclasses.dataclass
class StepScheduler:
    """torch ``StepLR``: lr = base·gamma^(epoch // step_size)."""

    base_lr: float
    step_size: int
    gamma: float = 0.1
    epoch: int = 0
    lr: float | None = None

    def __post_init__(self):
        if self.lr is None:
            self.lr = self.base_lr * self.gamma ** (self.epoch // self.step_size)

    def step(self, value: float) -> float:
        self.epoch += 1
        self.lr = self.base_lr * self.gamma ** (self.epoch // self.step_size)
        return self.lr

    def state_dict(self) -> dict:
        return {"kind": "step", **dataclasses.asdict(self)}

    @classmethod
    def from_state_dict(cls, d: dict) -> "StepScheduler":
        return cls(**{k: v for k, v in d.items() if k != "kind"})


@dataclasses.dataclass
class ExponentialScheduler:
    """torch ``ExponentialLR``: lr = base·gamma^epoch."""

    base_lr: float
    gamma: float
    epoch: int = 0
    lr: float | None = None

    def __post_init__(self):
        if self.lr is None:
            self.lr = self.base_lr * self.gamma ** self.epoch

    def step(self, value: float) -> float:
        self.epoch += 1
        self.lr = self.base_lr * self.gamma ** self.epoch
        return self.lr

    def state_dict(self) -> dict:
        return {"kind": "exponential", **dataclasses.asdict(self)}

    @classmethod
    def from_state_dict(cls, d: dict) -> "ExponentialScheduler":
        return cls(**{k: v for k, v in d.items() if k != "kind"})


_SCHEDULERS = {
    "plateau": PlateauScheduler,
    "cosine": CosineAnnealingScheduler,
    "step": StepScheduler,
    "exponential": ExponentialScheduler,
}


def make_scheduler(spec: dict | None, base_lr: float, plateau_factor: float = 0.5,
                   plateau_patience: int = 50) -> object:
    """An LR scheduler from a spec dict (``{"kind": ..., **kwargs}``); None or
    ``kind: plateau`` is the reference's ReduceLROnPlateau."""
    spec = dict(spec or {})
    kind = spec.pop("kind", "plateau")
    if kind == "plateau":
        return PlateauScheduler(
            base_lr,
            factor=float(spec.get("factor", plateau_factor)),
            patience=int(spec.get("patience", plateau_patience)),
            min_lr=float(spec.get("min_lr", 0.0)),
            threshold=float(spec.get("threshold", 1e-4)),
        )
    cls = _SCHEDULERS.get(kind)
    if cls is None:
        raise ValueError(f"unknown lr scheduler kind {kind!r} (have {sorted(_SCHEDULERS)})")
    return cls(base_lr, **spec)


def scheduler_from_state_dict(d: dict) -> object:
    """Any scheduler from its ``state_dict`` (``kind`` defaults to plateau,
    whose state dict carries none)."""
    d = dict(d)
    kind = d.pop("kind", "plateau")
    if kind not in _SCHEDULERS:
        raise ValueError(f"unknown lr scheduler kind {kind!r} (have {sorted(_SCHEDULERS)})")
    return _SCHEDULERS[kind].from_state_dict(d)


@dataclasses.dataclass
class EarlyStopping:
    """EarlyStopping on a monitored value (min mode), reference
    ``configs/default.yaml:137-142``: stops once ``patience`` epochs in a row
    failed to improve (Lightning's ``wait_count >= patience``)."""

    patience: int = 200
    min_delta: float = 0.0
    best: float = float("inf")
    bad_epochs: int = 0
    should_stop: bool = False

    def step(self, value: float) -> bool:
        if value < self.best - self.min_delta:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.should_stop = True
        return self.should_stop

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "EarlyStopping":
        return cls(**d)

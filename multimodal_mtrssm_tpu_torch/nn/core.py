"""MLP, GRU cell and the RSSM transition chain (port of ``nn/core.py``).

Module and parameter names follow the reference Lightning checkpoints that
``multimodal_mtrssm_tpu/train/torch_export.py`` writes: a torchrl MLP is a
``Sequential`` with its Linears at even indices, and the GRU cell holds
``weight_ih``/``weight_hh``/``bias_ih``/``bias_hh`` in torch layout
(``[3D, in]``, gate order r, z, n), which is ``nn.GRUCell``'s own; the
MTRNN cell holds its ``_d2h`` and ``_input2h`` Linears under the reference's
names (``mopoe_mmtrssm/core.py:36-37``).

Every layer runs in its input's dtype, the float32 parameters cast to it at
use (JAX ``dense_apply``, ``gru_apply``): a model at ``compute_dtype``
bf16 keeps float32 masters whose gradients reach them in float32. At
float32 the casts are no-ops.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

Act = Callable[[torch.Tensor], torch.Tensor]

# Torch-style class names, as the reference YAML spells them. GELU is the
# tanh approximation, jax.nn.gelu's default.
ACTIVATIONS: dict[str, Act] = {
    "ELU": F.elu,
    "ReLU": F.relu,
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "SiLU": F.silu,
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    "LeakyReLU": F.leaky_relu,
    "Identity": lambda x: x,
}


def activation(name: str) -> Act:
    """Look up an activation function by its torch-style class name."""
    try:
        return ACTIVATIONS[name]
    except KeyError as e:
        raise ValueError(f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)}") from e


class Activation(nn.Module):
    """A named activation as a parameter-free module (keeps ``Sequential``
    indices where torchrl puts them)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = activation(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Apply the activation."""
        return self.fn(x)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """``F.linear`` in ``x``'s dtype, ``w`` and ``b`` cast to it."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype (:func:`linear`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ weightᵀ + bias`` in ``x``'s dtype."""
        return linear(x, self.weight, self.bias)


def mlp(in_dim: int, out_dim: int, num_cells: int, depth: int = 1, act: str = "ELU",
        activate_last: bool = False) -> nn.Sequential:
    """torchrl ``MLP`` contract: ``depth`` hidden layers of ``num_cells``, the
    activation between layers and, with ``activate_last``, after the last."""
    dims = [in_dim] + [num_cells] * depth + [out_dim]
    layers: list[nn.Module] = []
    for i in range(len(dims) - 1):
        layers.append(Linear(dims[i], dims[i + 1]))
        if i < len(dims) - 2 or activate_last:
            layers.append(Activation(act))
    return nn.Sequential(*layers)


def gru_cell(x: torch.Tensor, h: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
             b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """One GRU step, torch ``nn.GRUCell`` equations: ``n = tanh(gi_n + r * gh_n)``,
    ``h' = (1 - z) * n + z * h``."""
    gi = linear(x, w_ih, b_ih)
    gh = linear(h, w_hh, b_hh)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def two_layer(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, act: Act) -> torch.Tensor:
    """A depth-1 MLP on raw weights: ``linear(act(linear(x)))``."""
    return linear(act(linear(x, w1, b1)), w2, b2)


def transition_step(weights: tuple[torch.Tensor, ...], action: torch.Tensor,
                    prev_stoch: torch.Tensor, prev_deter: torch.Tensor,
                    act: Act) -> tuple[torch.Tensor, torch.Tensor]:
    """The RSSM transition chain on its 12 raw weights (``Transition.weights``
    order): MLP(cat(action, stoch)) → GRU → prior MLP. Returns (deter, logits).

    The one home of this chain: the modules below and both kernels' plain
    versions call it."""
    w1, b1, w2, b2, wih, bih, whh, bhh, wp1, bp1, wp2, bp2 = weights
    x = two_layer(torch.cat([action, prev_stoch], dim=-1), w1, b1, w2, b2, act)
    deter = gru_cell(x, prev_deter, wih, whh, bih, bhh)
    return deter, two_layer(deter, wp1, bp1, wp2, bp2, act)


def mtrnn_step(weights: tuple[torch.Tensor, ...], x: torch.Tensor, prev_d: torch.Tensor,
               hidden: torch.Tensor, tau: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One MTRNN step on its 4 raw weights ``(w_d2h, b_d2h, w_input2h,
    b_input2h)`` (torch layout), JAX ``mtrnn_apply``'s association:
    ``hidden' = (1 - 1/tau) * hidden + (d2h(prev_d) + input2h(x)) * (1/tau)``,
    ``d = tanh(hidden')``. Returns ``(d, hidden')``.

    The one home of this cell: :class:`MTRNN`, the MMTRSSM model and both
    MT kernels' plain versions call it."""
    if tau <= 1.0:
        raise ValueError("tau must be greater than 1.0")  # reference core.py:34
    wd, bd, wi, bi = weights
    inv_tau = 1.0 / tau
    new_hidden = (1.0 - inv_tau) * hidden + (linear(prev_d, wd, bd) + linear(x, wi, bi)) * inv_tau
    return torch.tanh(new_hidden), new_hidden


class MTRNN(nn.Module):
    """Multiple-timescale RNN cell, a leaky integrator (reference
    ``mopoe_mmtrssm/core.py:40-74``). The integrator ``hidden`` is an
    explicit argument and result, not module state."""

    def __init__(self, input_size: int, hidden_size: int, tau: float):
        super().__init__()
        if tau <= 1.0:
            raise ValueError("tau must be greater than 1.0")
        self.tau = tau
        self._d2h = nn.Linear(hidden_size, hidden_size)
        self._input2h = nn.Linear(input_size, hidden_size)

    def weights(self) -> tuple[torch.Tensor, ...]:
        """``(w_d2h, b_d2h, w_input2h, b_input2h)`` in torch layout."""
        return (self._d2h.weight, self._d2h.bias, self._input2h.weight, self._input2h.bias)

    def forward(self, x: torch.Tensor, prev_d: torch.Tensor,
                hidden: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One step: ``(d, hidden')`` (:func:`mtrnn_step`)."""
        return mtrnn_step(self.weights(), x, prev_d, hidden, self.tau)


class Transition(nn.Module):
    """Prior network (reference ``networks.py:87-173``)."""

    def __init__(self, action_size: int, stoch_size: int, hidden_size: int, deter_size: int,
                 activation_name: str = "ELU"):
        super().__init__()
        self.action_state_projector = mlp(action_size + stoch_size, hidden_size, hidden_size,
                                          act=activation_name)
        self.rnn_cell = nn.GRUCell(hidden_size, deter_size)
        self.rnn_to_prior_projector = mlp(deter_size, stoch_size, hidden_size, act=activation_name)

    def weights(self) -> tuple[torch.Tensor, ...]:
        """The 12 transition tensors in kernel order (torch layouts):
        projector (w, b) ×2, GRU (w_ih, b_ih, w_hh, b_hh), prior (w, b) ×2."""
        asp, prior, gru = self.action_state_projector, self.rnn_to_prior_projector, self.rnn_cell
        return (asp[0].weight, asp[0].bias, asp[2].weight, asp[2].bias,
                gru.weight_ih, gru.bias_ih, gru.weight_hh, gru.bias_hh,
                prior[0].weight, prior[0].bias, prior[2].weight, prior[2].bias)


def rssm_transition_core(transition: Transition, action: torch.Tensor, prev_stoch: torch.Tensor,
                         prev_deter: torch.Tensor,
                         activation_name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared RSSM transition (reference ``networks.py:151-173``): (deter, logits)."""
    return transition_step(transition.weights(), action, prev_stoch, prev_deter,
                           activation(activation_name))


@torch.no_grad()
def init_fan_in_uniform_(module: nn.Module, generator: torch.Generator) -> None:
    """Torch's default init scale, drawn from ``generator`` in
    ``named_modules`` order: ``U(-1/sqrt(fan), 1/sqrt(fan))`` for weight and
    bias, with fan = in features (Linear), hidden size (GRU), in·k² (Conv2d)
    and OUT·k² (ConvTranspose2d, whose weight is laid out [in, out, k, k])."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan = m.in_features
        elif isinstance(m, nn.GRUCell):
            fan = m.weight_hh.shape[1]
        elif isinstance(m, nn.ConvTranspose2d):
            fan = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        elif isinstance(m, nn.Conv2d):
            fan = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        else:
            continue
        bound = 1.0 / math.sqrt(max(fan, 1))
        for p in m.parameters(recurse=False):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

"""Hand-written CUDA kernels and their dispatch (port of ``ops/pallas``).

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the kernel, with no fallback: the launch succeeds or raises. The JAX
package's measured TPU crossover (``B·T ≥ 256``) is not carried over, so on
CUDA the kernel always runs. The kernels hard-code ELU, so a model with
another activation raises on CUDA instead of silently taking the plain path.
The plain route is chosen by name: ``use_pallas_train=False`` (or None)
runs the recurrences (forward, and an autograd replay as the backward) and
the rollouts (on the kernels' Philox noise) as their plain versions on any
device, for any activation and shape; every refusal of the kernels names
it. Unlike JAX, where False touches training alone and imagination picks
XLA by eligibility, it also selects the plain rollouts: it is the one
knob, since serving has no ``use_pallas`` of its own.

Kernels (sources in ``csrc/``, built at first use by :mod:`.build`):

- ``recurrence_fwd``: the representation recurrence (observe, and the
  forward of a train step), replacing ``ops/pallas/train_step.py::_fwd_kernel``
  and ``::_fwd_kernel_chunked``;
- ``recurrence_bwd``: its BPTT backward, replacing ``::_bwd_kernel`` and
  ``::_bwd_kernel_chunked``;
- ``rollout``: imagination, replacing ``ops/pallas/rollout.py::_rollout_kernel``;
- ``mt_recurrence_fwd``: the MMTRSSM hierarchical recurrence, replacing
  ``ops/pallas/train_step_mt.py::_fwd_kernel`` and ``::_fwd_kernel_chunked``;
- ``mt_recurrence_bwd``: its BPTT backward, replacing ``::_bwd_kernel`` and
  ``::_bwd_kernel_chunked``;
- ``mt_rollout``: hierarchical imagination, replacing
  ``ops/pallas/rollout_mt.py::_mt_rollout_kernel``;
- ``stacked_recurrence_fwd`` / ``stacked_recurrence_bwd``: the MRSSM
  recurrence and its BPTT on stacked weights (``use_pallas_train=
  "stacked"``), replacing ``ops/pallas/train_step_stacked.py::
  _fwd_kernel_stacked`` and ``::_bwd_kernel_stacked``;
- ``fused_encoder_fwd`` / ``fused_encoder_bwd``: the whole conv encoder per
  tile of frames and its VJP (``conv_layout="fused_enc"``), replacing
  ``ops/pallas/fused_conv.py::_fwd_kernel`` and ``::_bwd_kernel`` as
  ``fused_encoder_apply`` reaches them;
- ``fused_encoder_fwd_bf16`` / ``fused_encoder_bwd_bf16``: the same encoder
  on bf16 frames (``trainer.precision: 16-mixed``), replacing the same two
  TPU kernels at ``dtype=bfloat16``;
- ``fused_decoder_fwd`` / ``fused_decoder_bwd``: the whole conv decoder per
  tile of frames and its VJP (``fused_decoder_apply``, a public function
  that no model config selects, as in JAX), replacing the same
  ``fused_conv.py::_fwd_kernel`` and ``::_bwd_kernel`` as
  ``fused_decoder_apply`` reaches them;
- ``fused_decoder_fwd_bf16`` / ``fused_decoder_bwd_bf16``: the same decoder
  on bf16 features, replacing the same two TPU kernels at
  ``dtype=bfloat16``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from multimodal_mtrssm_tpu_torch.nn.core import activation
from multimodal_mtrssm_tpu_torch.ops.kernels import (
    fused_conv,
    recurrence,
    recurrence_mt,
    recurrence_stacked,
    rollout,
    rollout_mt,
)
from multimodal_mtrssm_tpu_torch.ops.kernels.fused_conv import (
    fused_decoder_applicable,
    fused_decoder_apply,
    fused_encoder_applicable,
    fused_encoder_apply,
    resolve_conv_layout,
)
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import PLAIN_ROUTE
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence_mt import MT_SPEC, MTSpec
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import Seed, philox_gumbel
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout_mt import philox_mt_gumbel

# Kernel name → (module, attribute) of its launch counter.
LAUNCH_COUNTERS = {"recurrence_fwd": (recurrence, "launches"),
                   "recurrence_bwd": (recurrence, "bwd_launches"),
                   "rollout": (rollout, "launches"),
                   "mt_recurrence_fwd": (recurrence_mt, "launches"),
                   "mt_recurrence_bwd": (recurrence_mt, "bwd_launches"),
                   "mt_rollout": (rollout_mt, "launches"),
                   "stacked_recurrence_fwd": (recurrence_stacked, "launches"),
                   "stacked_recurrence_bwd": (recurrence_stacked, "bwd_launches"),
                   "fused_encoder_fwd": (fused_conv, "launches"),
                   "fused_encoder_bwd": (fused_conv, "bwd_launches"),
                   "fused_decoder_fwd": (fused_conv, "dec_launches"),
                   "fused_decoder_bwd": (fused_conv, "dec_bwd_launches"),
                   "fused_encoder_fwd_bf16": (fused_conv, "bf16_launches"),
                   "fused_encoder_bwd_bf16": (fused_conv, "bf16_bwd_launches"),
                   "fused_decoder_fwd_bf16": (fused_conv, "dec_bf16_launches"),
                   "fused_decoder_bwd_bf16": (fused_conv, "dec_bf16_bwd_launches")}

# use_pallas_train values of the JAX package that the port refuses: JAX's
# debug and test modes.
_JAX_DEBUG_TRAIN_MODES = ("interpret", "reference", "stacked_interpret")


def _route(device: torch.device, activation_name: str):
    """The plain version's activation on the CPU, None (= launch the
    kernel) on CUDA; raises where no route exists."""
    if device.type == "cpu":
        return activation(activation_name)
    if device.type != "cuda":
        raise ValueError(f"no kernel route for device {device}")
    if activation_name != "ELU":
        raise ValueError(f"the CUDA kernels implement ELU; this model uses {activation_name!r}: "
                         f"{recurrence.PLAIN_ROUTE}")
    return None


def _dispatch(device: torch.device, activation_name: str, plain: bool):
    """:func:`_route`, or where the caller chose the plain route by name
    (``plain``) the plain version's activation on the CPU and on CUDA."""
    if plain and device.type in ("cpu", "cuda"):
        return activation(activation_name)
    return _route(device, activation_name)


def fused_train_recurrence(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int = 4,
    category_size: int = 4, activation_name: str = "ELU", plain: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The representation recurrence over time-major ``[T, B, ·]`` inputs,
    differentiable on both routes (the forward kernel, and the backward
    kernel as its VJP; with ``plain``, their plain versions on any device).
    Returns ``(deter, prior_logits, prior_stoch, mixed_logits,
    post_stoch)``."""
    act = _dispatch(actions.device, activation_name, plain)
    return recurrence.RecurrenceFunction.apply(
        act, class_size, category_size, actions, a_emb, v_emb, init_deter, init_stoch,
        g_prior, g_post, *weights)


def fused_train_recurrence_stacked(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int = 4,
    category_size: int = 4, activation_name: str = "ELU",
) -> tuple[torch.Tensor, ...]:
    """:func:`fused_train_recurrence` on the stacked layout: the same 20
    weights in, the same outputs, gradients for the 20, through the stacked
    kernels (``train_step_stacked.fused_train_recurrence_stacked``)."""
    act = _route(actions.device, activation_name)
    return recurrence_stacked.RecurrenceStackedFunction.apply(
        act, class_size, category_size, actions, a_emb, v_emb, init_deter, init_stoch,
        g_prior, g_post, *weights)


def resolve_train_kernel_mode(value: bool | str | None, family: str = "mrssm") -> str:
    """A ``use_pallas_train`` value as the port runs it (JAX
    ``ops/pallas/__init__.py::resolve_train_kernel_mode``, the parts that
    mean something on one card): ``"auto"`` and ``True`` → ``"kernel"`` (the
    recurrence kernels), ``"stacked"`` → ``"stacked"`` (MRSSM only),
    ``False`` and ``None`` → ``"plain"`` (the plain versions on any device,
    JAX's XLA scan). Raises ``ValueError`` for JAX's debug modes and for
    anything else."""
    if value is False or value is None:
        return "plain"
    if value is True or value == "auto":
        return "kernel"
    if value == "stacked":
        if family != "mrssm":
            raise ValueError(f"use_pallas_train='stacked' is MRSSM-only (the {family.upper()} "
                             "family has no stacked-layout kernel); use 'auto'/True for "
                             f"{family.upper()}")
        return "stacked"
    if value in _JAX_DEBUG_TRAIN_MODES:
        raise ValueError(f"use_pallas_train={value!r} is not supported by the port: it runs the "
                         "recurrence kernels ('auto'/True), the stacked ones ('stacked') or the "
                         "plain route (False)")
    raise ValueError(f"use_pallas_train={value!r} not recognized; expected True, 'auto', "
                     "'stacked' or False")


def fused_rollout_transition(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init_deter: torch.Tensor,
    init_stoch: torch.Tensor, seed: Seed, class_size: int = 4, category_size: int = 4,
    activation_name: str = "ELU", plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prior-only imagination over ``[B, T, A]`` actions with the seed's
    Philox noise (an ``int``, or each row's ``(row_seed, row_index)``:
    ``rollout.row_keys``). Returns ``(deters, logits, stochs)``, each
    ``[B, T, ·]``. ``plain`` runs the plain version on any device, on the
    kernel's noise."""
    act = _dispatch(actions.device, activation_name, plain)
    if act is None:
        return rollout.rollout_cuda(weights, actions, init_deter, init_stoch, seed,
                                    class_size, category_size)
    return rollout.rollout_plain(weights, actions, init_deter, init_stoch, seed,
                                 class_size, category_size, act=act)


def fused_mt_train_recurrence(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init6: Sequence[torch.Tensor], gumbels: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC, activation_name: str = "ELU", plain: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The hierarchical recurrence over time-major ``[T, B, ·]`` inputs from
    ``init6`` ``(h_deter, l_deter, h_stoch, l_stoch, hid_h, hid_l)`` with the
    four sites' Gumbel noise (l-prior, l-posterior, h-prior, h-posterior),
    differentiable on both routes (``plain``: the plain versions on any
    device). Returns the 12 sequences of
    ``train_step_mt.fused_mt_train_recurrence``."""
    act = _dispatch(actions.device, activation_name, plain)
    return recurrence_mt.MTRecurrenceFunction.apply(
        act, spec, actions, a_emb, v_emb, *init6, *gumbels, *weights)


def fused_mt_rollout_transition(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init6: Sequence[torch.Tensor],
    seed: Seed, spec: MTSpec = MT_SPEC, activation_name: str = "ELU", plain: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Hierarchical prior-only imagination over ``[B, T, A]`` actions with
    the seed's Philox noise (as :func:`fused_rollout_transition`). Returns
    ``(h_deter, l_deter, h_logits, l_logits, h_stoch, l_stoch, hid_h,
    hid_l)``, each ``[B, T, ·]``."""
    act = _dispatch(actions.device, activation_name, plain)
    if act is None:
        return rollout_mt.rollout_mt_cuda(weights, actions, init6, seed, spec)
    return rollout_mt.rollout_mt_plain(weights, actions, init6, seed, spec, act=act)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr) for name, (mod, attr) in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod, attr in LAUNCH_COUNTERS.values():
        setattr(mod, attr, 0)


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set the launch counts to ``counts`` (:func:`launch_counts`'s form)."""
    for name, n in counts.items():
        mod, attr = LAUNCH_COUNTERS[name]
        setattr(mod, attr, n)


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` to the launch counts: the launches a CUDA graph's
    replay makes, which no Python wrapper sees (``train/graph.py``)."""
    for name, n in counts.items():
        mod, attr = LAUNCH_COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


__all__ = [
    "LAUNCH_COUNTERS",
    "MTSpec",
    "PLAIN_ROUTE",
    "Seed",
    "add_launch_counts",
    "fused_decoder_applicable",
    "fused_decoder_apply",
    "fused_encoder_applicable",
    "fused_encoder_apply",
    "fused_mt_rollout_transition",
    "fused_mt_train_recurrence",
    "fused_rollout_transition",
    "fused_train_recurrence",
    "fused_train_recurrence_stacked",
    "launch_counts",
    "philox_gumbel",
    "philox_mt_gumbel",
    "reset_launch_counts",
    "set_launch_counts",
    "resolve_conv_layout",
    "resolve_train_kernel_mode",
]

"""Kernel 6: the MoPoE-MMTRSSM hierarchical prior-only rollout (imagine).

Replaces ``multimodal_mtrssm_tpu/ops/pallas/rollout_mt.py::
_mt_rollout_kernel`` (line 51). For t = 0..T-1: the lower MTRNN on
``cat(action, ls, hs)`` of the previous prior samples → the l-prior → one-hot
Gumbel-argmax sample; the higher MTRNN on the previous ``hs`` → the h-prior
→ one-hot sample. It returns the integrator trajectories ``hidden_h`` /
``hidden_l`` too, which make a chained continuation exact.

Noise: Philox4x32-10 keyed by the 64-bit seed, as in the MRSSM rollout
(``rollout.py``), with the counter ``(t, b, block, word)``: the lower
site's blocks are ``0 .. ls_class - 1``, the higher site's
``ls_class + c``; a block of K categories takes ``ceil(K / 4)`` words (two
for the 2×8 higher latent). :func:`philox_mt_gumbel` is the same generator
in torch integer ops; its lower half is ``philox_gumbel(seed, T, B, 4, 4)``.

What bounds it on the card: the latency of the T dependent steps of small
products at serving batches. The design is the MRSSM rollout's: one launch,
one block per tile of batch rows with the T loop inside, the 16 weights
(7,072 floats, 28.3 KB) staged once in shared memory, the noise made in
registers.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import Act, mtrnn_step, two_layer
from multimodal_mtrssm_tpu_torch.ops.distributions import onehot_blocks
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import _check_inputs, _rows_per_block
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence_mt import (
    MT_SPEC,
    MTSpec,
    _check_spec,
    _dims,
    _expect_weights,
    _ptrs,
    mt_weight_shapes,
)
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import philox_block_gumbel

N_WEIGHTS = 16
# Kernel launches since the last reset (plain int; the serving path holds a
# device lock around every launch).
launches = 0


def philox_mt_gumbel(seed: int, T: int, B: int, ls: tuple[int, int] = (4, 4),
                     hs: tuple[int, int] = (2, 8),
                     device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's Gumbel noise for ``seed``: ``(lower [T, B, LS], higher
    [T, B, HS])`` for latents of ``ls`` and ``hs`` ``(class, category)``."""
    return (philox_block_gumbel(seed, T, B, 0, ls[0], ls[1], device),
            philox_block_gumbel(seed, T, B, ls[0], hs[0], hs[1], device))


def mt_prior_step(w: Sequence[torch.Tensor], action: torch.Tensor,
                  carry: Sequence[torch.Tensor], spec: MTSpec,
                  act: Act) -> tuple[torch.Tensor, ...]:
    """One imagination step before sampling, on the 16 weights, from the
    carry ``(h_deter, l_deter, h_stoch, l_stoch, hid_h, hid_l)``. Returns
    ``(h_deter, l_deter, h_logits, l_logits, hid_h, hid_l)``."""
    hd, ld, hs, ls, hidh, hidl = carry
    l_deter, hidl = mtrnn_step(w[0:4], torch.cat([action, ls, hs], -1), ld, hidl, spec.l_tau)
    l_logits = two_layer(l_deter, *w[8:12], act)
    h_deter, hidh = mtrnn_step(w[4:8], hs, hd, hidh, spec.h_tau)
    h_logits = two_layer(h_deter, *w[12:16], act)
    return h_deter, l_deter, h_logits, l_logits, hidh, hidl


def rollout_mt_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init6: Sequence[torch.Tensor],
    seed: int | None = None, spec: MTSpec = MT_SPEC,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None, act: Act = F.elu,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel. ``actions`` is ``[B, T, A]``,
    ``init6`` ``(h_deter, l_deter, h_stoch, l_stoch, hid_h, hid_l)``; the
    noise is ``noise`` (lower and higher ``[T, B, ·]`` Gumbel) when given,
    else ``philox_mt_gumbel(seed, ...)``, the kernel's own stream. Returns
    ``(h_deter, l_deter, h_logits, l_logits, h_stoch, l_stoch, hid_h,
    hid_l)``, each ``[B, T, ·]``; stochs are one-hot."""
    B, T, _ = actions.shape
    if noise is None:
        if seed is None:
            raise ValueError("rollout_mt_plain needs a seed or a noise tensor pair")
        noise = philox_mt_gumbel(seed, T, B, (spec.ls_class, spec.ls_category),
                                 (spec.hs_class, spec.hs_category), actions.device)
    carry = tuple(init6)
    outs = []
    for t in range(T):
        hd, ld, h_logits, l_logits, hidh, hidl = mt_prior_step(weights, actions[:, t], carry,
                                                               spec, act)
        hs = onehot_blocks(h_logits + noise[1][t], spec.hs_class, spec.hs_category)
        ls = onehot_blocks(l_logits + noise[0][t], spec.ls_class, spec.ls_category)
        outs.append((hd, ld, h_logits, l_logits, hs, ls, hidh, hidl))
        carry = (hd, ld, hs, ls, hidh, hidl)
    return tuple(torch.stack(seq, 1) for seq in zip(*outs))


def rollout_mt_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init6: Sequence[torch.Tensor],
    seed: int, spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel (``csrc/rollout_mt.cu``); same contract as
    :func:`rollout_mt_plain` with the seed's Philox noise and ELU."""
    global launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS or len(init6) != 6:
        raise ValueError(f"expected {N_WEIGHTS} weights and 6 initial carries, "
                         f"got {len(weights)} and {len(init6)}")
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must fit in 64 unsigned bits, got {seed}")
    _check_spec(spec)
    B, T, A = actions.shape
    HD, LD = weights[4].shape[0], weights[0].shape[0]
    C = weights[8].shape[0]
    LS, HS = spec.ls, spec.hs
    expect = {"actions": (actions, (B, T, A))}
    for i, (x, d) in enumerate(zip(init6, (HD, LD, HS, LS, HD, LD))):
        expect[f"init6[{i}]"] = (x, (B, d))
    _expect_weights(expect, weights, mt_weight_shapes(A, 0, HD, LD, C, 0, spec))
    _check_inputs(expect, actions.device)
    out = [actions.new_empty((B, T, d)) for d in (HD, LD, HS, LS, HS, LS, HD, LD)]
    if T == 0 or B == 0:
        return tuple(out)
    lib = build.load_library()
    dims = _dims(T, B, A, 0, HD, LD, C, 0, spec, _rows_per_block(B, actions.device))
    with torch.cuda.device(actions.device):
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mt_rollout(_ptrs(weights), _ptrs([actions, *init6]), _ptrs(out), seed, dims,
                             stream)
    build.check(err)
    launches += 1
    return tuple(out)

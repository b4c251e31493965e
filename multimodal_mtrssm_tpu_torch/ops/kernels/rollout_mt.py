"""Kernel 6: the MoPoE-MMTRSSM hierarchical prior-only rollout (imagine).

Replaces ``multimodal_mtrssm_tpu/ops/pallas/rollout_mt.py::
_mt_rollout_kernel`` (line 51). For t = 0..T-1: the lower MTRNN on
``cat(action, ls, hs)`` of the previous prior samples → the l-prior → one-hot
Gumbel-argmax sample; the higher MTRNN on the previous ``hs`` → the h-prior
→ one-hot sample. It returns the integrator trajectories ``hidden_h`` /
``hidden_l`` too, which make a chained continuation exact.

Noise: Philox4x32-10 keyed row by row by a 64-bit seed, as in the MRSSM
rollout (``rollout.py``: an ``int`` seed or each row's ``(row_seed,
row_index)``, :func:`~.rollout.row_keys`), with the counter ``(t, index,
block, word)``: the lower
site's blocks are ``0 .. ls_class - 1``, the higher site's
``ls_class + c``; a block of K categories takes ``ceil(K / 4)`` words (two
for the 2×8 higher latent). :func:`philox_mt_gumbel` is the same generator
in torch integer ops; its lower half is ``philox_gumbel(seed, T, B, 4, 4)``.

What bounds it on the card: the latency of the T dependent steps of small
products at serving batches. The kernel is one launch in stages, each with
a plain version here: a prologue of every step's carry-free work (the
action columns of the lower cell's input layer and both sites' Gumbel
scores, :func:`rollout_mt_inputs_plain`, into a ``[T, B, LD + LS + HS]``
workspace), and the T-step chain on the deter and integrator carries, two
barrier phases a step (:func:`rollout_mt_chain_plain`): both MTRNN updates,
whose sample columns are a gather of the ``ls_class + hs_class`` columns
the one-hot samples select (:func:`~.rollout.gather_columns`; the given
stochs at t = 0 need not be one-hot and go through the dense product), then
a warp a row and site for the prior and its sample on the prologue's noise
(:func:`~.rollout.sample_plain`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import Act, mtrnn_step, two_layer
from multimodal_mtrssm_tpu_torch.ops.distributions import onehot_blocks
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import _check_inputs
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence_mt import (
    MT_SPEC,
    MTSpec,
    _check_spec,
    _dims,
    _expect_weights,
    _ptrs,
    mt_weight_shapes,
)
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import (
    Seed,
    gather_columns,
    philox_block_gumbel,
    rollout_rows,
    row_keys,
    sample_plain,
)

N_WEIGHTS = 16
# Kernel launches since the last reset (plain int; the serving path holds a
# device lock around every launch).
launches = 0


def philox_mt_gumbel(seed: Seed, T: int, B: int, ls: tuple[int, int] = (4, 4),
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
    seed: Seed | None = None, spec: MTSpec = MT_SPEC,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None, act: Act = F.elu,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel. ``actions`` is ``[B, T, A]``,
    ``init6`` ``(h_deter, l_deter, h_stoch, l_stoch, hid_h, hid_l)``; the
    noise is ``noise`` (lower and higher ``[T, B, ·]`` Gumbel) when given,
    else ``philox_mt_gumbel(seed, ...)``, the kernel's own stream. Returns
    ``(h_deter, l_deter, h_logits, l_logits, h_stoch, l_stoch, hid_h,
    hid_l)``, each ``[B, T, ·]``; stochs are one-hot."""
    B, T, _ = actions.shape
    if T == 0:
        return tuple(actions.new_empty((B, 0, init6[i].shape[-1])) for i in (0, 1, 2, 3, 2, 3, 4, 5))
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


# ---- the kernel's stages ---------------------------------------------------------


def rollout_mt_inputs_plain(weights: Sequence[torch.Tensor], actions: torch.Tensor, seed: Seed,
                            spec: MTSpec = MT_SPEC) -> torch.Tensor:
    """Plain version of the kernel's prologue: every step's carry-free work,
    time-major ``[T, B, LD + LS + HS]`` (the workspace the chain reads):
    ``action·wli[:, :A]ᵀ + bli``, then both sites' Gumbel scores for the seed
    (:func:`philox_mt_gumbel`)."""
    B, T, A = actions.shape
    pre = F.linear(actions.transpose(0, 1), weights[2][:, :A], weights[3])
    g_l, g_h = philox_mt_gumbel(seed, T, B, (spec.ls_class, spec.ls_category),
                                (spec.hs_class, spec.hs_category), actions.device)
    return torch.cat([pre, g_l.to(pre.dtype), g_h.to(pre.dtype)], -1)


def rollout_mt_chain_plain(weights: Sequence[torch.Tensor], inputs: torch.Tensor,
                           init6: Sequence[torch.Tensor],
                           spec: MTSpec = MT_SPEC) -> tuple[torch.Tensor, ...]:
    """Plain version of the kernel's carry chain on the prologue's rows
    ``inputs`` (:func:`rollout_mt_inputs_plain`) from ``init6``: per step both
    MTRNN updates (JAX ``mtrnn_apply``'s association, the lower cell's input
    sum the sample columns' plus the prologue's action sum), the sample
    columns dense on the given stochs at t = 0 and a gather of the columns
    the one-hot samples select after; both priors and their samples on the
    prologue's noise. Returns :func:`rollout_mt_plain`'s eight outputs, each
    ``[B, T, ·]``."""
    wld, bld, wli, _, whd, bhd, whi, bhi, wp1, bp1, wp2, bp2, wh1, bh1, wh2, bh2 = weights
    LD, LS, HS = wld.shape[0], spec.ls, spec.hs
    wlx = wli[:, wli.shape[1] - LS - HS:]
    l_inv, h_inv = 1.0 / spec.l_tau, 1.0 / spec.h_tau
    hd, ld, hs, ls, hidh, hidl = init6
    cols = None  # both sites' chosen columns, in the lower cell's ls ⊕ hs columns
    steps = []
    for t in range(inputs.shape[0]):
        pl, g_l, g_h = inputs[t].split([LD, LS, HS], -1)
        if cols is None:
            xl, xh = F.linear(torch.cat([ls, hs], -1), wlx), F.linear(hs, whi)
        else:
            xl, xh = gather_columns(wlx, cols), gather_columns(whi, cols[..., spec.ls_class:] - LS)
        hidl = (1.0 - l_inv) * hidl + (F.linear(ld, wld, bld) + (xl + pl)) * l_inv
        hidh = (1.0 - h_inv) * hidh + (F.linear(hd, whd, bhd) + (xh + bhi)) * h_inv
        ld, hd = torch.tanh(hidl), torch.tanh(hidh)
        l_logits = two_layer(ld, wp1, bp1, wp2, bp2, F.elu)
        h_logits = two_layer(hd, wh1, bh1, wh2, bh2, F.elu)
        ls, l_cols = sample_plain(l_logits, g_l, spec.ls_class, spec.ls_category)
        hs, h_cols = sample_plain(h_logits, g_h, spec.hs_class, spec.hs_category)
        cols = torch.cat([l_cols, h_cols + LS], -1)
        steps.append((hd, ld, h_logits, l_logits, hs, ls, hidh, hidl))
    return tuple(torch.stack(seq, 1) for seq in zip(*steps))


def rollout_mt_stages_plain(weights: Sequence[torch.Tensor], actions: torch.Tensor,
                            init6: Sequence[torch.Tensor], seed: Seed,
                            spec: MTSpec = MT_SPEC) -> tuple[torch.Tensor, ...]:
    """The plain prologue and chain in a row: the rollout as the kernel
    decomposes it, with :func:`rollout_mt_plain`'s contract (the seed's
    Philox noise, ELU)."""
    if actions.shape[1] == 0:
        return rollout_mt_plain(weights, actions, init6, seed, spec)
    inputs = rollout_mt_inputs_plain(weights, actions, seed, spec)
    return rollout_mt_chain_plain(weights, inputs, init6, spec)


def rollout_mt_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init6: Sequence[torch.Tensor],
    seed: Seed, spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel (``csrc/rollout_mt.cu``: prologue and chain in
    one launch); same contract as :func:`rollout_mt_plain` with the seed's
    Philox noise and ELU. Raises on any input the kernel does not take."""
    global launches
    outs, _ = rollout_mt_launch(weights, actions, init6, seed, spec)
    if actions.shape[0] and actions.shape[1]:
        launches += 1
    return outs


def rollout_mt_launch(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init6: Sequence[torch.Tensor],
    seed: Seed, spec: MTSpec = MT_SPEC, stages: int = 3, workspace: torch.Tensor | None = None,
    outs: Sequence[torch.Tensor] | None = None, rows: int | None = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Launch the kernel's stages in ``stages`` (1 the prologue, 2 the chain)
    on ``workspace`` (the prologue's rows, ``[T, B, LD + LS + HS]``;
    allocated when None) into ``outs`` (the eight outputs; allocated when
    None), with ``rows`` batch rows a block (``rollout_rows`` when None).
    Returns the outputs and the workspace, for tests and timings that run one
    stage on what another wrote. Counts no launch."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS or len(init6) != 6:
        raise ValueError(f"expected {N_WEIGHTS} weights and 6 initial carries, "
                         f"got {len(weights)} and {len(init6)}")
    _check_spec(spec)
    B, T, A = actions.shape
    row_seed, row_index = row_keys(seed, B, actions.device)
    HD, LD = weights[4].shape[0], weights[0].shape[0]
    C = weights[8].shape[0]
    LS, HS = spec.ls, spec.hs
    widths = (HD, LD, HS, LS, HS, LS, HD, LD)
    expect = {"actions": (actions, (B, T, A))}
    for i, (x, d) in enumerate(zip(init6, (HD, LD, HS, LS, HD, LD))):
        expect[f"init6[{i}]"] = (x, (B, d))
    _expect_weights(expect, weights, mt_weight_shapes(A, 0, HD, LD, C, 0, spec))
    if outs is None:
        outs = [actions.new_empty((B, T, d)) for d in widths]
    for i, (o, d) in enumerate(zip(outs, widths)):
        expect[f"outs[{i}]"] = (o, (B, T, d))
    if workspace is None:
        workspace = actions.new_empty((T, B, LD + LS + HS))
    expect["workspace"] = (workspace, (T, B, LD + LS + HS))
    _check_inputs(expect, actions.device)
    if T == 0 or B == 0:
        return tuple(outs), workspace
    lib = build.load_library()
    R = rollout_rows(B, actions.device) if rows is None else rows
    dims = _dims(T, B, A, 0, HD, LD, C, 0, spec, R)
    with torch.cuda.device(actions.device):
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mt_rollout(_ptrs(weights), _ptrs([actions, *init6]), _ptrs(outs),
                             workspace.data_ptr(), row_seed.data_ptr(), row_index.data_ptr(),
                             dims, stages, stream)
    build.check(err)
    return tuple(outs), workspace

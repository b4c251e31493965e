"""Kernel 2: the MoPoE-MRSSM prior-only imagination rollout (imagine).

Replaces ``multimodal_mtrssm_tpu/ops/pallas/rollout.py::_rollout_kernel``
(line 105). For t = 0..T-1: transition MLP(action ⊕ stoch) → GRU → prior MLP
→ one-hot Gumbel-argmax sample per category block, which is the next step's
stoch.

Noise: the TPU's core PRNG becomes Philox4x32-10 written into the kernel,
keyed row by row by a 64-bit seed (low word, high word), with the counter
``(t, index, block, word)``, where ``index`` is the row's index inside its
own request: one call gives the four uniforms of a four-category block. A
seed is an ``int`` (one request: that seed on every row, the indices
``0 .. B-1``) or a pair ``(row_seed, row_index)`` of int64 ``[B]`` tensors
(:func:`row_keys`), with which the rows of coalesced requests each keep
their own request's draws. Uniforms come from the bits by mantissa
stuffing with the low bit forced on, so u is never 0
(``rollout.py::_uniform_from_bits``), and the Gumbel score is
``-log(-log(u))``. :func:`philox_gumbel` is the same generator
in torch integer ops, so a seed draws the same noise on the CPU and the card.

What bounds it on the card: as for the recurrence, the T dependent steps of
small products make it latency-bound at serving batches (B=8..64); only at
B≥256 does the batch fill the SMs. The kernel is one launch in stages, each
with a plain version here: a prologue of every step's carry-free work (the
action columns of the transition's first layer and the seed's Gumbel
scores, :func:`rollout_inputs_plain`, into a ``[T, B, H + S]`` workspace),
and the T-step chain on the deter carry, two barrier phases a step
(:func:`rollout_chain_plain`): the GRU, with the transition's second layer
folded into its input gates (it is linear), then a warp a row for the prior,
the sample on the prologue's noise (:func:`sample_plain`) and the next
step's first layer, whose stoch columns are a gather of the ``class_size``
columns the one-hot sample selects (:func:`gather_columns`; the given stoch
at t = 0 need not be one-hot and goes through the dense product).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import gru_cell, transition_step, two_layer
from multimodal_mtrssm_tpu_torch.ops.distributions import onehot_blocks
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import (
    _check_inputs,
    _rows_per_block,
    weight_shapes,
)

N_WEIGHTS = 12
# The most batch rows a block of either rollout kernel takes: its sampling
# phase takes a warp a row (two in the MMTRSSM's) and leaves the next
# step's carry products to at least two other warps of the eight.
MAX_ROWS = 3
# Kernel launches since the last reset (plain int; the serving path holds a
# device lock around every launch).
launches = 0

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
# A rollout's seed: one request's int, or each row's (row_seed, row_index).
Seed = int | tuple[torch.Tensor, torch.Tensor]


def _mul_hi_lo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * m`` for 32-bit ``a`` (int64 tensor)
    and a 32-bit constant, without overflowing int64."""
    p_lo = a * (m & 0xFFFF)             # < 2^48
    p_hi = a * (m >> 16)                # < 2^48; a·m = p_hi·2^16 + p_lo
    s = ((p_hi & 0xFFFF) << 16) + p_lo  # < 2^49
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(counter: Sequence[torch.Tensor],
                  key: tuple[int | torch.Tensor, int | torch.Tensor]) -> list[torch.Tensor]:
    """Philox4x32-10 (Salmon et al., SC'11, as in Random123) on int64 tensors
    holding 32-bit words; the key's two words are ints or int64 tensors that
    broadcast against the counter. Returns the four output words."""
    c = [x.to(torch.int64) & _MASK32 for x in counter]
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for i in range(10):
        if i > 0:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mul_hi_lo(c[0], _PHILOX_M[0])
        hi1, lo1 = _mul_hi_lo(c[2], _PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64 tensor) → float32 uniforms in (0, 1)."""
    pattern = ((bits >> 9) | 0x3F800001).to(torch.int32)
    return pattern.view(torch.float32) - 1.0


def row_keys(seed: Seed, B: int,
             device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Each batch row's Philox seed and its index inside its own request,
    int64 ``[B]`` each, on ``device``. An ``int`` seed in ``[0, 2**64)`` is
    one request: the seed on every row (as int64, two's complement) and the
    indices ``0 .. B-1``. A pair ``(row_seed, row_index)`` is taken as it
    is: the rows of coalesced requests, each with its request's seed and its
    index in that request. Only the low 64 bits of a row seed and the low 32
    of an index reach the generator."""
    if isinstance(seed, tuple):
        keys = []
        for name, x in zip(("row_seed", "row_index"), seed):
            if not isinstance(x, torch.Tensor) or x.dtype != torch.int64 or x.shape != (B,):
                raise ValueError(f"{name} must be an int64 tensor of shape ({B},), got "
                                 f"{getattr(x, 'dtype', type(x))} {tuple(getattr(x, 'shape', ()))}")
            keys.append(x.to(device).contiguous())
        return keys[0], keys[1]
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must fit in 64 unsigned bits, got {seed}")
    return (torch.full((B,), seed - 2**64 if seed >= 2**63 else seed, dtype=torch.int64,
                       device=device),
            torch.arange(B, dtype=torch.int64, device=device))


def philox_block_gumbel(seed: Seed, T: int, B: int, first_block: int, n_blocks: int,
                        category_size: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Gumbel noise of category blocks ``first_block ..`` (the counter's
    block word) for ``seed`` (:func:`row_keys`), time-major ``[T, B,
    n_blocks * category_size]``; a block of K categories takes ``ceil(K /
    4)`` Philox calls."""
    words = -(-category_size // 4)
    row_seed, row_index = row_keys(seed, B, device)
    t, b, c, w = torch.meshgrid(
        torch.arange(T, dtype=torch.int64, device=device), row_index,
        torch.arange(first_block, first_block + n_blocks, dtype=torch.int64, device=device),
        torch.arange(words, dtype=torch.int64, device=device), indexing="ij")
    key = ((row_seed & _MASK32)[:, None, None], (row_seed >> 32 & _MASK32)[:, None, None])
    bits = torch.stack(philox4x32_10((t, b, c, w), key), dim=-1)
    u = uniform_from_bits(bits.reshape(T, B, n_blocks, 4 * words)[..., :category_size])
    return (-torch.log(-torch.log(u))).reshape(T, B, n_blocks * category_size)


def philox_gumbel(seed: Seed, T: int, B: int, class_size: int, category_size: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernel's Gumbel noise for ``seed``, time-major ``[T, B, S]``."""
    return philox_block_gumbel(seed, T, B, 0, class_size, category_size, device)


def rollout_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init_deter: torch.Tensor,
    init_stoch: torch.Tensor, seed: Seed | None = None, class_size: int = 4,
    category_size: int = 4, noise: torch.Tensor | None = None,
    act: Callable[[torch.Tensor], torch.Tensor] = F.elu,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel. ``actions`` is ``[B, T, A]``; the
    noise is ``noise`` (``[T, B, S]`` Gumbel) when given, else
    ``philox_gumbel(seed, ...)``, the kernel's own stream. Returns
    ``(deters, logits, stochs)``, each ``[B, T, ·]``; stochs are one-hot."""
    B, T, _ = actions.shape
    if T == 0:
        return tuple(actions.new_empty((B, 0, x.shape[-1]))
                     for x in (init_deter, init_stoch, init_stoch))
    if noise is None:
        if seed is None:
            raise ValueError("rollout_plain needs a seed or a noise tensor")
        noise = philox_gumbel(seed, T, B, class_size, category_size, actions.device)
    deter, stoch = init_deter, init_stoch
    deters, logits, stochs = [], [], []
    for t in range(T):
        deter, lg = transition_step(weights, actions[:, t], stoch, deter, act)
        stoch = onehot_blocks(lg + noise[t], class_size, category_size)
        deters.append(deter)
        logits.append(lg)
        stochs.append(stoch)
    return torch.stack(deters, 1), torch.stack(logits, 1), torch.stack(stochs, 1)


# ---- the kernel's stages ---------------------------------------------------------


def rollout_inputs_plain(weights: Sequence[torch.Tensor], actions: torch.Tensor, seed: Seed,
                         class_size: int, category_size: int) -> torch.Tensor:
    """Plain version of the kernel's prologue: every step's carry-free work,
    time-major ``[T, B, H + S]`` (the workspace the chain reads):
    ``action·w1[:, :A]ᵀ + b1``, then the seed's Gumbel scores
    (:func:`philox_gumbel`)."""
    B, T, A = actions.shape
    pre = F.linear(actions.transpose(0, 1), weights[0][:, :A], weights[1])
    noise = philox_gumbel(seed, T, B, class_size, category_size, actions.device)
    return torch.cat([pre, noise.to(pre.dtype)], -1)


def sample_plain(logits: torch.Tensor, noise: torch.Tensor, class_size: int,
                 category_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's sample on precomputed noise: the one-hot
    first-index argmax of ``logits + noise`` per block, and each block's
    chosen column in the flat latent, ``[..., class_size]``."""
    onehot = onehot_blocks(logits + noise, class_size, category_size)
    blocks = onehot.reshape(*onehot.shape[:-1], class_size, category_size)
    first = torch.arange(class_size, device=logits.device) * category_size
    return onehot, blocks.argmax(-1) + first


def gather_columns(w: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``Σ_c w[:, cols[..., c]]``: the product of ``w`` (torch layout) with
    the one-hot carry whose chosen columns are ``cols``, which the dense
    product equals only where the carry is exactly one-hot."""
    return w.t()[cols].sum(-2)


def rollout_chain_plain(
    weights: Sequence[torch.Tensor], inputs: torch.Tensor, init_deter: torch.Tensor,
    init_stoch: torch.Tensor, class_size: int, category_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's carry chain on the prologue's rows
    ``inputs`` (:func:`rollout_inputs_plain`) from the initial carries: per
    step ``h1 = elu(the prologue's sum + stoch·w1[:, A:]ᵀ)``, the stoch
    product dense on the given stoch at t = 0 and a gather of the columns
    the one-hot sample selects after; the GRU with the transition's second
    layer folded into its input gates (``wih·w2``, ``wih·b2 + bih``); the
    prior; the sample on the prologue's noise. Returns ``(deters, logits,
    stochs)``, each ``[B, T, ·]``."""
    w1, _, w2, b2, wih, bih, whh, bhh, wp1, bp1, wp2, bp2 = weights
    H, S = w2.shape[0], init_stoch.shape[-1]
    w1s = w1[:, w1.shape[1] - S:]
    wf, bf = wih @ w2, wih @ b2 + bih
    deter, cols = init_deter, None
    steps = []
    for t in range(inputs.shape[0]):
        pre, noise = inputs[t].split([H, S], -1)
        x = F.linear(init_stoch, w1s) if cols is None else gather_columns(w1s, cols)
        deter = gru_cell(F.elu(pre + x), deter, wf, whh, bf, bhh)
        logits = two_layer(deter, wp1, bp1, wp2, bp2, F.elu)
        stoch, cols = sample_plain(logits, noise, class_size, category_size)
        steps.append((deter, logits, stoch))
    return tuple(torch.stack(seq, 1) for seq in zip(*steps))


def rollout_stages_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init_deter: torch.Tensor,
    init_stoch: torch.Tensor, seed: Seed, class_size: int = 4, category_size: int = 4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain prologue and chain in a row: the rollout as the kernel
    decomposes it, with :func:`rollout_plain`'s contract (the seed's Philox
    noise, ELU)."""
    if actions.shape[1] == 0:
        return rollout_plain(weights, actions, init_deter, init_stoch, seed, class_size,
                             category_size)
    inputs = rollout_inputs_plain(weights, actions, seed, class_size, category_size)
    return rollout_chain_plain(weights, inputs, init_deter, init_stoch, class_size, category_size)


def rollout_rows(batch: int, device: torch.device) -> int:
    """Batch rows per block of either rollout kernel: one block per SM
    where the batch allows it, at most :data:`MAX_ROWS`."""
    return min(MAX_ROWS, _rows_per_block(batch, device))


def rollout_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init_deter: torch.Tensor,
    init_stoch: torch.Tensor, seed: Seed, class_size: int = 4, category_size: int = 4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (``csrc/rollout.cu``: prologue and chain in one
    launch); same contract as :func:`rollout_plain` with the seed's Philox
    noise and ELU. Raises on any input the kernel does not take."""
    global launches
    outs, _ = rollout_launch(weights, actions, init_deter, init_stoch, seed, class_size,
                             category_size)
    if actions.shape[0] and actions.shape[1]:
        launches += 1
    return outs


def rollout_launch(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init_deter: torch.Tensor,
    init_stoch: torch.Tensor, seed: Seed, class_size: int = 4, category_size: int = 4,
    stages: int = 3, workspace: torch.Tensor | None = None,
    outs: Sequence[torch.Tensor] | None = None, rows: int | None = None,
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Launch the kernel's stages in ``stages`` (1 the prologue, 2 the chain)
    on ``workspace`` (the prologue's rows, ``[T, B, H + S]``; allocated when
    None) into ``outs`` (deters, logits, stochs; allocated when None), with
    ``rows`` batch rows a block (:func:`rollout_rows` when None). Returns the
    outputs and the workspace, for tests and timings that run one stage on
    what another wrote. Counts no launch."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    B, T, A = actions.shape
    row_seed, row_index = row_keys(seed, B, actions.device)
    D = init_deter.shape[-1]
    H = weights[0].shape[0]
    S = class_size * category_size
    expect = {"actions": (actions, (B, T, A)), "init_deter": (init_deter, (B, D)),
              "init_stoch": (init_stoch, (B, S))}
    for i, (w, shape) in enumerate(zip(weights, weight_shapes(A, S, H, D, 0)[:N_WEIGHTS])):
        expect[f"weights[{i}]"] = (w, shape)
    if outs is None:
        outs = [actions.new_empty((B, T, d)) for d in (D, S, S)]
    for i, (o, d) in enumerate(zip(outs, (D, S, S))):
        expect[f"outs[{i}]"] = (o, (B, T, d))
    if workspace is None:
        workspace = actions.new_empty((T, B, H + S))
    expect["workspace"] = (workspace, (T, B, H + S))
    _check_inputs(expect, actions.device)
    if T == 0 or B == 0:
        return tuple(outs), workspace
    lib = build.load_library()
    R = rollout_rows(B, actions.device) if rows is None else rows
    ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(w.data_ptr() for w in weights))
    with torch.cuda.device(actions.device):
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mrssm_rollout(
            ctypes.cast(ptrs, ctypes.c_void_p),
            *(t.data_ptr() for t in (actions, init_deter, init_stoch)),
            *(o.data_ptr() for o in outs), workspace.data_ptr(), row_seed.data_ptr(),
            row_index.data_ptr(), T, B, A, H, D, class_size, category_size, R, stages, stream,
        )
    build.check(err)
    return tuple(outs), workspace

"""Kernel 2: the MoPoE-MRSSM prior-only imagination rollout (imagine).

Replaces ``multimodal_mtrssm_tpu/ops/pallas/rollout.py::_rollout_kernel``
(line 105). For t = 0..T-1: transition MLP(action ⊕ stoch) → GRU → prior MLP
→ one-hot Gumbel-argmax sample per category block, which is the next step's
stoch.

Noise: the TPU's core PRNG becomes Philox4x32-10 written into the kernel,
keyed by the 64-bit ``seed`` (low word, high word), with the counter
``(t, b, block, word)``: one call gives the four uniforms of a four-category
block. Uniforms come from the bits by mantissa stuffing with the low bit
forced on, so u is never 0 (``rollout.py::_uniform_from_bits``), and the
Gumbel score is ``-log(-log(u))``. :func:`philox_gumbel` is the same generator
in torch integer ops, so a seed draws the same noise on the CPU and the card.

What bounds it on the card: as for the recurrence, the T dependent steps of
small products make it latency-bound at serving batches (B=8..64); only at
B≥256 does the batch fill the SMs. The design is the recurrence kernel's
(``recurrence.py``): one launch, one block per tile of batch rows with the T
loop inside, the 12 transition weights (~39 KB) in shared memory, the noise
generated in registers instead of read from device memory.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import transition_step
from multimodal_mtrssm_tpu_torch.ops.distributions import onehot_blocks
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import (
    _check_inputs,
    _rows_per_block,
    weight_shapes,
)

N_WEIGHTS = 12
# Kernel launches since the last reset (plain int; the serving path holds a
# device lock around every launch).
launches = 0

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mul_hi_lo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * m`` for 32-bit ``a`` (int64 tensor)
    and a 32-bit constant, without overflowing int64."""
    p_lo = a * (m & 0xFFFF)             # < 2^48
    p_hi = a * (m >> 16)                # < 2^48; a·m = p_hi·2^16 + p_lo
    s = ((p_hi & 0xFFFF) << 16) + p_lo  # < 2^49
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(counter: Sequence[torch.Tensor], key: tuple[int, int]) -> list[torch.Tensor]:
    """Philox4x32-10 (Salmon et al., SC'11, as in Random123) on int64 tensors
    holding 32-bit words. Returns the four output words."""
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


def philox_block_gumbel(seed: int, T: int, B: int, first_block: int, n_blocks: int,
                        category_size: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Gumbel noise of category blocks ``first_block ..`` (the counter's
    block word) for ``seed``, time-major ``[T, B, n_blocks * category_size]``;
    a block of K categories takes ``ceil(K / 4)`` Philox calls."""
    words = -(-category_size // 4)
    t, b, c, w = torch.meshgrid(
        torch.arange(T, dtype=torch.int64, device=device),
        torch.arange(B, dtype=torch.int64, device=device),
        torch.arange(first_block, first_block + n_blocks, dtype=torch.int64, device=device),
        torch.arange(words, dtype=torch.int64, device=device), indexing="ij")
    bits = torch.stack(philox4x32_10((t, b, c, w), (seed & _MASK32, seed >> 32)), dim=-1)
    u = uniform_from_bits(bits.reshape(T, B, n_blocks, 4 * words)[..., :category_size])
    return (-torch.log(-torch.log(u))).reshape(T, B, n_blocks * category_size)


def philox_gumbel(seed: int, T: int, B: int, class_size: int, category_size: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernel's Gumbel noise for ``seed``, time-major ``[T, B, S]``."""
    return philox_block_gumbel(seed, T, B, 0, class_size, category_size, device)


def rollout_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init_deter: torch.Tensor,
    init_stoch: torch.Tensor, seed: int | None = None, class_size: int = 4,
    category_size: int = 4, noise: torch.Tensor | None = None,
    act: Callable[[torch.Tensor], torch.Tensor] = F.elu,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel. ``actions`` is ``[B, T, A]``; the
    noise is ``noise`` (``[T, B, S]`` Gumbel) when given, else
    ``philox_gumbel(seed, ...)``, the kernel's own stream. Returns
    ``(deters, logits, stochs)``, each ``[B, T, ·]``; stochs are one-hot."""
    B, T, _ = actions.shape
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


def rollout_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, init_deter: torch.Tensor,
    init_stoch: torch.Tensor, seed: int, class_size: int = 4, category_size: int = 4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (``csrc/rollout.cu``); same contract as
    :func:`rollout_plain` with the seed's Philox noise and ELU."""
    global launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must fit in 64 unsigned bits, got {seed}")
    B, T, A = actions.shape
    D = init_deter.shape[-1]
    H = weights[0].shape[0]
    S = class_size * category_size
    w_shapes = weight_shapes(A, S, H, D, 0)[:N_WEIGHTS]
    expect = {"actions": (actions, (B, T, A)), "init_deter": (init_deter, (B, D)),
              "init_stoch": (init_stoch, (B, S))}
    for i, (w, shape) in enumerate(zip(weights, w_shapes)):
        expect[f"weights[{i}]"] = (w, shape)
    _check_inputs(expect, actions.device)
    out = [actions.new_empty((B, T, d)) for d in (D, S, S)]
    if T == 0 or B == 0:
        return out[0], out[1], out[2]
    lib = build.load_library()
    R = _rows_per_block(B, actions.device)
    ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(w.data_ptr() for w in weights))
    with torch.cuda.device(actions.device):
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mrssm_rollout(
            ctypes.cast(ptrs, ctypes.c_void_p),
            *(t.data_ptr() for t in (actions, init_deter, init_stoch)),
            *(o.data_ptr() for o in out),
            seed, T, B, A, H, D, class_size, category_size, R, stream,
        )
    build.check(err)
    launches += 1
    return out[0], out[1], out[2]

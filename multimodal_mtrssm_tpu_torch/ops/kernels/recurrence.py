"""Kernel 1: the MoPoE-MRSSM representation recurrence, forward (observe).

Replaces ``multimodal_mtrssm_tpu/ops/pallas/train_step.py::_fwd_kernel``
(line 244) and ``::_fwd_kernel_chunked`` (line 494). For t = 0..T-1 it runs
``_forward_step``: transition MLP(action ⊕ stoch) → GRU → prior MLP and its
straight-through sample, the audio and vision posterior MLPs on
deter ⊕ embed, the MoPoE fusion and the posterior straight-through sample,
whose value is the next step's stoch. The Gumbel noise is an input.

What bounds it on the card: the T steps are a dependent chain, and at the
reference batch (B=8) each step is a few thousand FMAs, so the time is the
latency of ~10 dependent stages per step, not FLOPs or bytes (the inputs and
outputs are ~0.4 MB at B=8 T=30). The design keeps the whole chain in one
launch: one block per tile of batch rows with the T loop inside it, the 20
weights (~68 KB) staged once into shared memory, the carry and every
activation in shared memory, and outputs written per step straight to
``[T, B, ·]`` in device memory, so no VMEM-style time chunking is needed.
Rows per block shrink with the batch so that small batches still spread over
several SMs. Plain f32 FMA loops: the products are far below a tensor-core
tile, and the reference is f32.

No backward yet: the wrapper refuses inputs that autograd would track.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import transition_step, two_layer
from multimodal_mtrssm_tpu_torch.ops.distributions import st_sample
from multimodal_mtrssm_tpu_torch.ops.fusion import mopoe_mix_log_probs

N_WEIGHTS = 20
# Kernel launches since the last reset (plain int; the serving path holds a
# device lock around every launch).
launches = 0


def recurrence_forward_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
    act: Callable[[torch.Tensor], torch.Tensor] = F.elu,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel (``train_step._forward_step`` for
    every t). Sequences are time-major ``[T, B, ·]``; ``weights`` are the 20
    tensors of ``MoPoEMRSSM.representation_weights`` in torch layout.

    Returns ``(deter, prior_logits, prior_stoch, mixed_logits, post_stoch)``,
    each ``[T, B, ·]``."""
    deter, stoch = init_deter, init_stoch
    outs: list[tuple[torch.Tensor, ...]] = []
    for t in range(actions.shape[0]):
        deter, prior_logits = transition_step(weights[:12], actions[t], stoch, deter, act)
        prior_stoch = st_sample(prior_logits, g_prior[t], class_size, category_size)
        a_logits = two_layer(torch.cat([deter, a_emb[t]], dim=-1), *weights[12:16], act)
        v_logits = two_layer(torch.cat([deter, v_emb[t]], dim=-1), *weights[16:20], act)
        mixed = mopoe_mix_log_probs(a_logits, v_logits)
        stoch = st_sample(mixed, g_post[t], class_size, category_size)
        outs.append((deter, prior_logits, prior_stoch, mixed, stoch))
    return tuple(torch.stack(seq) for seq in zip(*outs))


def _rows_per_block(batch: int, device: torch.device) -> int:
    """Batch rows per block: one block per SM where the batch allows it."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(32, -(-batch // sms)))


def recurrence_forward_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel (``csrc/recurrence_fwd.cu``); same contract as
    :func:`recurrence_forward_plain` with ELU. Raises on any input the kernel
    does not take."""
    global launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    T, B, A = actions.shape
    E = a_emb.shape[-1]
    D = init_deter.shape[-1]
    H = weights[0].shape[0]
    S = class_size * category_size
    expect = {
        "actions": (actions, (T, B, A)), "a_emb": (a_emb, (T, B, E)), "v_emb": (v_emb, (T, B, E)),
        "init_deter": (init_deter, (B, D)), "init_stoch": (init_stoch, (B, S)),
        "g_prior": (g_prior, (T, B, S)), "g_post": (g_post, (T, B, S)),
    }
    w_shapes = [(H, A + S), (H,), (H, H), (H,), (3 * D, H), (3 * D,), (3 * D, D), (3 * D,),
                (H, D), (H,), (S, H), (S,)] + [(H, D + E), (H,), (S, H), (S,)] * 2
    for i, (w, shape) in enumerate(zip(weights, w_shapes)):
        expect[f"weights[{i}]"] = (w, shape)
    _check_inputs(expect, actions.device)
    out = [actions.new_empty((T, B, d)) for d in (D, S, S, S, S)]
    if T == 0 or B == 0:
        return tuple(out)
    lib = build.load_library()
    R = _rows_per_block(B, actions.device)
    ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(w.data_ptr() for w in weights))
    with torch.cuda.device(actions.device):
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mrssm_recurrence_forward(
            ctypes.cast(ptrs, ctypes.c_void_p),
            *(t.data_ptr() for t in (actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post)),
            *(o.data_ptr() for o in out),
            T, B, A, E, H, D, class_size, category_size, R, stream,
        )
    build.check(err)
    launches += 1
    return tuple(out)


def _check_inputs(expect: dict[str, tuple[torch.Tensor, tuple[int, ...]]],
                  device: torch.device) -> None:
    """Device, dtype, shape, contiguity and autograd checks shared by both
    kernel wrappers."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")
    for name, (t, shape) in expect.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name} requires grad, but the kernel has no backward yet: "
                "call it under torch.no_grad()")

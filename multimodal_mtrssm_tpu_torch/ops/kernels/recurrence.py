"""Kernel 1: the MoPoE-MRSSM representation recurrence, forward and backward.

The forward replaces ``multimodal_mtrssm_tpu/ops/pallas/train_step.py::
_fwd_kernel`` (line 244) and ``::_fwd_kernel_chunked`` (line 494). For
t = 0..T-1 it runs ``_forward_step``: transition MLP(action ⊕ stoch) → GRU →
prior MLP and its straight-through sample, the audio and vision posterior
MLPs on deter ⊕ embed, the MoPoE fusion and the posterior straight-through
sample, whose value is the next step's stoch. The Gumbel noise is an input.

The backward replaces ``::_bwd_kernel`` (line 366) and
``::_bwd_kernel_chunked`` (line 530): BPTT in reverse time that recomputes
each step from the carries into it and applies ``_bwd_step``'s VJPs. The
gradient of a straight-through sample flows through the block softmax
only, so the backward needs no noise and no sample: a near-tie cannot
change it. :class:`RecurrenceFunction` joins the two under autograd, with
JAX's residuals (``train_step.py:686-690``: the inputs, ``deter`` and
``post_stoch``).

What bounds it on the card: the T steps are a dependent chain, and at the
reference batch (B=8) each step is a few thousand FMAs, so the time is the
latency of ~10 dependent stages per step (~25 in the backward), not FLOPs or
bytes (inputs and outputs are ~0.4 MB at B=8 T=30). The design keeps the
whole chain in one launch: one block per tile of batch rows with the T loop
inside it, the 20 weights (~68 KB) staged once into shared memory, the carry
and every activation in shared memory, and ``[T, B, ·]`` streamed straight
through device memory, so no VMEM-style time chunking is needed. The
backward keeps each block's weight gradients in shared memory too (another
~68 KB) and sums the blocks' partial sums in a second launch, in a fixed
order, so runs are reproducible. Plain f32 FMA loops: the products are far
below a tensor-core tile, and the reference is f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import Act, transition_step, two_layer
from multimodal_mtrssm_tpu_torch.ops.distributions import block_probs, st_sample
from multimodal_mtrssm_tpu_torch.ops.fusion import mopoe_mix_log_probs

N_WEIGHTS = 20
# Kernel launches since the last reset, forward and backward (plain ints).
launches = 0
bwd_launches = 0


def weight_shapes(A: int, S: int, H: int, D: int, E: int) -> list[tuple[int, ...]]:
    """Torch-layout shapes of the kernel's 20 weights, in kernel order (the
    first 12 are the transition's, the rollout kernel's weights)."""
    return ([(H, A + S), (H,), (H, H), (H,), (3 * D, H), (3 * D,), (3 * D, D), (3 * D,),
             (H, D), (H,), (S, H), (S,)] + [(H, D + E), (H,), (S, H), (S,)] * 2)


def recurrence_forward_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
    act: Act = F.elu,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the forward kernel (``train_step._forward_step``
    for every t). Sequences are time-major ``[T, B, ·]``; ``weights`` are the 20
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


def recurrence_backward_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
    gouts: Sequence[torch.Tensor], class_size: int, category_size: int, act: Act = F.elu,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernel: the VJP of the forward
    under the cotangents ``gouts`` of its five outputs.

    ``prev_deter[t]``/``prev_stoch[t]`` are the carries into step t (the
    initial state at t=0, the stored ``deter``/``post_stoch`` after). Not a
    copy of the hand-derived formulas: it replays the forward with autograd,
    chaining the deter recurrence from ``prev_deter[0]`` and teacher-forcing
    each posterior sample's value from the record
    (``stored.detach() + (p - p.detach())``), and takes ``autograd.grad``.

    Returns the 20 weight grads (torch layout), then ``d_actions``,
    ``d_a_emb``, ``d_v_emb`` ``[T, B, ·]``, ``d_init_deter`` and
    ``d_init_stoch`` ``[B, ·]``."""
    T, B = actions.shape[:2]
    if T == 0:
        return (*map(torch.zeros_like, (*weights, actions, a_emb, v_emb)),
                prev_deter.new_zeros(B, prev_deter.shape[-1]),
                prev_stoch.new_zeros(B, prev_stoch.shape[-1]))
    with torch.enable_grad():
        w = [x.detach().requires_grad_() for x in weights]
        xs = [x.detach().requires_grad_() for x in (actions, a_emb, v_emb)]
        deter = prev_deter[0].detach().requires_grad_()
        stoch = prev_stoch[0].detach().requires_grad_()
        leaves = [*w, *xs, deter, stoch]
        outputs: list[torch.Tensor] = []
        cots: list[torch.Tensor] = []
        for t in range(T):
            deter, prior_logits = transition_step(w[:12], xs[0][t], stoch, deter, act)
            a_logits = two_layer(torch.cat([deter, xs[1][t]], dim=-1), *w[12:16], act)
            v_logits = two_layer(torch.cat([deter, xs[2][t]], dim=-1), *w[16:20], act)
            mixed = mopoe_mix_log_probs(a_logits, v_logits)
            # A straight-through sample's gradient is its probs' gradient.
            post_p = block_probs(mixed, class_size, category_size)
            outputs += [deter, prior_logits, block_probs(prior_logits, class_size, category_size),
                        mixed, post_p]
            cots += [g[t] for g in gouts]
            if t + 1 < T:
                stoch = prev_stoch[t + 1].detach() + (post_p - post_p.detach())
        grads = torch.autograd.grad(outputs, leaves, cots, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves))


def _rows_per_block(batch: int, device: torch.device) -> int:
    """Batch rows per block: one block per SM where the batch allows it."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(32, -(-batch // sms)))


def recurrence_forward_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """Launch the forward kernel (``csrc/recurrence_fwd.cu``); same contract as
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
    for i, (w, shape) in enumerate(zip(weights, weight_shapes(A, S, H, D, E))):
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


def recurrence_backward_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
    gouts: Sequence[torch.Tensor], class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """Launch the backward kernel and its fixed-order reduction of the
    blocks' weight grads (``csrc/recurrence_bwd.cu``); same contract as
    :func:`recurrence_backward_plain` with ELU. Raises on any input the kernel
    does not take, and where a block's shared memory would not fit."""
    global bwd_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS or len(gouts) != 5:
        raise ValueError(f"expected {N_WEIGHTS} weights and 5 cotangents, "
                         f"got {len(weights)} and {len(gouts)}")
    T, B, A = actions.shape
    E = a_emb.shape[-1]
    D = prev_deter.shape[-1]
    H = weights[0].shape[0]
    S = class_size * category_size
    shapes = weight_shapes(A, S, H, D, E)
    expect = {
        "actions": (actions, (T, B, A)), "a_emb": (a_emb, (T, B, E)), "v_emb": (v_emb, (T, B, E)),
        "prev_deter": (prev_deter, (T, B, D)), "prev_stoch": (prev_stoch, (T, B, S)),
    }
    for i, (g, d) in enumerate(zip(gouts, (D, S, S, S, S))):
        expect[f"gouts[{i}]"] = (g, (T, B, d))
    for i, (w, shape) in enumerate(zip(weights, shapes)):
        expect[f"weights[{i}]"] = (w, shape)
    _check_inputs(expect, actions.device)
    sizes = [math.prod(s) for s in shapes]
    d_flat = actions.new_zeros(sum(sizes))
    d_ins = [actions.new_zeros(s) for s in ((T, B, A), (T, B, E), (T, B, E), (B, D), (B, S))]
    d_w = [g.view(s) for g, s in zip(d_flat.split(sizes), shapes)]
    if T == 0 or B == 0:
        return (*d_w, *d_ins)
    lib = build.load_library()
    ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(w.data_ptr() for w in weights))
    with torch.cuda.device(actions.device):
        R = lib.mrssm_recurrence_bwd_rows(A, E, H, D, class_size, category_size,
                                          _rows_per_block(B, actions.device))
        if R < 1:
            raise ValueError(
                f"the backward kernel's shared memory does not fit one block at A={A} "
                f"E={E} H={H} D={D} S={S}")
        partial = actions.new_empty((-(-B // R), sum(sizes)))
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mrssm_recurrence_backward(
            ctypes.cast(ptrs, ctypes.c_void_p),
            *(t.data_ptr() for t in (actions, a_emb, v_emb, prev_deter, prev_stoch, *gouts)),
            partial.data_ptr(), d_flat.data_ptr(), *(o.data_ptr() for o in d_ins),
            T, B, A, E, H, D, class_size, category_size, R, stream,
        )
    build.check(err)
    bwd_launches += 1
    return (*d_w, *d_ins)


class RecurrenceFunction(torch.autograd.Function):
    """The recurrence under autograd: the forward kernel, and the backward
    kernel as its VJP, with the 20 weights as separate inputs so that their
    gradients reach the ``nn.Parameter``s. ``act`` is None for the CUDA
    kernels and the activation for the plain versions (CPU tensors), so the
    CPU runs the same wiring as the card."""

    @staticmethod
    def forward(ctx, act: Act | None, class_size: int, category_size: int,
                actions: torch.Tensor, a_emb: torch.Tensor, v_emb: torch.Tensor,
                init_deter: torch.Tensor, init_stoch: torch.Tensor, g_prior: torch.Tensor,
                g_post: torch.Tensor, *weights: torch.Tensor) -> tuple[torch.Tensor, ...]:
        args = (weights, actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post,
                class_size, category_size)
        if act is None:
            outs = recurrence_forward_cuda(*args)
        else:
            outs = recurrence_forward_plain(*args, act=act)
        ctx.act, ctx.sizes = act, (class_size, category_size)
        ctx.save_for_backward(actions, a_emb, v_emb, init_deter, init_stoch, outs[0], outs[4],
                              *weights)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gouts: torch.Tensor | None):
        actions, a_emb, v_emb, init_deter, init_stoch, deter, post_stoch, *weights = \
            ctx.saved_tensors
        gouts = tuple(torch.zeros_like(deter if i == 0 else post_stoch) if g is None
                      else g.contiguous() for i, g in enumerate(gouts))
        # prev_*[t] = the carry into step t, shifted once here so the kernel's
        # loop body has no t == 0 branch (train_step.py:447-448).
        prev_deter = torch.cat([init_deter[None], deter[:-1]])
        prev_stoch = torch.cat([init_stoch[None], post_stoch[:-1]])
        args = (weights, actions, a_emb, v_emb, prev_deter, prev_stoch, gouts, *ctx.sizes)
        if ctx.act is None:
            grads = recurrence_backward_cuda(*args)
        else:
            grads = recurrence_backward_plain(*args, act=ctx.act)
        return (None, None, None, *grads[N_WEIGHTS:], None, None, *grads[:N_WEIGHTS])


def _check_inputs(expect: dict[str, tuple[torch.Tensor, tuple[int, ...]]],
                  device: torch.device) -> None:
    """Device, dtype, shape, contiguity and autograd checks shared by the
    kernel wrappers. A wrapper is not differentiable by itself, so it refuses
    inputs that autograd would track; :class:`RecurrenceFunction` calls the
    recurrence wrappers where autograd is off."""
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
                f"{name} requires grad, but the kernel wrapper is not differentiable: "
                "call it under torch.no_grad() or through ops.kernels.fused_train_recurrence")

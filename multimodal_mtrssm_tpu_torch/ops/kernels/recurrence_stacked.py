"""Kernel 7: the MoPoE-MRSSM representation recurrence on stacked weights.

Port of ``multimodal_mtrssm_tpu/ops/pallas/train_step_stacked.py``. The
recurrence of :mod:`.recurrence` with its weights folded into 10 stacked
tensors, so that a step runs 5 products instead of 10: the GRU's input and
hidden gates as one ``[x2 | deter] @ wg`` (block-diagonal ``wg``), the three
heads' first layers as one ``[deter | a_emb | v_emb] @ wc1`` and their
second layers as one ``hc @ wc2`` (block-diagonal ``wc2``). A zero block
adds exact zeros, so the values equal the unstacked recurrence's.

The contract is ``train_step_stacked.fused_train_recurrence_stacked``'s
(``:352-403``): the packed 20 tensors in, the same five ``[T, B, ·]``
outputs, gradients back in the 20-tensor layout. Stacking happens once per
call, outside the kernels (:func:`stack_train_params`); the backward
returns gradients of the stacked tensors and :func:`unstack_train_grads`
slices the zero blocks away.

Layout. JAX stacks ``[in, out]`` matrices; the port keeps torch's Linear
layout ``[out, in]``, so every stacked matrix here is the transpose of
JAX's: ``wg`` is ``[6D, H+D]`` (rows ``gi | gh``, columns ``x2 | deter``),
``wc1`` is ``[3H, D+2E]`` (rows prior | audio | vision, columns
``deter | a_emb | v_emb``) and ``wc2`` is ``[3S, 3H]``.

The kernels (``csrc/recurrence_stacked_{fwd,bwd}.cu``) replace
``_fwd_kernel_stacked`` (line 164) and ``_bwd_kernel_stacked`` (line 190).
Neither gains from the fold on the card: a chain's phase count is set by the
carries' dataflow, and a phase costs the same whatever the length of its
dots. So each is :mod:`.recurrence`'s kernels run on the stacked tensors'
non-zero blocks packed into the 20-tensor layout (``csrc/stack_map.cuh``):
the forward is the pack then :mod:`.recurrence`'s three-stage forward kernel,
its outputs those of the unstacked forward bit for bit; the backward is the
pack, :mod:`.recurrence`'s three passes (a recompute of all T·B row-steps,
the carry-only chain, the deferred GEMMs), and the 20 gradients scattered
into the non-zero blocks of the stacked gradients
(:func:`recurrence_stacked_backward_passes_plain` is that composition in
plain PyTorch).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import Act
from multimodal_mtrssm_tpu_torch.ops.distributions import block_probs, st_sample
from multimodal_mtrssm_tpu_torch.ops.fusion import mopoe_mix_log_probs
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import (
    N_WEIGHTS,
    _check_categories,
    _check_inputs,
    _forward_expect,
    chain_rows,
    fwd_rows,
    recurrence_backward_passes_plain,
)

N_STACKED = 10
# Kernel launches since the last reset, forward and backward (plain ints; a
# backward call counts once for its kernels).
launches = 0
bwd_launches = 0


def stacked_shapes(A: int, S: int, H: int, D: int, E: int) -> list[tuple[int, ...]]:
    """Torch-layout shapes of the 10 stacked tensors, in kernel order:
    w1, b1, w2, b2 (unchanged), wg, bg, wc1, bc1, wc2, bc2."""
    return [(H, A + S), (H,), (H, H), (H,), (6 * D, H + D), (6 * D,), (3 * H, D + 2 * E),
            (3 * H,), (3 * S, 3 * H), (3 * S,)]


def stack_train_params(weights: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """Fold the recurrence's 20 tensors (``MoPoEMRSSM.representation_weights``,
    torch layout) into the 10 stacked ones; each stacked matrix is the
    transpose of ``train_step_stacked.stack_train_params``'s."""
    (w1, b1, w2, b2, wih, bih, whh, bhh, wp1, bp1, wp2, bp2,
     wa1, ba1, wa2, ba2, wv1, bv1, wv2, bv2) = weights
    H, D = w2.shape[0], whh.shape[1]
    E = wa1.shape[1] - D
    zeros = lambda r, c: w1.new_zeros(r, c)  # noqa: E731
    wg = torch.cat([torch.cat([wih, zeros(3 * D, D)], 1),
                    torch.cat([zeros(3 * D, H), whh], 1)], 0)
    wc1 = torch.cat([torch.cat([wp1, zeros(H, 2 * E)], 1),
                     torch.cat([wa1, zeros(H, E)], 1),
                     torch.cat([wv1[:, :D], zeros(H, E), wv1[:, D:]], 1)], 0)
    return (w1, b1, w2, b2, wg, torch.cat([bih, bhh]), wc1, torch.cat([bp1, ba1, bv1]),
            torch.block_diag(wp2, wa2, wv2), torch.cat([bp2, ba2, bv2]))


def unstack_train_grads(d_stacked: Sequence[torch.Tensor],
                        dims: tuple[int, int, int, int]) -> tuple[torch.Tensor, ...]:
    """Slice the 10 stacked gradients (torch layout) back into the 20-tensor
    layout; ``dims`` is ``(A, H, D, E)``. The zero blocks are dropped."""
    d_w1, d_b1, d_w2, d_b2, d_wg, d_bg, d_wc1, d_bc1, d_wc2, d_bc2 = d_stacked
    _, H, D, E = dims
    S = d_wc2.shape[0] // 3
    G = 3 * D
    d_wv1 = torch.cat([d_wc1[2 * H:, :D], d_wc1[2 * H:, D + E:]], 1)
    return (d_w1, d_b1, d_w2, d_b2, d_wg[:G, :H], d_bg[:G], d_wg[G:, H:], d_bg[G:],
            d_wc1[:H, :D], d_bc1[:H], d_wc2[:S, :H], d_bc2[:S],
            d_wc1[H:2 * H, :D + E], d_bc1[H:2 * H], d_wc2[S:2 * S, H:2 * H], d_bc2[S:2 * S],
            d_wv1, d_bc1[2 * H:], d_wc2[2 * S:, 2 * H:], d_bc2[2 * S:])


def stacked_step(stacked: Sequence[torch.Tensor], action: torch.Tensor, a_emb: torch.Tensor,
                 v_emb: torch.Tensor, deter: torch.Tensor, stoch: torch.Tensor,
                 act: Act) -> tuple[torch.Tensor, ...]:
    """One step's five products on the stacked tensors
    (``train_step_stacked._forward_step_stacked``): returns ``(deter,
    prior_logits, audio_logits, vision_logits)``."""
    w1, b1, w2, b2, wg, bg, wc1, bc1, wc2, bc2 = stacked
    D = deter.shape[-1]
    S = wc2.shape[0] // 3
    x2 = F.linear(act(F.linear(torch.cat([action, stoch], -1), w1, b1)), w2, b2)
    gg = F.linear(torch.cat([x2, deter], -1), wg, bg)
    i_r, i_z, i_n, h_r, h_z, h_n = gg.split(D, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    deter = (1.0 - z) * n + z * deter
    logits = F.linear(act(F.linear(torch.cat([deter, a_emb, v_emb], -1), wc1, bc1)), wc2, bc2)
    return deter, logits[:, :S], logits[:, S:2 * S], logits[:, 2 * S:]


def recurrence_stacked_forward_plain(
    stacked: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
    act: Act = F.elu,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the stacked forward kernel over time-major
    ``[T, B, ·]`` inputs. Returns ``(deter, prior_logits, prior_stoch,
    mixed_logits, post_stoch)``, each ``[T, B, ·]``."""
    deter, stoch = init_deter, init_stoch
    outs: list[tuple[torch.Tensor, ...]] = []
    for t in range(actions.shape[0]):
        deter, prior_logits, a_logits, v_logits = stacked_step(
            stacked, actions[t], a_emb[t], v_emb[t], deter, stoch, act)
        prior_stoch = st_sample(prior_logits, g_prior[t], class_size, category_size)
        mixed = mopoe_mix_log_probs(a_logits, v_logits)
        stoch = st_sample(mixed, g_post[t], class_size, category_size)
        outs.append((deter, prior_logits, prior_stoch, mixed, stoch))
    return tuple(torch.stack(seq) for seq in zip(*outs))


def recurrence_stacked_backward_plain(
    stacked: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
    gouts: Sequence[torch.Tensor], class_size: int, category_size: int, act: Act = F.elu,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the stacked backward kernel: the VJP of the
    stacked forward under the cotangents ``gouts``, by an autograd replay
    teacher-forced on the recorded samples (as
    :func:`.recurrence.recurrence_backward_plain`), not a copy of the hand
    VJP. ``prev_*[t]`` are the carries into step t.

    Returns the 10 stacked gradients (the zero blocks hold their true
    gradient, which :func:`unstack_train_grads` drops), then ``d_actions``,
    ``d_a_emb``, ``d_v_emb``, ``d_init_deter`` and ``d_init_stoch``."""
    T, B = actions.shape[:2]
    if T == 0:
        return (*map(torch.zeros_like, (*stacked, actions, a_emb, v_emb)),
                prev_deter.new_zeros(B, prev_deter.shape[-1]),
                prev_stoch.new_zeros(B, prev_stoch.shape[-1]))
    with torch.enable_grad():
        w = [x.detach().requires_grad_() for x in stacked]
        xs = [x.detach().requires_grad_() for x in (actions, a_emb, v_emb)]
        deter = prev_deter[0].detach().requires_grad_()
        stoch = prev_stoch[0].detach().requires_grad_()
        leaves = [*w, *xs, deter, stoch]
        outputs: list[torch.Tensor] = []
        cots: list[torch.Tensor] = []
        for t in range(T):
            deter, prior_logits, a_logits, v_logits = stacked_step(
                w, xs[0][t], xs[1][t], xs[2][t], deter, stoch, act)
            mixed = mopoe_mix_log_probs(a_logits, v_logits)
            post_p = block_probs(mixed, class_size, category_size)
            outputs += [deter, prior_logits, block_probs(prior_logits, class_size, category_size),
                        mixed, post_p]
            cots += [g[t] for g in gouts]
            if t + 1 < T:
                stoch = prev_stoch[t + 1].detach() + (post_p - post_p.detach())
        grads = torch.autograd.grad(outputs, leaves, cots, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves))


def recurrence_stacked_backward_passes_plain(
    stacked: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
    gouts: Sequence[torch.Tensor], class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """The stacked backward as the kernels compose it (ELU): the non-zero
    blocks of ``stacked`` as the 20 tensors (the pack), :mod:`.recurrence`'s
    three plain passes on them, the 20 gradients into the non-zero blocks of
    the stacked gradients (the scatter; the zero blocks hold 0). Returns
    :func:`recurrence_stacked_backward_cuda`'s 15 tensors."""
    dims = (actions.shape[-1], *_dims(stacked, a_emb, prev_deter))
    packed = [w.contiguous() for w in unstack_train_grads(stacked, dims)]
    grads = recurrence_backward_passes_plain(packed, actions, a_emb, v_emb, prev_deter,
                                             prev_stoch, gouts, class_size, category_size)
    return (*stack_train_params(grads[:N_WEIGHTS]), *grads[N_WEIGHTS:])


def _dims(stacked: Sequence[torch.Tensor], a_emb: torch.Tensor,
          deter: torch.Tensor) -> tuple[int, int, int]:
    """``(H, D, E)`` read off the stacked weights and the inputs."""
    return stacked[2].shape[0], deter.shape[-1], a_emb.shape[-1]


def recurrence_stacked_forward_cuda(
    stacked: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """Launch the stacked forward (``csrc/recurrence_stacked_fwd.cu``: the
    pack, then :mod:`.recurrence`'s forward kernel on the packed weights);
    same contract as :func:`recurrence_stacked_forward_plain` with ELU, its
    outputs :func:`.recurrence.recurrence_forward_cuda`'s on the unstacked
    weights bit for bit. Raises on any input the kernels do not take, and
    where a block's shared memory would not fit."""
    global launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(stacked) != N_STACKED:
        raise ValueError(f"expected {N_STACKED} stacked weights, got {len(stacked)}")
    _check_categories(category_size)
    T, B, A = actions.shape
    H, D, E = _dims(stacked, a_emb, init_deter)
    S = class_size * category_size
    expect = _forward_expect(actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post, S)
    for i, (w, shape) in enumerate(zip(stacked, stacked_shapes(A, S, H, D, E))):
        expect[f"stacked[{i}]"] = (w, shape)
    _check_inputs(expect, actions.device)
    out = [actions.new_empty((T, B, d)) for d in (D, S, S, S, S)]
    if T == 0 or B == 0:
        return tuple(out)
    lib = build.load_library()
    ptrs = (ctypes.c_void_p * N_STACKED)(*(w.data_ptr() for w in stacked))
    with torch.cuda.device(actions.device):
        R = fwd_rows(lib, T, A, E, H, D, class_size, category_size, B, actions.device)
        workspace = actions.new_empty(
            lib.mrssm_stacked_fwd_workspace(T, B, A, E, H, D, class_size, category_size))
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mrssm_stacked_forward(
            ctypes.cast(ptrs, ctypes.c_void_p),
            *(t.data_ptr() for t in (actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post)),
            *(o.data_ptr() for o in out), workspace.data_ptr(),
            T, B, A, E, H, D, class_size, category_size, R, stream,
        )
    build.check(err)
    launches += 1
    return tuple(out)


def recurrence_stacked_backward_cuda(
    stacked: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
    gouts: Sequence[torch.Tensor], class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """Launch the stacked backward (``csrc/recurrence_stacked_bwd.cu``: the
    pack, :mod:`.recurrence`'s recompute, chain and deferred GEMMs, the
    scatter); same contract as :func:`recurrence_stacked_backward_plain` with
    ELU, except that the zero blocks of the stacked gradients hold zeros
    (they are sliced away), as :func:`recurrence_stacked_backward_passes_plain`.
    Raises on any input the kernels do not take, and where a chain block's
    shared memory would not fit."""
    global bwd_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(stacked) != N_STACKED or len(gouts) != 5:
        raise ValueError(f"expected {N_STACKED} stacked weights and 5 cotangents, "
                         f"got {len(stacked)} and {len(gouts)}")
    T, B, A = actions.shape
    H, D, E = _dims(stacked, a_emb, prev_deter)
    S = class_size * category_size
    shapes = stacked_shapes(A, S, H, D, E)
    expect = {
        "actions": (actions, (T, B, A)), "a_emb": (a_emb, (T, B, E)), "v_emb": (v_emb, (T, B, E)),
        "prev_deter": (prev_deter, (T, B, D)), "prev_stoch": (prev_stoch, (T, B, S)),
    }
    for i, (g, d) in enumerate(zip(gouts, (D, S, S, S, S))):
        expect[f"gouts[{i}]"] = (g, (T, B, d))
    for i, (w, shape) in enumerate(zip(stacked, shapes)):
        expect[f"stacked[{i}]"] = (w, shape)
    _check_inputs(expect, actions.device)
    empty = T == 0 or B == 0
    sizes = [math.prod(s) for s in shapes]
    d_flat = actions.new_zeros(sum(sizes))  # the scatter leaves the zero blocks as they are
    alloc = actions.new_zeros if empty else actions.new_empty
    d_ins = [alloc(s) for s in ((T, B, A), (T, B, E), (T, B, E), (B, D), (B, S))]
    d_w = [g.view(s) for g, s in zip(d_flat.split(sizes), shapes)]
    if empty:
        return (*d_w, *d_ins)
    lib = build.load_library()
    ptrs = (ctypes.c_void_p * N_STACKED)(*(w.data_ptr() for w in stacked))
    with torch.cuda.device(actions.device):
        R = chain_rows(lib, A, E, H, D, class_size, category_size, B, actions.device)
        workspace = actions.new_empty(
            lib.mrssm_stacked_bwd_workspace(T, B, A, E, H, D, class_size, category_size))
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mrssm_stacked_backward(
            ctypes.cast(ptrs, ctypes.c_void_p),
            *(t.data_ptr() for t in (actions, a_emb, v_emb, prev_deter, prev_stoch, *gouts)),
            workspace.data_ptr(), d_flat.data_ptr(), *(o.data_ptr() for o in d_ins),
            T, B, A, E, H, D, class_size, category_size, R, stream,
        )
    build.check(err)
    bwd_launches += 1
    return (*d_w, *d_ins)


class RecurrenceStackedFunction(torch.autograd.Function):
    """The stacked recurrence under autograd, with the contract of
    :class:`.recurrence.RecurrenceFunction`: the 20 unstacked weights in, the
    five outputs, gradients for the 20. The forward stacks them once;
    the backward runs the stacked backward (kernel, or its plain version for
    CPU tensors, ``act`` not None) and unstacks its gradients."""

    @staticmethod
    def forward(ctx, act: Act | None, class_size: int, category_size: int,
                actions: torch.Tensor, a_emb: torch.Tensor, v_emb: torch.Tensor,
                init_deter: torch.Tensor, init_stoch: torch.Tensor, g_prior: torch.Tensor,
                g_post: torch.Tensor, *weights: torch.Tensor) -> tuple[torch.Tensor, ...]:
        if len(weights) != N_WEIGHTS:
            raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
        stacked = stack_train_params(weights)
        args = (stacked, actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post,
                class_size, category_size)
        if act is None:
            outs = recurrence_stacked_forward_cuda(*args)
        else:
            outs = recurrence_stacked_forward_plain(*args, act=act)
        ctx.act, ctx.sizes, ctx.stacked = act, (class_size, category_size), stacked
        ctx.dims = (actions.shape[-1], weights[2].shape[0], init_deter.shape[-1], a_emb.shape[-1])
        ctx.save_for_backward(actions, a_emb, v_emb, init_deter, init_stoch, outs[0], outs[4])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gouts: torch.Tensor | None):
        actions, a_emb, v_emb, init_deter, init_stoch, deter, post_stoch = ctx.saved_tensors
        gouts = tuple(torch.zeros_like(deter if i == 0 else post_stoch) if g is None
                      else g.contiguous() for i, g in enumerate(gouts))
        prev_deter = torch.cat([init_deter[None], deter[:-1]])
        prev_stoch = torch.cat([init_stoch[None], post_stoch[:-1]])
        args = (ctx.stacked, actions, a_emb, v_emb, prev_deter, prev_stoch, gouts, *ctx.sizes)
        if ctx.act is None:
            grads = recurrence_stacked_backward_cuda(*args)
        else:
            grads = recurrence_stacked_backward_plain(*args, act=ctx.act)
        d_w = unstack_train_grads(grads[:N_STACKED], ctx.dims)
        return (None, None, None, *grads[N_STACKED:], None, None, *d_w)

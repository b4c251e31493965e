"""Kernels 4 and 5: the MoPoE-MMTRSSM hierarchical recurrence, forward and backward.

The forward replaces ``multimodal_mtrssm_tpu/ops/pallas/train_step_mt.py::
_fwd_kernel`` (line 142) and ``::_fwd_kernel_chunked`` (line 417). For
t = 0..T-1 it runs ``_mt_forward_step``: the lower MTRNN on
``cat(action, ls, hs)`` of the previous posterior samples (the cross-layer
edge), the l-prior and its straight-through sample, the audio and vision
heads on ``l_deter ⊕ embed``, the MoPoE fusion and the lower posterior
sample; the higher MTRNN on the previous ``hs``, the h-prior and its
sample, and the h-posterior on ``l_deter ⊕ h_deter`` and its sample. The
four Gumbel streams are inputs.

The backward replaces ``::_bwd_kernel`` (line 280) and
``::_bwd_kernel_chunked`` (line 454): BPTT in reverse time that recomputes
each step from the carries into it and applies ``_mt_bwd_step``'s VJPs. A
straight-through sample's gradient flows through its block softmax only,
so the backward takes no noise and no sample. :class:`MTRecurrenceFunction`
joins the two under autograd with JAX's residuals (``train_step_mt.py:
612-617``: the inputs, ``init6`` and the six carry sequences).

What bounds it on the card: as for the MRSSM recurrence, the latency of a
chain of small dependent stages (~10 a step forward, ~30 backward) at the
reference batch, not FLOPs or bytes. The design is the MRSSM kernels': one
block per tile of batch rows with the T loop inside, the 28 weights
(16,944 floats, 67.8 KB) staged once in shared memory, ``[T, B, ·]``
streamed through device memory (so one kernel covers the TPU's
single-block and time-chunked variants), and in the backward each block's
own weight-gradient copy beside the weights, summed over blocks in a fixed
order by a second launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import Act, mtrnn_step, two_layer
from multimodal_mtrssm_tpu_torch.ops.distributions import block_probs, st_sample
from multimodal_mtrssm_tpu_torch.ops.fusion import mopoe_mix_log_probs
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import _check_inputs, _rows_per_block

N_WEIGHTS = 28
N_OUT = 12
# Kernel launches since the last reset, forward and backward (plain ints).
launches = 0
bwd_launches = 0


class MTSpec(NamedTuple):
    """The hierarchy's static sizes: both time constants and both latents'
    ``class × category`` blocks (``MMTRSSMConfig`` defaults)."""

    l_tau: float = 2.0
    h_tau: float = 4.0
    ls_class: int = 4
    ls_category: int = 4
    hs_class: int = 2
    hs_category: int = 8

    @property
    def ls(self) -> int:
        """Flat width of the lower latent."""
        return self.ls_class * self.ls_category

    @property
    def hs(self) -> int:
        """Flat width of the higher latent."""
        return self.hs_class * self.hs_category


# The reference config's sizes, the default of every MT kernel function.
MT_SPEC = MTSpec()


def mt_weight_shapes(A: int, E: int, HD: int, LD: int, C: int, R: int,
                     spec: MTSpec) -> list[tuple[int, ...]]:
    """Torch-layout shapes of the kernel's 28 weights, in the order of
    ``train_step_mt.pack_mt_train_params``: the lower and higher MTRNN
    (d2h, input2h), the l-prior, h-prior and h-posterior MLPs (width ``C``),
    the audio and vision heads (width ``R``). The first 16 are the rollout
    kernel's."""
    LS, HS = spec.ls, spec.hs
    return [(LD, LD), (LD,), (LD, A + LS + HS), (LD,), (HD, HD), (HD,), (HD, HS), (HD,),
            (C, LD), (C,), (LS, C), (LS,), (C, HD), (C,), (HS, C), (HS,),
            (C, LD + HD), (C,), (HS, C), (HS,),
            (R, LD + E), (R,), (LS, R), (LS,), (R, LD + E), (R,), (LS, R), (LS,)]


def mt_out_dims(HD: int, LD: int, spec: MTSpec) -> tuple[int, ...]:
    """Widths of the 12 outputs: ``h_deter, l_deter, hid_h, hid_l,
    l_prior_logits, l_prior_stoch, mixed, l_stoch, h_prior_logits,
    h_prior_stoch, h_post_logits, h_stoch``."""
    LS, HS = spec.ls, spec.hs
    return (HD, LD, HD, LD, LS, LS, LS, LS, HS, HS, HS, HS)


def carries(outs: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """The six carries among the 12 outputs of a step (or the carry
    sequences among the 12 ``[T, B, ·]`` outputs): ``(h_deter, l_deter,
    h_stoch, l_stoch, hid_h, hid_l)``, the order of ``init6``."""
    return outs[0], outs[1], outs[11], outs[7], outs[2], outs[3]


Sampler = Callable[[torch.Tensor, int, int, int], torch.Tensor]


def _mt_step(w: Sequence[torch.Tensor], action: torch.Tensor, a_emb: torch.Tensor,
             v_emb: torch.Tensor, carry: Sequence[torch.Tensor], sample: Sampler,
             spec: MTSpec, act: Act) -> tuple[torch.Tensor, ...]:
    """One hierarchical step (``train_step_mt._mt_forward_step``) on the 28
    weights; ``sample(logits, site, class, category)`` draws the four
    sites (0 l-prior, 1 l-posterior, 2 h-prior, 3 h-posterior). Returns the
    12 outputs."""
    hd0, ld0, hs0, ls0, hidh0, hidl0 = carry
    lc, lk, hc, hk = spec.ls_class, spec.ls_category, spec.hs_class, spec.hs_category
    l_deter, hid_l = mtrnn_step(w[0:4], torch.cat([action, ls0, hs0], -1), ld0, hidl0,
                                spec.l_tau)
    lp_logits = two_layer(l_deter, *w[8:12], act)
    a_logits = two_layer(torch.cat([l_deter, a_emb], -1), *w[20:24], act)
    v_logits = two_layer(torch.cat([l_deter, v_emb], -1), *w[24:28], act)
    mixed = mopoe_mix_log_probs(a_logits, v_logits)
    h_deter, hid_h = mtrnn_step(w[4:8], hs0, hd0, hidh0, spec.h_tau)
    hp_logits = two_layer(h_deter, *w[12:16], act)
    hq_logits = two_layer(torch.cat([l_deter, h_deter], -1), *w[16:20], act)
    return (h_deter, l_deter, hid_h, hid_l,
            lp_logits, sample(lp_logits, 0, lc, lk), mixed, sample(mixed, 1, lc, lk),
            hp_logits, sample(hp_logits, 2, hc, hk), hq_logits, sample(hq_logits, 3, hc, hk))


def mt_recurrence_forward_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init6: Sequence[torch.Tensor], gumbels: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC, act: Act = F.elu,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the forward kernel (``_mt_forward_step`` for
    every t). Sequences are time-major ``[T, B, ·]``; ``init6`` is
    ``(h_deter, l_deter, h_stoch, l_stoch, hid_h, hid_l)`` ``[B, ·]``;
    ``gumbels`` the four sites' noise (l-prior, l-posterior, h-prior,
    h-posterior). Returns the 12 outputs, each ``[T, B, ·]``."""
    T, B = actions.shape[:2]
    if T == 0:
        dims = mt_out_dims(init6[0].shape[-1], init6[1].shape[-1], spec)
        return tuple(actions.new_empty((0, B, d)) for d in dims)
    carry = tuple(init6)
    outs = []
    for t in range(T):
        def sample(logits, site, c, k, t=t):
            return st_sample(logits, gumbels[site][t], c, k)
        step = _mt_step(weights, actions[t], a_emb[t], v_emb[t], carry, sample, spec, act)
        outs.append(step)
        carry = carries(step)
    return tuple(torch.stack(seq) for seq in zip(*outs))


def mt_recurrence_backward_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev6: Sequence[torch.Tensor], gouts: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC, act: Act = F.elu,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernel: the VJP of the forward
    under the cotangents ``gouts`` of its 12 outputs.

    ``prev6[i][t]`` is carry i into step t (``init6`` at t=0, the stored
    sequence after). Not a copy of the hand-derived formulas: it replays the
    forward with autograd, chaining the deter and integrator carries from
    ``prev6[·][0]`` and teacher-forcing each posterior sample's value from the
    record (``stored.detach() + (p - p.detach())``); a sample's output is its
    block softmax, which has the straight-through sample's gradient.

    Returns the 28 weight grads (torch layout), then ``d_actions``,
    ``d_a_emb``, ``d_v_emb`` ``[T, B, ·]`` and the six ``d_init6`` ``[B, ·]``."""
    T, B = actions.shape[:2]
    if T == 0:
        return (*map(torch.zeros_like, (*weights, actions, a_emb, v_emb)),
                *(p.new_zeros(B, p.shape[-1]) for p in prev6))

    def probs(logits, site, c, k):
        return block_probs(logits, c, k)

    with torch.enable_grad():
        w = [x.detach().requires_grad_() for x in weights]
        xs = [x.detach().requires_grad_() for x in (actions, a_emb, v_emb)]
        init = [p[0].detach().requires_grad_() for p in prev6]
        leaves = [*w, *xs, *init]
        carry = tuple(init)
        outputs: list[torch.Tensor] = []
        cots: list[torch.Tensor] = []
        for t in range(T):
            step = _mt_step(w, xs[0][t], xs[1][t], xs[2][t], carry, probs, spec, act)
            outputs += step
            cots += [g[t] for g in gouts]
            if t + 1 < T:
                hd, ld, hs_p, ls_p, hidh, hidl = carries(step)
                hs = prev6[2][t + 1].detach() + (hs_p - hs_p.detach())
                ls = prev6[3][t + 1].detach() + (ls_p - ls_p.detach())
                carry = (hd, ld, hs, ls, hidh, hidl)
        grads = torch.autograd.grad(outputs, leaves, cots, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves))


def _dims(T: int, B: int, A: int, E: int, HD: int, LD: int, C: int, R: int, spec: MTSpec,
          rows: int):
    """The kernels' ``MTDims`` struct (``csrc/mrssm_common.cuh``)."""
    from multimodal_mtrssm_tpu_torch.ops.kernels.build import MTDims

    return MTDims(T, B, A, E, HD, LD, C, R, spec.ls_class, spec.ls_category, spec.hs_class,
                  spec.hs_category, rows, 1.0 / spec.l_tau, 1.0 - 1.0 / spec.l_tau,
                  1.0 / spec.h_tau, 1.0 - 1.0 / spec.h_tau)


def _ptrs(tensors: Sequence[torch.Tensor]) -> ctypes.Array:
    """A host array of the tensors' device pointers (passed as ``void*``;
    the caller's expression keeps it alive for the call)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check_spec(spec: MTSpec) -> None:
    if spec.l_tau <= 1.0 or spec.h_tau <= 1.0:
        raise ValueError("tau must be greater than 1.0")
    if max(spec.ls_category, spec.hs_category) > 32:
        raise ValueError("the kernels take category blocks of at most 32")


def _expect_weights(expect: dict, weights: Sequence[torch.Tensor],
                    shapes: Sequence[tuple[int, ...]]) -> None:
    for i, (w, shape) in enumerate(zip(weights, shapes)):
        expect[f"weights[{i}]"] = (w, shape)


def mt_recurrence_forward_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init6: Sequence[torch.Tensor], gumbels: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """Launch the forward kernel (``csrc/recurrence_mt_fwd.cu``); same
    contract as :func:`mt_recurrence_forward_plain` with ELU. Raises on any
    input the kernel does not take."""
    global launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS or len(init6) != 6 or len(gumbels) != 4:
        raise ValueError(f"expected {N_WEIGHTS} weights, 6 initial carries and 4 noise "
                         f"tensors, got {len(weights)}, {len(init6)} and {len(gumbels)}")
    _check_spec(spec)
    T, B, A = actions.shape
    E = a_emb.shape[-1]
    HD, LD = weights[4].shape[0], weights[0].shape[0]
    C, R = weights[8].shape[0], weights[20].shape[0]
    LS, HS = spec.ls, spec.hs
    expect = {"actions": (actions, (T, B, A)), "a_emb": (a_emb, (T, B, E)),
              "v_emb": (v_emb, (T, B, E))}
    for i, (x, d) in enumerate(zip(init6, (HD, LD, HS, LS, HD, LD))):
        expect[f"init6[{i}]"] = (x, (B, d))
    for i, (g, d) in enumerate(zip(gumbels, (LS, LS, HS, HS))):
        expect[f"gumbels[{i}]"] = (g, (T, B, d))
    _expect_weights(expect, weights, mt_weight_shapes(A, E, HD, LD, C, R, spec))
    _check_inputs(expect, actions.device)
    out = [actions.new_empty((T, B, d)) for d in mt_out_dims(HD, LD, spec)]
    if T == 0 or B == 0:
        return tuple(out)
    lib = build.load_library()
    dims = _dims(T, B, A, E, HD, LD, C, R, spec, _rows_per_block(B, actions.device))
    with torch.cuda.device(actions.device):
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mt_recurrence_forward(_ptrs(weights),
                                        _ptrs([actions, a_emb, v_emb, *init6, *gumbels]),
                                        _ptrs(out), dims, stream)
    build.check(err)
    launches += 1
    return tuple(out)


def mt_recurrence_backward_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev6: Sequence[torch.Tensor], gouts: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """Launch the backward kernel and its fixed-order reduction of the
    blocks' weight grads (``csrc/recurrence_mt_bwd.cu``); same contract as
    :func:`mt_recurrence_backward_plain` with ELU. Raises on any input the
    kernel does not take, and where one row's shared memory would not fit."""
    global bwd_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS or len(prev6) != 6 or len(gouts) != N_OUT:
        raise ValueError(f"expected {N_WEIGHTS} weights, 6 carry sequences and {N_OUT} "
                         f"cotangents, got {len(weights)}, {len(prev6)} and {len(gouts)}")
    _check_spec(spec)
    T, B, A = actions.shape
    E = a_emb.shape[-1]
    HD, LD = weights[4].shape[0], weights[0].shape[0]
    C, R = weights[8].shape[0], weights[20].shape[0]
    LS, HS = spec.ls, spec.hs
    shapes = mt_weight_shapes(A, E, HD, LD, C, R, spec)
    expect = {"actions": (actions, (T, B, A)), "a_emb": (a_emb, (T, B, E)),
              "v_emb": (v_emb, (T, B, E))}
    for i, (x, d) in enumerate(zip(prev6, (HD, LD, HS, LS, HD, LD))):
        expect[f"prev6[{i}]"] = (x, (T, B, d))
    for i, (g, d) in enumerate(zip(gouts, mt_out_dims(HD, LD, spec))):
        expect[f"gouts[{i}]"] = (g, (T, B, d))
    _expect_weights(expect, weights, shapes)
    _check_inputs(expect, actions.device)
    sizes = [math.prod(s) for s in shapes]
    d_flat = actions.new_zeros(sum(sizes))
    d_w = [g.view(s) for g, s in zip(d_flat.split(sizes), shapes)]
    d_seq = [actions.new_zeros(s) for s in ((T, B, A), (T, B, E), (T, B, E))]
    d_init = [actions.new_zeros((B, d)) for d in (HD, LD, HS, LS, HD, LD)]
    if T == 0 or B == 0:
        return (*d_w, *d_seq, *d_init)
    lib = build.load_library()
    with torch.cuda.device(actions.device):
        dims = _dims(T, B, A, E, HD, LD, C, R, spec, 0)
        dims.rows = lib.mt_recurrence_bwd_rows(dims, _rows_per_block(B, actions.device))
        if dims.rows < 1:
            raise ValueError(f"the MT backward kernel's shared memory does not fit one block "
                             f"at A={A} E={E} HD={HD} LD={LD} C={C} R={R} {spec}")
        partial = actions.new_empty((-(-B // dims.rows), sum(sizes)))
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mt_recurrence_backward(
            _ptrs(weights), _ptrs([actions, a_emb, v_emb, *prev6]), _ptrs(gouts),
            partial.data_ptr(), d_flat.data_ptr(), _ptrs([*d_seq, *d_init]), dims, stream)
    build.check(err)
    bwd_launches += 1
    return (*d_w, *d_seq, *d_init)


def shift_carries(init6: Sequence[torch.Tensor],
                  seqs6: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``prev6[i][t]``, the carry i into step t: ``init6[i]`` at t=0, the
    stored carry sequence ``seqs6[i]`` (:func:`carries`) after
    (``train_step_mt._shift_prev``). Shifted once on the host, so the
    backward kernel's loop has no t == 0 branch."""
    return [torch.cat([i[None], s[:-1]]) for i, s in zip(init6, seqs6)]



class MTRecurrenceFunction(torch.autograd.Function):
    """The hierarchical recurrence under autograd: the forward kernel, and
    the backward kernel as its VJP, with the 28 weights as separate inputs
    so that their gradients reach the ``nn.Parameter``s. ``act`` is None for
    the CUDA kernels and the activation for the plain versions (CPU
    tensors), so the CPU runs the same wiring as the card. The Gumbel noise
    gets no gradient."""

    @staticmethod
    def forward(ctx, act: Act | None, spec: MTSpec, actions: torch.Tensor,
                a_emb: torch.Tensor, v_emb: torch.Tensor,
                *rest: torch.Tensor) -> tuple[torch.Tensor, ...]:
        init6, gumbels, weights = rest[:6], rest[6:10], rest[10:]
        args = (weights, actions, a_emb, v_emb, init6, gumbels, spec)
        if act is None:
            outs = mt_recurrence_forward_cuda(*args)
        else:
            outs = mt_recurrence_forward_plain(*args, act=act)
        ctx.act, ctx.spec = act, spec
        ctx.save_for_backward(actions, a_emb, v_emb, *init6, *carries(outs), *weights)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gouts: torch.Tensor | None):
        saved = ctx.saved_tensors
        actions, a_emb, v_emb = saved[:3]
        init6, seqs6, weights = saved[3:9], saved[9:15], saved[15:]
        dims = mt_out_dims(init6[0].shape[-1], init6[1].shape[-1], ctx.spec)
        T, B = actions.shape[:2]
        gouts = tuple(actions.new_zeros((T, B, d)) if g is None else g.contiguous()
                      for g, d in zip(gouts, dims))
        args = (weights, actions, a_emb, v_emb, shift_carries(init6, seqs6), gouts, ctx.spec)
        if ctx.act is None:
            grads = mt_recurrence_backward_cuda(*args)
        else:
            grads = mt_recurrence_backward_plain(*args, act=ctx.act)
        d_w, d_seq, d_init = grads[:N_WEIGHTS], grads[N_WEIGHTS:N_WEIGHTS + 3], \
            grads[N_WEIGHTS + 3:]
        return (None, None, *d_seq, *d_init, None, None, None, None, *d_w)

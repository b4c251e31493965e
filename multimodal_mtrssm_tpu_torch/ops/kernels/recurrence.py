"""Kernel 1: the MoPoE-MRSSM representation recurrence, forward and backward.

The forward replaces ``multimodal_mtrssm_tpu/ops/pallas/train_step.py::
_fwd_kernel`` (line 244) and ``::_fwd_kernel_chunked`` (line 494). For
t = 0..T-1 it runs ``_forward_step``: transition MLP(action ⊕ stoch) → GRU →
prior MLP and its straight-through sample, the audio and vision posterior
MLPs on deter ⊕ embed, the MoPoE fusion and the posterior straight-through
sample, whose value is the next step's stoch. The Gumbel noise is an input.

The backward replaces ``::_bwd_kernel`` (line 366) and
``::_bwd_kernel_chunked`` (line 530): BPTT in reverse time through
``_bwd_step``'s VJPs. The gradient of a straight-through sample flows
through the block softmax only, so the backward needs no noise and no
sample: a near-tie cannot change it. :class:`RecurrenceFunction` joins the
two under autograd, with JAX's residuals (``train_step.py:686-690``: the
inputs, ``deter`` and ``post_stoch``).

What bounds it on the card: the T steps are a dependent chain, and at the
reference batch (B=8) each step is a few thousand FMAs, so the time is the
latency of its dependent stages, not FLOPs or bytes (inputs and outputs are
~0.4 MB at B=8 T=30). The forward is one launch in three stages, each with a
plain version here: a prologue of every step's partial sums that no carry
feeds (:func:`fwd_inputs_plain`, into a ``[T, B, 3H]`` workspace), the T-step
chain on the deter and posterior-sample carries alone, five barrier phases a
step (:func:`fwd_chain_plain`), and an epilogue of the prior head and its
sample over all T steps (:func:`fwd_priors_plain`); ``[T, B, ·]`` is streamed
through device memory, so one kernel covers the TPU's single-block and
time-chunked variants. The backward is three launches, each with a plain
version here: a parallel recompute of every row-step with what of the VJP
needs no carry (:func:`recurrence_bwd_recompute_plain`), the reverse-time
chain carrying only d deter and d stoch (:func:`recurrence_bwd_chain_plain`),
and the deferred GEMMs over the T·B row-steps in a fixed order: the 20
weight gradients and the input cotangents that feed no carry
(:func:`recurrence_bwd_dw_plain`); they meet in three per-row-step records
(:func:`bwd_record_layout`). Plain f32 FMA loops: the products are far below
a tensor-core tile, and the reference is f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import Act, gru_cell, transition_step, two_layer
from multimodal_mtrssm_tpu_torch.ops.distributions import at_least_f32, block_probs, st_sample
from multimodal_mtrssm_tpu_torch.ops.fusion import mopoe_mix_log_probs

N_WEIGHTS = 20
# Kernel launches since the last reset, forward and backward (plain ints; a
# backward call counts once for its three kernels).
launches = 0
bwd_launches = 0
# Rows of the T·B row-steps a block of the weight-gradient GEMM sums before
# the chunks are added in order (kDgChunk of csrc/dense_grads.cuh).
DW_CHUNK = 128
LOG_THIRD = -math.log(3.0)
# What a refusal of the recurrence and rollout kernels tells the caller to
# run instead: the model's plain route, chosen by name (ops.kernels).
PLAIN_ROUTE = "set use_pallas_train=False to run the model's plain route on the card"


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
    each ``[T, B, ·]``.

    The carry runs in ``init_deter``'s dtype, the layers in their inputs'
    (bf16 for a full-bf16 model): the logits leave each step in f32 for the
    f32 islands (fusion, sampling), and the f32 sample is cast to the
    carry's dtype, as JAX's scan does (``models/mrssm.py:388-417``)."""
    deter = init_deter
    stoch = init_stoch.to(deter.dtype)
    outs: list[tuple[torch.Tensor, ...]] = []
    for t in range(actions.shape[0]):
        deter, prior_logits = transition_step(weights[:12], actions[t], stoch, deter, act)
        prior_logits = at_least_f32(prior_logits)
        prior_stoch = st_sample(prior_logits, g_prior[t], class_size, category_size)
        a_logits = two_layer(torch.cat([deter, a_emb[t]], dim=-1), *weights[12:16], act)
        v_logits = two_layer(torch.cat([deter, v_emb[t]], dim=-1), *weights[16:20], act)
        mixed = mopoe_mix_log_probs(a_logits, v_logits)
        post_stoch = st_sample(mixed, g_post[t], class_size, category_size)
        outs.append((deter, prior_logits, prior_stoch, mixed, post_stoch))
        stoch = post_stoch.to(deter.dtype)
    return tuple(torch.stack(seq) for seq in zip(*outs))


# ---- the forward's three stages ----------------------------------------------------


def fwd_inputs_plain(weights: Sequence[torch.Tensor], actions: torch.Tensor,
                     a_emb: torch.Tensor, v_emb: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel's prologue: the partial sums that
    no carry feeds, of every row-step at once, ``[T, B, 3H]`` (the workspace
    the chain reads): ``action·w1[:, :A]ᵀ + b1``, ``a_emb·wa1[:, D:]ᵀ + ba1``
    and ``v_emb·wv1[:, D:]ᵀ + bv1``."""
    A, D = actions.shape[-1], weights[6].shape[1]
    return torch.cat([F.linear(actions, weights[0][:, :A], weights[1]),
                      F.linear(a_emb, weights[12][:, D:], weights[13]),
                      F.linear(v_emb, weights[16][:, D:], weights[17])], -1)


def fwd_chain_plain(
    weights: Sequence[torch.Tensor], inputs: torch.Tensor, init_deter: torch.Tensor,
    init_stoch: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel's carry chain on the prologue's
    sums ``inputs`` (:func:`fwd_inputs_plain`), from the initial carries with
    the posterior's noise ``g_post`` ``[T, B, S]``: per step the transition's
    first layer on the stoch carry plus the prologue's sum, its second layer,
    the GRU, the audio and vision heads on the new deter plus the prologue's
    embedding sums, the fusion and the posterior sample. Returns ``deter``,
    ``mixed_logits`` and ``post_stoch``, each ``[T, B, ·]`` (the forward's
    outputs 0, 3 and 4)."""
    (w1, _, w2, b2, wih, bih, whh, bhh, *_, wa1, _, wa2, ba2, wv1, _, wv2, bv2) = weights
    H, D = w2.shape[0], whh.shape[1]
    A = w1.shape[1] - init_stoch.shape[-1]
    deter, stoch = init_deter, init_stoch
    steps = []
    for t in range(inputs.shape[0]):
        p1, pa, pv = inputs[t].split([H, H, H], -1)
        x2 = F.linear(F.elu(F.linear(stoch, w1[:, A:]) + p1), w2, b2)
        deter = gru_cell(x2, deter, wih, whh, bih, bhh)
        ha = F.elu(F.linear(deter, wa1[:, :D]) + pa)
        hv = F.elu(F.linear(deter, wv1[:, :D]) + pv)
        mixed = mopoe_mix_log_probs(F.linear(ha, wa2, ba2), F.linear(hv, wv2, bv2))
        stoch = st_sample(mixed, g_post[t], class_size, category_size)
        steps.append((deter, mixed, stoch))
    return tuple(torch.stack(seq) for seq in zip(*steps))


def fwd_priors_plain(weights: Sequence[torch.Tensor], deter: torch.Tensor, g_prior: torch.Tensor,
                     class_size: int, category_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel's epilogue: the prior MLP (ELU) on
    the deter sequence and its straight-through sample with the prior's
    noise, over every row-step at once. Returns ``prior_logits`` and
    ``prior_stoch`` (outputs 1 and 2)."""
    logits = two_layer(deter, *weights[8:12], F.elu)
    return logits, st_sample(logits, g_prior, class_size, category_size)


def recurrence_forward_stages_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """The three plain stages in a row: the forward as the kernel decomposes
    it, with :func:`recurrence_forward_plain`'s contract (ELU)."""
    if actions.shape[0] == 0:
        return recurrence_forward_plain(weights, actions, a_emb, v_emb, init_deter, init_stoch,
                                        g_prior, g_post, class_size, category_size)
    inputs = fwd_inputs_plain(weights, actions, a_emb, v_emb)
    deter, mixed, post_stoch = fwd_chain_plain(weights, inputs, init_deter, init_stoch, g_post,
                                               class_size, category_size)
    prior_logits, prior_stoch = fwd_priors_plain(weights, deter, g_prior, class_size,
                                                 category_size)
    return deter, prior_logits, prior_stoch, mixed, post_stoch


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
    The float32 sample enters the step in the carry's dtype, as in the
    forward, so a bf16 forward's float32 parameters get float32 gradients.

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
            deter, prior_logits = transition_step(w[:12], xs[0][t], stoch.to(deter.dtype), deter,
                                                  act)
            prior_logits = at_least_f32(prior_logits)
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


# ---- the backward's three passes ----------------------------------------------------


def bwd_record_layout(H: int, D: int, S: int) -> dict[str, tuple[int, dict[str, tuple[int, int]]]]:
    """The backward's three records a row-step (``csrc/recurrence_bwd.cu``'s
    ``Layout``, field for field): for ``"chain"`` (what the chain reads),
    ``"x"`` (the layers' inputs) and ``"dy"`` (their output cotangents), the
    width in floats (rounded to 4) and each field's ``(offset, width)``."""
    records = {
        "chain": (("gdb", D), ("gmx", S), ("gpo", S), ("qprob", S), ("ca", S), ("cv", S),
                  ("ea", S), ("ev", S), ("rg", D), ("z", D), ("an", D), ("az", D), ("ar", D),
                  ("dact_h1", H), ("dact_hp", 2 * H)),
        "x": (("h1", H), ("x2", H), ("deter", D), ("hid", 3 * H)),
        "dy": (("dlg", 3 * S), ("dhid", 3 * H), ("dgi", 3 * D), ("dgh", 3 * D), ("dx2", H),
               ("dh1", H)),
    }
    out = {}
    for name, fields in records.items():
        spans, off = {}, 0
        for field, width in fields:
            spans[field] = (off, width)
            off += width
        out[name] = (-(-off // 4) * 4, spans)
    return out


def record_field(rec: torch.Tensor, spans: dict[str, tuple[int, int]], name: str) -> torch.Tensor:
    """The ``[N, width]`` view of one field of a ``[N, record width]`` record."""
    off, width = spans[name]
    return rec[:, off:off + width]


def _d_elu(pre: torch.Tensor) -> torch.Tensor:
    return torch.where(pre > 0, torch.ones_like(pre), torch.exp(pre))


def _block_sum(x: torch.Tensor, class_size: int, category_size: int) -> torch.Tensor:
    """Each category block's sum, broadcast back over the block."""
    blocks = x.reshape(*x.shape[:-1], class_size, category_size)
    return blocks.sum(-1, keepdim=True).expand_as(blocks).reshape(x.shape)


def recompute_values(weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
                     v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
                     gouts: Sequence[torch.Tensor], class_size: int,
                     category_size: int) -> dict[str, torch.Tensor]:
    """Pass 1's values over all N = T·B row-steps at once (``[N, ·]``, in the
    inputs' dtype): the forward step from the carries into each step, the
    kernel's arithmetic written out (ELU; the fusion's full-axis log-softmax
    as ``(l - max) - log Σ exp(l - max)``), and what of the VJP needs no
    carry: the prior head's backward and the chain's coefficients."""
    (w0, b0, w2, b2, w4, b4, w6, b6, w8, b8, w10, b10, w12, b12, w14, b14, w16, b16, w18,
     b18) = weights
    T, B = actions.shape[:2]
    D, H = prev_deter.shape[-1], w0.shape[0]
    flat = lambda x: x.reshape(T * B, x.shape[-1])  # noqa: E731
    gd, gpl, gps, gmx, gpo = map(flat, gouts)
    pdeter, ae, ve = flat(prev_deter), flat(a_emb), flat(v_emb)
    h1p = F.linear(torch.cat([flat(actions), flat(prev_stoch)], -1), w0, b0)
    h1 = F.elu(h1p)
    x2 = F.linear(h1, w2, b2)
    gi, gh = F.linear(x2, w4, b4), F.linear(pdeter, w6, b6)
    rg = torch.sigmoid(gi[:, :D] + gh[:, :D])
    z = torch.sigmoid(gi[:, D:2 * D] + gh[:, D:2 * D])
    n = torch.tanh(gi[:, 2 * D:] + rg * gh[:, 2 * D:])
    deter = (1 - z) * n + z * pdeter
    hp = torch.cat([F.linear(deter, w8, b8), F.linear(torch.cat([deter, ae], -1), w12, b12),
                    F.linear(torch.cat([deter, ve], -1), w16, b16)], -1)
    hid = F.elu(hp)
    prior = F.linear(hid[:, :H], w10, b10)

    def log_softmax(x):
        shifted = x - x.amax(-1, keepdim=True)
        return shifted - shifted.exp().sum(-1, keepdim=True).log()

    la = log_softmax(F.linear(hid[:, H:2 * H], w14, b14))
    lv = log_softmax(F.linear(hid[:, 2 * H:], w18, b18))
    f = la + lv
    m = torch.maximum(torch.maximum(la, lv), f)
    mixed = (m + LOG_THIRD) + ((la - m).exp() + (lv - m).exp() + (f - m).exp()).log()
    pprob = block_probs(prior, class_size, category_size)
    qprob = block_probs(mixed, class_size, category_size)
    dlgp = gpl + pprob * (gps - _block_sum(pprob * gps, class_size, category_size))
    dhidp = (dlgp @ w10) * _d_elu(hp[:, :H])
    weight = lambda x: (x + LOG_THIRD - mixed).exp()  # noqa: E731
    return {
        "h1p": h1p, "h1": h1, "x2": x2, "deter": deter, "hp": hp, "hid": hid, "prior": prior,
        "mixed": mixed, "pprob": pprob, "qprob": qprob, "dlgp": dlgp, "dhidp": dhidp,
        "gdb": gd + dhidp @ w8, "gmx": gmx, "gpo": gpo, "ca": weight(la) + weight(f),
        "cv": weight(lv) + weight(f), "ea": la.exp(), "ev": lv.exp(), "rg": rg, "z": z,
        "an": (1 - z) * (1 - n * n), "az": (pdeter - n) * z * (1 - z),
        "ar": gh[:, 2 * D:] * rg * (1 - rg), "dact_h1": _d_elu(h1p), "dact_hp": _d_elu(hp[:, H:]),
    }


def recurrence_bwd_recompute_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
    gouts: Sequence[torch.Tensor], class_size: int, category_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of pass 1 (``recurrence_bwd_recompute_kernel``): the
    three records ``[T·B, width]`` of :func:`bwd_record_layout`, the ``"dy"``
    record holding only the prior head's cotangents (the chain writes the
    rest; zeros here). Same arguments as :func:`recurrence_backward_plain`."""
    v = recompute_values(weights, actions, a_emb, v_emb, prev_deter, prev_stoch, gouts,
                         class_size, category_size)
    H, D = weights[0].shape[0], prev_deter.shape[-1]
    lay = bwd_record_layout(H, D, class_size * category_size)
    N = v["deter"].shape[0]
    recs = [v["deter"].new_zeros(N, lay[k][0]) for k in ("chain", "x", "dy")]
    for name in lay["chain"][1]:
        record_field(recs[0], lay["chain"][1], name).copy_(v[name])
    for name in ("h1", "x2", "deter", "hid"):
        record_field(recs[1], lay["x"][1], name).copy_(v[name])
    S = class_size * category_size
    record_field(recs[2], lay["dy"][1], "dlg")[:, :S] = v["dlgp"]
    record_field(recs[2], lay["dy"][1], "dhid")[:, :H] = v["dhidp"]
    return tuple(recs)


def recurrence_bwd_chain_plain(
    weights: Sequence[torch.Tensor], crec: torch.Tensor, dyrec: torch.Tensor, T: int, B: int,
    class_size: int, category_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of pass 2 (``recurrence_bwd_chain_kernel``): for
    t = T-1..0, the VJP that carries d deter and d stoch, on pass 1's chain
    record. Returns the ``"dy"`` record with the chain's cotangents written
    into a copy of ``dyrec``, then ``d_init_deter`` and ``d_init_stoch``
    ``[B, ·]``; the input cotangents that feed no carry are pass 3's."""
    w0, w2, w4, w6, w12, w14, w16, w18 = (weights[i] for i in (0, 2, 4, 6, 12, 14, 16, 18))
    H, D = w0.shape[0], w6.shape[1]
    C, K, S = class_size, category_size, class_size * category_size
    A = w0.shape[1] - S
    lay = bwd_record_layout(H, D, S)
    f = {k: record_field(crec, lay["chain"][1], k) for k in lay["chain"][1]}
    dyrec = dyrec.clone()
    y = {k: record_field(dyrec, lay["dy"][1], k) for k in lay["dy"][1]}
    cd, cs = crec.new_zeros(B, D), crec.new_zeros(B, S)
    for t in reversed(range(T)):
        at = slice(t * B, (t + 1) * B)
        q, gs = f["qprob"][at], f["gpo"][at] + cs
        dmix = f["gmx"][at] + q * (gs - _block_sum(q * gs, C, K))
        da, dv = dmix * f["ca"][at], dmix * f["cv"][at]
        dlga = da - f["ea"][at] * da.sum(-1, keepdim=True)
        dlgv = dv - f["ev"][at] * dv.sum(-1, keepdim=True)
        dhida = (dlga @ w14) * f["dact_hp"][at, :H]
        dhidv = (dlgv @ w18) * f["dact_hp"][at, H:]
        g = f["gdb"][at] + cd + dhida @ w12[:, :D] + dhidv @ w16[:, :D]
        dpn = g * f["an"][at]
        dpz, dpr = g * f["az"][at], dpn * f["ar"][at]
        dgi = torch.cat([dpr, dpz, dpn], -1)
        dgh = torch.cat([dpr, dpz, dpn * f["rg"][at]], -1)
        dx2 = dgi @ w4
        cd = g * f["z"][at] + dgh @ w6
        dh1 = (dx2 @ w2) * f["dact_h1"][at]
        cs = dh1 @ w0[:, A:]
        y["dlg"][at, S:] = torch.cat([dlga, dlgv], -1)
        y["dhid"][at, H:] = torch.cat([dhida, dhidv], -1)
        for name, value in (("dgi", dgi), ("dgh", dgh), ("dx2", dx2), ("dh1", dh1)):
            y[name][at] = value
    return dyrec, cd, cs


def dw_tasks(actions: torch.Tensor, a_emb: torch.Tensor, v_emb: torch.Tensor,
             prev_deter: torch.Tensor, prev_stoch: torch.Tensor, xrec: torch.Tensor,
             dyrec: torch.Tensor, H: int, D: int, S: int) -> list[tuple[int, torch.Tensor,
                                                                        torch.Tensor]]:
    """Pass 3's task table (``csrc/recurrence_bwd.cu::dw_table``): for each
    dense layer, the index of its weight (its bias follows), its input rows
    x ``[N, in]`` and its output cotangent rows dy ``[N, out]``."""
    lay = bwd_record_layout(H, D, S)
    N = xrec.shape[0]
    flat = lambda x: x.reshape(N, x.shape[-1])  # noqa: E731
    x = {k: record_field(xrec, lay["x"][1], k) for k in lay["x"][1]}
    y = {k: record_field(dyrec, lay["dy"][1], k) for k in lay["dy"][1]}
    return [
        (0, torch.cat([flat(actions), flat(prev_stoch)], -1), y["dh1"]),
        (2, x["h1"], y["dx2"]),
        (4, x["x2"], y["dgi"]),
        (6, flat(prev_deter), y["dgh"]),
        (8, x["deter"], y["dhid"][:, :H]),
        (10, x["hid"][:, :H], y["dlg"][:, :S]),
        (12, torch.cat([x["deter"], flat(a_emb)], -1), y["dhid"][:, H:2 * H]),
        (14, x["hid"][:, H:2 * H], y["dlg"][:, S:2 * S]),
        (16, torch.cat([x["deter"], flat(v_emb)], -1), y["dhid"][:, 2 * H:]),
        (18, x["hid"][:, 2 * H:], y["dlg"][:, 2 * S:]),
    ]


def recurrence_bwd_dw_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor, xrec: torch.Tensor,
    dyrec: torch.Tensor,
) -> list[torch.Tensor]:
    """Plain version of pass 3 (``recurrence_bwd_dw_kernel``): each layer's
    ``dW = Σ dyᵀ·x`` and ``db = Σ dy`` over the N = T·B row-steps, as the
    kernel adds them (per chunk of :data:`DW_CHUNK` row-steps, then the
    chunks in order), and the input cotangents that feed no carry: the
    stored cotangents times weight columns (``d_actions = dh1 · W0[:, :A]``,
    ``d_a_emb = dh_audio · W12[:, D:]``, ``d_v_emb`` likewise with W16).
    Returns the 20 gradients in torch layout, in kernel order, then
    ``d_actions``, ``d_a_emb`` and ``d_v_emb`` ``[T, B, ·]``."""
    T, B, A = actions.shape
    H, D, S = weights[0].shape[0], prev_deter.shape[-1], prev_stoch.shape[-1]
    grads: list[torch.Tensor] = [None] * N_WEIGHTS  # type: ignore[list-item]
    for i, x, dy in dw_tasks(actions, a_emb, v_emb, prev_deter, prev_stoch, xrec, dyrec, H, D, S):
        xb = torch.cat([x, x.new_ones(x.shape[0], 1)], -1)  # the bias: the column x = 1
        acc = dy.new_zeros(dy.shape[1], xb.shape[1])
        for c0 in range(0, x.shape[0], DW_CHUNK):
            acc = acc + dy[c0:c0 + DW_CHUNK].T @ xb[c0:c0 + DW_CHUNK]
        grads[i], grads[i + 1] = acc[:, :-1], acc[:, -1]
    lay = bwd_record_layout(H, D, S)
    y = {k: record_field(dyrec, lay["dy"][1], k) for k in lay["dy"][1]}
    d_actions = y["dh1"] @ weights[0][:, :A]
    d_a_emb = y["dhid"][:, H:2 * H] @ weights[12][:, D:]
    d_v_emb = y["dhid"][:, 2 * H:] @ weights[16][:, D:]
    return [*grads, *(x.reshape(T, B, -1) for x in (d_actions, d_a_emb, d_v_emb))]


def recurrence_backward_passes_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
    gouts: Sequence[torch.Tensor], class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """The three plain passes in a row: the backward as the kernels
    decompose it, with :func:`recurrence_backward_plain`'s contract (ELU)."""
    T, B = actions.shape[:2]
    crec, xrec, dyrec = recurrence_bwd_recompute_plain(
        weights, actions, a_emb, v_emb, prev_deter, prev_stoch, gouts, class_size, category_size)
    dyrec, d_init_deter, d_init_stoch = recurrence_bwd_chain_plain(weights, crec, dyrec, T, B,
                                                                   class_size, category_size)
    return (*recurrence_bwd_dw_plain(weights, actions, a_emb, v_emb, prev_deter, prev_stoch, xrec,
                                     dyrec), d_init_deter, d_init_stoch)


def _rows_per_block(batch: int, device: torch.device) -> int:
    """Batch rows per block: one block per SM where the batch allows it."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(32, -(-batch // sms)))


def chain_rows(lib, A: int, E: int, H: int, D: int, C: int, K: int, B: int, device) -> int:
    """Batch rows per block of the backward's chain kernel (also the stacked
    backward's) whose shared memory fits; raises where one row does not."""
    R = lib.mrssm_recurrence_bwd_rows(A, E, H, D, C, K, _rows_per_block(B, device))
    if R < 1:
        raise ValueError(f"the backward chain's shared memory does not fit one block at A={A} "
                         f"E={E} H={H} D={D} S={C * K}; {PLAIN_ROUTE}")
    return R


def fwd_rows(lib, T: int, A: int, E: int, H: int, D: int, C: int, K: int, B: int,
             device) -> int:
    """Batch rows per block of the forward kernel (also the stacked
    forward's) whose shared memory fits; raises where one row does not."""
    R = lib.mrssm_recurrence_fwd_rows(T, A, E, H, D, C, K, _rows_per_block(B, device))
    if R < 1:
        raise ValueError(f"the forward kernel's shared memory does not fit one block at T={T} "
                         f"A={A} E={E} H={H} D={D} S={C}x{K}; {PLAIN_ROUTE}")
    return R


def _check_categories(category_size: int) -> None:
    """The forward kernel samples a category block within one warp's lanes."""
    if category_size > 32:
        raise ValueError(f"the forward kernel takes category blocks of at most 32, got "
                         f"{category_size}; {PLAIN_ROUTE}")


def _forward_expect(actions: torch.Tensor, a_emb: torch.Tensor, v_emb: torch.Tensor,
                    init_deter: torch.Tensor, init_stoch: torch.Tensor, g_prior: torch.Tensor,
                    g_post: torch.Tensor,
                    S: int) -> dict[str, tuple[torch.Tensor, tuple[int, ...]]]:
    """The forward's inputs and the shapes they must have (``_check_inputs``)."""
    T, B, A = actions.shape
    E, D = a_emb.shape[-1], init_deter.shape[-1]
    return {
        "actions": (actions, (T, B, A)), "a_emb": (a_emb, (T, B, E)), "v_emb": (v_emb, (T, B, E)),
        "init_deter": (init_deter, (B, D)), "init_stoch": (init_stoch, (B, S)),
        "g_prior": (g_prior, (T, B, S)), "g_post": (g_post, (T, B, S)),
    }


def recurrence_forward_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """Launch the forward kernel (``csrc/recurrence_fwd.cu``: prologue, chain
    and epilogue in one launch); same contract as
    :func:`recurrence_forward_plain` with ELU. Raises on any input the
    kernel does not take, and where a block's shared memory would not fit."""
    global launches
    outs, _ = forward_launch(weights, actions, a_emb, v_emb, init_deter, init_stoch, g_prior,
                             g_post, class_size, category_size)
    if actions.shape[0] and actions.shape[1]:
        launches += 1
    return outs


def forward_launch(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init_deter: torch.Tensor, init_stoch: torch.Tensor,
    g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int, category_size: int,
    stages: int = 7, workspace: torch.Tensor | None = None,
    outs: Sequence[torch.Tensor] | None = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Launch the forward kernel's stages in ``stages`` (1 the prologue, 2
    the chain, 4 the epilogue) on ``workspace`` (the prologue's sums, ``[T,
    B, 3H]``; allocated when None) into ``outs`` (the five outputs; allocated
    when None; a stage left out leaves its outputs as they are). Returns the
    outputs and the workspace, for tests that run one stage on what they
    wrote. Counts no launch."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    _check_categories(category_size)
    T, B, A = actions.shape
    E = a_emb.shape[-1]
    D = init_deter.shape[-1]
    H = weights[0].shape[0]
    S = class_size * category_size
    expect = _forward_expect(actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post, S)
    for i, (w, shape) in enumerate(zip(weights, weight_shapes(A, S, H, D, E))):
        expect[f"weights[{i}]"] = (w, shape)
    if outs is None:
        outs = [actions.new_empty((T, B, d)) for d in (D, S, S, S, S)]
    for i, (o, d) in enumerate(zip(outs, (D, S, S, S, S))):
        expect[f"outs[{i}]"] = (o, (T, B, d))
    if workspace is None:
        workspace = actions.new_empty((T, B, 3 * H))
    expect["workspace"] = (workspace, (T, B, 3 * H))
    _check_inputs(expect, actions.device)
    if T == 0 or B == 0:
        return tuple(outs), workspace
    lib = build.load_library()
    ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(w.data_ptr() for w in weights))
    with torch.cuda.device(actions.device):
        R = fwd_rows(lib, T, A, E, H, D, class_size, category_size, B, actions.device)
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mrssm_recurrence_forward(
            ctypes.cast(ptrs, ctypes.c_void_p),
            *(t.data_ptr() for t in (actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post)),
            *(o.data_ptr() for o in outs), workspace.data_ptr(),
            T, B, A, E, H, D, class_size, category_size, R, stages, stream,
        )
    build.check(err)
    return tuple(outs), workspace


def recurrence_backward_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
    gouts: Sequence[torch.Tensor], class_size: int, category_size: int,
) -> tuple[torch.Tensor, ...]:
    """Launch the backward's three kernels (``csrc/recurrence_bwd.cu``: the
    recompute, the chain, the deferred GEMMs); same contract as
    :func:`recurrence_backward_plain` with ELU. Raises on any input the
    kernels do not take, and where a chain block's shared memory would not
    fit."""
    global bwd_launches
    grads, _ = backward_launch(weights, actions, a_emb, v_emb, prev_deter, prev_stoch, gouts,
                               class_size, category_size)
    if actions.shape[0] and actions.shape[1]:
        bwd_launches += 1
    return grads


def bwd_workspace_records(workspace: torch.Tensor, N: int, H: int, D: int,
                          S: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``[N, width]`` views of the three records at the front of a
    backward workspace (``"chain"``, ``"x"``, ``"dy"`` of
    :func:`bwd_record_layout`)."""
    lay = bwd_record_layout(H, D, S)
    views, off = [], 0
    for name in ("chain", "x", "dy"):
        width = lay[name][0]
        views.append(workspace[off:off + N * width].view(N, width))
        off += N * width
    return tuple(views)


def backward_launch(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev_deter: torch.Tensor, prev_stoch: torch.Tensor,
    gouts: Sequence[torch.Tensor], class_size: int, category_size: int, passes: int = 7,
    workspace: torch.Tensor | None = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Launch the backward passes in ``passes`` (1 recompute, 2 chain, 4
    the deferred GEMMs) on ``workspace`` (allocated when None). Returns the
    gradients (as :func:`recurrence_backward_cuda`; where ``passes`` leaves
    some out, zeros stand for what they would write) and the workspace, for
    tests that run one pass on records they wrote. Counts no launch."""
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
    empty = T == 0 or B == 0
    alloc = actions.new_empty if passes == 7 and not empty else actions.new_zeros
    sizes = [math.prod(s) for s in shapes]
    d_flat = alloc(sum(sizes))
    d_ins = [alloc(s) for s in ((T, B, A), (T, B, E), (T, B, E), (B, D), (B, S))]
    d_w = [g.view(s) for g, s in zip(d_flat.split(sizes), shapes)]
    if empty:
        return (*d_w, *d_ins), actions.new_empty(0)
    lib = build.load_library()
    ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(w.data_ptr() for w in weights))
    with torch.cuda.device(actions.device):
        R = chain_rows(lib, A, E, H, D, class_size, category_size, B, actions.device)
        need = lib.mrssm_recurrence_bwd_workspace(T, B, A, E, H, D, class_size, category_size)
        if workspace is None:
            workspace = actions.new_empty(need)
        elif workspace.numel() < need or not workspace.is_contiguous():
            raise ValueError(f"the workspace needs {need} contiguous floats")
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mrssm_recurrence_backward(
            ctypes.cast(ptrs, ctypes.c_void_p),
            *(t.data_ptr() for t in (actions, a_emb, v_emb, prev_deter, prev_stoch, *gouts)),
            workspace.data_ptr(), d_flat.data_ptr(), *(o.data_ptr() for o in d_ins),
            T, B, A, E, H, D, class_size, category_size, R, passes, stream,
        )
    build.check(err)
    return (*d_w, *d_ins), workspace


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
                  device: torch.device, dtype: torch.dtype = torch.float32) -> None:
    """Device, dtype (``dtype``), shape, contiguity and autograd checks
    shared by the kernel wrappers. A wrapper is not differentiable by
    itself, so it refuses inputs that autograd would track;
    :class:`RecurrenceFunction` calls the recurrence wrappers where autograd
    is off."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")
    for name, (t, shape) in expect.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name} requires grad, but the kernel wrapper is not differentiable: "
                "call it under torch.no_grad() or through ops.kernels.fused_train_recurrence")

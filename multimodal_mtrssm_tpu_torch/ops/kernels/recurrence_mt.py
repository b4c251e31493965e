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
``::_bwd_kernel_chunked`` (line 454): BPTT in reverse time through
``_mt_bwd_step``'s VJPs. A straight-through sample's gradient flows through
its block softmax only, so the backward takes no noise and no sample.
:class:`MTRecurrenceFunction` joins the two under autograd with JAX's
residuals (``train_step_mt.py:612-617``: the inputs, ``init6`` and the six
carry sequences).

What bounds it on the card: as for the MRSSM recurrence, the latency of a chain
of small dependent stages at the reference batch, not FLOPs or bytes. The
forward is one launch in three stages, each with a plain version here: a
prologue of every step's partial sums that no carry feeds
(:func:`mt_fwd_inputs_plain`, into a ``[T, B, LD + 2R]`` workspace), the T-step
chain on the six carries alone, three barrier phases a step
(:func:`mt_fwd_chain_plain`), and an epilogue of both prior heads and their
samples over all T steps (:func:`mt_fwd_priors_plain`); ``[T, B, ·]`` is
streamed through device memory, so one kernel covers the TPU's single-block and
time-chunked variants. The backward is the MRSSM backward's three launches,
each with a plain version here: a parallel recompute of every row-step with
what of the VJP needs no carry, both prior heads' backward included
(:func:`mt_bwd_recompute_plain`), the reverse-time chain carrying only the six
carries (:func:`mt_bwd_chain_plain`), and the deferred GEMMs over the T·B
row-steps in a fixed order: the 28 weight gradients and the input cotangents
that feed no carry (:func:`mt_bwd_dw_plain`); they meet in three per-row-step
records (:func:`mt_bwd_record_layout`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.core import Act, mtrnn_step, two_layer
from multimodal_mtrssm_tpu_torch.ops.distributions import at_least_f32, block_probs, st_sample
from multimodal_mtrssm_tpu_torch.ops.fusion import mopoe_mix_log_probs
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import (
    DW_CHUNK,
    LOG_THIRD,
    PLAIN_ROUTE,
    _block_sum,
    _check_inputs,
    _d_elu,
    _rows_per_block,
    record_field,
)

N_WEIGHTS = 28
N_OUT = 12
# Kernel launches since the last reset, forward and backward (plain ints; a
# backward call counts once for its three kernels).
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
    12 outputs.

    The deter and integrator carries run in their own dtype (bf16 for a
    full-bf16 model) and the f32 stoch samples enter in it; the logits leave
    in f32 for the f32 islands, as JAX's scan (``models/mmtrssm.py:340-353``)."""
    hd0, ld0, hs0, ls0, hidh0, hidl0 = carry
    hs0, ls0 = hs0.to(ld0.dtype), ls0.to(ld0.dtype)
    lc, lk, hc, hk = spec.ls_class, spec.ls_category, spec.hs_class, spec.hs_category
    l_deter, hid_l = mtrnn_step(w[0:4], torch.cat([action, ls0, hs0], -1), ld0, hidl0,
                                spec.l_tau)
    lp_logits = at_least_f32(two_layer(l_deter, *w[8:12], act))
    a_logits = two_layer(torch.cat([l_deter, a_emb], -1), *w[20:24], act)
    v_logits = two_layer(torch.cat([l_deter, v_emb], -1), *w[24:28], act)
    mixed = mopoe_mix_log_probs(a_logits, v_logits)
    h_deter, hid_h = mtrnn_step(w[4:8], hs0, hd0, hidh0, spec.h_tau)
    hp_logits = at_least_f32(two_layer(h_deter, *w[12:16], act))
    hq_logits = at_least_f32(two_layer(torch.cat([l_deter, h_deter], -1), *w[16:20], act))
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


# ---- the forward's three stages ----------------------------------------------------


def mt_fwd_inputs_plain(weights: Sequence[torch.Tensor], actions: torch.Tensor,
                        a_emb: torch.Tensor, v_emb: torch.Tensor,
                        spec: MTSpec = MT_SPEC) -> torch.Tensor:
    """Plain version of the forward kernel's prologue: the partial sums that
    no carry feeds, of every row-step at once, ``[T, B, LD + 2R]`` (the
    workspace the chain reads): ``action·wli[:, :A]ᵀ + bli``, ``a_emb·wa1[:,
    LD:]ᵀ + ba1`` and ``v_emb·wv1[:, LD:]ᵀ + bv1``."""
    z = _mt_widths(weights, spec)
    A, LD = z["A"], z["LD"]
    return torch.cat([F.linear(actions, weights[2][:, :A], weights[3]),
                      F.linear(a_emb, weights[20][:, LD:], weights[21]),
                      F.linear(v_emb, weights[24][:, LD:], weights[25])], -1)


def mt_fwd_chain_plain(
    weights: Sequence[torch.Tensor], inputs: torch.Tensor, init6: Sequence[torch.Tensor],
    g_l: torch.Tensor, g_h: torch.Tensor, spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the forward kernel's carry chain on the prologue's
    sums ``inputs`` (:func:`mt_fwd_inputs_plain`), from ``init6`` with the
    posteriors' noise ``g_l`` and ``g_h`` ``[T, B, ·]``: per step both MTRNN
    cells (JAX ``mtrnn_apply``'s association, the lower cell's input sum the
    sample columns' plus the prologue's), the audio, vision and h-posterior
    heads, the fusion and both posterior samples. Returns ``h_deter,
    l_deter, hid_h, hid_l, mixed, l_stoch, h_post_logits, h_stoch``, each
    ``[T, B, ·]`` (the forward's outputs 0-3, 6, 7, 10, 11)."""
    (wld, bld, wli, _, whd, bhd, whi, bhi, *_, hq1, bhq1, hq2, bhq2,
     wa1, _, wa2, ba2, wv1, _, wv2, bv2) = weights
    z = _mt_widths(weights, spec)
    A, LD, R = z["A"], z["LD"], z["R"]
    lc, lk, hc, hk = spec.ls_class, spec.ls_category, spec.hs_class, spec.hs_category
    l_inv, h_inv = 1.0 / spec.l_tau, 1.0 / spec.h_tau
    hd, ld, hs, ls, hidh, hidl = init6
    steps = []
    for t in range(inputs.shape[0]):
        pl, pa, pv = inputs[t].split([LD, R, R], -1)
        ul = F.linear(ld, wld, bld) + (F.linear(torch.cat([ls, hs], -1), wli[:, A:]) + pl)
        hidl = (1.0 - l_inv) * hidl + ul * l_inv
        uh = F.linear(hd, whd, bhd) + F.linear(hs, whi, bhi)
        hidh = (1.0 - h_inv) * hidh + uh * h_inv
        ld, hd = torch.tanh(hidl), torch.tanh(hidh)
        ha = F.elu(F.linear(ld, wa1[:, :LD]) + pa)
        hv = F.elu(F.linear(ld, wv1[:, :LD]) + pv)
        hq = F.elu(F.linear(torch.cat([ld, hd], -1), hq1, bhq1))
        mixed = mopoe_mix_log_probs(F.linear(ha, wa2, ba2), F.linear(hv, wv2, bv2))
        hq_logits = F.linear(hq, hq2, bhq2)
        ls, hs = st_sample(mixed, g_l[t], lc, lk), st_sample(hq_logits, g_h[t], hc, hk)
        steps.append((hd, ld, hidh, hidl, mixed, ls, hq_logits, hs))
    return tuple(torch.stack(seq) for seq in zip(*steps))


def mt_fwd_priors_plain(
    weights: Sequence[torch.Tensor], h_deter: torch.Tensor, l_deter: torch.Tensor,
    g_lp: torch.Tensor, g_hp: torch.Tensor, spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the forward kernel's epilogue: both prior MLPs (ELU)
    on the deter sequences and their straight-through samples with the
    priors' noise, over every row-step at once. Returns ``l_prior_logits,
    l_prior_stoch, h_prior_logits, h_prior_stoch`` (outputs 4, 5, 8, 9)."""
    lp = two_layer(l_deter, *weights[8:12], F.elu)
    hp = two_layer(h_deter, *weights[12:16], F.elu)
    return (lp, st_sample(lp, g_lp, spec.ls_class, spec.ls_category),
            hp, st_sample(hp, g_hp, spec.hs_class, spec.hs_category))


def mt_recurrence_forward_stages_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init6: Sequence[torch.Tensor], gumbels: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """The three plain stages in a row: the forward as the kernel decomposes
    it, with :func:`mt_recurrence_forward_plain`'s contract (ELU)."""
    inputs = mt_fwd_inputs_plain(weights, actions, a_emb, v_emb, spec)
    if actions.shape[0] == 0:
        return mt_recurrence_forward_plain(weights, actions, a_emb, v_emb, init6, gumbels, spec)
    hd, ld, hidh, hidl, mixed, l_stoch, hq, h_stoch = mt_fwd_chain_plain(
        weights, inputs, init6, gumbels[1], gumbels[3], spec)
    lp, lp_stoch, hp, hp_stoch = mt_fwd_priors_plain(weights, hd, ld, gumbels[0], gumbels[2], spec)
    return hd, ld, hidh, hidl, lp, lp_stoch, mixed, l_stoch, hp, hp_stoch, hq, h_stoch


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


# ---- the backward's three passes ----------------------------------------------------


def mt_bwd_record_layout(A: int, E: int, HD: int, LD: int, C: int, R: int,
                         spec: MTSpec) -> dict[str, tuple[int, dict[str, tuple[int, int]]]]:
    """The backward's three records a row-step (``csrc/recurrence_mt_bwd.cu``'s
    ``Layout``, field for field): for ``"chain"`` (what the chain reads),
    ``"x"`` (the layers' inputs not in device memory) and ``"dy"`` (their
    output cotangents), the width in floats (rounded to 4) and each field's
    ``(offset, width)``. The five MLPs' hiddens (``hid``, ``dhid``) lie in
    the order l-prior, audio, vision, h-prior, h-posterior (widths C, R, R,
    C, C), and so do their logits (``dlg``: LS, LS, LS, HS, HS)."""
    LS, HS = spec.ls, spec.hs
    H5, G5 = 3 * C + 2 * R, 3 * LS + 2 * HS
    records = {
        "chain": (("gls", LS), ("gmx", LS), ("ql", LS), ("ca", LS), ("cv", LS), ("ea", LS),
                  ("ev", LS), ("ghs", HS), ("ghql", HS), ("qh", HS), ("dact", 2 * R + C),
                  ("gldb", LD), ("tl", LD), ("ghidl", LD), ("ghdb", HD), ("th", HD),
                  ("ghidh", HD)),
        "x": (("xl", A + LS + HS), ("xq", LD + HD), ("hid", H5)),
        "dy": (("dhid", H5), ("dlg", G5), ("sl", LD), ("sh", HD)),
    }
    out = {}
    for name, fields in records.items():
        spans, off = {}, 0
        for field, width in fields:
            spans[field] = (off, width)
            off += width
        out[name] = (-(-off // 4) * 4, spans)
    return out


def _mt_widths(weights: Sequence[torch.Tensor], spec: MTSpec) -> dict[str, int]:
    """The sizes a weight list implies, and the hidden and logit offsets."""
    LD, HD, C, R = weights[0].shape[0], weights[4].shape[0], weights[8].shape[0], \
        weights[20].shape[0]
    LS, HS = spec.ls, spec.hs
    return dict(A=weights[2].shape[1] - LS - HS, E=weights[20].shape[1] - LD, HD=HD, LD=LD, C=C,
                R=R, LS=LS, HS=HS, hA=C, hV=C + R, hP=C + 2 * R, hQ=2 * C + 2 * R, gA=LS,
                gV=2 * LS, gP=3 * LS, gQ=3 * LS + HS)


def _layout_of(weights: Sequence[torch.Tensor], spec: MTSpec):
    z = _mt_widths(weights, spec)
    return mt_bwd_record_layout(z["A"], z["E"], z["HD"], z["LD"], z["C"], z["R"], spec)


def mt_recompute_values(weights: Sequence[torch.Tensor], actions: torch.Tensor,
                        a_emb: torch.Tensor, v_emb: torch.Tensor, prev6: Sequence[torch.Tensor],
                        gouts: Sequence[torch.Tensor],
                        spec: MTSpec = MT_SPEC) -> dict[str, torch.Tensor]:
    """Pass 1's values over all N = T·B row-steps at once (``[N, ·]``, in the
    inputs' dtype): the forward step from the carries into each step, the
    kernel's arithmetic written out (ELU; the fusion's full-axis log-softmax
    as ``(l - max) - log Σ exp(l - max)``), and what of the VJP needs no
    carry: both prior heads' backward and the chain's coefficients, under
    the names of :func:`mt_bwd_record_layout`'s fields."""
    (wld, bld, wli, bli, whd, bhd, whi, bhi, lp1, blp1, lp2, blp2, hp1, bhp1, hp2, bhp2,
     hq1, bhq1, hq2, bhq2, wa1, ba1, wa2, ba2, wv1, bv1, wv2, bv2) = weights
    T, B = actions.shape[:2]
    z = _mt_widths(weights, spec)
    C, R = z["C"], z["R"]
    lc, lk, hc, hk = spec.ls_class, spec.ls_category, spec.hs_class, spec.hs_category
    flat = lambda x: x.reshape(T * B, x.shape[-1])  # noqa: E731
    g = list(map(flat, gouts))
    hd0, ld0, hs0, ls0, hidh0, hidl0 = map(flat, prev6)
    ae, ve = flat(a_emb), flat(v_emb)
    xl = torch.cat([flat(actions), ls0, hs0], -1)
    l_inv, h_inv = 1.0 / spec.l_tau, 1.0 / spec.h_tau
    hidl = (1.0 - l_inv) * hidl0 + (F.linear(ld0, wld, bld) + F.linear(xl, wli, bli)) * l_inv
    hidh = (1.0 - h_inv) * hidh0 + (F.linear(hd0, whd, bhd) + F.linear(hs0, whi, bhi)) * h_inv
    ldet, hdet = torch.tanh(hidl), torch.tanh(hidh)
    pre = torch.cat([F.linear(ldet, lp1, blp1), F.linear(torch.cat([ldet, ae], -1), wa1, ba1),
                     F.linear(torch.cat([ldet, ve], -1), wv1, bv1), F.linear(hdet, hp1, bhp1),
                     F.linear(torch.cat([ldet, hdet], -1), hq1, bhq1)], -1)
    hid = F.elu(pre)
    lp_logits = F.linear(hid[:, :C], lp2, blp2)
    hp_logits = F.linear(hid[:, C + 2 * R:2 * C + 2 * R], hp2, bhp2)
    hq_logits = F.linear(hid[:, 2 * C + 2 * R:], hq2, bhq2)

    def log_softmax(x):
        shifted = x - x.amax(-1, keepdim=True)
        return shifted - shifted.exp().sum(-1, keepdim=True).log()

    la = log_softmax(F.linear(hid[:, C:C + R], wa2, ba2))
    lv = log_softmax(F.linear(hid[:, C + R:C + 2 * R], wv2, bv2))
    f = la + lv
    m = torch.maximum(torch.maximum(la, lv), f)
    mixed = (m + LOG_THIRD) + ((la - m).exp() + (lv - m).exp() + (f - m).exp()).log()
    pl, ql = block_probs(lp_logits, lc, lk), block_probs(mixed, lc, lk)
    ph, qh = block_probs(hp_logits, hc, hk), block_probs(hq_logits, hc, hk)
    dlpl = g[4] + pl * (g[5] - _block_sum(pl * g[5], lc, lk))
    dhpl = g[8] + ph * (g[9] - _block_sum(ph * g[9], hc, hk))
    dlp = (dlpl @ lp2) * _d_elu(pre[:, :C])
    dhp = (dhpl @ hp2) * _d_elu(pre[:, C + 2 * R:2 * C + 2 * R])
    weight = lambda x: (x + LOG_THIRD - mixed).exp()  # noqa: E731
    return {
        "ldet": ldet, "hdet": hdet, "hidl": hidl, "hidh": hidh, "pre": pre, "hid": hid,
        "lp_logits": lp_logits, "mixed": mixed, "hp_logits": hp_logits, "hq_logits": hq_logits,
        "dlpl": dlpl, "dhpl": dhpl, "dlp": dlp, "dhp": dhp,
        "gls": g[7], "gmx": g[6], "ql": ql, "ca": weight(la) + weight(f),
        "cv": weight(lv) + weight(f), "ea": la.exp(), "ev": lv.exp(), "ghs": g[11],
        "ghql": g[10], "qh": qh,
        "dact": torch.cat([_d_elu(pre[:, C:C + 2 * R]), _d_elu(pre[:, 2 * C + 2 * R:])], -1),
        "gldb": g[1] + dlp @ lp1, "tl": 1 - ldet * ldet, "ghidl": g[3],
        "ghdb": g[0] + dhp @ hp1, "th": 1 - hdet * hdet, "ghidh": g[2],
        "xl": xl, "xq": torch.cat([ldet, hdet], -1),
    }


def mt_bwd_recompute_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev6: Sequence[torch.Tensor], gouts: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of pass 1 (``mt_recurrence_bwd_recompute_kernel``): the
    three records ``[T·B, width]`` of :func:`mt_bwd_record_layout`, the
    ``"dy"`` record holding only the prior heads' cotangents (the chain
    writes the rest; zeros here). Same arguments as
    :func:`mt_recurrence_backward_plain`."""
    v = mt_recompute_values(weights, actions, a_emb, v_emb, prev6, gouts, spec)
    z = _mt_widths(weights, spec)
    lay = _layout_of(weights, spec)
    N = v["ldet"].shape[0]
    recs = [v["ldet"].new_zeros(N, lay[k][0]) for k in ("chain", "x", "dy")]
    for name in lay["chain"][1]:
        record_field(recs[0], lay["chain"][1], name).copy_(v[name])
    for name in lay["x"][1]:
        record_field(recs[1], lay["x"][1], name).copy_(v[name])
    dhid = record_field(recs[2], lay["dy"][1], "dhid")
    dlg = record_field(recs[2], lay["dy"][1], "dlg")
    dhid[:, :z["hA"]], dhid[:, z["hP"]:z["hQ"]] = v["dlp"], v["dhp"]
    dlg[:, :z["gA"]], dlg[:, z["gP"]:z["gQ"]] = v["dlpl"], v["dhpl"]
    return tuple(recs)


def mt_bwd_chain_plain(
    weights: Sequence[torch.Tensor], crec: torch.Tensor, dyrec: torch.Tensor, T: int, B: int,
    spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """Plain version of pass 2 (``mt_recurrence_bwd_chain_kernel``): for
    t = T-1..0, the VJP that carries the six carries, on pass 1's chain
    record. Returns the ``"dy"`` record with the chain's cotangents written
    into a copy of ``dyrec``, then the six ``d_init6`` ``[B, ·]``; the input
    cotangents that feed no carry are pass 3's."""
    z = _mt_widths(weights, spec)
    A, LD, C, R, LS = z["A"], z["LD"], z["C"], z["R"], z["LS"]
    wld, wli, whd, whi = weights[0], weights[2], weights[4], weights[6]
    hq1, hq2, wa1, wa2, wv1, wv2 = (weights[i] for i in (16, 18, 20, 22, 24, 26))
    lc, lk, hc, hk = spec.ls_class, spec.ls_category, spec.hs_class, spec.hs_category
    lay = _layout_of(weights, spec)
    f = {k: record_field(crec, lay["chain"][1], k) for k in lay["chain"][1]}
    dyrec = dyrec.clone()
    y = {k: record_field(dyrec, lay["dy"][1], k) for k in lay["dy"][1]}
    cdh, chh = (crec.new_zeros(B, z["HD"]) for _ in range(2))
    cdl, chl = (crec.new_zeros(B, LD) for _ in range(2))
    csh, csl = crec.new_zeros(B, z["HS"]), crec.new_zeros(B, LS)
    l_inv, h_inv = 1.0 / spec.l_tau, 1.0 / spec.h_tau
    for t in reversed(range(T)):
        at = slice(t * B, (t + 1) * B)
        q, gs = f["ql"][at], f["gls"][at] + csl
        dmix = f["gmx"][at] + q * (gs - _block_sum(q * gs, lc, lk))
        da, dv = dmix * f["ca"][at], dmix * f["cv"][at]
        dlga = da - f["ea"][at] * da.sum(-1, keepdim=True)
        dlgv = dv - f["ev"][at] * dv.sum(-1, keepdim=True)
        qh, gh = f["qh"][at], f["ghs"][at] + csh
        dhql = f["ghql"][at] + qh * (gh - _block_sum(qh * gh, hc, hk))
        dact = f["dact"][at]
        dha = (dlga @ wa2) * dact[:, :R]
        dhv = (dlgv @ wv2) * dact[:, R:2 * R]
        dhq = (dhql @ hq2) * dact[:, 2 * R:]
        gl = (f["gldb"][at] + cdl) + (dhq @ hq1[:, :LD] + dha @ wa1[:, :LD] + dhv @ wv1[:, :LD])
        ghl = (f["ghidl"][at] + chl) + gl * f["tl"][at]
        g_h = (f["ghdb"][at] + cdh) + dhq @ hq1[:, LD:]
        ghh = (f["ghidh"][at] + chh) + g_h * f["th"][at]
        chl, chh = ghl * (1.0 - l_inv), ghh * (1.0 - h_inv)
        sl, sh = ghl * l_inv, ghh * h_inv
        cdl, cdh = sl @ wld, sh @ whd
        csl = sl @ wli[:, A:A + LS]
        csh = sh @ whi + sl @ wli[:, A + LS:]
        y["dlg"][at, z["gA"]:z["gP"]] = torch.cat([dlga, dlgv], -1)
        y["dlg"][at, z["gQ"]:] = dhql
        y["dhid"][at, z["hA"]:z["hP"]] = torch.cat([dha, dhv], -1)
        y["dhid"][at, z["hQ"]:] = dhq
        y["sl"][at], y["sh"][at] = sl, sh
    return dyrec, cdh, cdl, csh, csl, chh, chl


def mt_dw_tasks(actions: torch.Tensor, a_emb: torch.Tensor, v_emb: torch.Tensor,
                prev6: Sequence[torch.Tensor], xrec: torch.Tensor, dyrec: torch.Tensor,
                weights: Sequence[torch.Tensor],
                spec: MTSpec = MT_SPEC) -> list[tuple[int, torch.Tensor, torch.Tensor]]:
    """Pass 3's task table (``csrc/recurrence_mt_bwd.cu::dw_table``): for
    each dense layer, the index of its weight (its bias follows), its input
    rows x ``[N, in]`` and its output cotangent rows dy ``[N, out]``."""
    z = _mt_widths(weights, spec)
    LD, C, R = z["LD"], z["C"], z["R"]
    lay = _layout_of(weights, spec)
    N = xrec.shape[0]
    flat = lambda x: x.reshape(N, x.shape[-1])  # noqa: E731
    hd0, ld0, hs0 = (flat(p) for p in prev6[:3])
    x = {k: record_field(xrec, lay["x"][1], k) for k in lay["x"][1]}
    y = {k: record_field(dyrec, lay["dy"][1], k) for k in lay["dy"][1]}
    hid, dhid, dlg, ldet = x["hid"], y["dhid"], y["dlg"], x["xq"][:, :LD]
    hA, hV, hP, hQ = z["hA"], z["hV"], z["hP"], z["hQ"]
    gA, gV, gP, gQ = z["gA"], z["gV"], z["gP"], z["gQ"]
    return [
        (0, ld0, y["sl"]), (2, x["xl"], y["sl"]), (4, hd0, y["sh"]), (6, hs0, y["sh"]),
        (8, ldet, dhid[:, :hA]), (10, hid[:, :C], dlg[:, :gA]),
        (12, x["xq"][:, LD:], dhid[:, hP:hQ]), (14, hid[:, hP:hQ], dlg[:, gP:gQ]),
        (16, x["xq"], dhid[:, hQ:]), (18, hid[:, hQ:], dlg[:, gQ:]),
        (20, torch.cat([ldet, flat(a_emb)], -1), dhid[:, hA:hV]), (22, hid[:, hA:hV], dlg[:, gA:gV]),
        (24, torch.cat([ldet, flat(v_emb)], -1), dhid[:, hV:hP]), (26, hid[:, hV:hP], dlg[:, gV:gP]),
    ]


def mt_bwd_dw_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev6: Sequence[torch.Tensor], xrec: torch.Tensor, dyrec: torch.Tensor,
    spec: MTSpec = MT_SPEC,
) -> list[torch.Tensor]:
    """Plain version of pass 3 (``recurrence_bwd_dw_kernel`` on the MT task
    table): each layer's ``dW = Σ dyᵀ·x`` and ``db = Σ dy`` over the N = T·B
    row-steps, as the kernel adds them (per chunk of :data:`DW_CHUNK`
    row-steps, then the chunks in order; the two MTRNN cells' bias
    gradients from the same cotangents in the same order, so
    ``dw[3] == dw[1]`` and ``dw[7] == dw[5]``), and the input cotangents
    that feed no carry (``d_actions = sl · wli[:, :A]``, ``d_a_emb = d_ha ·
    wa1[:, LD:]``, ``d_v_emb`` likewise with wv1). Returns the 28 gradients
    in torch layout, in kernel order, then ``d_actions``, ``d_a_emb`` and
    ``d_v_emb`` ``[T, B, ·]``."""
    T, B, A = actions.shape
    z = _mt_widths(weights, spec)
    LD = z["LD"]
    grads: list[torch.Tensor] = [None] * N_WEIGHTS  # type: ignore[list-item]
    for i, x, dy in mt_dw_tasks(actions, a_emb, v_emb, prev6, xrec, dyrec, weights, spec):
        xb = torch.cat([x, x.new_ones(x.shape[0], 1)], -1)  # the bias: the column x = 1
        acc = dy.new_zeros(dy.shape[1], xb.shape[1])
        for c0 in range(0, x.shape[0], DW_CHUNK):
            acc = acc + dy[c0:c0 + DW_CHUNK].T @ xb[c0:c0 + DW_CHUNK]
        grads[i], grads[i + 1] = acc[:, :-1], acc[:, -1]
    lay = _layout_of(weights, spec)
    y = {k: record_field(dyrec, lay["dy"][1], k) for k in lay["dy"][1]}
    dhid = y["dhid"]
    d_actions = y["sl"] @ weights[2][:, :A]
    d_a_emb = dhid[:, z["hA"]:z["hV"]] @ weights[20][:, LD:]
    d_v_emb = dhid[:, z["hV"]:z["hP"]] @ weights[24][:, LD:]
    return [*grads, *(x.reshape(T, B, -1) for x in (d_actions, d_a_emb, d_v_emb))]


def mt_recurrence_backward_passes_plain(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev6: Sequence[torch.Tensor], gouts: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """The three plain passes in a row: the backward as the kernels
    decompose it, with :func:`mt_recurrence_backward_plain`'s contract (ELU)."""
    T, B = actions.shape[:2]
    crec, xrec, dyrec = mt_bwd_recompute_plain(weights, actions, a_emb, v_emb, prev6, gouts, spec)
    dyrec, *d_init = mt_bwd_chain_plain(weights, crec, dyrec, T, B, spec)
    return (*mt_bwd_dw_plain(weights, actions, a_emb, v_emb, prev6, xrec, dyrec, spec), *d_init)


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
        raise ValueError(f"the kernels take category blocks of at most 32; {PLAIN_ROUTE}")


def _expect_weights(expect: dict, weights: Sequence[torch.Tensor],
                    shapes: Sequence[tuple[int, ...]]) -> None:
    for i, (w, shape) in enumerate(zip(weights, shapes)):
        expect[f"weights[{i}]"] = (w, shape)


def mt_recurrence_forward_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init6: Sequence[torch.Tensor], gumbels: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """Launch the forward kernel (``csrc/recurrence_mt_fwd.cu``: prologue,
    chain and epilogue in one launch); same contract as
    :func:`mt_recurrence_forward_plain` with ELU. Raises on any input the
    kernel does not take, and where a block's shared memory would not fit."""
    global launches
    outs, _ = mt_forward_launch(weights, actions, a_emb, v_emb, init6, gumbels, spec)
    if actions.shape[0] and actions.shape[1]:
        launches += 1
    return outs


def mt_forward_launch(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, init6: Sequence[torch.Tensor], gumbels: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC, stages: int = 7, workspace: torch.Tensor | None = None,
    outs: Sequence[torch.Tensor] | None = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Launch the forward kernel's stages in ``stages`` (1 the prologue, 2
    the chain, 4 the epilogue) on ``workspace`` (the prologue's sums, ``[T,
    B, LD + 2R]``; allocated when None) into ``outs`` (the 12 outputs;
    allocated when None; a stage left out leaves its outputs as they are).
    Returns the outputs and the workspace, for tests that run one stage on
    what they wrote. Counts no launch."""
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
    if outs is None:
        outs = [actions.new_empty((T, B, d)) for d in mt_out_dims(HD, LD, spec)]
    for i, (o, d) in enumerate(zip(outs, mt_out_dims(HD, LD, spec))):
        expect[f"outs[{i}]"] = (o, (T, B, d))
    if workspace is None:
        workspace = actions.new_empty((T, B, LD + 2 * R))
    expect["workspace"] = (workspace, (T, B, LD + 2 * R))
    _check_inputs(expect, actions.device)
    if T == 0 or B == 0:
        return tuple(outs), workspace
    lib = build.load_library()
    with torch.cuda.device(actions.device):
        dims = _dims(T, B, A, E, HD, LD, C, R, spec, 0)
        dims.rows = lib.mt_recurrence_fwd_rows(dims, _rows_per_block(B, actions.device))
        if dims.rows < 1:
            raise ValueError(f"the MT forward's shared memory does not fit one block at A={A} "
                             f"E={E} HD={HD} LD={LD} C={C} R={R} {spec}; {PLAIN_ROUTE}")
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mt_recurrence_forward(_ptrs(weights),
                                        _ptrs([actions, a_emb, v_emb, *init6, *gumbels]),
                                        _ptrs(outs), workspace.data_ptr(), dims, stages, stream)
    build.check(err)
    return tuple(outs), workspace


def mt_recurrence_backward_cuda(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev6: Sequence[torch.Tensor], gouts: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC,
) -> tuple[torch.Tensor, ...]:
    """Launch the backward's three kernels (``csrc/recurrence_mt_bwd.cu``:
    the recompute, the chain, the deferred GEMMs); same contract as
    :func:`mt_recurrence_backward_plain` with ELU. Raises on any input the
    kernels do not take, and where a chain block's shared memory would not
    fit."""
    global bwd_launches
    grads, _ = mt_backward_launch(weights, actions, a_emb, v_emb, prev6, gouts, spec)
    if actions.shape[0] and actions.shape[1]:
        bwd_launches += 1
    return grads


def mt_bwd_workspace_records(workspace: torch.Tensor, N: int,
                             layout: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``[N, width]`` views of the three records at the front of a
    backward workspace (``"chain"``, ``"x"``, ``"dy"`` of ``layout``,
    :func:`mt_bwd_record_layout`'s result)."""
    views, off = [], 0
    for name in ("chain", "x", "dy"):
        width = layout[name][0]
        views.append(workspace[off:off + N * width].view(N, width))
        off += N * width
    return tuple(views)


def mt_backward_launch(
    weights: Sequence[torch.Tensor], actions: torch.Tensor, a_emb: torch.Tensor,
    v_emb: torch.Tensor, prev6: Sequence[torch.Tensor], gouts: Sequence[torch.Tensor],
    spec: MTSpec = MT_SPEC, passes: int = 7, workspace: torch.Tensor | None = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Launch the backward passes in ``passes`` (1 recompute, 2 chain, 4
    the deferred GEMMs) on ``workspace`` (allocated when None). Returns the
    gradients (as :func:`mt_recurrence_backward_cuda`; where ``passes``
    leaves some out, zeros stand for what they would write) and the
    workspace, for tests that run one pass on records they wrote. Counts no
    launch."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if len(weights) != N_WEIGHTS or len(prev6) != 6 or len(gouts) != N_OUT:
        raise ValueError(f"expected {N_WEIGHTS} weights, 6 carry sequences and {N_OUT} "
                         f"cotangents, got {len(weights)}, {len(prev6)} and {len(gouts)}")
    _check_spec(spec)
    T, B, A = actions.shape
    E = a_emb.shape[-1]
    HD, LD = weights[4].shape[0], weights[0].shape[0]
    C, R = weights[8].shape[0], weights[20].shape[0]
    shapes = mt_weight_shapes(A, E, HD, LD, C, R, spec)
    expect = {"actions": (actions, (T, B, A)), "a_emb": (a_emb, (T, B, E)),
              "v_emb": (v_emb, (T, B, E))}
    for i, (x, d) in enumerate(zip(prev6, (HD, LD, spec.hs, spec.ls, HD, LD))):
        expect[f"prev6[{i}]"] = (x, (T, B, d))
    for i, (g, d) in enumerate(zip(gouts, mt_out_dims(HD, LD, spec))):
        expect[f"gouts[{i}]"] = (g, (T, B, d))
    _expect_weights(expect, weights, shapes)
    _check_inputs(expect, actions.device)
    empty = T == 0 or B == 0
    alloc = actions.new_empty if passes == 7 and not empty else actions.new_zeros
    sizes = [math.prod(s) for s in shapes]
    d_flat = alloc(sum(sizes))
    d_w = [g.view(s) for g, s in zip(d_flat.split(sizes), shapes)]
    d_seq = [alloc(s) for s in ((T, B, A), (T, B, E), (T, B, E))]
    d_init = [alloc((B, d)) for d in (HD, LD, spec.hs, spec.ls, HD, LD)]
    if empty:
        return (*d_w, *d_seq, *d_init), actions.new_empty(0)
    lib = build.load_library()
    with torch.cuda.device(actions.device):
        dims = _dims(T, B, A, E, HD, LD, C, R, spec, 0)
        dims.rows = lib.mt_recurrence_bwd_rows(dims, _rows_per_block(B, actions.device))
        if dims.rows < 1:
            raise ValueError(f"the MT backward chain's shared memory does not fit one block "
                             f"at A={A} E={E} HD={HD} LD={LD} C={C} R={R} {spec}; {PLAIN_ROUTE}")
        need = lib.mt_recurrence_bwd_workspace(dims)
        if workspace is None:
            workspace = actions.new_empty(need)
        elif workspace.numel() < need or not workspace.is_contiguous():
            raise ValueError(f"the workspace needs {need} contiguous floats")
        stream = torch.cuda.current_stream(actions.device).cuda_stream
        err = lib.mt_recurrence_backward(
            _ptrs(weights), _ptrs([actions, a_emb, v_emb, *prev6]), _ptrs(gouts),
            workspace.data_ptr(), d_flat.data_ptr(), _ptrs([*d_seq, *d_init]), dims, passes,
            stream)
    build.check(err)
    return (*d_w, *d_seq, *d_init), workspace


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
        # The carries' cotangents in the carries' dtype, the logits' and
        # samples' (outputs 4-11) in at least f32.
        wide = torch.promote_types(actions.dtype, torch.float32)
        gouts = tuple(g.contiguous() if g is not None else actions.new_zeros(
            (T, B, d), dtype=actions.dtype if i < 4 else wide)
            for i, (g, d) in enumerate(zip(gouts, dims)))
        args = (weights, actions, a_emb, v_emb, shift_carries(init6, seqs6), gouts, ctx.spec)
        if ctx.act is None:
            grads = mt_recurrence_backward_cuda(*args)
        else:
            grads = mt_recurrence_backward_plain(*args, act=ctx.act)
        d_w, d_seq, d_init = grads[:N_WEIGHTS], grads[N_WEIGHTS:N_WEIGHTS + 3], \
            grads[N_WEIGHTS + 3:]
        return (None, None, *d_seq, *d_init, None, None, None, None, *d_w)

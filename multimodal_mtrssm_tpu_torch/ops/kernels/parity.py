"""Checks that hold a kernel's output against its plain version.

Sampling makes exact comparison fragile in one place: where the top two
Gumbel scores of a category block lie within ``tie_eps``, summation order
alone can pick the other category, and a recurrence then follows another
trajectory. The forward checks exclude exactly those blocks (and, for the
observe recurrence, what follows them in that row) and compare everything
else. A gradient flows through the probs only, so the backward check
compares everything; a whole train step samples, so its check first counts
the near-ties of its noise (:func:`train_step_near_ties`) and the caller
takes other noise where there are any.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.models.state import MTState
from multimodal_mtrssm_tpu_torch.nn.core import transition_step
from multimodal_mtrssm_tpu_torch.ops.distributions import onehot_blocks
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence_mt import MT_SPEC, MTSpec
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import Seed, philox_gumbel
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout_mt import mt_prior_step, philox_mt_gumbel


class ParityError(AssertionError):
    """A kernel disagrees with its plain version beyond the stated tolerance."""


def near_ties(scores: torch.Tensor, class_size: int, category_size: int,
              tie_eps: float) -> torch.Tensor:
    """``[..., class_size]`` mask of blocks whose top two scores lie within ``tie_eps``."""
    blocks = scores.reshape(*scores.shape[:-1], class_size, category_size)
    top2 = blocks.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) < tie_eps


def _max_err(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    """Max |a - b| over the ``[T, B]`` (or ``[B, T]``) entries where ``mask``."""
    diff = (a - b).abs().amax(dim=-1)
    return float(diff[mask].max()) if bool(mask.any()) else 0.0


@torch.no_grad()
def check_recurrence(kernel_out: Sequence[torch.Tensor], plain_out: Sequence[torch.Tensor],
                     g_prior: torch.Tensor, g_post: torch.Tensor, class_size: int,
                     category_size: int, atol: float = 1e-4,
                     tie_eps: float = 1e-5) -> dict[str, Any]:
    """Compare the observe recurrence's ``[T, B, ·]`` outputs. In each batch
    row, steps up to the first posterior near-tie are compared (deter,
    prior logits and mixed logits within ``atol``, stochs equal); a prior
    near-tie excludes only its own block. Raises :class:`ParityError`.

    Returns the largest error, the share of steps compared, and under
    ``"agree"`` the ``[T, B]`` mask of steps whose whole posterior state
    (deter and sample) was held equal."""
    deter_k, prior_k, pstoch_k, mixed_k, post_k = kernel_out
    deter_p, prior_p, pstoch_p, mixed_p, post_p = plain_out
    T = deter_p.shape[0]
    post_tie = near_ties(mixed_p + g_post, class_size, category_size, tie_eps)
    prior_tie = near_ties(prior_p + g_prior, class_size, category_size, tie_eps)
    steps = torch.arange(T, device=deter_p.device)[:, None]
    first = torch.where(post_tie.any(-1), steps, T).amin(0)  # [B]
    upto = steps <= first  # the carry into these steps agrees
    before = steps < first
    err = max(_max_err(k, p, upto) for k, p in
              ((deter_k, deter_p), (prior_k, prior_p), (mixed_k, mixed_p)))
    if not err <= atol:
        raise ParityError(f"recurrence: max |kernel - plain| {err:.3g} > {atol}")
    pmask = upto[..., None] & ~prior_tie
    post_mask = before[..., None].expand_as(post_tie)
    for name, k, p, m in (("prior_stoch", pstoch_k, pstoch_p, pmask),
                          ("post_stoch", post_k, post_p, post_mask)):
        _check_blocks(k, p, m, class_size, category_size, atol, f"recurrence: {name}")
    return {"max_abs_err": err, "compared": float(upto.float().mean()), "agree": before}


@torch.no_grad()
def replay_transition(weights: Sequence[torch.Tensor], actions: torch.Tensor,
                      init_deter: torch.Tensor, init_stoch: torch.Tensor,
                      stochs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain transition teacher-forced with given ``[B, T, S]`` stochs:
    step t reads ``stochs[:, t-1]``. Returns ``(deters, logits)``."""
    deter, stoch = init_deter, init_stoch
    deters, logits = [], []
    for t in range(actions.shape[1]):
        deter, lg = transition_step(weights, actions[:, t], stoch, deter, F.elu)
        deters.append(deter)
        logits.append(lg)
        stoch = stochs[:, t]
    return torch.stack(deters, 1), torch.stack(logits, 1)


@torch.no_grad()
def check_rollout(weights: Sequence[torch.Tensor], actions: torch.Tensor,
                  init_deter: torch.Tensor, init_stoch: torch.Tensor, seed: Seed,
                  kernel_out: Sequence[torch.Tensor], class_size: int, category_size: int,
                  atol: float = 1e-4, tie_eps: float = 1e-5) -> dict[str, float]:
    """Check the rollout kernel by replaying its stochs through the plain
    transition (deters and logits within ``atol``) and by re-sampling: its
    stochs must be the one-hot argmax of its logits plus the plain Philox
    noise for ``seed``, except in near-tie blocks. Raises :class:`ParityError`."""
    deters_k, logits_k, stochs_k = kernel_out
    B, T, _ = actions.shape
    deters_p, logits_p = replay_transition(weights, actions, init_deter, init_stoch, stochs_k)
    everywhere = torch.ones(B, T, dtype=torch.bool, device=actions.device)
    err = max(_max_err(deters_k, deters_p, everywhere), _max_err(logits_k, logits_p, everywhere))
    if not err <= atol:
        raise ParityError(f"rollout: max |kernel - replay| {err:.3g} > {atol}")
    noise = philox_gumbel(seed, T, B, class_size, category_size, actions.device).transpose(0, 1)
    scores = logits_k + noise
    expect = onehot_blocks(scores, class_size, category_size)
    keep = ~near_ties(scores, class_size, category_size, tie_eps)
    blocks = lambda x: x.reshape(B, T, class_size, category_size)  # noqa: E731
    bad = (blocks(stochs_k) != blocks(expect)).any(-1) & keep
    if bool(bad.any()):
        raise ParityError(f"rollout: stochs differ from argmax(logits + noise) in "
                          f"{int(bad.sum())} blocks")
    return {"max_abs_err": err, "compared": float(keep.float().mean())}


def _check_blocks(k: torch.Tensor, p: torch.Tensor, mask: torch.Tensor, class_size: int,
                   category_size: int, atol: float, name: str) -> None:
    """Raise unless the sampled blocks of ``k`` and ``p`` pick the same
    category and hold the same values (within ``atol``) wherever ``mask``
    (``[..., class_size]``)."""
    blocks = lambda x: x.reshape(*x.shape[:-1], class_size, category_size)  # noqa: E731
    bad = (blocks(k).argmax(-1) != blocks(p).argmax(-1)) & mask
    if bool(bad.any()):
        raise ParityError(f"{name} differs in {int(bad.sum())} blocks")
    err = float((blocks(k) - blocks(p)).abs().amax(-1)[mask].max()) if bool(mask.any()) else 0.0
    if not err <= atol:
        raise ParityError(f"{name} values differ by {err:.3g}")


@torch.no_grad()
def check_mt_recurrence(kernel_out: Sequence[torch.Tensor], plain_out: Sequence[torch.Tensor],
                        gumbels: Sequence[torch.Tensor], spec: MTSpec = MT_SPEC,
                        atol: float = 1e-4, tie_eps: float = 1e-5) -> dict[str, Any]:
    """Compare the hierarchical recurrence's 12 ``[T, B, ·]`` outputs. In
    each batch row, steps up to the first near-tie of either posterior are
    compared (deters, integrators and the four logits within ``atol``; the
    posterior samples, which are the next carries, equal before it); a
    prior near-tie excludes only its own block. Raises :class:`ParityError`.

    Returns the largest error, the share of steps compared, and under
    ``"agree"`` the ``[T, B]`` mask of steps whose whole posterior state was
    held equal."""
    lc, lk, hc, hk = spec.ls_class, spec.ls_category, spec.hs_class, spec.hs_category
    T = plain_out[0].shape[0]
    l_post_tie = near_ties(plain_out[6] + gumbels[1], lc, lk, tie_eps)
    h_post_tie = near_ties(plain_out[10] + gumbels[3], hc, hk, tie_eps)
    steps = torch.arange(T, device=plain_out[0].device)[:, None]
    tie = l_post_tie.any(-1) | h_post_tie.any(-1)
    first = torch.where(tie, steps, T).amin(0)  # [B]
    upto, before = steps <= first, steps < first
    err = max(_max_err(kernel_out[i], plain_out[i], upto) for i in (0, 1, 2, 3, 4, 6, 8, 10))
    if not err <= atol:
        raise ParityError(f"mt recurrence: max |kernel - plain| {err:.3g} > {atol}")
    for name, i, c, k, mask in (
            ("l_prior_stoch", 5, lc, lk,
             upto[..., None] & ~near_ties(plain_out[4] + gumbels[0], lc, lk, tie_eps)),
            ("l_stoch", 7, lc, lk, before[..., None].expand_as(l_post_tie)),
            ("h_prior_stoch", 9, hc, hk,
             upto[..., None] & ~near_ties(plain_out[8] + gumbels[2], hc, hk, tie_eps)),
            ("h_stoch", 11, hc, hk, before[..., None].expand_as(h_post_tie))):
        _check_blocks(kernel_out[i], plain_out[i], mask, c, k, atol, f"mt recurrence: {name}")
    return {"max_abs_err": err, "compared": float(upto.float().mean()), "agree": before}


@torch.no_grad()
def replay_mt_prior(weights: Sequence[torch.Tensor], actions: torch.Tensor,
                    init6: Sequence[torch.Tensor], h_stochs: torch.Tensor,
                    l_stochs: torch.Tensor, spec: MTSpec = MT_SPEC) -> tuple[torch.Tensor, ...]:
    """The plain imagination step teacher-forced with given ``[B, T, ·]``
    stochs: step t reads those of step t-1. Returns ``(h_deter, l_deter,
    h_logits, l_logits, hid_h, hid_l)``, each ``[B, T, ·]``."""
    carry = tuple(init6)
    outs = []
    for t in range(actions.shape[1]):
        hd, ld, h_logits, l_logits, hidh, hidl = mt_prior_step(weights, actions[:, t], carry,
                                                               spec, F.elu)
        outs.append((hd, ld, h_logits, l_logits, hidh, hidl))
        carry = (hd, ld, h_stochs[:, t], l_stochs[:, t], hidh, hidl)
    return tuple(torch.stack(seq, 1) for seq in zip(*outs))


@torch.no_grad()
def check_mt_rollout(weights: Sequence[torch.Tensor], actions: torch.Tensor,
                     init6: Sequence[torch.Tensor], seed: Seed, kernel_out: Sequence[torch.Tensor],
                     spec: MTSpec = MT_SPEC, atol: float = 1e-4,
                     tie_eps: float = 1e-5) -> dict[str, float]:
    """Check the hierarchical rollout kernel by replaying its stochs through
    the plain step (deters, logits and integrators within ``atol``) and by
    re-sampling: each layer's stochs must be the one-hot argmax of its
    logits plus the plain Philox noise for ``seed``, except in near-tie
    blocks. Raises :class:`ParityError`."""
    h_deter, l_deter, h_logits, l_logits, h_stoch, l_stoch, hid_h, hid_l = kernel_out
    B, T, _ = actions.shape
    replay = replay_mt_prior(weights, actions, init6, h_stoch, l_stoch, spec)
    everywhere = torch.ones(B, T, dtype=torch.bool, device=actions.device)
    err = max(_max_err(k, p, everywhere) for k, p in
              zip((h_deter, l_deter, h_logits, l_logits, hid_h, hid_l), replay))
    if not err <= atol:
        raise ParityError(f"mt rollout: max |kernel - replay| {err:.3g} > {atol}")
    g_l, g_h = philox_mt_gumbel(seed, T, B, (spec.ls_class, spec.ls_category),
                                (spec.hs_class, spec.hs_category), actions.device)
    kept = []
    for name, logits, stochs, noise, c, k in (
            ("l_stoch", l_logits, l_stoch, g_l, spec.ls_class, spec.ls_category),
            ("h_stoch", h_logits, h_stoch, g_h, spec.hs_class, spec.hs_category)):
        scores = logits + noise.transpose(0, 1)
        keep = ~near_ties(scores, c, k, tie_eps)
        blocks = lambda x: x.reshape(B, T, c, k)  # noqa: E731, B023
        bad = (blocks(stochs) != blocks(onehot_blocks(scores, c, k))).any(-1) & keep
        if bool(bad.any()):
            raise ParityError(f"mt rollout: {name} differs from argmax(logits + noise) in "
                              f"{int(bad.sum())} blocks")
        kept.append(keep.flatten())
    return {"max_abs_err": err, "compared": float(torch.cat(kept).float().mean())}


@torch.no_grad()
def first_near_tie(scores: Sequence[tuple[torch.Tensor, int, int]],
                   tie_eps: float = 1e-5) -> torch.Tensor:
    """Each row's first step at which a sampled site has a near-tie block:
    ``scores`` holds, per site that feeds the carry, its ``[B, T, C·K]``
    logits plus noise with its ``(class_size, category_size)``. Returns a
    ``[B]`` tensor, ``T`` where a row has none. Up to that step two runs of
    one trajectory sample alike; from there a rounding can pick another
    category."""
    B, T = scores[0][0].shape[:2]
    tie = torch.zeros(B, T, dtype=torch.bool, device=scores[0][0].device)
    for s, c, k in scores:
        tie |= near_ties(s, c, k, tie_eps).any(-1)
    steps = torch.arange(T, device=tie.device)[None, :]
    return torch.where(tie, steps, T).amin(1)


def _tie_rows(out: Mapping[str, Any], cfg: Any,
              tie_eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """A ``predict_word`` output's ``[B]`` first rollout step with a Gumbel
    near-tie (:func:`first_near_tie`) and whether the row's initial sample
    has one."""
    init, states, seed = out["initial"], out["states"], out["seed"]
    g0 = out["init_noise"]
    if isinstance(init, MTState):
        ls, hs = (cfg.ls_class, cfg.ls_category), (cfg.hs_class, cfg.hs_category)
        B, T = states.deter_h.shape[:2]
        g_l, g_h = philox_mt_gumbel(seed, T, B, ls, hs, states.deter_h.device)
        sites = [(states.logits_l + g_l.transpose(0, 1), *ls),
                 (states.logits_h + g_h.transpose(0, 1), *hs)]
        init_sites = [(init.logits_h + g0["g_init_h"], *hs), (init.logits_l + g0["g_init_l"], *ls)]
    else:
        C, K = cfg.class_size, cfg.category_size
        B, T = states.deter.shape[:2]
        g = philox_gumbel(seed, T, B, C, K, states.deter.device)
        sites = [(states.logits + g.transpose(0, 1), C, K)]
        init_sites = [(init.logits + g0["g_init"], C, K)]
    init_tie = torch.stack([near_ties(s, c, k, tie_eps).any(-1) for s, c, k in init_sites]).any(0)
    return first_near_tie(sites, tie_eps), init_tie.repeat_interleave(B // init_tie.shape[0])


@torch.no_grad()
def check_predicted_digits(got: Mapping[str, Any], ref: Mapping[str, Any], cfg: Any,
                           classify_frame: int, tie_eps: float = 1e-5,
                           atol: float = 1e-4) -> dict[str, Any]:
    """Two ``evaluation.word_transitions.predict_word`` outputs on the same
    weights, intervals and seed (the card's and the CPU's). The rollout
    states, in rows whose initial sample has no Gumbel near-tie, up to each
    row's first rollout near-tie in either run: stochs equal before it,
    every other field within ``atol`` up to and including it (it depends
    only on earlier samples). Each row's digit equal, except in rows with
    an initial near-tie or a rollout one up to ``classify_frame``, or whose
    top two classifier logits lie within ``tie_eps``. Raises
    :class:`ParityError`. Returns the rows compared and excluded, the
    distinct digits among the compared rows, and the states' largest
    error."""
    first_g, init_g = _tie_rows(got, cfg, tie_eps)
    first_r, init_r = _tie_rows(ref, cfg, tie_eps)
    first = torch.minimum(first_g.cpu(), first_r.cpu())
    init_tie = init_g.cpu() | init_r.cpu()
    fields = [f.name for f in dataclasses.fields(ref["states"])]
    steps = torch.arange(getattr(ref["states"], fields[0]).shape[1])[None, :]
    upto = (steps <= first[:, None]) & ~init_tie[:, None]
    before = (steps < first[:, None]) & ~init_tie[:, None]
    err = 0.0
    for name in fields:
        a, b = getattr(got["states"], name).cpu(), getattr(ref["states"], name).cpu()
        if name.startswith("stoch"):
            if not torch.equal(a[before], b[before]):
                raise ParityError(f"rollout {name} differs before the first near-tie")
        else:
            err = max(err, _max_err(a, b, upto))
    if not err <= atol:
        raise ParityError(f"rollout states: max |card - cpu| {err:.3g} > {atol}")
    top2 = lambda out: out["logits"].topk(2, dim=-1).values.cpu()  # noqa: E731
    clear = ((first > classify_frame) & ~init_tie
             & ((top2(got)[:, 0] - top2(got)[:, 1]) > tie_eps)
             & ((top2(ref)[:, 0] - top2(ref)[:, 1]) > tie_eps))
    a, b = got["digits"].cpu()[clear], ref["digits"].cpu()[clear]
    if not torch.equal(a, b):
        raise ParityError(f"predicted digits differ in {int((a != b).sum())} of "
                          f"{int(clear.sum())} rows clear of near-ties")
    return {"compared": int(clear.sum()), "excluded": int((~clear).sum()),
            "digits": sorted(set(b.tolist())), "max_abs_err": err}


def _reconstruction_ties(out: Mapping[str, Any], cfg: Any,
                         tie_eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """A ``viz.rollout.reconstruction_states`` output's ``[B]`` first step
    with a sampled near-tie, over the posterior's sites and the imagined
    ones from step ``q`` on (:func:`first_near_tie`), and whether the
    row's initial sample has one."""
    init, post, imag, noise = out["initial"], out["posterior"], out["imagined"], out["noise"]
    q = out["q"]
    tm = lambda g: g.transpose(0, 1)  # noqa: E731
    if isinstance(init, MTState):
        ls, hs = (cfg.ls_class, cfg.ls_category), (cfg.hs_class, cfg.hs_category)
        B, T = post.deter_h.shape[:2]
        sites = [(post.logits_l + tm(noise["g_lpost"]), *ls),
                 (post.logits_h + tm(noise["g_hpost"]), *hs)]
        init_sites = [(init.logits_h + noise["g_init_h"], *hs),
                      (init.logits_l + noise["g_init_l"], *ls)]
        if imag is not None:
            g_l, g_h = philox_mt_gumbel(out["seed"], T - q, B, ls, hs, post.deter_h.device)
            imag_sites = [(imag.logits_l + tm(g_l), *ls), (imag.logits_h + tm(g_h), *hs)]
    else:
        C, K = cfg.class_size, cfg.category_size
        B, T = post.deter.shape[:2]
        sites = [(post.logits + tm(noise["g_post"]), C, K)]
        init_sites = [(init.logits + noise["g_init"], C, K)]
        if imag is not None:
            g = philox_gumbel(out["seed"], T - q, B, C, K, post.deter.device)
            imag_sites = [(imag.logits + tm(g), C, K)]
    first = first_near_tie(sites, tie_eps)
    if imag is not None:  # its steps are the prior's from q on; T - q + q = T: none
        first = torch.minimum(first, first_near_tie(imag_sites, tie_eps) + q)
    init_tie = torch.stack([near_ties(s, c, k, tie_eps).any(-1) for s, c, k in init_sites]).any(0)
    return first, init_tie


@torch.no_grad()
def check_reconstructions(got: Mapping[str, Any], ref: Mapping[str, Any], cfg: Any,
                          tie_eps: float = 1e-5, atol: float = 1e-4) -> dict[str, Any]:
    """Two ``viz.rollout.reconstruction_states`` outputs on the same
    weights, batch and seed (the card's and the CPU's), each with its
    decoded ``frames`` (``decode_reconstructions``). In rows whose initial
    sample has no Gumbel near-tie, up to each row's first sampled near-tie
    in either run (:func:`_reconstruction_ties`): the posterior's and the
    prior's stochs pick the same categories before it (their values, a
    straight-through sample's, within ``atol``) and every other field is
    within ``atol`` up to and including it; the frames within ``atol``
    before it. Raises :class:`ParityError`. Returns the largest state and
    frame errors and the share of steps compared."""
    first_g, init_g = _reconstruction_ties(got, cfg, tie_eps)
    first_r, init_r = _reconstruction_ties(ref, cfg, tie_eps)
    first = torch.minimum(first_g.cpu(), first_r.cpu())
    init_tie = init_g.cpu() | init_r.cpu()
    T = ref["frames"]["posterior/audio"].shape[1]
    steps = torch.arange(T)[None, :]
    upto = (steps <= first[:, None]) & ~init_tie[:, None]
    before = (steps < first[:, None]) & ~init_tie[:, None]
    if isinstance(ref["initial"], MTState):
        blocks = {"stoch_h": (cfg.hs_class, cfg.hs_category),
                  "stoch_l": (cfg.ls_class, cfg.ls_category)}
    else:
        blocks = {"stoch": (cfg.class_size, cfg.category_size)}
    err = 0.0
    for which in ("posterior", "prior"):
        for f in dataclasses.fields(ref[which]):
            a, b = getattr(got[which], f.name).cpu(), getattr(ref[which], f.name).cpu()
            if f.name in blocks:
                c, k = blocks[f.name]
                _check_blocks(a, b, before[..., None].expand(*before.shape, c), c, k, atol,
                              f"{which} {f.name} before the first near-tie")
            else:
                err = max(err, _max_err(a, b, upto))
    if not err <= atol:
        raise ParityError(f"reconstruction states: max |a - b| {err:.3g} > {atol}")
    frame_err = max(_max_err(got["frames"][k].cpu().flatten(2), v.cpu().flatten(2), before)
                    for k, v in ref["frames"].items())
    if not frame_err <= atol:
        raise ParityError(f"reconstructed frames: max |a - b| {frame_err:.3g} > {atol}")
    return {"max_abs_err": err, "frame_err": frame_err, "compared": float(before.float().mean())}


@torch.no_grad()
def check_same_trajectories(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                            samples: Sequence[int], first: torch.Tensor, atol: float = 1e-4,
                            name: str = "trajectories") -> dict[str, Any]:
    """Two runs of the same ``[B, T, ·]`` trajectories (a request coalesced
    and alone): the outputs whose indices are in ``samples`` equal at the
    steps before each row's ``first`` near-tie (:func:`first_near_tie`),
    every other output within ``atol`` up to and including it (it depends
    only on earlier samples). Raises :class:`ParityError`. Returns the
    largest error and whether the two runs are bit-identical."""
    T = ref[0].shape[1]
    steps = torch.arange(T, device=first.device)[None, :]
    upto, before = steps <= first[:, None], steps < first[:, None]
    err = max((_max_err(g, r, upto) for i, (g, r) in enumerate(zip(got, ref))
               if i not in samples), default=0.0)
    if not err <= atol:
        raise ParityError(f"{name}: max |a - b| {err:.3g} > {atol}")
    for i in samples:
        if not torch.equal(got[i][before], ref[i][before]):
            raise ParityError(f"{name}: output {i} differs before the first near-tie")
    return {"max_abs_err": err,
            "bit_identical": all(torch.equal(g, r) for g, r in zip(got, ref))}


def check_gradients(kernel_grads: Sequence[torch.Tensor], plain_grads: Sequence[torch.Tensor],
                    rel: float = 2e-4) -> float:
    """Each kernel gradient within ``rel × max(1, max|plain|)`` of its plain
    twin (the bound of ``tests/test_pallas_train_step.py``). Returns the
    largest error divided by its tensor's scale; raises :class:`ParityError`."""
    worst = 0.0
    for i, (k, p) in enumerate(zip(kernel_grads, plain_grads, strict=True)):
        scale = max(1.0, float(p.abs().max())) if p.numel() else 1.0
        err = float((k.to(p.device) - p).abs().max()) / scale if p.numel() else 0.0
        if not err <= rel:
            raise ParityError(f"grads[{i}]: max |kernel - plain| / scale {err:.3g} > {rel}")
        worst = max(worst, err)
    return worst


@torch.no_grad()
def train_step_near_ties(model: Any, batch: Sequence[torch.Tensor],
                         noise: Mapping[str, Any], tie_eps: float = 1e-5) -> int:
    """Blocks of a ``shared_step`` on ``batch`` and ``noise`` whose top two
    Gumbel scores lie within ``tie_eps`` (every sample site of either
    family); where there are none, two routes must sample alike."""
    init, post, prior, g = model._observe_batch(batch, noise, None)
    tm = lambda x: x.transpose(0, 1)  # noqa: E731
    cfg = model.cfg
    if isinstance(init, MTState):
        lc, lk, hc, hk = cfg.ls_class, cfg.ls_category, cfg.hs_class, cfg.hs_category
        sites = ((init.logits_h + g["g_init_h"], hc, hk), (init.logits_l + g["g_init_l"], lc, lk),
                 (tm(prior.logits_l) + g["g_lprior"], lc, lk),
                 (tm(post.logits_l) + g["g_lpost"], lc, lk),
                 (tm(prior.logits_h) + g["g_hprior"], hc, hk),
                 (tm(post.logits_h) + g["g_hpost"], hc, hk))
    else:
        C, K = cfg.class_size, cfg.category_size
        g_init, g_prior, g_post = g
        sites = ((init.logits + g_init, C, K), (tm(prior.logits) + g_prior, C, K),
                 (tm(post.logits) + g_post, C, K))
    return sum(int(near_ties(scores, c, k, tie_eps).sum()) for scores, c, k in sites)


def train_step_grads(model: Any, batch: Sequence[torch.Tensor],
                     noise: Mapping[str, Any]) -> tuple[dict[str, float],
                                                                 dict[str, torch.Tensor]]:
    """The losses of one ``shared_step`` and every parameter's gradient."""
    model.zero_grad(set_to_none=True)
    out = model.shared_step(batch, noise)
    out["loss"].backward()
    return ({k: float(v.detach()) for k, v in out.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def check_train_step(kernel_model: Any, plain_model: Any, kernel_inputs: tuple, plain_inputs: tuple,
                     rtol: float = 2e-5, rel: float = 3e-4) -> dict[str, float]:
    """One train step's loss terms within ``rtol`` of the total loss (the
    KL is a small term whose own relative error says little) and its
    gradient tree within ``rel × max(1, max|plain grad|)`` (one scale for
    the whole tree, as ``tests/test_pallas_train_step.py`` holds the JAX
    kernel). Each inputs tuple is ``(batch, noise)`` on its model's device.
    Raises :class:`ParityError`."""
    loss_k, grads_k = train_step_grads(kernel_model, *kernel_inputs)
    loss_p, grads_p = train_step_grads(plain_model, *plain_inputs)
    total = max(abs(loss_p["loss"]), 1e-30)
    loss_errs = {k: abs(loss_k[k] - v) / total for k, v in loss_p.items()}
    if not max(loss_errs.values()) <= rtol:
        raise ParityError(f"train step losses differ: {loss_k} vs {loss_p}")
    scale = max(1.0, max(float(g.abs().max()) for g in grads_p.values()))
    err = max(float((grads_k[n].to(g.device) - g).abs().max()) for n, g in grads_p.items())
    if not err <= rel * scale:
        raise ParityError(f"train step gradients differ by {err:.3g} > {rel} x {scale:.3g}")
    return {"losses": loss_p, "loss_rel_errs": loss_errs, "grad_max_abs_err": err,
            "grad_scale": scale}


@torch.no_grad()
def check_same_rollouts(got: Any, ref: Any, cfg: Any, seed: int, atol: float = 1e-4,
                        tie_eps: float = 1e-5) -> dict[str, Any]:
    """Two imaginations of one ``seed`` (``State``s or ``MTState``s, ``[B,
    T, ·]``; two routes or two devices): the same trajectories up to each
    row's first near-tie on ``ref``'s logits plus the seed's Philox noise
    (:func:`check_same_trajectories`). Returns its result and the share of
    steps before a near-tie (``"compared"``)."""
    B, T = ref.feature.shape[:2]
    dev = ref.feature.device
    if isinstance(ref, MTState):
        g_l, g_h = philox_mt_gumbel(seed, T, B, (cfg.ls_class, cfg.ls_category),
                                    (cfg.hs_class, cfg.hs_category), dev)
        sites = [(ref.logits_l + g_l.transpose(0, 1), cfg.ls_class, cfg.ls_category),
                 (ref.logits_h + g_h.transpose(0, 1), cfg.hs_class, cfg.hs_category)]
        fields = ("deter_h", "deter_l", "logits_h", "logits_l", "stoch_h", "stoch_l",
                  "hidden_h", "hidden_l")
        samples = (4, 5)
    else:
        g = philox_gumbel(seed, T, B, cfg.class_size, cfg.category_size, dev)
        sites = [(ref.logits + g.transpose(0, 1), cfg.class_size, cfg.category_size)]
        fields, samples = ("deter", "logits", "stoch"), (2,)
    first = first_near_tie(sites, tie_eps)
    out = check_same_trajectories([getattr(got, f).to(dev) for f in fields],
                                  [getattr(ref, f) for f in fields], samples, first, atol)
    return {**out, "compared": float(first.float().mean()) / T}

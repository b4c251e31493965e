"""The MMTRSSM recurrence forward as its kernel decomposes it, on the CPU.

``csrc/recurrence_mt_fwd.cu`` runs the forward in three stages of one
launch: a prologue of every step's partial sums that no carry feeds (the
action columns of the lower cell, the embedding columns of the audio and
vision first layers, with their biases), the T-step chain on the six
carries alone, and an epilogue of both prior heads and their samples over
all T steps. Each stage has a plain version in ``ops/kernels/recurrence_mt.py``;
these tests hold the identities the kernel relies on, on those plain
versions:

- the three stages in a row equal ``mt_recurrence_forward_plain`` in float64
  (within 1e-10 × max(1, max|plain|) per output: the same arithmetic in
  another association; the fusion runs in float32 in both, ``ops/fusion.py``)
  with the samples' categories equal;
- in float32 they match it within 1e-5 × scale, samples equal outside blocks
  whose top two scores lie within 1e-5 (``ops/kernels/parity.py``: a
  posterior's near-tie ends the comparison of its row);
- the prologue is the first layers' carry-free columns, and the epilogue
  reads nothing but the deter sequences and the priors' noise;
- they equal JAX's ``fused_mt_train_recurrence`` through the Pallas forward
  in interpret mode, single-block and time-chunked, at tiny widths (float32:
  1e-5 absolute, categories equal, straight-through values within 1e-6, as
  ``tests/test_torch_port_mt_kernels.py``).

At B ∈ {1, 3, 8}, T ∈ {1, 7}, on tiny widths, the reference widths, odd
ones (HD=17 ≠ LD=33, 3 × 5 and 2 × 7 categories) and latents wider than a
warp (5 × 8 lower, 3 × 12 higher), with weights, inputs and noise made by
numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu.ops.pallas import train_step_mt as jax_mt
from multimodal_mtrssm_tpu_torch.ops.distributions import onehot_blocks
from multimodal_mtrssm_tpu_torch.ops.kernels import parity
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt as rmt
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence_mt import MTSpec

WIDTHS = {  # A, E, HD, LD, C, R, spec
    "tiny": (3, 12, 8, 12, 16, 10, MTSpec(2.0, 4.0, 2, 3, 2, 4)),
    "reference": (6, 64, 32, 32, 32, 32, rmt.MT_SPEC),
    "odd": (5, 63, 17, 33, 19, 13, MTSpec(2.0, 3.0, 3, 5, 2, 7)),
    "ls40": (6, 64, 32, 32, 32, 32, MTSpec(2.0, 4.0, 5, 8, 3, 12)),
}
SHAPES = [(1, 1), (3, 7), (8, 1), (8, 7), (1, 7)]
SAMPLES = (5, 7, 9, 11)  # the four straight-through samples among the 12 outputs


def _scale(ref) -> float:
    return max(1.0, float(ref.abs().max())) if ref.numel() else 1.0


def _close(got, ref, rel: float, name: str) -> None:
    err = float((got.double() - ref.double()).abs().max()) if ref.numel() else 0.0
    assert err <= rel * _scale(ref), f"{name}: {err:.3g} > {rel} x {_scale(ref):.3g}"


def _case(width: str, B: int, T: int, seed: int, dtype=np.float32):
    """Weights (torch layout), inputs, ``init6`` and the four sites' noise,
    made by numpy from ``seed`` in ``dtype``: the forward's arguments."""
    A, E, HD, LD, C, R, spec = WIDTHS[width]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, dtype))  # noqa: E731
    weights = [t(rng.uniform(-1, 1, s) / np.sqrt(s[-1] if len(s) == 2 else C))
               for s in rmt.mt_weight_shapes(A, E, HD, LD, C, R, spec)]

    def onehot(c, k):
        x = np.zeros((B, c, k))
        x[np.arange(B)[:, None], np.arange(c), rng.integers(0, k, (B, c))] = 1.0
        return x.reshape(B, c * k)

    xs = [t(rng.uniform(-1, 1, (T, B, A))), t(rng.standard_normal((T, B, E))),
          t(rng.standard_normal((T, B, E)))]
    hd, ld = np.tanh(rng.standard_normal((B, HD))), np.tanh(rng.standard_normal((B, LD)))
    init6 = [t(hd), t(ld), t(onehot(spec.hs_class, spec.hs_category)),
             t(onehot(spec.ls_class, spec.ls_category)), t(np.arctanh(0.9 * hd)),
             t(np.arctanh(0.9 * ld))]
    gumbels = [t(rng.gumbel(size=(T, B, d))) for d in (spec.ls, spec.ls, spec.hs, spec.hs)]
    return weights, *xs, init6, gumbels, spec


def _categories(x, i: int, spec: MTSpec):
    c, k = (spec.ls_class, spec.ls_category) if i in (5, 7) else (spec.hs_class, spec.hs_category)
    return onehot_blocks(x, c, k)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_stages_equal_the_plain_forward_in_float64(width, B, T):
    """Prologue, chain and epilogue in a row give ``mt_recurrence_forward_plain``'s
    12 outputs: within 1e-10 × scale, every sample's category equal."""
    args = _case(width, B, T, seed=B * 10 + T, dtype=np.float64)
    ref = rmt.mt_recurrence_forward_plain(*args)
    got = rmt.mt_recurrence_forward_stages_plain(*args)
    assert len(got) == len(ref) == rmt.N_OUT
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype
        _close(g, r, 1e-10, f"out[{i}]")
        if i in SAMPLES:
            assert torch.equal(_categories(g, i, args[-1]), _categories(r, i, args[-1]))


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_stages_match_the_plain_forward_in_float32(width, B, T):
    """In float32, as the kernel runs: within 1e-5 × scale, samples equal
    outside near-ties of 1e-5 (a posterior's near-tie ends its row's
    comparison, since the sample is the next step's carry)."""
    args = _case(width, B, T, seed=B * 10 + T + 1)
    ref = rmt.mt_recurrence_forward_plain(*args)
    got = rmt.mt_recurrence_forward_stages_plain(*args)
    scale = max(_scale(r) for r in ref)
    r = parity.check_mt_recurrence(got, ref, args[5], args[6], atol=1e-5 * scale, tie_eps=1e-5)
    assert r["compared"] > 0.5


@pytest.mark.parametrize("width", list(WIDTHS))
def test_prologue_is_the_carry_free_columns(width):
    """The prologue's ``[T, B, LD + 2R]`` sums are the lower cell's input
    layer and the audio and vision first layers with the carries' columns
    zeroed: what the chain adds them to is then exactly the rest."""
    weights, actions, a_emb, v_emb, init6, gumbels, spec = _case(width, 3, 7, seed=3,
                                                                 dtype=np.float64)
    A, E, HD, LD, C, R, _ = WIDTHS[width]
    got = rmt.mt_fwd_inputs_plain(weights, actions, a_emb, v_emb, spec)
    assert got.shape == (7, 3, LD + 2 * R)
    zeros = lambda n: actions.new_zeros(7, 3, n)  # noqa: E731
    want = torch.cat([F.linear(torch.cat([actions, zeros(spec.ls + spec.hs)], -1), weights[2],
                               weights[3]),
                      F.linear(torch.cat([zeros(LD), a_emb], -1), weights[20], weights[21]),
                      F.linear(torch.cat([zeros(LD), v_emb], -1), weights[24], weights[25])], -1)
    _close(got, want, 1e-12, "prologue")


@pytest.mark.parametrize("width", list(WIDTHS))
def test_epilogue_reads_only_the_deters_and_the_priors_noise(width):
    """The epilogue over all row-steps at once, from the chain's deter
    sequences and the priors' noise alone, gives the plain forward's prior
    logits and samples (float64, 1e-10 × scale, categories equal); the chain
    gives the other eight outputs without the priors."""
    args = _case(width, 8, 7, seed=5, dtype=np.float64)
    weights, actions, a_emb, v_emb, init6, gumbels, spec = args
    ref = rmt.mt_recurrence_forward_plain(*args)
    inputs = rmt.mt_fwd_inputs_plain(weights, actions, a_emb, v_emb, spec)
    chain = rmt.mt_fwd_chain_plain(weights, inputs, init6, gumbels[1], gumbels[3], spec)
    for i, c in zip((0, 1, 2, 3, 6, 7, 10, 11), chain):
        _close(c, ref[i], 1e-10, f"chain out[{i}]")
    priors = rmt.mt_fwd_priors_plain(weights, chain[0], chain[1], gumbels[0], gumbels[2], spec)
    for i, p in zip((4, 5, 8, 9), priors):
        _close(p, ref[i], 1e-10, f"prior out[{i}]")
        if i in SAMPLES:
            assert torch.equal(_categories(p, i, spec), _categories(ref[i], i, spec))


def test_stages_of_an_empty_sequence():
    """T = 0: the stages return the plain forward's empty outputs."""
    args = _case("tiny", 3, 0, seed=1)
    got = rmt.mt_recurrence_forward_stages_plain(*args)
    ref = rmt.mt_recurrence_forward_plain(*args)
    assert [g.shape for g in got] == [r.shape for r in ref] and all(g.numel() == 0 for g in got)


@pytest.mark.parametrize("chunked", [False, True])
def test_stages_match_jax_pallas_forward(chunked, monkeypatch):
    """The three stages (float32) against JAX's ``fused_mt_train_recurrence``
    through the Pallas forward in interpret mode, single-block and with the
    VMEM budget shrunk to three time steps (``_fwd_kernel_chunked``), on the
    same weights (``[in, out]``), inputs and noise."""
    B, T = 3, 7
    weights, actions, a_emb, v_emb, init6, gumbels, spec = _case("tiny", B, T, seed=31 + chunked)
    if chunked:
        sizes = dict(action_size=actions.shape[-1], obs_embed_size=a_emb.shape[-1],
                     hd_dim=init6[0].shape[-1], ld_dim=init6[1].shape[-1], hs_size=spec.hs,
                     ls_size=spec.ls)
        per = (1 << 40) // jax_mt.mt_chunk_len(B, 1 << 40, **sizes)
        monkeypatch.setattr(jax_mt, "MT_VMEM_BUDGET_BYTES", 3 * per)
        assert 1 < jax_mt.mt_chunk_len(B, jax_mt.MT_VMEM_BUDGET_BYTES, **sizes) < T
    j = lambda ts: tuple(jnp.asarray(x.numpy()) for x in ts)  # noqa: E731
    packed = tuple(jnp.asarray(w.numpy().T if w.ndim == 2 else w.numpy()) for w in weights)
    ref = jax_mt.fused_mt_train_recurrence(
        packed, *j((actions, a_emb, v_emb)), j(init6), j(gumbels), l_tau=spec.l_tau,
        h_tau=spec.h_tau, ls_class=spec.ls_class, ls_category=spec.ls_category,
        hs_class=spec.hs_class, hs_category=spec.hs_category, interpret=True)
    got = rmt.mt_recurrence_forward_stages_plain(weights, actions, a_emb, v_emb, init6, gumbels,
                                                 spec)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = torch.tensor(np.array(r))
        if i in SAMPLES:
            assert torch.equal(_categories(g, i, spec), _categories(r, i, spec)), f"out[{i}]"
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-6, err_msg=f"out[{i}]")
        else:
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5, err_msg=f"out[{i}]")


def test_launch_refuses_cpu_tensors():
    """The kernel's wrapper and its stage launcher take CUDA tensors only:
    on the CPU the model's dispatch runs the plain version, and neither
    falls back to it."""
    args = _case("tiny", 3, 7, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        rmt.mt_recurrence_forward_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        rmt.mt_forward_launch(*args, stages=1)

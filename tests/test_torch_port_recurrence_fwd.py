"""The MRSSM recurrence forward as its kernel decomposes it, on the CPU.

``csrc/recurrence_fwd.cu`` runs the forward in three stages of one launch:
a prologue of every step's partial sums that no carry feeds (the action
columns of the transition's first layer, the embedding columns of the audio
and vision first layers, with their biases), the T-step chain on the deter
and posterior-sample carries alone, and an epilogue of the prior head and
its sample over all T steps. The stacked forward runs the same kernel on
the stacked tensors' non-zero blocks. Each stage has a plain version in
``ops/kernels/recurrence.py``; these tests hold the identities the kernel
relies on, on those plain versions:

- the three stages in a row equal ``recurrence_forward_plain`` in float64
  (within 1e-10 × max(1, max|plain|) per output: the same arithmetic in
  another association; the fusion runs in float32 in both, ``ops/fusion.py``)
  with the samples' categories equal;
- in float32 they match it within 1e-5 × scale, samples equal outside blocks
  whose top two scores lie within 1e-5 (``ops/kernels/parity.py``: a
  posterior's near-tie ends the comparison of its row);
- the prologue is the first layers with the carries' columns zeroed, and the
  epilogue reads nothing but the deter sequence and the prior's noise;
- they equal JAX's ``fused_train_recurrence`` through the Pallas forward in
  interpret mode, single-block and time-chunked (float32: 1e-5 absolute,
  categories equal, straight-through values within 1e-6);
- the stacked plain forward on the stacked tensors equals them in float64.

At B ∈ {1, 3, 8}, T ∈ {1, 7}, on tiny widths, the reference widths, odd
ones (A=5, E=63, H=19, D=17, 3 × 5 categories) and a latent wider than a
warp (5 × 8), with weights, inputs and noise made by numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu.ops.pallas import train_step as jax_ts
from multimodal_mtrssm_tpu_torch.ops.distributions import onehot_blocks
from multimodal_mtrssm_tpu_torch.ops.kernels import parity
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence as rec
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_stacked as rs

WIDTHS = {  # A, E, H, D, C, K
    "tiny": (3, 12, 16, 8, 2, 3),
    "reference": (6, 64, 32, 32, 4, 4),
    "odd": (5, 63, 19, 17, 3, 5),
    "s40": (6, 64, 32, 32, 5, 8),
}
SHAPES = [(1, 1), (3, 7), (8, 1), (8, 7), (1, 7)]
SAMPLES = (2, 4)  # the two straight-through samples among the five outputs


def _scale(ref) -> float:
    return max(1.0, float(ref.abs().max())) if ref.numel() else 1.0


def _close(got, ref, rel: float, name: str) -> None:
    err = float((got.double() - ref.double()).abs().max()) if ref.numel() else 0.0
    assert err <= rel * _scale(ref), f"{name}: {err:.3g} > {rel} x {_scale(ref):.3g}"


def _case(width: str, B: int, T: int, seed: int, dtype=np.float32):
    """Weights (torch layout), inputs, initial carries and both sites' noise,
    made by numpy from ``seed`` in ``dtype``: the forward's arguments."""
    A, E, H, D, C, K = WIDTHS[width]
    S = C * K
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, dtype))  # noqa: E731
    weights = [t(rng.uniform(-1, 1, s) / np.sqrt(s[-1] if len(s) == 2 else H))
               for s in rec.weight_shapes(A, S, H, D, E)]
    stoch0 = np.zeros((B, C, K))
    stoch0[np.arange(B)[:, None], np.arange(C), rng.integers(0, K, (B, C))] = 1.0
    ins = [t(a) for a in (rng.uniform(-1, 1, (T, B, A)), rng.standard_normal((T, B, E)),
                          rng.standard_normal((T, B, E)), np.tanh(rng.standard_normal((B, D))),
                          stoch0.reshape(B, S), rng.gumbel(size=(T, B, S)),
                          rng.gumbel(size=(T, B, S)))]
    return (weights, *ins, C, K)


def _categories(x, C: int, K: int):
    return onehot_blocks(x, C, K)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_stages_equal_the_plain_forward_in_float64(width, B, T):
    """Prologue, chain and epilogue in a row give ``recurrence_forward_plain``'s
    five outputs: within 1e-10 × scale, every sample's category equal."""
    args = _case(width, B, T, seed=B * 10 + T, dtype=np.float64)
    C, K = args[-2:]
    ref = rec.recurrence_forward_plain(*args)
    got = rec.recurrence_forward_stages_plain(*args)
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype
        _close(g, r, 1e-10, f"out[{i}]")
        if i in SAMPLES:
            assert torch.equal(_categories(g, C, K), _categories(r, C, K))


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_stages_match_the_plain_forward_in_float32(width, B, T):
    """In float32, as the kernel runs: within 1e-5 × scale, samples equal
    outside near-ties of 1e-5 (a posterior's near-tie ends its row's
    comparison, since the sample is the next step's carry)."""
    args = _case(width, B, T, seed=B * 10 + T + 1)
    ref = rec.recurrence_forward_plain(*args)
    got = rec.recurrence_forward_stages_plain(*args)
    scale = max(_scale(r) for r in ref)
    r = parity.check_recurrence(got, ref, args[6], args[7], *args[8:], atol=1e-5 * scale,
                                tie_eps=1e-5)
    assert r["compared"] > 0.5


@pytest.mark.parametrize("width", list(WIDTHS))
def test_prologue_is_the_carry_free_columns(width):
    """The prologue's ``[T, B, 3H]`` sums are the transition's first layer
    and the audio and vision first layers with the carries' columns zeroed:
    what the chain adds them to is then exactly the rest."""
    weights, actions, a_emb, v_emb, *_ = _case(width, 3, 7, seed=3, dtype=np.float64)
    A, E, H, D, C, K = WIDTHS[width]
    got = rec.fwd_inputs_plain(weights, actions, a_emb, v_emb)
    assert got.shape == (7, 3, 3 * H)
    zeros = lambda n: actions.new_zeros(7, 3, n)  # noqa: E731
    want = torch.cat([F.linear(torch.cat([actions, zeros(C * K)], -1), weights[0], weights[1]),
                      F.linear(torch.cat([zeros(D), a_emb], -1), weights[12], weights[13]),
                      F.linear(torch.cat([zeros(D), v_emb], -1), weights[16], weights[17])], -1)
    _close(got, want, 1e-12, "prologue")


@pytest.mark.parametrize("width", list(WIDTHS))
def test_epilogue_reads_only_the_deter_and_the_priors_noise(width):
    """The epilogue over all row-steps at once, from the chain's deter
    sequence and the prior's noise alone, gives the plain forward's prior
    logits and sample (float64, 1e-10 × scale, categories equal); the chain
    gives the other three outputs without the prior."""
    args = _case(width, 8, 7, seed=5, dtype=np.float64)
    weights, actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post, C, K = args
    ref = rec.recurrence_forward_plain(*args)
    inputs = rec.fwd_inputs_plain(weights, actions, a_emb, v_emb)
    chain = rec.fwd_chain_plain(weights, inputs, init_deter, init_stoch, g_post, C, K)
    for i, c in zip((0, 3, 4), chain):
        _close(c, ref[i], 1e-10, f"chain out[{i}]")
    priors = rec.fwd_priors_plain(weights, chain[0], g_prior, C, K)
    for i, p in zip((1, 2), priors):
        _close(p, ref[i], 1e-10, f"prior out[{i}]")
    assert torch.equal(_categories(priors[1], C, K), _categories(ref[2], C, K))


def test_stages_of_an_empty_sequence():
    """T = 0: the stages return the plain forward's empty outputs."""
    args = _case("tiny", 3, 0, seed=1)
    got = rec.recurrence_forward_stages_plain(*args)
    ref = rec.recurrence_forward_plain(*args)
    assert [g.shape for g in got] == [r.shape for r in ref] and all(g.numel() == 0 for g in got)


@pytest.mark.parametrize("width,B,T,chunked", [("tiny", 3, 7, False), ("tiny", 3, 7, True),
                                               ("odd", 8, 7, False)])
def test_stages_match_jax_pallas_forward(width, B, T, chunked, monkeypatch):
    """The three stages (float32) against JAX's ``fused_train_recurrence``
    through the Pallas forward in interpret mode, single-block and with the
    VMEM budget shrunk to three time steps (``_fwd_kernel_chunked``), on the
    same weights (``[in, out]``), inputs and noise."""
    args = _case(width, B, T, seed=31 + chunked)
    weights, actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post, C, K = args
    if chunked:
        sizes = dict(action_size=actions.shape[-1], stoch_size=C * K,
                     deter_size=init_deter.shape[-1], obs_embed_size=a_emb.shape[-1])
        per = (1 << 40) // jax_ts.chunk_len(B, 1 << 40, **sizes)
        monkeypatch.setattr(jax_ts, "VMEM_BUDGET_BYTES", 3 * per)
        assert 1 < jax_ts.chunk_len(B, jax_ts.VMEM_BUDGET_BYTES, **sizes) < T
    packed = tuple(jnp.asarray(w.numpy().T if w.ndim == 2 else w.numpy()) for w in weights)
    ref = jax_ts.fused_train_recurrence(
        packed, *(jnp.asarray(x.numpy()) for x in args[1:8]), class_size=C, category_size=K,
        interpret=True)
    got = rec.recurrence_forward_stages_plain(*args)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = torch.tensor(np.array(r))
        if i in SAMPLES:
            assert torch.equal(_categories(g, C, K), _categories(r, C, K)), f"out[{i}]"
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-6, err_msg=f"out[{i}]")
        else:
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5, err_msg=f"out[{i}]")


@pytest.mark.parametrize("width", list(WIDTHS))
def test_stacked_plain_forward_is_the_stages(width):
    """The stacked forward's plain version on ``stack_train_params``' tensors
    equals the three stages on the 20 tensors they were stacked from
    (float64, 1e-10 × scale, categories equal): the kernel the stacked
    forward packs its tensors for computes the same function."""
    args = _case(width, 8, 7, seed=11, dtype=np.float64)
    C, K = args[-2:]
    got = rs.recurrence_stacked_forward_plain(rs.stack_train_params(args[0]), *args[1:])
    ref = rec.recurrence_forward_stages_plain(*args)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, 1e-10, f"out[{i}]")
        if i in SAMPLES:
            assert torch.equal(_categories(g, C, K), _categories(r, C, K))


def test_launch_refuses_what_the_kernel_does_not_take():
    """Both forwards' wrappers and the stage launcher take CUDA tensors only
    (on the CPU the model's dispatch runs the plain version, and none falls
    back to it), and category blocks of at most 32."""
    args = _case("tiny", 3, 7, seed=2)
    st = rs.stack_train_params(args[0])
    for call in (lambda: rec.recurrence_forward_cuda(*args),
                 lambda: rec.forward_launch(*args, stages=1),
                 lambda: rs.recurrence_stacked_forward_cuda(st, *args[1:])):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    wide = _case("tiny", 2, 3, seed=4)
    with pytest.raises(ValueError, match="at most 32"):
        rec.recurrence_forward_cuda(*wide[:-2], 1, 33)

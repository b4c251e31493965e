"""Both imagination rollouts as their kernels decompose them, on the CPU.

``csrc/rollout.cu`` and ``csrc/rollout_mt.cu`` each run in stages of one
launch: a prologue of every step's carry-free work (the action columns of
the first layer with its bias, and the seed's Gumbel scores) into a
``[T, B, ·]`` workspace, and a chain on the deter (and integrator) carries
whose sample columns are, from the second step on, a gather of the weight
columns the one-hot carry selects. The MRSSM chain also folds the
transition's second layer into the GRU's input gates. Each piece has a plain
version in ``ops/kernels/rollout.py`` and ``rollout_mt.py``; these tests
hold the identities the kernels rely on, on those plain versions:

- the stages in a row equal ``rollout_plain`` / ``rollout_mt_plain`` in
  float64 (within 1e-10 × max(1, max|plain|) per output: the same
  arithmetic in another association) with every sample's category equal;
- in float32 they match them within 1e-5 × scale, samples equal, in each row
  up to its first block whose top two scores lie within 1e-5 (a sample is
  the next step's carry), and pass ``ops/kernels/parity.py``'s replay;
- the prologue's noise is ``philox_gumbel`` / ``philox_mt_gumbel`` bit for
  bit, and its sums are the first layer with the stoch columns zeroed;
- the gather equals the dense product only where the carry is one-hot: a
  straight-through initial stoch goes through the dense product at t = 0;
- forced to the JAX Pallas rollouts' samples (interpret mode), the plain
  chains give their deters, logits and integrators (float32: 1e-5).

At B ∈ {1, 3, 8}, T ∈ {1, 7}, on tiny widths, the reference widths (the
MMTRSSM's higher latent 2 × 8), odd ones with a 3 × 5 latent (K no power of
two) and a latent wider than a warp, with weights, inputs and actions made
by numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu.ops.pallas import rollout as jax_rollout
from multimodal_mtrssm_tpu.ops.pallas import rollout_mt as jax_rollout_mt
from multimodal_mtrssm_tpu_torch.ops.distributions import onehot_blocks
from multimodal_mtrssm_tpu_torch.ops.kernels import parity, rollout, rollout_mt
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt as rmt
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import weight_shapes
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence_mt import MTSpec

WIDTHS = {  # A, H, D, C, K
    "tiny": (3, 10, 12, 2, 4),
    "reference": (6, 32, 32, 4, 4),
    "odd": (5, 19, 17, 3, 5),
    "s40": (6, 32, 32, 5, 8),
}
MT_WIDTHS = {  # A, HD, LD, C, spec
    "tiny": (3, 8, 12, 16, MTSpec(2.0, 4.0, 2, 3, 2, 4)),
    "reference": (6, 32, 32, 32, rmt.MT_SPEC),
    "odd": (5, 17, 33, 19, MTSpec(2.0, 3.0, 3, 5, 2, 7)),
}
SHAPES = [(1, 1), (3, 7), (8, 1), (8, 7), (1, 7)]
SEED = 2**33 + 17  # both key words nonzero


def _scale(ref) -> float:
    return max(1.0, float(ref.abs().max())) if ref.numel() else 1.0


def _close(got, ref, rel: float, name: str) -> None:
    err = float((got.double() - ref.double()).abs().max()) if ref.numel() else 0.0
    assert err <= rel * _scale(ref), f"{name}: {err:.3g} > {rel} x {_scale(ref):.3g}"


def _onehot(rng, B: int, c: int, k: int) -> np.ndarray:
    x = np.zeros((B, c, k))
    x[np.arange(B)[:, None], np.arange(c), rng.integers(0, k, (B, c))] = 1.0
    return x.reshape(B, c * k)


def _straight_through(rng, B: int, c: int, k: int) -> np.ndarray:
    """``(onehot + p) - p`` of random logits in float32: the straight-through
    stoch an observe hands to imagine, not exactly one-hot."""
    logits = rng.standard_normal((B, c, k)).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    onehot = (logits == logits.max(-1, keepdims=True)).astype(np.float32)
    return ((onehot + p) - p).reshape(B, c * k)


def _case(width: str, B: int, T: int, seed: int, dtype=np.float32, straight=False):
    """The MRSSM rollout's 12 weights (torch layout), actions ``[B, T, A]``,
    initial deter and stoch, and the class and category counts."""
    A, H, D, C, K = WIDTHS[width]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, dtype))  # noqa: E731
    weights = [t(rng.uniform(-1, 1, s) / np.sqrt(s[-1] if len(s) == 2 else H))
               for s in weight_shapes(A, C * K, H, D, 0)[:rollout.N_WEIGHTS]]
    stoch0 = _straight_through(rng, B, C, K) if straight else _onehot(rng, B, C, K)
    return (weights, t(rng.uniform(-1, 1, (B, T, A))), t(np.tanh(rng.standard_normal((B, D)))),
            t(stoch0), C, K)


def _mt_case(width: str, B: int, T: int, seed: int, dtype=np.float32, straight=False):
    """The MMTRSSM rollout's 16 weights (torch layout), actions ``[B, T,
    A]``, ``init6`` and the spec."""
    A, HD, LD, C, spec = MT_WIDTHS[width]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, dtype))  # noqa: E731
    weights = [t(rng.uniform(-1, 1, s) / np.sqrt(s[-1] if len(s) == 2 else C))
               for s in rmt.mt_weight_shapes(A, 0, HD, LD, C, 0, spec)[:rollout_mt.N_WEIGHTS]]
    stoch = _straight_through if straight else _onehot
    hd, ld = np.tanh(rng.standard_normal((B, HD))), np.tanh(rng.standard_normal((B, LD)))
    init6 = [t(hd), t(ld), t(stoch(rng, B, spec.hs_class, spec.hs_category)),
             t(stoch(rng, B, spec.ls_class, spec.ls_category)), t(np.arctanh(0.9 * hd)),
             t(np.arctanh(0.9 * ld))]
    return weights, t(rng.uniform(-1, 1, (B, T, A))), init6, spec


def _first_ties(scores, c: int, k: int) -> torch.Tensor:
    """``[B]``: each row's first step with a block whose top two scores
    (``[B, T, c·k]``) lie within 1e-5 (T where none does)."""
    T = scores.shape[1]
    tie = parity.near_ties(scores, c, k, 1e-5).any(-1)
    return torch.where(tie, torch.arange(T), T).amin(1)


def _compare_up_to_ties(got, ref, first, stochs, rel: float) -> None:
    """Each row's outputs within ``rel`` × scale up to and including its
    first near-tie, and its samples (``stochs``: their indices) equal before
    it."""
    steps = torch.arange(ref[0].shape[1])[None]
    upto, before = steps <= first[:, None], steps < first[:, None]
    for i, (g, r) in enumerate(zip(got, ref)):
        if i in stochs:
            assert torch.equal(g[before], r[before]), f"out[{i}]"
        else:
            _close(g[upto], r[upto], rel, f"out[{i}]")


# ---- the MRSSM rollout ---------------------------------------------------------------


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_stages_equal_the_plain_rollout_in_float64(width, B, T):
    """Prologue and chain in a row give ``rollout_plain``'s deters, logits
    and stochs: within 1e-10 × scale, every sample's category equal."""
    args = _case(width, B, T, seed=B * 10 + T, dtype=np.float64)
    ref = rollout.rollout_plain(*args[:4], SEED, *args[4:])
    got = rollout.rollout_stages_plain(*args[:4], SEED, *args[4:])
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype
        _close(g, r, 1e-10, f"out[{i}]")
    assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_stages_match_the_plain_rollout_in_float32(width, B, T):
    """In float32, as the kernel runs: within 1e-5 × scale of
    ``rollout_plain`` up to each row's first near-tie of 1e-5, stochs equal
    before it; and the replay of ``parity.check_rollout``."""
    weights, actions, deter0, stoch0, C, K = _case(width, B, T, seed=B * 10 + T + 1)
    ref = rollout.rollout_plain(weights, actions, deter0, stoch0, SEED, C, K)
    got = rollout.rollout_stages_plain(weights, actions, deter0, stoch0, SEED, C, K)
    noise = rollout.philox_gumbel(SEED, T, B, C, K).transpose(0, 1)
    _compare_up_to_ties(got, ref, _first_ties(ref[1] + noise, C, K), (2,), 1e-5)
    scale = max(_scale(r) for r in ref)
    r = parity.check_rollout(weights, actions, deter0, stoch0, SEED, got, C, K,
                             atol=1e-5 * scale, tie_eps=1e-5)
    assert r["compared"] > 0.5


@pytest.mark.parametrize("width", list(WIDTHS))
def test_prologue_is_the_action_columns_and_the_seed_noise(width):
    """The prologue's ``[T, B, H + S]`` rows: the transition's first layer
    with the stoch columns zeroed, then ``philox_gumbel`` bit for bit."""
    weights, actions, _, _, C, K = _case(width, 3, 7, seed=3)
    H, S = weights[0].shape[0], C * K
    got = rollout.rollout_inputs_plain(weights, actions, SEED, C, K)
    assert got.shape == (7, 3, H + S)
    x = torch.cat([actions, actions.new_zeros(3, 7, S)], -1).transpose(0, 1)
    _close(got[..., :H], F.linear(x, weights[0], weights[1]), 1e-6, "action sums")
    assert torch.equal(got[..., H:], rollout.philox_gumbel(SEED, 7, 3, C, K))


@pytest.mark.parametrize("width", list(WIDTHS))
def test_gather_is_the_dense_product_on_one_hot_carries_only(width):
    """``gather_columns`` of a one-hot carry's chosen columns is its dense
    product (float64, 1e-12); on a straight-through stoch it is not, so the
    chain takes the dense product at t = 0 and equals ``rollout_plain``
    from a straight-through stoch (1e-10 × scale)."""
    weights, actions, deter0, stoch0, C, K = _case(width, 8, 7, seed=5, dtype=np.float64)
    w1s = weights[0][:, weights[0].shape[1] - C * K:]
    onehot, cols = rollout.sample_plain(stoch0, torch.zeros_like(stoch0), C, K)
    assert torch.equal(onehot, stoch0)
    _close(rollout.gather_columns(w1s, cols), F.linear(stoch0, w1s), 1e-12, "gather")
    args = _case(width, 8, 7, seed=5, dtype=np.float64, straight=True)
    st = args[3]
    assert not bool(((st == 0) | (st == 1)).all())
    _, st_cols = rollout.sample_plain(st, torch.zeros_like(st), C, K)
    assert float((rollout.gather_columns(w1s, st_cols) - F.linear(st, w1s)).abs().max()) > 1e-9
    ref = rollout.rollout_plain(*args[:4], SEED, C, K)
    got = rollout.rollout_stages_plain(*args[:4], SEED, C, K)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, 1e-10, f"out[{i}]")


@pytest.mark.parametrize("C,K", [(4, 4), (3, 5), (2, 8), (1, 33)])
def test_sample_on_precomputed_noise(C, K):
    """``sample_plain``: the first-index one-hot argmax of logits + noise per
    block, and each block's chosen column in the flat latent (ties to the
    first index)."""
    rng = np.random.default_rng(C * K)
    logits = torch.tensor(rng.standard_normal((5, C * K)))
    noise = torch.tensor(rng.gumbel(size=(5, C * K)))
    onehot, cols = rollout.sample_plain(logits, noise, C, K)
    assert torch.equal(onehot, onehot_blocks(logits + noise, C, K))
    assert torch.equal(onehot.nonzero()[:, 1].reshape(5, C), cols)
    tie = torch.zeros(1, C * K)
    _, first = rollout.sample_plain(tie, tie, C, K)
    assert torch.equal(first, torch.arange(C)[None] * K)


def test_stages_of_an_empty_sequence():
    """T = 0: the stages return the plain rollout's empty outputs."""
    args = _case("tiny", 3, 0, seed=1)
    got = rollout.rollout_stages_plain(*args[:4], SEED, *args[4:])
    ref = rollout.rollout_plain(*args[:4], SEED, *args[4:])
    assert [g.shape for g in got] == [r.shape for r in ref] and all(g.numel() == 0 for g in got)


@pytest.mark.parametrize("width", ["tiny", "odd"])
def test_chain_replays_the_jax_pallas_rollout(width):
    """JAX's ``fused_rollout_transition`` (Pallas, interpret mode) draws its
    own samples; with noise that forces them, the plain chain on the plain
    prologue's sums gives its deters, logits and stochs (float32: 1e-5,
    stochs equal)."""
    weights, actions, deter0, stoch0, C, K = _case(width, 3, 7, seed=11)
    packed = tuple(jnp.asarray(w.numpy().T if w.ndim == 2 else w.numpy()) for w in weights)
    ref = jax_rollout.fused_rollout_transition(
        packed, jnp.asarray(actions.numpy()), jnp.asarray(deter0.numpy()),
        jnp.asarray(stoch0.numpy()), jnp.int32(5), class_size=C, category_size=K, interpret=True)
    ref = [torch.tensor(np.array(r)) for r in ref]
    H = weights[0].shape[0]
    inputs = rollout.rollout_inputs_plain(weights, actions, SEED, C, K)
    inputs[..., H:] = 1e3 * ref[2].transpose(0, 1)
    got = rollout.rollout_chain_plain(weights, inputs, deter0, stoch0, C, K)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5, err_msg=f"out[{i}]")
    assert torch.equal(got[2], ref[2])


def test_launch_refuses_cpu_tensors():
    """The kernel's wrapper and its stage launcher take CUDA tensors only:
    on the CPU the dispatch runs the plain version, and neither falls back
    to it."""
    weights, actions, deter0, stoch0, C, K = _case("tiny", 3, 7, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        rollout.rollout_cuda(weights, actions, deter0, stoch0, 5, C, K)
    with pytest.raises(ValueError, match="CUDA"):
        rollout.rollout_launch(weights, actions, deter0, stoch0, 5, C, K, stages=1)


# ---- the MMTRSSM rollout -------------------------------------------------------------

MT_STOCHS = (4, 5)  # h_stoch, l_stoch among the eight outputs


@pytest.mark.parametrize("width", list(MT_WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_mt_stages_equal_the_plain_rollout_in_float64(width, B, T):
    """Prologue and chain in a row give ``rollout_mt_plain``'s eight
    outputs: within 1e-10 × scale, both sites' samples equal."""
    weights, actions, init6, spec = _mt_case(width, B, T, seed=B * 10 + T, dtype=np.float64)
    ref = rollout_mt.rollout_mt_plain(weights, actions, init6, SEED, spec)
    got = rollout_mt.rollout_mt_stages_plain(weights, actions, init6, SEED, spec)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype
        _close(g, r, 1e-10, f"out[{i}]")
        if i in MT_STOCHS:
            assert torch.equal(g, r), f"out[{i}]"


@pytest.mark.parametrize("width", list(MT_WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_mt_stages_match_the_plain_rollout_in_float32(width, B, T):
    """In float32: within 1e-5 × scale of ``rollout_mt_plain`` up to each
    row's first near-tie of 1e-5 at either site, samples equal before it;
    and the replay of ``parity.check_mt_rollout``."""
    weights, actions, init6, spec = _mt_case(width, B, T, seed=B * 10 + T + 1)
    ref = rollout_mt.rollout_mt_plain(weights, actions, init6, SEED, spec)
    got = rollout_mt.rollout_mt_stages_plain(weights, actions, init6, SEED, spec)
    g_l, g_h = rollout_mt.philox_mt_gumbel(SEED, T, B, (spec.ls_class, spec.ls_category),
                                           (spec.hs_class, spec.hs_category))
    first = torch.minimum(
        _first_ties(ref[3] + g_l.transpose(0, 1), spec.ls_class, spec.ls_category),
        _first_ties(ref[2] + g_h.transpose(0, 1), spec.hs_class, spec.hs_category))
    _compare_up_to_ties(got, ref, first, MT_STOCHS, 1e-5)
    scale = max(_scale(r) for r in ref)
    r = parity.check_mt_rollout(weights, actions, init6, SEED, got, spec, atol=1e-5 * scale,
                                tie_eps=1e-5)
    assert r["compared"] > 0.5


@pytest.mark.parametrize("width", list(MT_WIDTHS))
def test_mt_prologue_is_the_action_columns_and_the_seed_noise(width):
    """The prologue's ``[T, B, LD + LS + HS]`` rows: the lower cell's input
    layer with the sample columns zeroed, then ``philox_mt_gumbel``'s two
    sites bit for bit."""
    weights, actions, _, spec = _mt_case(width, 3, 7, seed=3)
    LD = weights[0].shape[0]
    got = rollout_mt.rollout_mt_inputs_plain(weights, actions, SEED, spec)
    assert got.shape == (7, 3, LD + spec.ls + spec.hs)
    x = torch.cat([actions, actions.new_zeros(3, 7, spec.ls + spec.hs)], -1).transpose(0, 1)
    _close(got[..., :LD], F.linear(x, weights[2], weights[3]), 1e-6, "action sums")
    g_l, g_h = rollout_mt.philox_mt_gumbel(SEED, 7, 3, (spec.ls_class, spec.ls_category),
                                           (spec.hs_class, spec.hs_category))
    assert torch.equal(got[..., LD:], torch.cat([g_l, g_h], -1))


@pytest.mark.parametrize("width", list(MT_WIDTHS))
def test_mt_gather_is_the_dense_product_on_one_hot_carries_only(width):
    """Both cells' sample columns: the gather of the one-hot carries' chosen
    columns is their dense product (float64, 1e-12), on straight-through
    stochs it is not, and the chain from straight-through stochs equals
    ``rollout_mt_plain`` (1e-10 × scale): its first step goes dense."""
    weights, actions, init6, spec = _mt_case(width, 8, 7, seed=5, dtype=np.float64)
    wlx = weights[2][:, weights[2].shape[1] - spec.ls - spec.hs:]
    hs, ls = init6[2], init6[3]

    def cols_of(h, lo):
        _, lc = rollout.sample_plain(lo, torch.zeros_like(lo), spec.ls_class, spec.ls_category)
        _, hc = rollout.sample_plain(h, torch.zeros_like(h), spec.hs_class, spec.hs_category)
        return torch.cat([lc, hc + spec.ls], -1)

    cols = cols_of(hs, ls)
    _close(rollout.gather_columns(wlx, cols), F.linear(torch.cat([ls, hs], -1), wlx), 1e-12,
           "lower gather")
    _close(rollout.gather_columns(weights[6], cols[:, spec.ls_class:] - spec.ls),
           F.linear(hs, weights[6]), 1e-12, "higher gather")
    weights, actions, init6, spec = _mt_case(width, 8, 7, seed=5, dtype=np.float64, straight=True)
    hs, ls = init6[2], init6[3]
    dense = F.linear(torch.cat([ls, hs], -1), wlx)
    assert float((rollout.gather_columns(wlx, cols_of(hs, ls)) - dense).abs().max()) > 1e-9
    ref = rollout_mt.rollout_mt_plain(weights, actions, init6, SEED, spec)
    got = rollout_mt.rollout_mt_stages_plain(weights, actions, init6, SEED, spec)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, 1e-10, f"out[{i}]")


def test_mt_stages_of_an_empty_sequence():
    """T = 0: the stages return the plain rollout's empty outputs."""
    weights, actions, init6, spec = _mt_case("tiny", 3, 0, seed=1)
    got = rollout_mt.rollout_mt_stages_plain(weights, actions, init6, SEED, spec)
    ref = rollout_mt.rollout_mt_plain(weights, actions, init6, SEED, spec)
    assert [g.shape for g in got] == [r.shape for r in ref] and all(g.numel() == 0 for g in got)


@pytest.mark.parametrize("width", ["tiny", "reference"])
def test_mt_chain_replays_the_jax_pallas_rollout(width):
    """JAX's ``fused_mt_rollout_transition`` (Pallas, interpret mode) draws
    its own samples; with noise that forces them at both sites, the plain
    chain on the plain prologue's sums gives its eight outputs (float32:
    1e-5, stochs equal)."""
    weights, actions, init6, spec = _mt_case(width, 3, 7, seed=13)
    packed = tuple(jnp.asarray(w.numpy().T if w.ndim == 2 else w.numpy()) for w in weights)
    ref = jax_rollout_mt.fused_mt_rollout_transition(
        packed, jnp.asarray(actions.numpy()), tuple(jnp.asarray(x.numpy()) for x in init6),
        jnp.int32(5), l_tau=spec.l_tau, h_tau=spec.h_tau, ls_class=spec.ls_class,
        ls_category=spec.ls_category, hs_class=spec.hs_class, hs_category=spec.hs_category,
        interpret=True)
    ref = [torch.tensor(np.array(r)) for r in ref]
    LD = weights[0].shape[0]
    inputs = rollout_mt.rollout_mt_inputs_plain(weights, actions, SEED, spec)
    inputs[..., LD:] = 1e3 * torch.cat([ref[5], ref[4]], -1).transpose(0, 1)
    got = rollout_mt.rollout_mt_chain_plain(weights, inputs, init6, spec)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5, err_msg=f"out[{i}]")
        if i in MT_STOCHS:
            assert torch.equal(g, r), f"out[{i}]"


def test_mt_launch_refuses_cpu_tensors():
    """As the MRSSM rollout's: CUDA tensors only, no fallback."""
    weights, actions, init6, spec = _mt_case("tiny", 3, 7, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        rollout_mt.rollout_mt_cuda(weights, actions, init6, 5, spec)
    with pytest.raises(ValueError, match="CUDA"):
        rollout_mt.rollout_mt_launch(weights, actions, init6, 5, spec, stages=1)

"""The stacked MRSSM recurrence backward as its kernels compose it, on the CPU.

``csrc/recurrence_stacked_bwd.cu`` runs the MRSSM backward's three passes
(``csrc/recurrence_bwd.cu``) on the stacked tensors' non-zero blocks: a pack
copies them into the 20-tensor layout, the passes run on that copy, a
scatter writes the 20 gradients into the non-zero blocks of the stacked
gradients. ``ops/kernels/recurrence_stacked.py`` has the composition in
plain PyTorch (``recurrence_stacked_backward_passes_plain``); these tests
hold it and its two maps:

- the pack and the scatter in plain form (``unstack_train_grads`` on the
  stacked weights, ``stack_train_params`` on 20 gradients) equal JAX's
  ``train_step_stacked.unstack_train_grads``/``stack_train_params``,
  transposed to torch's layout, exactly, at the reference widths and at odd
  ones whose stacked rows are no multiple of 4 floats and whose ``wv1`` is
  split raggedly around the audio embedding's columns; the pack of a stack
  gives back the 20 tensors exactly;
- the composition equals the autograd replay of the stacked forward
  (``recurrence_stacked_backward_plain``) on the non-zero blocks, and
  ``jax.grad`` through ``fused_train_recurrence_stacked`` with its Pallas
  kernels in interpret mode, both within 1e-5 × max(1, max|reference|) per
  tensor (float32, sums in another order; the bound of
  ``tests/test_torch_port_stacked.py``'s VJP test);
- the zero blocks of its stacked gradients are exactly 0.

Weights, inputs, noise and cotangents are made by numpy from a seed; JAX's
``[in, out]`` weights reach the port transposed to torch's ``[out, in]``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.ops.pallas import train_step_stacked as jax_stacked
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence as rec
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_stacked as rs

WIDTHS = {  # A, E, H, D, C, K
    "tiny": (3, 12, 16, 8, 2, 3),
    "narrow": (6, 10, 12, 8, 4, 4),
    "reference": (6, 64, 32, 32, 4, 4),
    "odd": (5, 63, 33, 17, 3, 5),
}


def _jax_layout(widths: str, seed: int) -> list[np.ndarray]:
    """The 20 recurrence weights in JAX's ``[in, out]`` layout."""
    A, E, H, D, C, K = WIDTHS[widths]
    S = C * K
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, s[::-1]) / np.sqrt(s[-1] if len(s) == 2 else H)).astype(np.float32)
            for s in rec.weight_shapes(A, S, H, D, E)]


def _torch(arrays) -> list[torch.Tensor]:
    """JAX-layout arrays as torch-layout tensors (matrices transposed)."""
    return [torch.from_numpy(np.array(np.asarray(a).T, order="C")) for a in arrays]


def _dims(widths: str) -> tuple[int, int, int, int]:
    A, E, H, D, _, _ = WIDTHS[widths]
    return A, H, D, E


def _close(got: torch.Tensor, ref: torch.Tensor, name: str, rel: float = 1e-5) -> None:
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    assert err <= rel * scale, f"{name}: {err:.3g} > {rel} x {scale:.3g}"


def _case(widths: str, B: int, T: int, seed: int):
    """Stacked weights (torch layout), forward inputs, the plain stacked
    forward's record as carries into each step, and cotangents on its five
    outputs; with the JAX-layout weights and the numpy arrays."""
    A, E, H, D, C, K = WIDTHS[widths]
    S = C * K
    packed = _jax_layout(widths, seed)
    rng = np.random.default_rng(seed + 1)
    stoch0 = np.zeros((B, C, K), np.float32)
    stoch0[np.arange(B)[:, None], np.arange(C), rng.integers(0, K, (B, C))] = 1.0
    ins = [np.asarray(a, np.float32) for a in (
        rng.uniform(-1, 1, (T, B, A)), rng.standard_normal((T, B, E)),
        rng.standard_normal((T, B, E)), np.tanh(rng.standard_normal((B, D))),
        stoch0.reshape(B, S), rng.gumbel(size=(T, B, S)), rng.gumbel(size=(T, B, S)))]
    cots = [rng.standard_normal((T, B, d)).astype(np.float32) for d in (D, S, S, S, S)]
    stacked = rs.stack_train_params(_torch(packed))
    x = [torch.from_numpy(a) for a in ins]
    with torch.no_grad():
        outs = rs.recurrence_stacked_forward_plain(stacked, *x, C, K)
    prev_deter = torch.cat([x[3][None], outs[0][:-1]])
    prev_stoch = torch.cat([x[4][None], outs[4][:-1]])
    args = (stacked, *x[:3], prev_deter, prev_stoch, [torch.from_numpy(c) for c in cots], C, K)
    return args, packed, ins, cots


def _nonzero_blocks(widths: str) -> list[torch.Tensor]:
    """Per stacked tensor, True where a non-zero block lies."""
    A, E, H, D, C, K = WIDTHS[widths]
    ones = [torch.ones(s) for s in rec.weight_shapes(A, C * K, H, D, E)]
    return [m.bool() for m in rs.stack_train_params(ones)]


# ---- the pack and the scatter ------------------------------------------------------------


@pytest.mark.parametrize("widths", ["reference", "odd"])
def test_pack_map_equals_jax_unstack(widths):
    """The pack's map (the 20 tensors' elements in the stacked ones) is
    JAX's ``unstack_train_grads`` on JAX's stacked weights, transposed, and
    gives back the 20 tensors the stack was made from: exactly."""
    packed = _jax_layout(widths, seed=1)
    jax_st = jax_stacked.stack_train_params(tuple(map(jnp.asarray, packed)))
    ref = jax_stacked.unstack_train_grads(jax_st, _dims(widths))
    got = rs.unstack_train_grads(_torch(jax_st), _dims(widths))
    assert len(got) == len(ref) == rec.N_WEIGHTS
    for i, (g, r, w) in enumerate(zip(got, ref, packed)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).T, err_msg=f"pack[{i}]")
        np.testing.assert_array_equal(g.numpy(), w.T, err_msg=f"pack[{i}] of the stack")


@pytest.mark.parametrize("widths", ["reference", "odd"])
def test_scatter_map_equals_jax_stack(widths):
    """The scatter's map (the 20 gradients into the non-zero blocks) is
    JAX's ``stack_train_params`` on 20 gradients, transposed: exactly, with
    every zero block 0."""
    grads = _jax_layout(widths, seed=2)
    ref = jax_stacked.stack_train_params(tuple(map(jnp.asarray, grads)))
    got = rs.stack_train_params(_torch(grads))
    assert len(got) == len(ref) == rs.N_STACKED
    for i, (g, r, m) in enumerate(zip(got, ref, _nonzero_blocks(widths))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).T, err_msg=f"scatter[{i}]")
        assert not g[~m].any(), f"scatter[{i}]: a zero block holds a value"


@pytest.mark.parametrize("widths", ["reference", "odd"])
def test_scatter_of_the_pack_keeps_only_the_non_zero_blocks(widths):
    """Scatter after pack is the identity on the non-zero blocks of any
    stacked tensors and 0 on the zero blocks; the blocks tile each stacked
    tensor without overlap (their elements add up to the 20 tensors')."""
    A, E, H, D, C, K = WIDTHS[widths]
    S = C * K
    rng = np.random.default_rng(3)
    full = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in rs.stacked_shapes(A, S, H, D, E)]
    back = rs.stack_train_params(rs.unstack_train_grads(full, _dims(widths)))
    masks = _nonzero_blocks(widths)
    assert sum(int(m.sum()) for m in masks) == sum(
        int(np.prod(s)) for s in rec.weight_shapes(A, S, H, D, E))
    for i, (b, f, m) in enumerate(zip(back, full, masks)):
        assert torch.equal(b[m], f[m]) and not b[~m].any(), f"stacked[{i}]"


# ---- the composition -------------------------------------------------------------------


@pytest.mark.parametrize("widths", ["tiny", "reference", "odd"])
@pytest.mark.parametrize("B,T", [(1, 1), (3, 7), (8, 4)])
def test_passes_equal_the_autograd_replay(widths, B, T):
    """Pack, the three plain passes and the scatter give the autograd
    replay's gradients on the non-zero blocks and its five input
    cotangents; the zero blocks hold exactly 0."""
    args, _, _, _ = _case(widths, B, T, seed=B * 10 + T)
    got = rs.recurrence_stacked_backward_passes_plain(*args)
    ref = rs.recurrence_stacked_backward_plain(*args)
    assert len(got) == len(ref) == rs.N_STACKED + 5
    for i, (g, r, m) in enumerate(zip(got, ref, _nonzero_blocks(widths))):
        assert g.shape == r.shape
        _close(g[m], r[m], f"stacked gradient {i}")
        assert not g[~m].any(), f"stacked gradient {i}: a zero block is not 0"
    for name, g, r in zip(("actions", "a_emb", "v_emb", "init_deter", "init_stoch"),
                          got[rs.N_STACKED:], ref[rs.N_STACKED:]):
        assert g.shape == r.shape
        _close(g, r, name)


@pytest.mark.parametrize("widths", ["tiny", "reference"])
def test_passes_unstacked_are_the_unstacked_passes(widths):
    """On the CPU too the composition is the unstacked passes on the packed
    weights: its gradients, unstacked, equal
    ``recurrence_backward_passes_plain``'s on the 20 tensors bit for bit."""
    args, packed, _, _ = _case(widths, 3, 5, seed=5)
    got = rs.recurrence_stacked_backward_passes_plain(*args)
    ref = rec.recurrence_backward_passes_plain(_torch(packed), *args[1:])
    unstacked = rs.unstack_train_grads(got[:rs.N_STACKED], _dims(widths))
    for i, (g, r) in enumerate(zip((*unstacked, *got[rs.N_STACKED:]), ref)):
        assert torch.equal(g, r), f"gradient {i}"


@pytest.mark.parametrize("widths,B,T", [("tiny", 3, 5), ("narrow", 3, 5), ("narrow", 5, 7)])
def test_passes_match_jax_stacked_pallas_backward(widths, B, T):
    """The composition against ``jax.grad`` of Σ outputs · cotangents
    through JAX's ``fused_train_recurrence_stacked`` (the Pallas kernels in
    interpret mode) on the same weights, inputs and noise: the 20 weight
    gradients (the non-zero blocks, unstacked) and the 5 input gradients."""
    args, packed, ins, cots = _case(widths, B, T, seed=B * 10 + T + 1)
    C, K = WIDTHS[widths][4:]

    def loss(packed, actions, a_emb, v_emb, init_deter, init_stoch):
        outs = jax_stacked.fused_train_recurrence_stacked(
            packed, actions, a_emb, v_emb, init_deter, init_stoch, jnp.asarray(ins[5]),
            jnp.asarray(ins[6]), class_size=C, category_size=K, interpret=True)
        return sum(jnp.sum(o * c) for o, c in zip(outs, map(jnp.asarray, cots)))

    d_packed, *d_ins = jax.grad(loss, argnums=tuple(range(6)))(
        tuple(map(jnp.asarray, packed)), *map(jnp.asarray, ins[:5]))
    got = rs.recurrence_stacked_backward_passes_plain(*args)
    unstacked = rs.unstack_train_grads(got[:rs.N_STACKED], _dims(widths))
    for i, (g, r) in enumerate(zip(unstacked, _torch(d_packed))):
        _close(g, r, f"weights[{i}]")
    for name, g, r in zip(("actions", "a_emb", "v_emb", "init_deter", "init_stoch"),
                          got[rs.N_STACKED:], d_ins):
        _close(g, torch.from_numpy(np.asarray(r)), name)


def test_the_cuda_wrapper_refuses_cpu_tensors():
    """On CPU tensors the kernels' wrapper raises and counts no launch: the
    CPU runs the plain version only through ``RecurrenceStackedFunction``'s
    dispatch."""
    args, _, _, _ = _case("tiny", 2, 3, seed=9)
    before = rs.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        rs.recurrence_stacked_backward_cuda(*args)
    assert rs.bwd_launches == before

"""The MMTRSSM recurrence backward as its three kernels decompose it, on the CPU.

``csrc/recurrence_mt_bwd.cu`` splits the backward into a parallel recompute
of every row-step (with what of the VJP needs no carry: both prior heads'
backward), a reverse-time chain that carries only the six carries (d h_deter,
d l_deter, d hs, d ls and both integrators'), and the 28 weight gradients as
one GEMM over the T·B row-steps, summed in a fixed chunk order. Each pass
has a plain version in ``ops/kernels/recurrence_mt.py``; these tests hold the
identities the kernels rely on, on those plain versions:

- the recompute of all T·B row-steps at once gives the forward's values
  (float32, as the forward runs: within 1e-5 × max(1, max|forward|), the
  same arithmetic in another op order);
- the chain plus pass 3's GEMMs (the weight gradients in its chunk order,
  the input cotangents that feed no carry as row products) equals
  ``mt_recurrence_backward_plain``, the autograd replay (float64: within
  1e-6 × max(1, max|plain|) per gradient; the replay's fusion runs in
  float32, ``ops/fusion.py``), and a direct sum over the row-steps (float64,
  1e-12 × scale); both MTRNN cells' two bias gradients are bit-equal;
- it equals ``jax.grad`` through ``train_step_mt.py``'s Pallas backward in
  interpret mode, single-block and time-chunked (float32, 2e-4 × scale, the
  bound ``tests/test_torch_port_mt_kernels.py`` holds the recurrence VJP
  to), at tiny widths.

At B ∈ {1, 3, 8}, T ∈ {1, 7}, on tiny widths, the reference widths and odd
ones (HD=17 ≠ LD=33, 3 × 5 and 2 × 7 categories), with weights, inputs and
cotangents made by numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.ops.pallas import train_step_mt as jax_mt
from multimodal_mtrssm_tpu_torch.ops.distributions import block_probs
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt as rmt
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import record_field
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence_mt import MTSpec

WIDTHS = {  # A, E, HD, LD, C, R, spec
    "tiny": (3, 12, 8, 12, 16, 10, MTSpec(2.0, 4.0, 2, 3, 2, 4)),
    "reference": (6, 64, 32, 32, 32, 32, rmt.MT_SPEC),
    "odd": (5, 63, 17, 33, 19, 13, MTSpec(2.0, 3.0, 3, 5, 2, 7)),
}
SHAPES = [(1, 1), (3, 7), (8, 1), (8, 7), (1, 7)]


def _scale(ref) -> float:
    return max(1.0, float(ref.abs().max())) if ref.numel() else 1.0


def _close(got, ref, rel: float, name: str) -> None:
    err = float((got.double() - ref.double()).abs().max()) if ref.numel() else 0.0
    assert err <= rel * _scale(ref), f"{name}: {err:.3g} > {rel} x {_scale(ref):.3g}"


def _case(width: str, B: int, T: int, seed: int):
    """Weights (torch layout), forward inputs, the float32 forward record and
    cotangents on its 12 outputs, made by numpy from ``seed``: the backward's
    arguments, the inputs (``xs``, ``init6``, ``gumbels``) and the outputs."""
    A, E, HD, LD, C, R, spec = WIDTHS[width]
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    weights = [f32(rng.uniform(-1, 1, s) / np.sqrt(s[-1] if len(s) == 2 else C))
               for s in rmt.mt_weight_shapes(A, E, HD, LD, C, R, spec)]

    def onehot(c, k):
        x = np.zeros((B, c, k), np.float32)
        x[np.arange(B)[:, None], np.arange(c), rng.integers(0, k, (B, c))] = 1.0
        return x.reshape(B, c * k)

    xs = [f32(rng.uniform(-1, 1, (T, B, A))), f32(rng.standard_normal((T, B, E))),
          f32(rng.standard_normal((T, B, E)))]
    hd, ld = np.tanh(rng.standard_normal((B, HD))), np.tanh(rng.standard_normal((B, LD)))
    init6 = [f32(hd), f32(ld), f32(onehot(spec.hs_class, spec.hs_category)),
             f32(onehot(spec.ls_class, spec.ls_category)), f32(np.arctanh(0.9 * hd)),
             f32(np.arctanh(0.9 * ld))]
    gumbels = [f32(rng.gumbel(size=(T, B, d))) for d in (spec.ls, spec.ls, spec.hs, spec.hs)]
    with torch.no_grad():
        outs = rmt.mt_recurrence_forward_plain(weights, *xs, init6, gumbels, spec)
    cots = [f32(rng.standard_normal(tuple(o.shape))) for o in outs]
    prev6 = rmt.shift_carries(init6, rmt.carries(outs))
    return (weights, *xs, prev6, cots, spec), (xs, init6, gumbels), outs


def _double(args):
    weights, actions, a_emb, v_emb, prev6, cots, spec = args
    d = lambda xs: [x.double() for x in xs]  # noqa: E731
    return (d(weights), *d((actions, a_emb, v_emb)), d(prev6), d(cots), spec)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_recompute_of_every_row_step_is_the_forward(width, B, T):
    """Pass 1 recomputes all T·B row-steps at once from the stored carries:
    both deters and integrators, the four sites' logits and the posteriors'
    block probs are the forward's; the records hold them field for field."""
    args, _, outs = _case(width, B, T, seed=B * 10 + T)
    spec = args[-1]
    v = rmt.mt_recompute_values(*args)
    flat = lambda x: x.reshape(T * B, x.shape[-1])  # noqa: E731
    for name, got, want in (
            ("h_deter", v["hdet"], outs[0]), ("l_deter", v["ldet"], outs[1]),
            ("hid_h", v["hidh"], outs[2]), ("hid_l", v["hidl"], outs[3]),
            ("l-prior logits", v["lp_logits"], outs[4]), ("mixed logits", v["mixed"], outs[6]),
            ("h-prior logits", v["hp_logits"], outs[8]), ("h-post logits", v["hq_logits"], outs[10]),
            ("l-posterior probs", v["ql"], block_probs(outs[6], spec.ls_class, spec.ls_category)),
            ("h-posterior probs", v["qh"], block_probs(outs[10], spec.hs_class, spec.hs_category))):
        _close(got, flat(want), 1e-5, name)
    crec, xrec, dyrec = rmt.mt_bwd_recompute_plain(*args)
    lay = rmt.mt_bwd_record_layout(*WIDTHS[width])
    assert crec.shape == (T * B, lay["chain"][0]) and all(lay[k][0] % 4 == 0 for k in lay)
    assert torch.equal(record_field(xrec, lay["x"][1], "hid"), v["hid"])
    assert torch.equal(record_field(xrec, lay["x"][1], "xq"), torch.cat([v["ldet"], v["hdet"]], -1))
    assert torch.equal(record_field(crec, lay["chain"][1], "ql"), v["ql"])
    assert torch.equal(record_field(dyrec, lay["dy"][1], "dlg")[:, :spec.ls], v["dlpl"])
    assert not record_field(dyrec, lay["dy"][1], "sl").any()  # the chain's to write


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_passes_equal_the_plain_backward(width, B, T):
    """Recompute, carry-only chain and chunk-ordered weight-gradient GEMM
    give ``mt_recurrence_backward_plain``'s 37 gradients."""
    args, _, _ = _case(width, B, T, seed=B * 10 + T + 1)
    args = _double(args)
    ref = rmt.mt_recurrence_backward_plain(*args)
    got = rmt.mt_recurrence_backward_passes_plain(*args)
    assert len(got) == len(ref) == rmt.N_WEIGHTS + 9
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        _close(g, r, 1e-6, f"gradient {i}")


@pytest.mark.parametrize("width", list(WIDTHS))
def test_cell_bias_gradients_are_bit_equal(width):
    """In both MTRNN cells the d2h and input2h biases get one gradient (the
    pre-activation's cotangent summed over the row-steps); the passes give it
    bit for bit to both, over two chunks (160 row-steps) in float32."""
    args, _, _ = _case(width, 8, 20, seed=11)
    got = rmt.mt_recurrence_backward_passes_plain(*args)
    assert torch.equal(got[1], got[3]) and torch.equal(got[5], got[7])
    assert got[1].abs().max() > 0 and got[5].abs().max() > 0


@pytest.mark.parametrize("B,T", [(8, 20), (3, 7)])
def test_weight_gradient_pass_sums_chunks_in_order(B, T):
    """Pass 3's tasks cover every weight in torch layout, and its chunked
    sum (160 row-steps: two chunks; 21: one) is the direct sum over the
    row-steps; the bias is the GEMM's column of ones. Its row products (the
    input cotangents that feed no carry) are the stored cotangents times the
    weights' action and embedding columns."""
    args, _, _ = _case("odd", B, T, seed=7)
    args = _double(args)
    weights, actions, a_emb, v_emb, prev6, cots, spec = args
    crec, xrec, dyrec = rmt.mt_bwd_recompute_plain(*args)
    dyrec = rmt.mt_bwd_chain_plain(weights, crec, dyrec, T, B, spec)[0]
    grads = rmt.mt_bwd_dw_plain(weights, actions, a_emb, v_emb, prev6, xrec, dyrec, spec)
    tasks = rmt.mt_dw_tasks(actions, a_emb, v_emb, prev6, xrec, dyrec, weights, spec)
    assert [i for i, _, _ in tasks] == list(range(0, rmt.N_WEIGHTS, 2))
    for i, x, dy in tasks:
        assert grads[i].shape == weights[i].shape and grads[i + 1].shape == weights[i + 1].shape
        _close(grads[i], torch.einsum("no,nk->ok", dy, x), 1e-12, f"weights[{i}]")
        _close(grads[i + 1], dy.sum(0), 1e-12, f"weights[{i + 1}]")
    A, E, HD, LD, C, R, _ = WIDTHS["odd"]
    lay = rmt.mt_bwd_record_layout(*WIDTHS["odd"])
    dh = record_field(dyrec, lay["dy"][1], "dhid")
    for got, dy, w in ((grads[28], record_field(dyrec, lay["dy"][1], "sl"), weights[2][:, :A]),
                       (grads[29], dh[:, C:C + R], weights[20][:, LD:]),
                       (grads[30], dh[:, C + R:C + 2 * R], weights[24][:, LD:])):
        _close(got.reshape(T * B, -1), torch.einsum("nh,hc->nc", dy, w), 1e-12, "row product")


def _jax_grads(args, inputs, chunked: bool, monkeypatch):
    """``jax.grad`` of Σ outputs · cotangents through JAX's
    ``fused_mt_train_recurrence`` (the Pallas kernels in interpret mode) on
    the same weights (``[in, out]``), inputs and noise."""
    weights, *_, cots, spec = args
    xs, init6, gumbels = inputs
    T, B, A = xs[0].shape
    hp = dict(l_tau=spec.l_tau, h_tau=spec.h_tau, ls_class=spec.ls_class,
              ls_category=spec.ls_category, hs_class=spec.hs_class,
              hs_category=spec.hs_category)
    if chunked:
        # A VMEM budget of three time steps, so JAX takes its chunked kernels.
        sizes = dict(action_size=A, obs_embed_size=xs[1].shape[-1], hd_dim=init6[0].shape[-1],
                     ld_dim=init6[1].shape[-1], hs_size=spec.hs, ls_size=spec.ls)
        per = (1 << 40) // jax_mt.mt_chunk_len(B, 1 << 40, **sizes)
        monkeypatch.setattr(jax_mt, "MT_VMEM_BUDGET_BYTES", 3 * per)
        assert 1 < jax_mt.mt_chunk_len(B, jax_mt.MT_VMEM_BUDGET_BYTES, **sizes) < T
    packed = tuple(jnp.asarray(w.numpy().T if w.ndim == 2 else w.numpy()) for w in weights)
    j = lambda ts: tuple(jnp.asarray(t.numpy()) for t in ts)  # noqa: E731

    def loss(packed, actions, a_emb, v_emb, init):
        outs = jax_mt.fused_mt_train_recurrence(packed, actions, a_emb, v_emb, init, j(gumbels),
                                                **hp, interpret=True)
        return sum(jnp.sum(o * c) for o, c in zip(outs, j(cots)))

    return jax.grad(loss, argnums=tuple(range(5)))(packed, *j(xs), j(init6))


@pytest.mark.parametrize("B,T,chunked", [(3, 7, False), (3, 7, True), (8, 3, False),
                                         (1, 1, False)])
def test_passes_match_jax_pallas_backward(B, T, chunked, monkeypatch):
    """The three passes (float32) against JAX's Pallas backward in interpret
    mode, single-block and time-chunked, at tiny widths: all 28 weight
    gradients, the 3 input gradients and the 6 initial-state gradients."""
    args, inputs, _ = _case("tiny", B, T, seed=B * 10 + T + 2)
    got = rmt.mt_recurrence_backward_passes_plain(*args)
    d_packed, *d_ins = _jax_grads(args, inputs, chunked, monkeypatch)
    for i, (g, r) in enumerate(zip(got, d_packed)):
        r = np.asarray(r)
        _close(g, torch.tensor(np.array(r.T if r.ndim == 2 else r)), 2e-4, f"weights[{i}]")
    for name, g, r in zip(("actions", "a_emb", "v_emb"), got[rmt.N_WEIGHTS:], d_ins[:3]):
        _close(g, torch.tensor(np.array(r)), 2e-4, name)
    for i, (g, r) in enumerate(zip(got[rmt.N_WEIGHTS + 3:], d_ins[3])):
        _close(g, torch.tensor(np.array(r)), 2e-4, f"init6[{i}]")

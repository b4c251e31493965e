"""The MRSSM recurrence backward as its three kernels decompose it, on the CPU.

``csrc/recurrence_bwd.cu`` splits the backward into a parallel recompute of
every row-step (with what of the VJP needs no carry), a reverse-time chain
that carries only d deter and d stoch, and the 20 weight gradients as one
GEMM over the T·B row-steps, summed in a fixed chunk order. Each pass has a
plain version in ``ops/kernels/recurrence.py``; these tests hold the
identities the kernels rely on, on those plain versions:

- the recompute of all T·B row-steps at once gives the forward's values
  (float32, as the forward runs: within 1e-5 × max(1, max|forward|), the
  same arithmetic in another op order);
- the chain plus pass 3's GEMMs (the weight gradients in its chunk order,
  the input cotangents that feed no carry as row products) equals
  ``recurrence_backward_plain`` (float64: within 1e-6 × max(1, max|plain|)
  per gradient; the plain backward's fusion runs in float32, ``ops/fusion.py``)
  and a direct sum over the row-steps (float64, 1e-12 × scale);
- it equals ``jax.grad`` through ``train_step.py``'s Pallas backward in
  interpret mode, single-block and time-chunked (float32, 2e-4 × scale, the
  bound ``tests/test_torch_port_train.py`` holds the recurrence VJP to).

At B ∈ {1, 3, 8}, T ∈ {1, 7}, on tiny widths, the reference widths and an
odd one (H=33, E=63, D=17, 3 × 5 categories), with weights, inputs and
cotangents made by numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.ops.pallas import train_step as jax_ts
from multimodal_mtrssm_tpu_torch.ops.distributions import block_probs
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence as rec

WIDTHS = {  # A, E, H, D, C, K
    "tiny": (3, 12, 16, 8, 2, 3),
    "reference": (6, 64, 32, 32, 4, 4),
    "odd": (5, 63, 33, 17, 3, 5),
}
SHAPES = [(1, 1), (3, 7), (8, 1), (8, 7), (1, 7)]


def _scale(ref) -> float:
    return max(1.0, float(ref.abs().max())) if ref.numel() else 1.0


def _close(got, ref, rel: float, name: str) -> None:
    err = float((got.double() - ref.double()).abs().max()) if ref.numel() else 0.0
    assert err <= rel * _scale(ref), f"{name}: {err:.3g} > {rel} x {_scale(ref):.3g}"


def _case(width: str, B: int, T: int, seed: int):
    """Weights (torch layout), forward inputs, the float32 forward record and
    cotangents on its five outputs, made by numpy from ``seed``."""
    A, E, H, D, C, K = WIDTHS[width]
    S = C * K
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    weights = [f32(rng.uniform(-1, 1, s) / np.sqrt(s[-1] if len(s) == 2 else H))
               for s in rec.weight_shapes(A, S, H, D, E)]
    stoch0 = np.zeros((B, C, K), np.float32)
    stoch0[np.arange(B)[:, None], np.arange(C), rng.integers(0, K, (B, C))] = 1.0
    ins = [f32(a) for a in (rng.uniform(-1, 1, (T, B, A)), rng.standard_normal((T, B, E)),
                            rng.standard_normal((T, B, E)), np.tanh(rng.standard_normal((B, D))),
                            stoch0.reshape(B, S), rng.gumbel(size=(T, B, S)),
                            rng.gumbel(size=(T, B, S)))]
    with torch.no_grad():
        outs = rec.recurrence_forward_plain(weights, *ins, C, K)
    cots = [f32(rng.standard_normal(tuple(o.shape))) for o in outs]
    prev_deter = torch.cat([ins[3][None], outs[0][:-1]])
    prev_stoch = torch.cat([ins[4][None], outs[4][:-1]])
    args = (weights, *ins[:3], prev_deter, prev_stoch, cots, C, K)
    return args, ins, outs


def _double(args):
    weights, actions, a_emb, v_emb, prev_deter, prev_stoch, cots, C, K = args
    d = lambda xs: [x.double() for x in xs]  # noqa: E731
    return (d(weights), *d((actions, a_emb, v_emb, prev_deter, prev_stoch)), d(cots), C, K)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_recompute_of_every_row_step_is_the_forward(width, B, T):
    """Pass 1 recomputes all T·B row-steps at once from the stored carries:
    deter, the prior and mixed logits and the posterior's block probs are
    the forward's; the records hold them field for field."""
    args, _, outs = _case(width, B, T, seed=B * 10 + T)
    A, E, H, D, C, K = WIDTHS[width]
    S = C * K
    v = rec.recompute_values(*args)
    flat = lambda x: x.reshape(T * B, x.shape[-1])  # noqa: E731
    for name, got, want in (("deter", v["deter"], outs[0]), ("prior logits", v["prior"], outs[1]),
                            ("mixed logits", v["mixed"], outs[3]),
                            ("posterior probs", v["qprob"], block_probs(outs[3], C, K))):
        _close(got, flat(want), 1e-5, name)
    crec, xrec, dyrec = rec.recurrence_bwd_recompute_plain(*args)
    lay = rec.bwd_record_layout(H, D, S)
    assert crec.shape == (T * B, lay["chain"][0]) and lay["chain"][0] % 4 == 0
    assert torch.equal(rec.record_field(xrec, lay["x"][1], "deter"), v["deter"])
    assert torch.equal(rec.record_field(xrec, lay["x"][1], "hid"), v["hid"])
    assert torch.equal(rec.record_field(crec, lay["chain"][1], "qprob"), v["qprob"])
    assert torch.equal(rec.record_field(dyrec, lay["dy"][1], "dlg")[:, :S], v["dlgp"])
    assert not rec.record_field(dyrec, lay["dy"][1], "dgi").any()  # the chain's to write


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B,T", SHAPES)
def test_passes_equal_the_plain_backward(width, B, T):
    """Recompute, carry-only chain and chunk-ordered weight-gradient GEMM
    give ``recurrence_backward_plain``'s 25 gradients."""
    args, _, _ = _case(width, B, T, seed=B * 10 + T + 1)
    args = _double(args)
    ref = rec.recurrence_backward_plain(*args)
    got = rec.recurrence_backward_passes_plain(*args)
    assert len(got) == len(ref) == rec.N_WEIGHTS + 5
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        _close(g, r, 1e-6, f"gradient {i}")


@pytest.mark.parametrize("B,T", [(8, 20), (3, 7)])
def test_weight_gradient_pass_sums_chunks_in_order(B, T):
    """Pass 3's tasks cover every weight in torch layout, and its chunked
    sum (160 row-steps: two chunks; 21: one) is the direct sum over the
    row-steps; the bias is the GEMM's column of ones. Its row products (the
    input cotangents that feed no carry) are the stored cotangents times the
    weights' action and embedding columns."""
    args, _, _ = _case("odd", B, T, seed=7)
    args = _double(args)
    weights, actions, a_emb, v_emb, prev_deter, prev_stoch, cots, C, K = args
    H, D, S = weights[0].shape[0], prev_deter.shape[-1], C * K
    crec, xrec, dyrec = rec.recurrence_bwd_recompute_plain(*args)
    dyrec = rec.recurrence_bwd_chain_plain(weights, crec, dyrec, T, B, C, K)[0]
    grads = rec.recurrence_bwd_dw_plain(weights, actions, a_emb, v_emb, prev_deter, prev_stoch,
                                        xrec, dyrec)
    tasks = rec.dw_tasks(actions, a_emb, v_emb, prev_deter, prev_stoch, xrec, dyrec, H, D, S)
    assert [i for i, _, _ in tasks] == list(range(0, rec.N_WEIGHTS, 2))
    for i, x, dy in tasks:
        assert grads[i].shape == weights[i].shape and grads[i + 1].shape == weights[i + 1].shape
        _close(grads[i], torch.einsum("no,nk->ok", dy, x), 1e-12, f"weights[{i}]")
        _close(grads[i + 1], dy.sum(0), 1e-12, f"weights[{i + 1}]")
    lay = rec.bwd_record_layout(H, D, S)
    dh = rec.record_field(dyrec, lay["dy"][1], "dhid")
    A = actions.shape[-1]
    for got, dy, w in ((grads[20], rec.record_field(dyrec, lay["dy"][1], "dh1"), weights[0][:, :A]),
                       (grads[21], dh[:, H:2 * H], weights[12][:, D:]),
                       (grads[22], dh[:, 2 * H:], weights[16][:, D:])):
        _close(got.reshape(T * B, -1), torch.einsum("nh,hc->nc", dy, w), 1e-12, "row product")


def _jax_grads(args, ins, chunked: bool, monkeypatch):
    """``jax.grad`` of Σ outputs · cotangents through JAX's
    ``fused_train_recurrence`` (the Pallas kernels in interpret mode) on the
    same weights (``[in, out]``), inputs and noise."""
    weights, *_, cots, C, K = args
    T, B, A = ins[0].shape
    sizes = dict(action_size=A, stoch_size=C * K, deter_size=ins[3].shape[-1],
                 obs_embed_size=ins[1].shape[-1])
    if chunked:
        # A VMEM budget of three time steps, so JAX takes its chunked kernels.
        per = (1 << 40) // jax_ts.chunk_len(B, 1 << 40, **sizes)
        monkeypatch.setattr(jax_ts, "VMEM_BUDGET_BYTES", 3 * per)
        assert 1 < jax_ts.chunk_len(B, jax_ts.VMEM_BUDGET_BYTES, **sizes) < T
    packed = tuple(jnp.asarray(w.numpy().T if w.ndim == 2 else w.numpy()) for w in weights)
    x = [jnp.asarray(a.numpy()) for a in ins]

    def loss(packed, actions, a_emb, v_emb, init_deter, init_stoch):
        outs = jax_ts.fused_train_recurrence(packed, actions, a_emb, v_emb, init_deter,
                                             init_stoch, x[5], x[6], class_size=C,
                                             category_size=K, interpret=True)
        return sum(jnp.sum(o * jnp.asarray(c.numpy())) for o, c in zip(outs, cots))

    return jax.grad(loss, argnums=tuple(range(6)))(packed, *x[:5])


@pytest.mark.parametrize("width,B,T,chunked", [("tiny", 3, 7, False), ("tiny", 3, 7, True),
                                               ("odd", 8, 7, False), ("odd", 1, 1, False)])
def test_passes_match_jax_pallas_backward(width, B, T, chunked, monkeypatch):
    """The three passes (float32) against JAX's Pallas backward in interpret
    mode, single-block and time-chunked: all 20 weight gradients and the 5
    input gradients."""
    args, ins, _ = _case(width, B, T, seed=B * 10 + T + 2)
    got = rec.recurrence_backward_passes_plain(*args)
    d_packed, *d_ins = _jax_grads(args, ins, chunked, monkeypatch)
    for i, (g, r) in enumerate(zip(got, d_packed)):
        r = np.asarray(r)
        _close(g, torch.tensor(np.array(r.T if r.ndim == 2 else r)), 2e-4,
               f"weights[{i}]")
    for name, g, r in zip(("actions", "a_emb", "v_emb", "init_deter", "init_stoch"),
                          got[rec.N_WEIGHTS:], d_ins):
        _close(g, torch.tensor(np.array(r)), 2e-4, name)

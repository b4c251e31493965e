"""The port's MoPoE-MMTRSSM kernels (``ops/kernels/recurrence_mt.py``,
``ops/kernels/rollout_mt.py``) and the MTRNN cell against the JAX package.

On the CPU each kernel's plain PyTorch version is what runs, through the
same ``MTRecurrenceFunction`` the card uses; it is held to JAX
``reference_mt_train_recurrence``, to the Pallas kernels in interpret mode
(single-block and time-chunked) and to ``jax.grad``, with weights through the
weight bridge and inputs and noise made by numpy from a seed. The CUDA
kernels themselves are checked against the plain versions by
``tests/test_torch_port_gpu.py`` (marked ``gpu``) and by ``chip_smoke.py``.

Tolerances, those of the MRSSM tests (``test_torch_port_kernels.py``,
``test_torch_port_train.py``): 1e-5 absolute for deters, integrators and
logits (f32, the two frameworks sum the small matmuls in different
orders); sampled categories exactly and straight-through values within
1e-6; gradients within 2e-4 × max(1, max|ref|) per tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.models.mmtrssm import MMTRSSMConfig as JaxMMTRSSMConfig
from multimodal_mtrssm_tpu.models.mmtrssm import MoPoEMMTRSSM as JaxMoPoEMMTRSSM
from multimodal_mtrssm_tpu.nn.core import mlp_apply, mtrnn_apply
from multimodal_mtrssm_tpu.ops.pallas import rollout as jax_rollout
from multimodal_mtrssm_tpu.ops.pallas import train_step_mt as jax_mt
from multimodal_mtrssm_tpu.train.torch_export import export_reference_mmtrssm_state_dict
from multimodal_mtrssm_tpu_torch.models.mmtrssm import MMTRSSMConfig, MoPoEMMTRSSM
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.nn.core import MTRNN, mtrnn_step
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import parity, recurrence_mt, rollout_mt
from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence_mt import MTSpec
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import philox_gumbel
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

SPEC = MTSpec()
LS, HS, HD, LD = 16, 16, 32, 32
HP = dict(l_tau=2.0, h_tau=4.0, ls_class=4, ls_category=4, hs_class=2, hs_category=8)
ATOL = 1e-5


def _port_enc(jax_enc) -> EncoderConfig:
    return EncoderConfig(**dataclasses.asdict(jax_enc))


@pytest.fixture(scope="module")
def models():
    """A small JAX MMTRSSM, its params, and the port model with the same
    weights through the weight bridge."""
    from conftest import small_encoder_config

    enc = small_encoder_config()
    jmodel = JaxMoPoEMMTRSSM(JaxMMTRSSMConfig(audio_encoder=enc, vision_encoder=enc,
                                              use_pallas_train="reference"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(7))
    port = MoPoEMMTRSSM(MMTRSSMConfig(audio_encoder=_port_enc(enc), vision_encoder=_port_enc(enc),
                                      input_noise_std=0.0))
    load_reference_state_dict(port, export_reference_mmtrssm_state_dict(params))
    return jmodel, params, port.eval()


def _onehot(rng, B: int, c: int, k: int) -> np.ndarray:
    x = np.zeros((B, c, k), np.float32)
    x[np.arange(B)[:, None], np.arange(c), rng.integers(0, k, (B, c))] = 1.0
    return x.reshape(B, c * k)


def _case(seed: int, B: int, T: int):
    """Inputs ``(actions, a_emb, v_emb)``, ``init6``, the four sites' Gumbel
    noise and cotangents on the 12 outputs, made by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    xs = [f32(rng.uniform(-1, 1, (T, B, 6))), f32(rng.standard_normal((T, B, 64))),
          f32(rng.standard_normal((T, B, 64)))]
    hd, ld = f32(np.tanh(rng.standard_normal((B, HD)))), f32(np.tanh(rng.standard_normal((B, LD))))
    init6 = [hd, ld, _onehot(rng, B, 2, 8), _onehot(rng, B, 4, 4),
             f32(np.arctanh(hd * 0.9)), f32(np.arctanh(ld * 0.9))]
    gumbels = [f32(rng.gumbel(size=(T, B, d))) for d in (LS, LS, HS, HS)]
    cots = [f32(rng.standard_normal((T, B, d))) for d in recurrence_mt.mt_out_dims(HD, LD, SPEC)]
    return xs, init6, gumbels, cots


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _assert_outputs(port_outs, jax_outs):
    """The 12 outputs: floats within ATOL, samples by category and value."""
    for i, (p, j) in enumerate(zip(port_outs, jax_outs)):
        p, j = p.detach().numpy(), np.asarray(j)
        if i in (5, 7, 9, 11):
            k = 4 if i in (5, 7) else 8
            blocks = lambda x: x.reshape(*x.shape[:-1], -1, k)  # noqa: E731, B023
            np.testing.assert_array_equal(blocks(p).argmax(-1), blocks(j).argmax(-1), f"out[{i}]")
            np.testing.assert_allclose(p, j, rtol=0, atol=1e-6, err_msg=f"out[{i}]")
        else:
            np.testing.assert_allclose(p, j, rtol=0, atol=ATOL, err_msg=f"out[{i}]")


def _chunked(monkeypatch, B: int, T: int, per_chunk: int = 3) -> None:
    """Shrink the JAX VMEM budget so its kernels take the time-chunked grid."""
    row = (10 << 20) // jax_mt.mt_chunk_len(B)
    monkeypatch.setattr(jax_mt, "MT_VMEM_BUDGET_BYTES", row * per_chunk)
    assert jax_mt.mt_chunk_len(B, jax_mt.MT_VMEM_BUDGET_BYTES) < T


# ---- the MTRNN cell -----------------------------------------------------------------


def test_mtrnn_step_matches_jax_mtrnn_apply():
    rng = np.random.default_rng(0)
    cell = MTRNN(20, 12, 3.0)
    with torch.no_grad():
        for p in cell.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.3))
    x, d, h = (rng.standard_normal(s).astype(np.float32) for s in ((5, 20), (5, 12), (5, 12)))
    jparams = {"d2h": {"w": cell._d2h.weight.detach().numpy().T, "b": cell._d2h.bias.detach().numpy()},
               "input2h": {"w": cell._input2h.weight.detach().numpy().T,
                           "b": cell._input2h.bias.detach().numpy()}}
    ref_d, ref_h = mtrnn_apply(jparams, jnp.asarray(x), jnp.asarray(d), jnp.asarray(h), 3.0)
    with torch.no_grad():
        got_d, got_h = cell(*map(torch.from_numpy, (x, d, h)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=0, atol=1e-6)
    assert torch.equal(got_d, mtrnn_step(cell.weights(), *map(torch.from_numpy, (x, d, h)), 3.0)[0])


@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_mtrnn_refuses_tau_at_most_one(tau):
    with pytest.raises(ValueError, match="tau"):
        MTRNN(4, 3, tau)
    w = MTRNN(4, 3, 2.0).weights()
    with pytest.raises(ValueError, match="tau"):
        mtrnn_step(w, torch.zeros(1, 4), torch.zeros(1, 3), torch.zeros(1, 3), tau)


# ---- the forward ----------------------------------------------------------------------


@pytest.mark.parametrize("B,T", [(3, 5), (2, 1)])
def test_plain_forward_matches_jax_reference(models, B, T):
    _, params, port = models
    xs, init6, gumbels, _ = _case(B * 10 + T, B, T)
    ref = jax_mt.reference_mt_train_recurrence(jax_mt.pack_mt_train_params(params), *_j(xs),
                                               _j(init6), _j(gumbels), **HP)
    with torch.no_grad():
        got = kernels.fused_mt_train_recurrence(port.recurrence_weights(), *_t(xs), _t(init6),
                                                _t(gumbels), SPEC)
    _assert_outputs(got, ref)


@pytest.mark.parametrize("chunked", [False, True])
def test_plain_forward_matches_pallas_interpret(models, chunked, monkeypatch):
    """Against the Pallas kernel in interpret mode, single-block and with
    the VMEM budget shrunk so it takes ``_fwd_kernel_chunked``."""
    _, params, port = models
    B, T = 3, 7
    if chunked:
        _chunked(monkeypatch, B, T)
    xs, init6, gumbels, _ = _case(31 + chunked, B, T)
    ref = jax_mt.fused_mt_train_recurrence(jax_mt.pack_mt_train_params(params), *_j(xs),
                                           _j(init6), _j(gumbels), **HP, interpret=True)
    with torch.no_grad():
        got = recurrence_mt.mt_recurrence_forward_plain(port.recurrence_weights(), *_t(xs),
                                                        _t(init6), _t(gumbels), SPEC)
    _assert_outputs(got, ref)


# ---- the VJP ----------------------------------------------------------------------------


def _scaled_close(got, ref, rel: float, name: str) -> None:
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * scale, err_msg=name)


@pytest.mark.parametrize("route", ["pallas_interpret", "pallas_chunked", "reference_autodiff"])
def test_recurrence_vjp_matches_jax(models, route, monkeypatch):
    """``MTRecurrenceFunction`` (CPU route) against the Pallas kernel's VJP
    in interpret mode (single-block and time-chunked) and ``jax.grad`` of
    ``reference_mt_train_recurrence``: the 28 weight grads (in torch
    layout), ``d_actions``, ``d_a_emb``, ``d_v_emb`` and ``d_init6``, under
    cotangents on all 12 outputs."""
    _, params, port = models
    B, T = (3, 7) if route == "pallas_chunked" else (2, 5)
    xs, init6, gumbels, cots = _case(len(route) + T, B, T)
    if route == "reference_autodiff":
        fn = lambda *a: jax_mt.reference_mt_train_recurrence(*a, **HP)  # noqa: E731
    else:
        if route == "pallas_chunked":
            _chunked(monkeypatch, B, T)
        fn = lambda *a: jax_mt.fused_mt_train_recurrence(*a, **HP, interpret=True)  # noqa: E731

    def loss(packed, actions, a_emb, v_emb, init):
        outs = fn(packed, actions, a_emb, v_emb, init, _j(gumbels))
        return sum(jnp.sum(o * c) for o, c in zip(outs, _j(cots)))

    ref = jax.grad(loss, argnums=tuple(range(5)))(jax_mt.pack_mt_train_params(params), *_j(xs),
                                                  _j(init6))
    weights = [w.detach().clone().requires_grad_() for w in port.recurrence_weights()]
    tx = [x.requires_grad_() for x in _t(xs)]
    ti = [x.requires_grad_() for x in _t(init6)]
    outs = kernels.fused_mt_train_recurrence(weights, *tx, ti, _t(gumbels), SPEC)
    torch.autograd.backward(outs, _t(cots))
    for i, (g, r) in enumerate(zip(weights, ref[0])):
        r = np.asarray(r)
        _scaled_close(g.grad.numpy(), r.T if r.ndim == 2 else r, 2e-4, f"weights[{i}]")
    for name, g, r in zip(("actions", "a_emb", "v_emb"), tx, ref[1:4]):
        _scaled_close(g.grad.numpy(), r, 2e-4, name)
    for i, (g, r) in enumerate(zip(ti, ref[4])):
        _scaled_close(g.grad.numpy(), r, 2e-4, f"init6[{i}]")
    # The two pairs of equal bias gradients (train_step_mt.py:229, 270).
    assert torch.equal(weights[1].grad, weights[3].grad)
    assert torch.equal(weights[5].grad, weights[7].grad)


def test_plain_backward_is_the_function_backward(models):
    """``mt_recurrence_backward_plain`` on the stored record is what the
    Function returns, and a missing cotangent counts as zeros."""
    _, _, port = models
    B, T = 2, 4
    xs, init6, gumbels, cots = _case(3, B, T)
    cots[5] = np.zeros_like(cots[5])
    weights = [w.detach() for w in port.recurrence_weights()]
    with torch.no_grad():
        outs = recurrence_mt.mt_recurrence_forward_plain(weights, *_t(xs), _t(init6), _t(gumbels))
    prev6 = recurrence_mt.shift_carries(_t(init6), recurrence_mt.carries(outs))
    plain = recurrence_mt.mt_recurrence_backward_plain(weights, *_t(xs), prev6, _t(cots))
    assert len(plain) == 28 + 3 + 6
    w_req = [w.clone().requires_grad_() for w in weights]
    x_req = [x.requires_grad_() for x in _t(xs)]
    i_req = [x.requires_grad_() for x in _t(init6)]
    outs = kernels.fused_mt_train_recurrence(w_req, *x_req, i_req, _t(gumbels))
    used = [i for i in range(12) if i != 5]  # l_prior_stoch gets no cotangent
    torch.autograd.backward([outs[i] for i in used], [torch.from_numpy(cots[i]) for i in used])
    for got, want in zip([*w_req, *x_req, *i_req], plain):
        torch.testing.assert_close(got.grad, want, rtol=0, atol=1e-6)


# ---- the rollout ------------------------------------------------------------------------


def _jax_rollout_replay(jmodel, params, actions, init6, g_l, g_h):
    """The JAX model's per-step math (``_lower_prior``, ``mtrnn_apply``,
    ``mlp_apply``) sampled with the given noise by the kernels' first-index
    one-hot sweep. Returns the 8 outputs, each ``[B, T, ·]``."""
    hd, ld, hs, ls, hidh, hidl = _j(init6)
    outs = []
    for t in range(actions.shape[1]):
        l_deter, l_logits, hidl = jmodel._lower_prior(params, jnp.asarray(actions[:, t]), ls, hs,
                                                      ld, hidl)
        h_deter, hidh = mtrnn_apply(params["h_rnn"], hs, hd, hidh, 4.0)
        h_logits = mlp_apply(params["h_prior"], h_deter, "ELU")
        ls = jax_rollout.onehot_blocks(l_logits + g_l[t], 4, 4)
        hs = jax_rollout.onehot_blocks(h_logits + g_h[t], 2, 8)
        hd, ld = h_deter, l_deter
        outs.append((h_deter, l_deter, h_logits, l_logits, hs, ls, hidh, hidl))
    return [np.stack([np.asarray(o[i]) for o in outs], 1) for i in range(8)]


def test_plain_rollout_with_noise_matches_jax_replay(models):
    jmodel, params, port = models
    B, T = 4, 6
    xs, init6, gumbels, _ = _case(41, B, T)
    actions = np.swapaxes(xs[0], 0, 1).copy()
    ref = _jax_rollout_replay(jmodel, params, actions, init6, gumbels[0], gumbels[2])
    with torch.no_grad():
        got = rollout_mt.rollout_mt_plain(port.rollout_weights(), torch.from_numpy(actions),
                                          _t(init6), noise=(torch.from_numpy(gumbels[0]),
                                                            torch.from_numpy(gumbels[2])))
    for i, (g, r) in enumerate(zip(got, ref)):
        if i in (4, 5):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=f"out[{i}]")
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=ATOL, err_msg=f"out[{i}]")


def test_pallas_rollout_replays_through_the_plain_step(models):
    """The JAX kernel (interpret mode) draws its own samples; fed through
    the port's plain step, they give its deters, logits and integrators."""
    from multimodal_mtrssm_tpu.ops.pallas import fused_mt_rollout_transition, pack_mt_params

    _, params, port = models
    B, T = 3, 7
    xs, init6, _, _ = _case(43, B, T)
    actions = np.swapaxes(xs[0], 0, 1).copy()
    out = fused_mt_rollout_transition(pack_mt_params(params), jnp.asarray(actions), _j(init6),
                                      jnp.int32(5), interpret=True)
    out = [np.array(o) for o in out]
    with torch.no_grad():
        replay = parity.replay_mt_prior(port.rollout_weights(), torch.from_numpy(actions),
                                        _t(init6), torch.from_numpy(out[4]),
                                        torch.from_numpy(out[5]))
    for got, want in zip(replay, (out[0], out[1], out[2], out[3], out[6], out[7])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_chained_imagine_equals_one_imagine(models):
    """A rollout of T1 steps, then T2 steps from its ``[:, -1]`` (the
    integrators included), equals one rollout of T1 + T2 on the same noise."""
    _, _, port = models
    B, T1, T2 = 3, 4, 5
    xs, init6, gumbels, _ = _case(47, B, T1 + T2)
    actions = torch.from_numpy(np.swapaxes(xs[0], 0, 1).copy())
    g_l, g_h = torch.from_numpy(gumbels[0]), torch.from_numpy(gumbels[2])
    w = port.rollout_weights()
    with torch.no_grad():
        whole = rollout_mt.rollout_mt_plain(w, actions, _t(init6), noise=(g_l, g_h))
        first = rollout_mt.rollout_mt_plain(w, actions[:, :T1], _t(init6),
                                            noise=(g_l[:T1], g_h[:T1]))
        last = [x[:, -1] for x in first]
        carry = (last[0], last[1], last[4], last[5], last[6], last[7])
        second = rollout_mt.rollout_mt_plain(w, actions[:, T1:], carry,
                                             noise=(g_l[T1:], g_h[T1:]))
    for a, b, c in zip(whole, first, second):
        assert torch.equal(a, torch.cat([b, c], 1))


def test_philox_mt_gumbel_extends_the_mrssm_stream():
    """Its lower half is ``philox_gumbel``; the higher blocks are the next
    block indices, two words each for K=8."""
    g_l, g_h = rollout_mt.philox_mt_gumbel(9, 5, 3)
    assert torch.equal(g_l, philox_gumbel(9, 5, 3, 4, 4))
    assert g_h.shape == (5, 3, 16) and bool(torch.isfinite(g_h).all())
    wide = philox_gumbel(9, 5, 3, 6, 8)  # blocks 0..5, K=8: blocks 4 and 5 are the higher ones
    assert torch.equal(g_h, wide[..., 32:])
    assert not torch.equal(g_h, rollout_mt.philox_mt_gumbel(10, 5, 3)[1])


def test_plain_rollout_seed_draws_the_philox_stream(models):
    _, _, port = models
    xs, init6, _, _ = _case(53, 3, 4)
    actions = torch.from_numpy(np.swapaxes(xs[0], 0, 1).copy())
    w = port.rollout_weights()
    with torch.no_grad():
        by_seed = rollout_mt.rollout_mt_plain(w, actions, _t(init6), 21)
        by_noise = rollout_mt.rollout_mt_plain(w, actions, _t(init6),
                                               noise=rollout_mt.philox_mt_gumbel(21, 4, 3))
        res = parity.check_mt_rollout(w, actions, _t(init6), 21, by_seed)
    for x, y in zip(by_seed, by_noise):
        assert torch.equal(x, y)
    assert res["max_abs_err"] == 0.0


# ---- checks and wrappers --------------------------------------------------------------


def test_mt_parity_checks_catch_a_wrong_kernel(models):
    """The checks ``chip_smoke.py`` holds the MT kernels to reject a wrong output."""
    _, _, port = models
    xs, init6, gumbels, _ = _case(59, 4, 6)
    with torch.no_grad():
        ref = recurrence_mt.mt_recurrence_forward_plain(port.recurrence_weights(), *_t(xs),
                                                        _t(init6), _t(gumbels))
        ok = parity.check_mt_recurrence(ref, ref, _t(gumbels))
        assert ok["max_abs_err"] == 0.0 and ok["compared"] == 1.0
        for i, change in ((2, lambda x: x + 1e-3), (10, lambda x: x - 1e-3),
                          (7, lambda x: x.roll(1, dims=-1)), (9, lambda x: x.roll(1, dims=-1))):
            bad = list(ref)
            bad[i] = change(bad[i])
            with pytest.raises(parity.ParityError):
                parity.check_mt_recurrence(bad, ref, _t(gumbels))
        actions = torch.from_numpy(np.swapaxes(xs[0], 0, 1).copy())
        w = port.rollout_weights()
        out = rollout_mt.rollout_mt_plain(w, actions, _t(init6), 3)
        for i, change in ((6, lambda x: x + 1e-3), (4, lambda x: x.roll(1, dims=-1))):
            bad = list(out)
            bad[i] = change(bad[i])
            with pytest.raises(parity.ParityError):
                parity.check_mt_rollout(w, actions, _t(init6), 3, bad)
    grads = [torch.ones(3), torch.full((2,), 5.0)]
    with pytest.raises(parity.ParityError):
        parity.check_gradients([grads[0], grads[1] + 0.01], grads)


def test_mt_cuda_wrappers_refuse_what_the_kernels_do_not_take(models):
    """The MT wrappers refuse CPU tensors, wrong counts and categories the
    kernels do not take, without counting a launch; a non-ELU model raises
    on CUDA."""
    _, _, port = models
    xs, init6, gumbels, cots = _case(61, 2, 3)
    kernels.reset_launch_counts()
    w = port.recurrence_weights()
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensors"):
            recurrence_mt.mt_recurrence_forward_cuda(w, *_t(xs), _t(init6), _t(gumbels))
        prev6 = [torch.from_numpy(np.repeat(x[None], 3, 0)) for x in init6]
        with pytest.raises(ValueError, match="CUDA tensors"):
            recurrence_mt.mt_recurrence_backward_cuda(w, *_t(xs), prev6, _t(cots))
        with pytest.raises(ValueError, match="12 cotangents"):
            recurrence_mt.mt_recurrence_backward_cuda(w, *_t(xs), prev6, _t(cots[:5]))
        with pytest.raises(ValueError, match="expected 28 weights"):
            recurrence_mt.mt_recurrence_forward_cuda(w[:20], *_t(xs), _t(init6), _t(gumbels))
        with pytest.raises(ValueError, match="at most 32"):
            recurrence_mt.mt_recurrence_forward_cuda(w, *_t(xs), _t(init6), _t(gumbels),
                                                     MTSpec(hs_class=1, hs_category=64))
        actions = torch.from_numpy(np.swapaxes(xs[0], 0, 1).copy())
        with pytest.raises(ValueError, match="CUDA tensors"):
            rollout_mt.rollout_mt_cuda(port.rollout_weights(), actions, _t(init6), 1)
        with pytest.raises(ValueError, match="64 unsigned bits"):
            rollout_mt.rollout_mt_cuda(port.rollout_weights(), actions, _t(init6), -1)
    with pytest.raises(ValueError, match="ELU"):
        kernels._route(torch.device("cuda"), "Tanh")
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)

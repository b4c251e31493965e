"""The port's stacked recurrence (``use_pallas_train="stacked"``) against JAX.

``ops/kernels/recurrence_stacked.py`` is held to
``ops/pallas/train_step_stacked.py`` run as the JAX package's own tests run
it on the CPU (``interpret=True``): the stacking and unstacking of the
weights exactly (the port's stacked matrices are JAX's transposed), the
forward within 1e-5 with stochs equal, the VJP of all 20 weights and the 5
differentiable inputs within 1e-5 × max(1, max|JAX|) per tensor (f32, one
order of sums apart), and the MRSSM ``shared_step`` at
``MRSSMConfig(use_pallas_train="stacked")`` with ``conv_layout`` ``"auto"``
and ``"fused_enc"`` — loss within rtol 2e-5, gradient tree within 3e-4 ×
scale, the bounds of ``test_torch_port_train.py`` — against the JAX model at
the same ``conv_layout`` with the stacked kernel in interpret mode. Inputs, cotangents
and noise are made by numpy from a seed; model weights go through the
weight bridge. On the CPU the port runs the kernels' plain versions through
the same ``RecurrenceStackedFunction`` the card uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
from multimodal_mtrssm_tpu.models.state import State as JaxState
from multimodal_mtrssm_tpu.nn.core import mlp_apply
from multimodal_mtrssm_tpu.ops import distributions as jdist
from multimodal_mtrssm_tpu.ops.pallas import train_step as jax_ts
from multimodal_mtrssm_tpu.ops.pallas import train_step_stacked as jax_stacked
from multimodal_mtrssm_tpu.train.torch_export import export_reference_state_dict
from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_stacked
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

C, K = 4, 4
S = C * K
# (A, H, D, E): a narrow recurrence and the reference widths.
WIDTHS = {"narrow": (6, 12, 8, 10), "reference": (6, 32, 32, 64)}


def _packed(rng, A: int, H: int, D: int, E: int) -> list[np.ndarray]:
    """Random recurrence weights in JAX's packed 20-tensor layout ([in, out])."""
    X, G = A + S, 3 * D
    shapes = [(X, H), (H,), (H, H), (H,), (H, G), (G,), (D, G), (G,), (D, H), (H,), (H, S), (S,),
              (D + E, H), (H,), (H, S), (S,), (D + E, H), (H,), (H, S), (S,)]
    return [(rng.standard_normal(s) / np.sqrt(s[0] if len(s) == 2 else 4)).astype(np.float32)
            for s in shapes]


def _torch(arrays) -> list[torch.Tensor]:
    """JAX-layout arrays as torch-layout tensors (matrices transposed)."""
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(a).T)) for a in arrays]


def _case(seed: int, B: int, T: int, A: int, H: int, D: int, E: int):
    rng = np.random.default_rng(seed)
    stoch0 = np.zeros((B, C, K), np.float32)
    stoch0[np.arange(B)[:, None], np.arange(C), rng.integers(0, K, (B, C))] = 1.0
    ins = [np.asarray(a, np.float32) for a in (
        rng.uniform(-1, 1, (T, B, A)), rng.standard_normal((T, B, E)),
        rng.standard_normal((T, B, E)), np.tanh(rng.standard_normal((B, D))),
        stoch0.reshape(B, S), rng.gumbel(size=(T, B, S)), rng.gumbel(size=(T, B, S)))]
    cots = [rng.standard_normal((T, B, d)).astype(np.float32) for d in (D, S, S, S, S)]
    return _packed(rng, A, H, D, E), ins, cots


def _scaled_close(got, ref, rel: float, name: str) -> None:
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * scale, err_msg=name)


# ---- stacking --------------------------------------------------------------------------


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_stack_and_unstack_equal_jax(widths):
    """``stack_train_params`` is JAX's, transposed, and ``unstack_train_grads``
    slices the same blocks out of any stacked gradient: exactly."""
    A, H, D, E = WIDTHS[widths]
    rng = np.random.default_rng(1)
    packed = _packed(rng, A, H, D, E)
    ref = jax_stacked.stack_train_params(tuple(map(jnp.asarray, packed)))
    got = recurrence_stacked.stack_train_params(_torch(packed))
    assert len(got) == recurrence_stacked.N_STACKED
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).T, err_msg=f"stacked[{i}]")
    d_stacked = [rng.standard_normal(np.asarray(r).shape).astype(np.float32) for r in ref]
    ref_u = jax_stacked.unstack_train_grads(tuple(map(jnp.asarray, d_stacked)), (A, H, D, E))
    got_u = recurrence_stacked.unstack_train_grads(_torch(d_stacked), (A, H, D, E))
    assert len(got_u) == 20
    for i, (g, r) in enumerate(zip(got_u, ref_u)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).T, err_msg=f"grads[{i}]")


# ---- the recurrence and its VJP -----------------------------------------------------------


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_stacked_forward_matches_jax_interpret(widths):
    A, H, D, E = WIDTHS[widths]
    B, T = 3, 5
    packed, ins, _ = _case(7, B, T, A, H, D, E)
    ref = jax_stacked.fused_train_recurrence_stacked(
        tuple(map(jnp.asarray, packed)), *map(jnp.asarray, ins), class_size=C, category_size=K,
        interpret=True)
    with torch.no_grad():
        got = kernels.fused_train_recurrence_stacked(_torch(packed), *map(torch.from_numpy, ins),
                                                     C, K)
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), rtol=0, atol=1e-5)
    for i in (2, 4):
        np.testing.assert_array_equal(got[i].numpy().round(), np.asarray(ref[i]).round())
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_stacked_vjp_matches_jax_interpret(widths):
    """``RecurrenceStackedFunction``'s VJP (the plain stacked backward, an
    autograd replay) against ``jax.vjp`` of the JAX function through its
    Pallas kernels in interpret mode: all 20 weight grads, 5 input grads."""
    A, H, D, E = WIDTHS[widths]
    B, T = 3, 5
    packed, ins, cots = _case(11, B, T, A, H, D, E)

    def loss(packed, actions, a_emb, v_emb, init_deter, init_stoch):
        outs = jax_stacked.fused_train_recurrence_stacked(
            packed, actions, a_emb, v_emb, init_deter, init_stoch, jnp.asarray(ins[5]),
            jnp.asarray(ins[6]), class_size=C, category_size=K, interpret=True)
        return sum(jnp.sum(o * c) for o, c in zip(outs, map(jnp.asarray, cots)))

    ref = jax.grad(loss, argnums=tuple(range(6)))(tuple(map(jnp.asarray, packed)),
                                                  *map(jnp.asarray, ins[:5]))
    weights = [w.requires_grad_() for w in _torch(packed)]
    xs = [torch.from_numpy(a).requires_grad_() for a in ins[:5]]
    outs = kernels.fused_train_recurrence_stacked(weights, *xs, *map(torch.from_numpy, ins[5:]),
                                                  C, K)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    for i, (w, r) in enumerate(zip(weights, ref[0])):
        _scaled_close(w.grad.numpy(), np.asarray(r).T, 1e-5, f"weights[{i}]")
    for name, x, r in zip(("actions", "a_emb", "v_emb", "init_deter", "init_stoch"), xs, ref[1:]):
        _scaled_close(x.grad.numpy(), r, 1e-5, name)
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


def test_stacked_equals_unstacked_recurrence():
    """Zero blocks add zeros: the stacked plain forward and its VJP agree
    with the unstacked ones (within 1e-5: BLAS sums a wider product in
    another order), and the samples are the same."""
    A, H, D, E = WIDTHS["reference"]
    packed, ins, cots = _case(3, 2, 4, A, H, D, E)
    runs = []
    for fn in (kernels.fused_train_recurrence, kernels.fused_train_recurrence_stacked):
        weights = [w.requires_grad_() for w in _torch(packed)]
        outs = fn(weights, *map(torch.from_numpy, ins), C, K)
        torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
        runs.append(([o.detach() for o in outs], [w.grad for w in weights]))
    for a, b in zip(runs[0][0], runs[1][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    for i in (2, 4):
        assert torch.equal(runs[0][0][i].round(), runs[1][0][i].round())
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# ---- the model ------------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["auto", "fused_enc"])
def fused_stacked(request):
    """JAX MoPoE-MRSSM at ``conv_layout`` (``"fused_enc"``: the fused Pallas
    encoder in interpret mode), its params, and the port model at the same
    ``conv_layout`` with ``use_pallas_train="stacked"`` and the same weights
    (no input noise)."""
    jmodel = JaxMoPoEMRSSM(JaxMRSSMConfig(conv_layout=request.param, init_proj_cells=32,
                                          use_pallas_train="stacked_interpret"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3))
    port = MoPoEMRSSM(MRSSMConfig(conv_layout=request.param, use_pallas_train="stacked",
                                  init_proj_cells=32, input_noise_std=0.0))
    load_reference_state_dict(port, export_reference_state_dict(params))
    return jmodel, params, port


def _jax_elbo_stacked(jmodel, params, batch, noise):
    """``test_torch_port_train._jax_elbo`` with JAX's stacked recurrence
    (interpret mode) in place of its pure-JAX twin, and the model's own
    encoders (``fused_encoder_apply`` at ``conv_layout="fused_enc"``)."""
    cfg = jmodel.cfg
    a_raw, v_raw = jmodel._encode_embeds(params, batch[1], batch[2])
    deter0 = mlp_apply(params["init_proj"], (a_raw[:, 0] + v_raw[:, 0]) / 2.0,
                       cfg.init_proj_activation)
    logits0 = mlp_apply(params["transition"]["rnn_to_prior_projector"], deter0, "ELU")
    s0, p0 = jax_ts._st_sample(logits0, noise["g_init"], C, K)
    stoch0 = jax.lax.stop_gradient(s0 - p0) + p0
    tm = lambda x: jnp.swapaxes(x, 0, 1)  # noqa: E731
    outs = jax_stacked.fused_train_recurrence_stacked(
        jax_ts.pack_train_params(params), tm(batch[0]), tm(a_raw), tm(v_raw), deter0, stoch0,
        noise["g_prior"], noise["g_post"], class_size=C, category_size=K, interpret=True)
    deter, prior_logits, _, mixed, post_stoch = (tm(o) for o in outs)
    post = JaxState(deter=deter, stoch=post_stoch, distribution=jmodel._dist(mixed))
    losses = jmodel.compute_reconstruction_loss(
        jmodel.decode_state(params, post), {"recon/audio": batch[4], "recon/vision": batch[5]})
    kl = jdist.kl_balanced(post.distribution, jmodel._dist(prior_logits),
                           use_balancing=cfg.use_kl_balancing)
    losses["kl"] = jnp.mean(jnp.sum(kl, axis=-1)) * cfg.kl_coeff
    losses["loss"] = losses["recon"] + losses["kl"]
    return losses


def test_fused_stacked_shared_step_matches_jax(fused_stacked):
    """``shared_step``'s losses and full gradient tree at ``use_pallas_train=
    "stacked"``, with the canonical encoders and with ``conv_layout=
    "fused_enc"``, against the JAX model at the same config, its stacked
    recurrence (and fused encoder) in interpret mode, on the same noise."""
    from test_torch_port_train import _batch

    jmodel, params, port = fused_stacked
    batch, noise = _batch(21, B=2, T=3)
    jb = tuple(map(jnp.asarray, batch))
    jn = {k: jnp.asarray(v) for k, v in noise.items()}

    def loss(p):
        d = _jax_elbo_stacked(jmodel, p, jb, jn)
        return d["loss"], d

    grads, ref = jax.jit(jax.grad(loss, has_aux=True))(params)
    ref_grads = export_reference_state_dict(grads)
    port.zero_grad(set_to_none=True)
    out = port.shared_step(tuple(map(torch.from_numpy, batch)),
                           {k: torch.from_numpy(v) for k, v in noise.items()})
    for key in ("loss", "recon", "recon/audio", "recon/vision", "kl"):
        np.testing.assert_allclose(float(out[key].detach()), float(ref[key]), rtol=2e-5,
                                   err_msg=key)
    out["loss"].backward()
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(ref_grads)
    scale = max(1.0, max(float(np.abs(g).max()) for g in ref_grads.values()))
    for name, g in ref_grads.items():
        np.testing.assert_allclose(got[name].numpy(), g, rtol=0, atol=3e-4 * scale, err_msg=name)
        _scaled_close(got[name].numpy(), g, 3e-4, name)
    for prefix in ("init_proj", "audio_encoder.res_blocks", "vision_encoder.convs.0",
                   "transition", "audio_representation"):
        assert any(float(got[n].abs().max()) > 0 for n in got if n.startswith(prefix)), prefix
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


# ---- the dispatch table -------------------------------------------------------------------


@pytest.mark.parametrize("value", ["plain", "xla", "interpret", "reference", "stacked_interpret",
                                   "false", "atuo", 1])
def test_refused_train_modes_raise(value):
    with pytest.raises(ValueError, match="use_pallas_train"):
        MoPoEMRSSM(MRSSMConfig(use_pallas_train=value))


def test_train_mode_dispatch():
    """``"auto"`` and True run the recurrence kernels, ``"stacked"`` the
    stacked ones (MRSSM only: MMTRSSM raises, as ``models/mmtrssm.py:
    459-462``); ``resolve_train_kernel_mode`` names the refusal."""
    assert not MoPoEMRSSM(MRSSMConfig()).stacked
    assert not MoPoEMRSSM(MRSSMConfig(use_pallas_train=True)).stacked
    assert MoPoEMRSSM(MRSSMConfig(use_pallas_train="stacked")).stacked
    assert kernels.resolve_train_kernel_mode("stacked") == "stacked"
    assert kernels.resolve_train_kernel_mode(True, "mmtrssm") == "kernel"
    with pytest.raises(ValueError, match="not supported by the port"):
        kernels.resolve_train_kernel_mode("reference")
    with pytest.raises(ValueError, match="MRSSM-only"):
        MoPoEMMTRSSM(MMTRSSMConfig(use_pallas_train="stacked"))
    for value in ("auto", True):
        MoPoEMMTRSSM(MMTRSSMConfig(use_pallas_train=value))

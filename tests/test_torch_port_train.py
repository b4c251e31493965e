"""The port's ELBO and its gradients against the JAX package, on the CPU.

Inputs, cotangents and noise are made by numpy from a seed and handed to
both packages; weights go through the weight bridge. On the CPU the port's
``RecurrenceFunction`` runs the plain versions of both kernels (the
backward replays the forward under autograd), so these tests exercise the
autograd wiring the card uses. Tolerances: rtol 1e-6 on distribution
values and atol 1e-6 on their gradients (f32, one op order apart); the
recurrence VJP within 2e-4 × max(1, max|ref|) per tensor and
``shared_step`` within rtol 2e-5 (losses) and atol 3e-4 × scale (gradient
tree), the bounds the JAX package holds its own kernel to
(``tests/test_pallas_train_step.py``).
"""

import dataclasses

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
from multimodal_mtrssm_tpu.ops.likelihood import gaussian_nll as jax_gaussian_nll
from multimodal_mtrssm_tpu.ops.pallas import train_step as jax_ts
from multimodal_mtrssm_tpu.train import optim as jax_optim
from multimodal_mtrssm_tpu.train.torch_export import export_reference_state_dict
from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.ops import distributions as dist
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence
from multimodal_mtrssm_tpu_torch.ops.likelihood import gaussian_nll
from multimodal_mtrssm_tpu_torch.train import optim
from multimodal_mtrssm_tpu_torch.train.steps import accumulate_gradients, apply_accumulated
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

C, K = 4, 4
S = C * K


def _port_enc(jax_enc) -> EncoderConfig:
    return EncoderConfig(**dataclasses.asdict(jax_enc))


@pytest.fixture(scope="module")
def models():
    """A small JAX model (reference recurrence path), its params, and the
    port model with the same weights."""
    from conftest import small_encoder_config

    enc = small_encoder_config()
    jmodel = JaxMoPoEMRSSM(JaxMRSSMConfig(audio_encoder=enc, vision_encoder=enc,
                                          init_proj_cells=32, use_pallas_train="reference"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(5))
    port = MoPoEMRSSM(MRSSMConfig(audio_encoder=_port_enc(enc), vision_encoder=_port_enc(enc),
                                  init_proj_cells=32, input_noise_std=0.0))
    load_reference_state_dict(port, export_reference_state_dict(params))
    return jmodel, params, port


def _scaled_close(got, ref, rel: float, name: str) -> None:
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * scale, err_msg=name)


# ---- the straight-through sample -------------------------------------------------


def test_st_sample_passes_the_block_softmax_gradient():
    """``st_sample``'s value is ``(onehot + p) - p`` bit for bit, and its
    gradient is the block-softmax VJP (``train_step._block_softmax_vjp``)."""
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((5, S)).astype(np.float32), requires_grad=True)
    gumbel = torch.tensor(rng.gumbel(size=(5, S)).astype(np.float32))
    cot = rng.standard_normal((5, S)).astype(np.float32)
    value = dist.st_sample(logits, gumbel, C, K)
    onehot = dist.onehot_blocks(logits.detach() + gumbel, C, K)
    p = dist.block_probs(logits.detach(), C, K)
    assert torch.equal(value.detach(), (onehot + p) - p)
    (grad,) = torch.autograd.grad(value, logits, torch.from_numpy(cot))
    ref = jax_ts._block_softmax_vjp(jnp.asarray(p.numpy()), jnp.asarray(cot), C, K)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert float(grad.abs().max()) > 1e-3


# ---- distributions and likelihood against JAX -----------------------------------


def _two_dists(seed: int, shape=(3, 4)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((*shape, S)).astype(np.float32) * 2
    p = rng.standard_normal((*shape, S)).astype(np.float32) * 2
    return q, p


_DIST_FNS = {
    "kl_plain": (lambda q, p: dist.kl_categorical(dist.MultiOneHot(q, C, K), dist.MultiOneHot(p, C, K)),
                 lambda q, p: jdist.kl_categorical(jdist.multi_one_hot(q, C, K),
                                                   jdist.multi_one_hot(p, C, K))),
    "kl_balanced": (
        lambda q, p: dist.kl_balanced(dist.MultiOneHot(q, C, K), dist.MultiOneHot(p, C, K),
                                      use_balancing=True),
        lambda q, p: jdist.kl_balanced(jdist.multi_one_hot(q, C, K), jdist.multi_one_hot(p, C, K),
                                       use_balancing=True)),
    "kl_balanced_off": (
        lambda q, p: dist.kl_balanced(dist.MultiOneHot(q, C, K), dist.MultiOneHot(p, C, K),
                                      use_balancing=False),
        lambda q, p: jdist.kl_balanced(jdist.multi_one_hot(q, C, K), jdist.multi_one_hot(p, C, K),
                                       use_balancing=False)),
    # ``p`` doubles as a value: its per-block one-hot mode.
    "log_prob": (lambda q, p: dist.MultiOneHot(q, C, K).log_prob(dist.onehot_blocks(p, C, K)),
                 lambda q, p: jdist.multi_one_hot(q, C, K).log_prob(
                     jdist.multi_one_hot(p, C, K).mode())),
    "entropy": (lambda q, p: dist.MultiOneHot(q, C, K).entropy() + 0 * p.sum(),
                lambda q, p: jdist.multi_one_hot(q, C, K).entropy() + 0 * p.sum()),
    "log_probs": (lambda q, p: dist.MultiOneHot(q, C, K).log_probs() + 0 * p.sum(),
                  lambda q, p: jdist.multi_one_hot(q, C, K).log_probs() + 0 * p.sum()),
}


@pytest.mark.parametrize("name", sorted(_DIST_FNS))
def test_distribution_ops_match_jax(name):
    """Value and the gradient with respect to both logits, under a random
    cotangent (balancing changes only the gradient mix)."""
    port_fn, jax_fn = _DIST_FNS[name]
    q, p = _two_dists(len(name))
    tq, tp = (torch.tensor(x, requires_grad=True) for x in (q, p))
    out = port_fn(tq, tp)
    ref, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(p))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    cot = np.random.default_rng(1).standard_normal(out.shape).astype(np.float32)
    got = torch.autograd.grad(out, (tq, tp), torch.from_numpy(cot), allow_unused=True)
    for g, r, x in zip(got, vjp(jnp.asarray(cot)), (q, p)):
        g = np.zeros_like(x) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("event_ndims,scale", [(3, 1.0), (1, 0.5)])
def test_gaussian_nll_matches_jax(event_ndims, scale):
    rng = np.random.default_rng(event_ndims)
    pred, tgt = (rng.uniform(-1, 1, (2, 3, 8, 8, 1)).astype(np.float32) for _ in range(2))
    tp = torch.tensor(pred, requires_grad=True)
    out = gaussian_nll(tp, torch.from_numpy(tgt), event_ndims, scale)
    ref, vjp = jax.vjp(lambda x: jax_gaussian_nll(x, jnp.asarray(tgt), event_ndims, scale),
                       jnp.asarray(pred))
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-6)
    (g,) = torch.autograd.grad(out, tp)
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.float32(1.0))[0]), rtol=0, atol=1e-6)


# ---- the recurrence's VJP ------------------------------------------------------------


def _recurrence_case(seed: int, B: int, T: int):
    rng = np.random.default_rng(seed)
    stoch0 = np.zeros((B, C, K), np.float32)
    stoch0[np.arange(B)[:, None], np.arange(C), rng.integers(0, K, (B, C))] = 1.0
    ins = [np.asarray(a, np.float32) for a in (
        rng.uniform(-1, 1, (T, B, 6)), rng.standard_normal((T, B, 64)),
        rng.standard_normal((T, B, 64)), np.tanh(rng.standard_normal((B, 32))),
        stoch0.reshape(B, S), rng.gumbel(size=(T, B, S)), rng.gumbel(size=(T, B, S)))]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((T, B, 32), (T, B, S), (T, B, S), (T, B, S), (T, B, S))]
    return ins, cots


def _jax_vjp(fn, packed, ins, cots):
    def loss(packed, actions, a_emb, v_emb, init_deter, init_stoch):
        outs = fn(packed, actions, a_emb, v_emb, init_deter, init_stoch,
                  jnp.asarray(ins[5]), jnp.asarray(ins[6]))
        return sum(jnp.sum(o * c) for o, c in zip(outs, map(jnp.asarray, cots)))

    return jax.grad(loss, argnums=tuple(range(6)))(packed, *map(jnp.asarray, ins[:5]))


def _port_vjp(port, ins, cots):
    weights = [w.detach().clone().requires_grad_() for w in port.representation_weights()]
    xs = [torch.from_numpy(a).requires_grad_() for a in ins[:5]]
    outs = kernels.fused_train_recurrence(weights, *xs, *map(torch.from_numpy, ins[5:]), C, K)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [w.grad for w in weights], [x.grad for x in xs]


@pytest.mark.parametrize("route", ["pallas_interpret", "pallas_chunked", "reference_autodiff"])
def test_recurrence_vjp_matches_jax(models, route, monkeypatch):
    """The port's ``RecurrenceFunction`` (CPU route) against the JAX Pallas
    kernel's VJP in interpret mode (single-block and time-chunked) and
    against ``jax.grad`` of ``reference_train_recurrence``: all 20 weight
    grads and the 5 input grads, under cotangents on all five outputs."""
    _, params, port = models
    B, T = (3, 7) if route == "pallas_chunked" else (2, 5)
    ins, cots = _recurrence_case(T * 10 + B, B, T)
    if route == "reference_autodiff":
        fn = lambda *a: jax_ts.reference_train_recurrence(*a, class_size=C, category_size=K)  # noqa: E731
    else:
        if route == "pallas_chunked":
            # Shrink the VMEM budget so JAX takes its chunked kernels (3 steps a chunk).
            row = (10 << 20) // jax_ts.chunk_len(B)
            monkeypatch.setattr(jax_ts, "VMEM_BUDGET_BYTES", row * 3)
            assert jax_ts.chunk_len(B, jax_ts.VMEM_BUDGET_BYTES) < T
        fn = lambda *a: jax_ts.fused_train_recurrence(  # noqa: E731
            *a, class_size=C, category_size=K, interpret=True)
    ref = _jax_vjp(fn, jax_ts.pack_train_params(params), ins, cots)
    d_w, d_x = _port_vjp(port, ins, cots)
    for i, (g, r) in enumerate(zip(d_w, ref[0])):
        r = np.asarray(r)
        _scaled_close(g.numpy(), r.T if r.ndim == 2 else r, 2e-4, f"weights[{i}]")
    for name, g, r in zip(("actions", "a_emb", "v_emb", "init_deter", "init_stoch"), d_x, ref[1:]):
        _scaled_close(g.numpy(), r, 2e-4, name)


def test_plain_backward_is_the_function_backward(models):
    """``recurrence_backward_plain`` on the stored record is what the
    Function returns, and a missing cotangent counts as zeros."""
    _, _, port = models
    B, T = 2, 4
    ins, cots = _recurrence_case(3, B, T)
    cots[2] = np.zeros_like(cots[2])
    weights = [w.detach() for w in port.representation_weights()]
    t_ins = [torch.from_numpy(a) for a in ins]
    with torch.no_grad():
        outs = recurrence.recurrence_forward_plain(weights, *t_ins, C, K)
    prev_deter = torch.cat([t_ins[3][None], outs[0][:-1]])
    prev_stoch = torch.cat([t_ins[4][None], outs[4][:-1]])
    plain = recurrence.recurrence_backward_plain(
        weights, *t_ins[:3], prev_deter, prev_stoch, [torch.from_numpy(c) for c in cots], C, K)
    assert len(plain) == 25
    w_req = [w.clone().requires_grad_() for w in weights]
    x_req = [t.clone().requires_grad_() for t in t_ins[:5]]
    outs = kernels.fused_train_recurrence(w_req, *x_req, *t_ins[5:], C, K)
    used = [i for i in range(5) if i != 2]  # prior_stoch gets no cotangent
    torch.autograd.backward([outs[i] for i in used], [torch.from_numpy(cots[i]) for i in used])
    for got, want in zip([*w_req, *x_req], plain):
        torch.testing.assert_close(got.grad, want, rtol=0, atol=1e-6)


# ---- shared_step against a JAX composition ------------------------------------------------


def _batch(seed: int, B: int = 2, T: int = 5):
    rng = np.random.default_rng(seed)
    act = rng.uniform(-1, 1, (B, T, 6)).astype(np.float32)
    audio, vision = (rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32) for _ in range(2))
    noise = {"g_init": rng.gumbel(size=(B, S)), "g_prior": rng.gumbel(size=(T, B, S)),
             "g_post": rng.gumbel(size=(T, B, S))}
    return (act, audio, vision, act, audio, vision), {k: v.astype(np.float32) for k, v in noise.items()}


def _jax_elbo(jmodel, params, batch, noise):
    """encoders → initial state with ``g_init`` (the straight-through
    estimator re-injected, as ``reference_train_recurrence`` does) →
    ``reference_train_recurrence`` → decoders → Gaussian NLL + balanced KL."""
    cfg = jmodel.cfg
    a_raw, v_raw = jmodel._encode_embeds(params, batch[1], batch[2])
    deter0 = mlp_apply(params["init_proj"], (a_raw[:, 0] + v_raw[:, 0]) / 2.0,
                       cfg.init_proj_activation)
    logits0 = mlp_apply(params["transition"]["rnn_to_prior_projector"], deter0, "ELU")
    s0, p0 = jax_ts._st_sample(logits0, noise["g_init"], C, K)
    stoch0 = jax.lax.stop_gradient(s0 - p0) + p0
    tm = lambda x: jnp.swapaxes(x, 0, 1)  # noqa: E731
    outs = jax_ts.reference_train_recurrence(
        jax_ts.pack_train_params(params), tm(batch[0]), tm(a_raw), tm(v_raw), deter0, stoch0,
        noise["g_prior"], noise["g_post"], class_size=C, category_size=K)
    deter, prior_logits, _, mixed, post_stoch = (tm(o) for o in outs)
    post = JaxState(deter=deter, stoch=post_stoch, distribution=jmodel._dist(mixed))
    losses = jmodel.compute_reconstruction_loss(
        jmodel.decode_state(params, post), {"recon/audio": batch[4], "recon/vision": batch[5]})
    kl = jdist.kl_balanced(post.distribution, jmodel._dist(prior_logits),
                           use_balancing=cfg.use_kl_balancing)
    losses["kl"] = jnp.mean(jnp.sum(kl, axis=-1)) * cfg.kl_coeff
    losses["loss"] = losses["recon"] + losses["kl"]
    return losses


_ELBO_GRADS: dict = {}


def _jax_elbo_grad(jmodel):
    """``jax.grad`` of ``_jax_elbo``'s loss, its terms as aux, jitted once a
    model so the tests on one shape share its compile."""
    if id(jmodel) not in _ELBO_GRADS:
        def loss(p, batch, noise):
            d = _jax_elbo(jmodel, p, batch, noise)
            return d["loss"], d

        _ELBO_GRADS[id(jmodel)] = (jmodel, jax.jit(jax.grad(loss, has_aux=True)))
    return _ELBO_GRADS[id(jmodel)][1]


def test_shared_step_loss_and_gradients_match_jax(models):
    jmodel, params, port = models
    batch, noise = _batch(11)
    grads, ref = _jax_elbo_grad(jmodel)(params, tuple(map(jnp.asarray, batch)),
                                        {k: jnp.asarray(v) for k, v in noise.items()})
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
        # Per tensor too: the tree's scale comes from the decoders, and would
        # hide a fault upstream of the initial state (a straight-through
        # sample that passes no gradient moves init_proj's by ~2%).
        _scaled_close(got[name].numpy(), g, 3e-4, name)
    # Every part of the model receives gradient: the straight-through
    # initial stoch reaches init_proj and both encoders.
    for prefix in ("init_proj", "audio_encoder", "vision_encoder", "transition", "audio_decoder"):
        assert any(float(got[n].abs().max()) > 0 for n in got if n.startswith(prefix)), prefix


def test_accumulated_gradient_and_step_match_jax(models):
    """Two batches' gradients summed by ``accumulate_gradients`` and
    divided by ``apply_accumulated``, on noise handed to both packages,
    against the mean of ``jax.grad`` over the same batches (the gradient
    tree's bound, per tensor); then that step against ``FusedAdamW``'s on
    JAX's mean gradient (rtol 1e-6, atol 1e-9: the optimizer's bound)."""
    jmodel, params, port = models
    batches = [_batch(21), _batch(22)]
    grad = _jax_elbo_grad(jmodel)
    jgrads = [grad(params, tuple(map(jnp.asarray, batch)),
                   {k: jnp.asarray(v) for k, v in noise.items()})[0] for batch, noise in batches]
    jmean = jax.tree.map(lambda a, b: (a + b) / 2.0, *jgrads)
    want = export_reference_state_dict(jmean)
    opt = optim.AdamW(port.parameters(), 1e-3)
    port.zero_grad(set_to_none=True)
    for batch, noise in batches:
        accumulate_gradients(port, tuple(map(torch.from_numpy, batch)),
                             noise={k: torch.from_numpy(v) for k, v in noise.items()})
    for name, p in port.named_parameters():
        _scaled_close(p.grad.numpy() / 2.0, want[name], 3e-4, name)
    # The step, on JAX's mean gradient in both packages.
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for name, p in port.named_parameters():
        p.grad = torch.from_numpy(np.asarray(want[name]) * 2.0)
    apply_accumulated(opt, 2)
    assert all(p.grad is None for p in port.parameters())
    jopt = jax_optim.make_optimizer(1e-3)
    updates, _ = jopt.update(jmean, jopt.init(params), params)
    after = export_reference_state_dict(jax.tree.map(lambda p, u: p + u, params, updates))
    for name, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), after[name], rtol=1e-6, atol=1e-9, err_msg=name)
    port.load_state_dict(before)  # the module's other tests share the weights


def test_shared_step_input_noise_is_added_to_the_inputs_only(models):
    """With ``input_noise_std`` the given normals are added to the three
    input streams, scaled per stream; the targets stay clean."""
    _, _, port = models
    batch, noise = _batch(12)
    rng = np.random.default_rng(3)
    normals = tuple(rng.standard_normal(x.shape).astype(np.float32) for x in batch[:3])
    stds = (0.1, 0.2, 0.0)
    noisy = port.__class__(dataclasses.replace(port.cfg, input_noise_std=stds))
    noisy.load_state_dict(port.state_dict())
    t = lambda xs: tuple(map(torch.from_numpy, xs))  # noqa: E731
    tn = {k: torch.from_numpy(v) for k, v in noise.items()}
    with torch.no_grad():
        got = noisy.shared_step(t(batch), {**tn, "input": t(normals)})
        pre = tuple(x + s * n for x, s, n in zip(batch[:3], stds, normals))
        want = port.shared_step(t(pre) + t(batch[3:]), tn)
    for key in ("loss", "recon", "kl"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6), key


def test_shared_step_draws_missing_noise_from_the_generator(models):
    _, _, port = models
    batch = tuple(map(torch.from_numpy, _batch(13)[0]))
    with torch.no_grad():
        a = port.shared_step(batch, generator=torch.Generator().manual_seed(4))
        b = port.shared_step(batch, generator=torch.Generator().manual_seed(4))
        c = port.shared_step(batch, generator=torch.Generator().manual_seed(5))
    assert all(torch.isfinite(v) for v in a.values())
    assert float(a["loss"]) == float(b["loss"]) != float(c["loss"])
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)

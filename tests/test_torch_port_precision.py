"""``trainer.precision: 16-mixed``: bf16 conv stacks with a float32
recurrence and ELBO, against the JAX package's ``conv_dtype=bfloat16``.

A YAML whose ``trainer.precision`` contains 16 sets the model's
``conv_dtype`` to ``torch.bfloat16`` as JAX's ``train/config.py:192-202``
sets it, and one without stays float32. ``shared_step`` at bf16 convs, on
JAX's XLA scan and the port's plain route with the same weights, batch and
per-step noise (``_port_models.jax_scan_gumbels``), agrees with JAX's
within JAX's own bound for bf16 against f32, ``0.01·|v| + 0.5``
(``tests/test_bf16.py:170-172``), and within the tighter bound measured
here: every loss term within 1e-5 of the loss (measured 1.4e-6). Every
gradient outside the decoders is within 5e-3 × max(1, max|JAX|) per
tensor (measured ≤ 7e-4); the decoders' are only finite, as JAX's test
holds them: both packages sum a transposed conv's bias gradient over
1024 positions in bf16, in other orders (measured up to 0.5-1.4 × the
tensor's scale). Gradients reach the float32 parameters in float32,
reconstructions come back in float32. The fused encoder's plain version
on bf16 frames (``fused_encoder_plain``) is held to JAX
``fused_encoder_apply(..., interpret=True)`` at bf16, N=4, within JAX's
0.1 (measured ~1e-3, one bf16 ulp), and its backward to ``jax.vjp`` of
JAX's ``encoder_apply`` in bf16 within 5e-2 × max(1, max|JAX|) per tensor
(measured ≤ 3.5e-2 at the reference widths: JAX's bf16 backward sums in
bf16, a few ulps of each tensor's scale).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.nn.conv import EncoderConfig as JaxEncoderConfig
from multimodal_mtrssm_tpu.nn.conv import encoder_apply, encoder_init
from multimodal_mtrssm_tpu.ops.pallas import fused_conv as jax_fused
from multimodal_mtrssm_tpu.train.config import load_experiment as jax_load_experiment
from multimodal_mtrssm_tpu.train.torch_export import _export_conv_component
from multimodal_mtrssm_tpu_torch.nn.conv import Encoder, EncoderConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
from multimodal_mtrssm_tpu_torch.train.config import load_experiment
from _port_models import jax_scan_gumbels, scan_family
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
# A reference-shaped stack at narrow widths (the fused encoder's gate needs 3
# strided convs): JAX's interpreted kernel stays seconds long.
NARROW = {"channels": (5, 7, 9), "residual_output_size": 12, "residual_intermediate_size": 10,
          "num_residual_blocks": 2, "linear_sizes": (33,)}


# ---- the YAML -------------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["mrssm", "mmtrssm"])
def test_16_mixed_maps_to_bf16_convs_as_jax(family):
    path = REPO / "configs" / f"mopoe_{family}.yaml"
    over = {"trainer": {"precision": "16-mixed"}}
    exp = load_experiment(path, over)
    assert exp.model.cfg.conv_dtype == torch.bfloat16 and exp.pending == {}
    assert jax_load_experiment(path, over).model.cfg.conv_dtype == jnp.bfloat16
    assert load_experiment(path).model.cfg.conv_dtype is None
    assert load_experiment(path, {"trainer": {"precision": "32"}}).model.cfg.conv_dtype is None


# ---- shared_step against JAX ----------------------------------------------------------------


def _batch(seed: int, B: int = 2, T: int = 5):
    rng = np.random.default_rng(seed)
    act = rng.uniform(-1, 1, (B, T, 6)).astype(np.float32)
    audio, vision = (rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32) for _ in range(2))
    return act, audio, vision, act, audio, vision


@pytest.mark.parametrize("name", ["mrssm", "mmtrssm"])
def test_bf16_shared_step_matches_jax(name):
    """Loss terms and the gradients of ``shared_step`` at bf16 convs, against
    JAX's at bf16 convs: within JAX's bound and the tighter measured ones;
    float32 gradients and reconstructions."""
    jmodel, params, port, export = scan_family(name, "ELU", "bfloat16")
    batch = _batch(3)
    key = jax.random.PRNGKey(4)

    def loss(p):
        d = jmodel.shared_step(p, tuple(map(jnp.asarray, batch)), key)
        return d["loss"], d

    grads, ref = jax.jit(jax.grad(loss, has_aux=True))(params)
    port.zero_grad(set_to_none=True)
    noise = {k: torch.from_numpy(v) for k, v in jax_scan_gumbels(key, port.cfg, 2, 5).items()}
    out = port.shared_step(tuple(map(torch.from_numpy, batch)), noise)
    out["loss"].backward()
    for k, v in out.items():
        got, want = float(v.detach()), float(ref[k])
        assert abs(got - want) <= 0.01 * abs(want) + 0.5, (k, got, want)
        assert abs(got - want) <= 1e-5 * abs(float(ref["loss"])), (k, got, want)
    ref_grads = export(grads)
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(ref_grads)
    assert all(g.dtype == torch.float32 and bool(g.isfinite().all()) for g in got.values())
    for n, g in ref_grads.items():
        if n.startswith(("audio_decoder", "vision_decoder")):
            continue
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got[n].numpy(), g, rtol=0, atol=5e-3 * scale, err_msg=n)
    with torch.no_grad():
        posterior, _ = port.observe(*map(torch.from_numpy, batch[:3]), noise)
        recon = port.decode_state(posterior)
    assert all(v.dtype == torch.float32 for v in recon.values())


# ---- the fused encoder's plain version at bf16 ----------------------------------------------


def _bridged_encoder(kw: dict):
    jcfg = JaxEncoderConfig(**kw)
    params = jax.jit(lambda key: encoder_init(key, jcfg))(jax.random.PRNGKey(3))
    sd = {}
    _export_conv_component(sd, "enc", params, encoder_head=True)
    enc = Encoder(EncoderConfig(**kw))
    enc.load_state_dict({k[len("enc."):]: torch.tensor(np.asarray(v)) for k, v in sd.items()})
    return jcfg, params, enc


def _frames(seed: int, N: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (N, 32, 32, 1)).astype(np.float32)


def test_bf16_plain_forward_matches_jax_fused_kernel():
    """``fused_encoder_plain`` on bf16 frames and weights against JAX's
    fused encoder kernel at bf16 (interpret mode, N=4, as
    ``tests/test_fused_conv.py::test_bf16_path`` runs it): bf16 out, within
    JAX's 0.1 and within two bf16 ulps of the output's scale."""
    jcfg, params, enc = _bridged_encoder(NARROW)
    x = _frames(7)
    fused = jax.jit(lambda p, v: jax_fused.fused_encoder_apply(p, jcfg, v, tile=4, interpret=True))
    ref = np.asarray(fused(params, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.encoder_weights(enc)]
    got = fused_conv.fused_encoder_plain(w, enc.cfg, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err < 0.1 and err <= 2 * 2.0 ** -8 * float(np.abs(ref).max())


def test_bf16_plain_backward_matches_jax_vjp():
    """``fused_encoder_backward_plain`` on bf16 input against ``jax.vjp`` of
    JAX's ``encoder_apply`` with bf16 params and frames: dx and every weight
    gradient in bf16, within 5e-2 × max(1, max|JAX|) per tensor."""
    jcfg, params, enc = _bridged_encoder({})
    x, g = _frames(8), np.random.default_rng(9).standard_normal((4, 64)).astype(np.float32)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    dp, dx_ref = jax.jit(lambda p, v, c: jax.vjp(lambda p, v: encoder_apply(p, jcfg, v), p, v)[1](c))(
        pb, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16))
    sd = {}
    _export_conv_component(sd, "enc", jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), dp),
                           encoder_head=True)
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.encoder_weights(enc)]
    dx, dw = fused_conv.fused_encoder_backward_plain(
        w, enc.cfg, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(g).to(torch.bfloat16),
        True)
    names = {id(p): n for n, p in enc.named_parameters()}
    pairs = [(d, sd["enc." + names[id(t)]]) for t, d in zip(fused_conv.encoder_weights(enc), dw)]
    pairs.append((dx, np.asarray(dx_ref.astype(jnp.float32))))
    for got, ref in pairs:
        assert got.dtype == torch.bfloat16
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(got.float().numpy() - ref).max()) <= 5e-2 * scale


def test_fused_enc_on_bf16_frames_on_the_cpu():
    """``fused_encoder_apply`` on bf16 frames runs the plain bf16 version on
    the CPU (no launch), differentiable to the float32 master parameters,
    whose gradients are the plain backward's, widened; the cuDNN-layout
    ``Encoder`` on bf16 frames agrees with it within bf16 rounding."""
    _, _, enc = _bridged_encoder(NARROW)
    x = torch.from_numpy(_frames(10, 6)).to(torch.bfloat16)
    g = torch.from_numpy(np.random.default_rng(11).standard_normal((6, 33)).astype(np.float32))
    kernels.reset_launch_counts()
    out = fused_conv.fused_encoder_apply(enc, x)
    out.backward(g.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.encoder_weights(enc)]
    _, dw = fused_conv.fused_encoder_backward_plain(w, enc.cfg, x, g.to(torch.bfloat16), False)
    for t, d in zip(fused_conv.encoder_weights(enc), dw):
        assert t.grad.dtype == torch.float32 and torch.equal(t.grad, d.float())
    with torch.no_grad():
        cudnn = enc(x)
    assert cudnn.dtype == torch.bfloat16
    assert float((cudnn.float() - out.detach().float()).abs().max()) <= 4 * 2.0 ** -8 * max(
        1.0, float(out.detach().float().abs().max()))


def test_conv_dtype_is_validated():
    from multimodal_mtrssm_tpu_torch.models import MRSSMConfig

    assert MRSSMConfig(conv_dtype=torch.bfloat16).conv_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="conv_dtype"):
        MRSSMConfig(conv_dtype=torch.float16)
    dataclasses.replace(MRSSMConfig(), conv_dtype=None)

"""The port's fused conv decoder (``fused_decoder_apply``) against JAX.

``ops/kernels/fused_conv.py``'s decoder entry is held to the decoder entry
of ``ops/pallas/fused_conv.py`` run as the JAX package's own tests run it
on the CPU (``fused_decoder_apply(params, cfg, f, tile=8, interpret=True)``,
``tests/test_fused_conv.py``), on the decoders of a bridged MoPoE-MRSSM
(48-wide features) and MoPoE-MMTRSSM (96-wide), and on a decoder with a
``res_proj`` bridged alone; features and targets are made with numpy. The
frames within 1e-5 (f32 convolutions summed in another order, then a Tanh);
under a mean-squared loss, as the JAX test takes, every decoder parameter's
gradient and the features' within 1e-4 × max(1, max|JAX|) per tensor. On
the CPU the port runs the kernels' plain versions through the same
``FusedStackFunction`` the card uses; ``tests/test_torch_port_gpu.py``
holds the CUDA kernels to those plain versions on the card.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.models.mmtrssm import MMTRSSMConfig as JaxMMTRSSMConfig
from multimodal_mtrssm_tpu.models.mmtrssm import MoPoEMMTRSSM as JaxMoPoEMMTRSSM
from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
from multimodal_mtrssm_tpu.nn.conv import DecoderConfig as JaxDecoderConfig
from multimodal_mtrssm_tpu.nn.conv import decoder_init
from multimodal_mtrssm_tpu.ops.pallas import fused_conv as jax_fused
from multimodal_mtrssm_tpu.train.torch_export import (
    _export_conv_component,
    export_reference_mmtrssm_state_dict,
    export_reference_state_dict,
)
from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.nn.conv import Decoder, DecoderConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

N = 11  # a ragged count: JAX pads it to two tiles of 8
FAMILIES = {
    "mrssm": (JaxMoPoEMRSSM, JaxMRSSMConfig, export_reference_state_dict, MoPoEMRSSM, MRSSMConfig),
    "mmtrssm": (JaxMoPoEMMTRSSM, JaxMMTRSSMConfig, export_reference_mmtrssm_state_dict,
                MoPoEMMTRSSM, MMTRSSMConfig),
}


def _export_decoder(params) -> dict[str, np.ndarray]:
    """A JAX decoder's params (or their gradients) under the port
    ``Decoder``'s names, through the exporter the model bridge uses."""
    sd: dict[str, np.ndarray] = {}
    _export_conv_component(sd, "decoder", params)
    return {k[len("decoder."):]: v for k, v in sd.items()}


def _jax_reference(params, cfg, seed: int, *lead: int):
    """JAX's fused decoder (interpret mode) on numpy features: the frames,
    and under a mean-squared loss against numpy targets the gradients of
    the decoder's params (port names) and of the features."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((*lead, cfg.in_features)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (*lead, 32, 32, 1)).astype(np.float32)

    def apply(p, x):
        return jax_fused.fused_decoder_apply(p, cfg, x, tile=8, interpret=True)

    def loss(p, x):
        return jnp.mean((apply(p, x) - tgt) ** 2)

    frames = apply(params, jnp.asarray(feats))
    g_params, g_feats = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(feats))
    return types.SimpleNamespace(feats=feats, tgt=tgt, frames=np.asarray(frames),
                                 grads=_export_decoder(g_params), g_feats=np.asarray(g_feats))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def bridged(request):
    """A JAX model of each family at its reference config and the port model
    with the same weights; their audio decoders are the pair under test,
    with JAX's results computed once."""
    jcls, jcfg, export, pcls, pcfg = FAMILIES[request.param]
    jmodel = jcls(jcfg())
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(21))
    port = pcls(pcfg())
    load_reference_state_dict(port, export(params))
    cfg = jmodel.cfg.decoder_cfg("audio")
    return types.SimpleNamespace(decoder=port.audio_decoder, params=params["audio_decoder"],
                                 cfg=cfg, ref=_jax_reference(params["audio_decoder"], cfg, 5, N))


def _check_grads(decoder: Decoder, feats: torch.Tensor, ref) -> None:
    got = dict(decoder.named_parameters())
    assert set(got) == set(ref.grads)
    for name, r in ref.grads.items():
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(got[name].grad.numpy(), r, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    scale = max(1.0, float(np.abs(ref.g_feats).max()))
    np.testing.assert_allclose(feats.grad.numpy(), ref.g_feats, rtol=0, atol=1e-4 * scale)


def _port_backward(decoder: Decoder, ref) -> torch.Tensor:
    """The port's decoder under JAX's mean-squared loss; returns the
    features, whose ``.grad`` holds their gradient."""
    decoder.zero_grad(set_to_none=True)
    feats = torch.from_numpy(ref.feats).requires_grad_()
    loss = torch.mean((fused_conv.fused_decoder_apply(decoder, feats) - torch.from_numpy(ref.tgt))
                      ** 2)
    loss.backward()
    return feats


# ---- the decoder against JAX -----------------------------------------------------------------


def test_plain_matches_jax_fused_kernel(bridged):
    with torch.no_grad():
        got = fused_conv.fused_decoder_apply(bridged.decoder, torch.from_numpy(bridged.ref.feats))
    assert got.shape == (N, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), bridged.ref.frames, rtol=0, atol=1e-5)


def test_gradients_match_jax_grad_through_the_kernel(bridged):
    """Every decoder parameter's gradient and the features' under JAX's
    mean-squared loss, against ``jax.grad`` through the Pallas kernels'
    custom VJP (interpret mode); the JAX gradients reach the port's names
    through the weight bridge."""
    feats = _port_backward(bridged.decoder, bridged.ref)
    assert len(bridged.ref.grads) == 22
    _check_grads(bridged.decoder, feats, bridged.ref)


def test_leading_dims_match_jax(bridged):
    """``[3, 5, F]`` features → ``[3, 5, 32, 32, 1]`` frames, as JAX's
    ``tests/test_fused_conv.py::test_fused_decoder_leading_dims``."""
    f = np.random.default_rng(6).standard_normal((3, 5, bridged.cfg.in_features)).astype(np.float32)
    ref = jax_fused.fused_decoder_apply(bridged.params, bridged.cfg, jnp.asarray(f), tile=8,
                                        interpret=True)
    with torch.no_grad():
        got = fused_conv.fused_decoder_apply(bridged.decoder, torch.from_numpy(f))
    assert got.shape == (3, 5, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_plain_matches_the_cudnn_route_decoder(bridged):
    """The plain version equals the port's canonical ``Decoder`` module."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (7, bridged.cfg.in_features)).astype(np.float32))
    with torch.no_grad():
        got = fused_conv.fused_decoder_plain(fused_conv.decoder_weights(bridged.decoder),
                                             bridged.decoder.cfg, x)
        ref = bridged.decoder(x)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_res_proj_decoder_matches_jax():
    """A decoder whose residual stack is narrower than its conv input
    (``residual_input_size`` 32 against 64 channels) has a 1×1 ``res_proj``:
    the kernels take it; frames and gradients against JAX."""
    overrides = {"in_features": 48, "residual_input_size": 32}
    jcfg = JaxDecoderConfig(**overrides)
    params = decoder_init(jax.random.PRNGKey(22), jcfg)
    decoder = Decoder(DecoderConfig(**overrides))
    assert decoder.res_proj is not None and fused_conv.fused_decoder_applicable(decoder.cfg)
    load_reference_state_dict(decoder, _export_decoder(params))
    ref = _jax_reference(params, jcfg, 8, 9)
    with torch.no_grad():
        got = fused_conv.fused_decoder_apply(decoder, torch.from_numpy(ref.feats))
    np.testing.assert_allclose(got.numpy(), ref.frames, rtol=0, atol=1e-5)
    feats = _port_backward(decoder, ref)
    assert len(ref.grads) == 24
    _check_grads(decoder, feats, ref)


# ---- eligibility and refusals ----------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    {}, {"in_features": 96}, {"residual_input_size": 32}, {"num_residual_blocks": 0},
    {"num_residual_blocks": 1}, {"num_residual_blocks": fused_conv.MAX_RESIDUAL_BLOCKS},
    {"residual_intermediate_size": 64}, {"linear_sizes": (128, 1024)},
    {"linear_sizes": (64, 512), "conv_in_shape": (32, 4, 4), "residual_input_size": 32},
    {"channels": (16, 8, 1)},
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "reference")
def test_gate_takes_every_config_jax_takes_at_32x32x1(overrides):
    """Every config JAX's ``fused_decoder_applicable`` takes whose frames are
    32×32×1, the port's gate takes too, and the port builds it."""
    cfg = DecoderConfig(**{"in_features": 48, **overrides})
    assert jax_fused.fused_decoder_applicable(JaxDecoderConfig(**dataclasses.asdict(cfg)))
    assert fused_conv.fused_decoder_applicable(cfg)
    dec = Decoder(cfg)
    assert [tuple(t.shape) for t in fused_conv.decoder_weights(dec)] == \
        fused_conv.decoder_weight_shapes(cfg)


@pytest.mark.parametrize("overrides,jax_takes", [
    ({"channels": (32, 16, 3)}, True),  # 32×32×3 frames: the kernels write one channel
    ({"num_residual_blocks": fused_conv.MAX_RESIDUAL_BLOCKS + 1}, True),  # the layer table
    ({"linear_sizes": (64, 512)}, True),  # the second linear does not fill conv_in_shape
    ({"activation_name": "ReLU"}, False),
    ({"out_activation_name": "Sigmoid"}, False),
    ({"kernel_sizes": (3, 3, 3)}, False),
    ({"output_paddings": (1, 1, 1)}, False),
    ({"conv_in_shape": (16, 8, 8)}, False),
    ({"channels": (16, 1), "kernel_sizes": (4, 4), "strides": (2, 2), "paddings": (1, 1),
      "output_paddings": (0, 0)}, False),
    ({"linear_sizes": (1024,)}, False),
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) if isinstance(o, dict) else str(o))
def test_gate_refuses_what_the_kernels_do_not_take(overrides, jax_takes):
    """What JAX's gate refuses the port's refuses; beyond it the port refuses
    what its kernels assume (32×32×1 frames, a layer table of 14, a second
    linear as wide as ``conv_in_shape``), and ``fused_decoder_apply``
    raises for it."""
    cfg = DecoderConfig(**{"in_features": 48, **overrides})
    jax_cfg = JaxDecoderConfig(**dataclasses.asdict(cfg))
    assert jax_fused.fused_decoder_applicable(jax_cfg) == jax_takes
    assert not fused_conv.fused_decoder_applicable(cfg)
    decoder = types.SimpleNamespace(cfg=cfg)
    with pytest.raises(ValueError, match="do not take this decoder"):
        fused_conv.fused_decoder_apply(decoder, torch.zeros(2, 48))


def test_apply_refuses_features_and_devices_it_does_not_take(bridged):
    """Features of another width raise; a device other than the CPU and CUDA
    raises; CPU tensors launch no kernel."""
    dec, width = bridged.decoder, bridged.cfg.in_features
    with pytest.raises(ValueError, match="features"):
        fused_conv.fused_decoder_apply(dec, torch.zeros(2, width + 1))
    with pytest.raises(ValueError, match="no fused decoder route for device meta"):
        fused_conv.fused_decoder_apply(dec, torch.zeros(2, width, device="meta"))
    kernels.reset_launch_counts()
    with torch.no_grad():
        kernels.fused_decoder_apply(dec, torch.zeros(2, width))
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes(bridged):
    """The CUDA wrappers raise on CPU tensors and on features or weights
    they do not take, before any build or launch."""
    dec, cfg = bridged.decoder, bridged.decoder.cfg
    w = [t.detach() for t in fused_conv.decoder_weights(dec)]
    feats = torch.zeros(3, cfg.in_features)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.fused_decoder_forward_cuda(w, cfg, feats)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.fused_decoder_backward_cuda(w, cfg, feats, torch.zeros(3, 32, 32, 1), True)
    with pytest.raises(ValueError, match="features"):
        fused_conv.fused_decoder_forward_cuda(w, cfg, torch.zeros(3, 5, cfg.in_features))
    with pytest.raises(ValueError, match="decoder tensors"):
        fused_conv.fused_decoder_forward_cuda(w[:-2], cfg, feats)

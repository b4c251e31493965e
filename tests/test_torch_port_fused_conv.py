"""The port's fused encoder (``conv_layout="fused_enc"``) against JAX, and the
device repairs of the serving entry points.

``ops/kernels/fused_conv.py`` is held to the encoder entry of
``ops/pallas/fused_conv.py`` run as the JAX package's own tests run it on
the CPU (``fused_encoder_apply(..., tile=8, interpret=True)``), on weights
bridged from JAX params: the embedding within 2e-5 (f32 convolutions summed
in another order), the gradients of every encoder parameter and of the
frames within 1e-4 × max(1, max|JAX|) per tensor; and the MMTRSSM
``shared_step`` at ``MMTRSSMConfig(conv_layout="fused_enc")`` — loss within
rtol 2e-5, gradient tree within 3e-4 × scale — against the JAX model at
the same config. On the CPU the port runs the kernels' plain versions
through the same ``FusedStackFunction`` the card uses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.models.mmtrssm import MMTRSSMConfig as JaxMMTRSSMConfig
from multimodal_mtrssm_tpu.models.mmtrssm import MoPoEMMTRSSM as JaxMoPoEMMTRSSM
from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
from multimodal_mtrssm_tpu.nn.conv import EncoderConfig as JaxEncoderConfig
from multimodal_mtrssm_tpu.ops.pallas import fused_conv as jax_fused
from multimodal_mtrssm_tpu.train.torch_export import (
    export_reference_mmtrssm_state_dict,
    export_reference_state_dict,
)
from multimodal_mtrssm_tpu_torch import server as server_mod
from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
from multimodal_mtrssm_tpu_torch.server import InferenceServer
from multimodal_mtrssm_tpu_torch.serving import WorldModel
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

REF = EncoderConfig()


@pytest.fixture(scope="module")
def bridged():
    """JAX MRSSM params at the reference config and the port model with the
    same weights: their encoders are the pair under test."""
    jmodel = JaxMoPoEMRSSM(JaxMRSSMConfig(conv_layout="fused_enc"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(8))
    port = MoPoEMRSSM(MRSSMConfig(conv_layout="fused_enc"))
    load_reference_state_dict(port, export_reference_state_dict(params))
    return params, port


def _frames(seed: int, *lead: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (*lead, 32, 32, 1)).astype(np.float32)


# ---- eligibility ------------------------------------------------------------------------


def test_applicable_gates():
    """JAX's gates (``tests/test_fused_conv.py::test_applicable_gates``), and
    the 32×32×1 frames JAX assumes without checking."""
    assert fused_conv.fused_encoder_applicable(REF)
    assert fused_conv.fused_encoder_applicable(EncoderConfig(coord_conv=False))
    for bad in (EncoderConfig(channels=(8, 16), kernel_sizes=(3, 3), strides=(2, 2),
                              paddings=(1, 1)),
                EncoderConfig(activation_name="ReLU"), EncoderConfig(in_hw=(64, 64)),
                EncoderConfig(in_channels=3), EncoderConfig(linear_sizes=(128, 64)),
                EncoderConfig(num_residual_blocks=fused_conv.MAX_RESIDUAL_BLOCKS + 1)):
        assert not fused_conv.fused_encoder_applicable(bad), bad
    # Every config JAX's gate takes, at 32×32×1, the port's takes too.
    jax_ref = JaxEncoderConfig(**dataclasses.asdict(REF))
    assert jax_fused.fused_encoder_applicable(jax_ref)


def test_conv_layout_resolves_as_jax():
    """``"fused_enc"`` selects the fused encoder and raises naming it for
    ineligible stacks, in both families; ``"auto"``, ``"nhwc"`` and
    ``"s2d"`` keep the canonical layout; anything else raises."""
    bad = EncoderConfig(channels=(8, 16), kernel_sizes=(3, 3), strides=(2, 2), paddings=(1, 1))
    assert MoPoEMRSSM(MRSSMConfig(conv_layout="fused_enc")).fused_enc
    assert MoPoEMMTRSSM(MMTRSSMConfig(conv_layout="fused_enc")).fused_enc
    for layout in ("auto", "nhwc", "s2d"):
        assert not MoPoEMRSSM(MRSSMConfig(conv_layout=layout)).fused_enc
        assert fused_conv.resolve_conv_layout(layout, (bad,)) == "canonical"
    with pytest.raises(ValueError, match="fused_enc"):
        MoPoEMRSSM(MRSSMConfig(conv_layout="fused_enc", audio_encoder=bad, vision_encoder=bad))
    with pytest.raises(ValueError, match="fused_enc"):
        MoPoEMMTRSSM(MMTRSSMConfig(conv_layout="fused_enc", vision_encoder=bad))
    with pytest.raises(ValueError, match="fused_enc"):
        MoPoEMRSSM(MRSSMConfig(conv_layout="fused_enc",
                               audio_encoder=EncoderConfig(in_hw=(16, 16))))
    with pytest.raises(ValueError, match="conv_layout"):
        MoPoEMRSSM(MRSSMConfig(conv_layout="nchw"))


# ---- the encoder against JAX ----------------------------------------------------------------


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_plain_matches_jax_fused_kernel(bridged, lead):
    """A ragged N (5 frames in JAX's tile of 8) and leading ``[B, T]`` dims."""
    params, port = bridged
    x = _frames(len(lead), *lead)
    ref = jax_fused.fused_encoder_apply(params["audio_encoder"], JaxEncoderConfig(),
                                        jnp.asarray(x), tile=8, interpret=True)
    with torch.no_grad():
        got = fused_conv.fused_encoder_apply(port.audio_encoder, torch.from_numpy(x))
    assert got.shape == (*lead, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


def test_gradients_match_jax_grad_through_the_kernel(bridged):
    """Every encoder parameter's gradient and the frames' under a random
    cotangent, against ``jax.grad`` through the Pallas kernels' custom VJP
    (interpret mode); the JAX gradients reach the port's names through the
    weight bridge."""
    params, port = bridged
    x = _frames(4, 5)
    cot = np.random.default_rng(5).standard_normal((5, 64)).astype(np.float32)

    def loss(p, xs):
        out = jax_fused.fused_encoder_apply(p["vision_encoder"], JaxEncoderConfig(), xs, tile=8,
                                            interpret=True)
        return jnp.sum(out * cot)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    ref = {k[len("vision_encoder."):]: v for k, v in export_reference_state_dict(g_params).items()
           if k.startswith("vision_encoder.")}
    enc = port.vision_encoder
    enc.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = fused_conv.fused_encoder_apply(enc, xt)
    out.backward(torch.from_numpy(cot))
    got = dict(enc.named_parameters())
    assert set(got) == set(ref) and len(ref) == 22
    for name, r in ref.items():
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(got[name].grad.numpy(), r, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    scale = max(1.0, float(np.abs(np.asarray(g_x)).max()))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=0, atol=1e-4 * scale)


def test_plain_matches_the_cudnn_route_encoder(bridged):
    """The plain version equals the port's canonical ``Encoder`` module."""
    _, port = bridged
    x = torch.from_numpy(_frames(6, 7))
    with torch.no_grad():
        got = fused_conv.fused_encoder_plain(fused_conv.encoder_weights(port.audio_encoder), REF, x)
        ref = port.audio_encoder(x)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_weight_shapes_and_refusals(bridged):
    """``weight_shapes`` names the encoder's tensors in the kernels' order;
    frames that are not 32×32×1 and encoders the kernels do not take raise;
    CPU tensors launch nothing."""
    _, port = bridged
    enc = port.audio_encoder
    assert [tuple(t.shape) for t in fused_conv.encoder_weights(enc)] == \
        fused_conv.weight_shapes(REF)
    with pytest.raises(ValueError, match="frames"):
        fused_conv.fused_encoder_apply(enc, torch.zeros(2, 16, 16, 1))
    with pytest.raises(ValueError, match="frames"):
        fused_conv.fused_encoder_apply(enc, torch.zeros(2, 32, 32, 3))
    small = MoPoEMRSSM(MRSSMConfig(audio_encoder=EncoderConfig(channels=(4, 8), kernel_sizes=(3, 3),
                                                               strides=(2, 2), paddings=(1, 1))))
    with pytest.raises(ValueError, match="fused_enc"):
        fused_conv.fused_encoder_apply(small.audio_encoder, torch.zeros(2, 32, 32, 1))
    kernels.reset_launch_counts()
    with torch.no_grad():
        fused_conv.fused_encoder_apply(enc, torch.zeros(2, 32, 32, 1))
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


# ---- MMTRSSM at conv_layout="fused_enc" -------------------------------------------------------


def test_mmtrssm_fused_enc_shared_step_matches_jax():
    """``shared_step``'s losses and gradient tree at ``MMTRSSMConfig(
    conv_layout="fused_enc")`` against the JAX model at the same config (its
    fused encoder in interpret mode) on the same noise."""
    from test_torch_port_mt_model import _batch, _jax_elbo

    jmodel = JaxMoPoEMMTRSSM(JaxMMTRSSMConfig(conv_layout="fused_enc", init_proj_cells=32,
                                              use_pallas_train="reference"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(12))
    port = MoPoEMMTRSSM(MMTRSSMConfig(conv_layout="fused_enc", init_proj_cells=32,
                                      input_noise_std=0.0))
    load_reference_state_dict(port, export_reference_mmtrssm_state_dict(params))
    batch, noise = _batch(31, b=2, t=3)
    jb = tuple(map(jnp.asarray, batch))
    jn = {k: jnp.asarray(v) for k, v in noise.items()}

    def loss(p):
        d = _jax_elbo(jmodel, p, jb, jn)
        return d["loss"], d

    grads, ref = jax.jit(jax.grad(loss, has_aux=True))(params)
    ref_grads = export_reference_mmtrssm_state_dict(grads)
    out = port.shared_step(tuple(map(torch.from_numpy, batch)),
                           {k: torch.from_numpy(v) for k, v in noise.items()})
    for key in ("loss", "recon", "kl", "kl_h"):
        np.testing.assert_allclose(float(out[key].detach()), float(ref[key]), rtol=2e-5,
                                   err_msg=key)
    out["loss"].backward()
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(ref_grads)
    scale = max(1.0, max(float(np.abs(g).max()) for g in ref_grads.values()))
    for name, g in ref_grads.items():
        np.testing.assert_allclose(got[name].numpy(), g, rtol=0, atol=3e-4 * scale, err_msg=name)
    for prefix in ("audio_encoder.convs.0", "vision_encoder.res_blocks.2", "audio_encoder.linears"):
        assert any(float(got[n].abs().max()) > 0 for n in got if n.startswith(prefix)), prefix


# ---- serving at the new config, and the device repairs ------------------------------------


def test_serving_observe_and_imagine_at_fused_enc_stacked():
    """``/observe`` and two chained ``/imagine`` through ``InferenceServer``
    on the CPU at ``MRSSMConfig(conv_layout="fused_enc",
    use_pallas_train="stacked")``; the observed posterior equals the
    canonical-layout model's on the same weights and seed."""
    from test_torch_port_serving import _request

    cfg = MRSSMConfig(conv_layout="fused_enc", use_pallas_train="stacked")
    port = MoPoEMRSSM(cfg).init(torch.Generator().manual_seed(2))
    canonical = MoPoEMRSSM(MRSSMConfig())
    canonical.load_state_dict(port.state_dict())
    B, T = 2, 4
    rng = np.random.default_rng(9)
    obs = {"actions": rng.uniform(-1, 1, (B, T, 6)).astype(np.float32),
           "audio": _frames(10, B, T), "vision": _frames(11, B, T)}
    post, ref = (WorldModel(m, device="cpu").observe(obs["actions"], obs["audio"], obs["vision"],
                                                     seed=3)[0] for m in (port, canonical))
    torch.testing.assert_close(post.deter, ref.deter, rtol=0, atol=1e-5)
    assert torch.equal(post.stoch.round(), ref.stoch.round())
    server = InferenceServer(WorldModel(port, device="cpu"), port=0)
    server.start()
    try:
        code, out = _request(server.port, "/observe", {**{k: v.tolist() for k, v in obs.items()},
                                                       "seed": 3, "decode": True})
        assert code == 200 and np.asarray(out["recon"]["recon/audio"]).shape == (B, T, 32, 32, 1)
        plan = np.zeros((B, 5, 6), np.float32)
        state = out["state_id"]
        for seed in (1, 2):
            code, im = _request(server.port, "/imagine",
                                {"state_id": state, "actions": plan.tolist(), "seed": seed})
            assert code == 200
            frames = np.asarray(im["frames"]["recon/vision"])
            assert frames.shape == (B, 5, 32, 32, 1) and np.isfinite(frames).all()
            state = im["state_id"]
    finally:
        server.stop()


def test_world_model_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = MoPoEMRSSM()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WorldModel(model)
    assert WorldModel(model, device="cpu").device == torch.device("cpu")


def test_server_device_defaults_to_cuda(monkeypatch):
    """``serve`` without ``--device`` asks for the card and says so when
    there is none; ``--device cpu`` serves on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = {}

    class Fake:
        def __init__(self, wm, host, port):
            built["device"], self.port = wm.device, 0

        def serve_forever(self):
            pass

    monkeypatch.setattr(server_mod, "InferenceServer", Fake)
    with pytest.raises(SystemExit, match="--device cpu"):
        server_mod.main([])
    with pytest.raises(SystemExit, match="--device cuda:1"):
        server_mod.main(["--device", "cuda:1"])
    server_mod.main(["--device", "cpu"])
    assert built["device"] == torch.device("cpu")

"""The port's dense and conv building blocks against the JAX package.

Each port function gets the same numpy inputs (and, where it has weights,
the same weights through the weight bridge) as its JAX counterpart.
Tolerances: 1e-5 absolute for dense ops, 1e-4 for conv stacks (f32; the two
frameworks order their sums differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
from multimodal_mtrssm_tpu.nn import conv as jconv
from multimodal_mtrssm_tpu.nn import core as jcore
from multimodal_mtrssm_tpu.ops import distributions as jdist
from multimodal_mtrssm_tpu.ops import fusion as jfusion
from multimodal_mtrssm_tpu.ops.pallas import rollout as jax_rollout
from multimodal_mtrssm_tpu.ops.pallas import train_step as jax_train_step
from multimodal_mtrssm_tpu.train.torch_export import (
    _export_conv_component,
    export_reference_state_dict,
)
from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.nn import conv as tconv
from multimodal_mtrssm_tpu_torch.nn import core as tcore
from multimodal_mtrssm_tpu_torch.ops import distributions as tdist
from multimodal_mtrssm_tpu_torch.ops import fusion as tfusion
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

C, K = 4, 4
DENSE = 1e-5
CONV = 1e-4


def _rng(seed: int):
    return np.random.default_rng(seed)


def _f32(x) -> np.ndarray:
    return np.array(x, np.float32)  # a writable copy, as torch.from_numpy wants


def _close(port: torch.Tensor, ref, atol: float) -> None:
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


# ---- distributions -------------------------------------------------------------


def test_block_probs_and_mode_match_jax():
    logits = _f32(_rng(0).standard_normal((5, 7, C * K)) * 3)
    dist = jdist.MultiOneHot(logits=jnp.asarray(logits), class_size=C, category_size=K)
    port = tdist.MultiOneHot(torch.from_numpy(logits), C, K)
    _close(port.probs(), dist.probs(), DENSE)
    np.testing.assert_array_equal(port.mode().numpy(), np.asarray(dist.mode()))


def test_onehot_blocks_take_the_first_index_on_ties():
    scores = _f32(_rng(1).integers(0, 3, (64, C * K)))  # many exact ties
    port = tdist.onehot_blocks(torch.from_numpy(scores), C, K)
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(jax_rollout.onehot_blocks(jnp.asarray(scores), C, K)))
    assert bool((port.reshape(64, C, K).sum(-1) == 1).all())


def test_st_sample_matches_the_jax_kernels():
    """Same logits and noise: the same categories, and the straight-through
    value (onehot + p) - p, exactly 0 off the sample and within an ulp of 1
    on it (torch's and XLA's exp differ in the last bit, and so does p)."""
    rng = _rng(2)
    logits = _f32(rng.standard_normal((16, C * K)) * 2)
    noise = _f32(rng.gumbel(size=(16, C * K)))
    port = tdist.st_sample(torch.from_numpy(logits), torch.from_numpy(noise), C, K).numpy()
    ref, _ = jax_train_step._st_sample(jnp.asarray(logits), jnp.asarray(noise), C, K)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(port.round(), ref.round())
    np.testing.assert_array_equal(port[ref.round() == 0], 0.0)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1.2e-7)


def test_gumbel_noise_follows_the_generator():
    a = tdist.gumbel_noise((4, 16), torch.Generator().manual_seed(3))
    b = tdist.gumbel_noise((4, 16), torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


# ---- fusion ---------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_fusion_matches_jax(scale):
    rng = _rng(4)
    a = _f32(rng.standard_normal((6, 3, C * K)) * scale)
    v = _f32(rng.standard_normal((6, 3, C * K)) * scale)
    ta, tv = torch.from_numpy(a), torch.from_numpy(v)
    _close(tfusion.poe_fuse_log_probs(ta, tv),
           jfusion.poe_fuse_log_probs(jnp.asarray(a), jnp.asarray(v)), DENSE * scale)
    _close(tfusion.mopoe_mix_log_probs(ta, tv),
           jfusion.mopoe_mix_log_probs(jnp.asarray(a), jnp.asarray(v)), DENSE * scale)
    assert tfusion.LOG_THIRD == jfusion._LOG_THIRD


# ---- MLP, GRU, transition --------------------------------------------------------


def _load_mlp(seq: torch.nn.Sequential, params) -> None:
    linears = [m for m in seq if isinstance(m, torch.nn.Linear)]
    with torch.no_grad():
        for lin, layer in zip(linears, params["layers"]):
            lin.weight.copy_(torch.from_numpy(_f32(layer["w"]).T.copy()))
            lin.bias.copy_(torch.from_numpy(_f32(layer["b"])))


@pytest.mark.parametrize("depth,act,activate_last", [
    (1, "ELU", False), (2, "Tanh", False), (1, "ELU", True), (0, "ReLU", False),
])
def test_mlp_matches_jax(depth, act, activate_last):
    params = jcore.mlp_init(jax.random.PRNGKey(depth), 10, 7, 12, depth=depth)
    seq = tcore.mlp(10, 7, 12, depth=depth, act=act, activate_last=activate_last)
    _load_mlp(seq, params)
    assert len(seq) == 2 * (depth + 1) - (0 if activate_last else 1)
    x = _f32(_rng(5).standard_normal((9, 10)))
    _close(seq(torch.from_numpy(x)),
           jcore.mlp_apply(params, jnp.asarray(x), act, activate_last=activate_last), DENSE)


def test_gru_cell_matches_jax():
    """``gru_cell`` (the kernels' plain step) equals JAX ``gru_apply`` and
    torch's ``nn.GRUCell``, whose layout the transition keeps; the JAX
    ``w_ih`` is ``[H, 3D]``, torch's ``[3D, H]``, gate order r, z, n in both."""
    params = jcore.gru_init(jax.random.PRNGKey(6), 12, 8)
    w_ih, w_hh = (torch.from_numpy(_f32(params[k]).T.copy()) for k in ("w_ih", "w_hh"))
    b_ih, b_hh = (torch.from_numpy(_f32(params[k])) for k in ("b_ih", "b_hh"))
    rng = _rng(7)
    x, h = (torch.from_numpy(_f32(rng.standard_normal((5, n)))) for n in (12, 8))
    got = tcore.gru_cell(x, h, w_ih, w_hh, b_ih, b_hh)
    _close(got, jcore.gru_apply(params, jnp.asarray(x.numpy()), jnp.asarray(h.numpy())), DENSE)
    cell = torch.nn.GRUCell(12, 8)
    cell.load_state_dict({"weight_ih": w_ih, "weight_hh": w_hh, "bias_ih": b_ih, "bias_hh": b_hh})
    _close(got, cell(x, h).detach().numpy(), DENSE)


@pytest.fixture(scope="module")
def small_models():
    """A small JAX MoPoE-MRSSM, its params, and the port model loaded from
    them through the weight bridge."""
    from conftest import small_encoder_config

    enc = small_encoder_config()
    jmodel = JaxMoPoEMRSSM(JaxMRSSMConfig(audio_encoder=enc, vision_encoder=enc))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(8))
    port_enc = tconv.EncoderConfig(**dataclasses.asdict(enc))
    port = MoPoEMRSSM(MRSSMConfig(audio_encoder=port_enc, vision_encoder=port_enc))
    load_reference_state_dict(port, export_reference_state_dict(params))
    return jmodel, params, port.eval()


def test_rssm_transition_core_matches_jax(small_models):
    jmodel, params, port = small_models
    rng = _rng(9)
    action = _f32(rng.uniform(-1, 1, (5, 6)))
    stoch = _f32(np.eye(K)[rng.integers(0, K, (5, C))].reshape(5, C * K))
    deter = _f32(np.tanh(rng.standard_normal((5, 32))))
    d, lg = tcore.rssm_transition_core(port.transition, torch.from_numpy(action),
                                       torch.from_numpy(stoch), torch.from_numpy(deter), "ELU")
    jd, jl = jcore.rssm_transition_core(params["transition"], jnp.asarray(action),
                                        jnp.asarray(stoch), jnp.asarray(deter), "ELU")
    _close(d, jd, DENSE)
    _close(lg, jl, DENSE)


# ---- conv stacks -------------------------------------------------------------------


def _frames(seed: int, lead: tuple[int, ...]) -> np.ndarray:
    return _f32(_rng(seed).uniform(-1, 1, (*lead, 32, 32, 1)))


def test_small_encoder_and_decoder_match_jax(small_models):
    jmodel, params, port = small_models
    x = _frames(10, (2, 3))
    with torch.no_grad():
        for which in ("audio", "vision"):
            cfg = getattr(jmodel.cfg, f"{which}_encoder")
            ref = jconv.encoder_apply(params[f"{which}_encoder"], cfg, jnp.asarray(x))
            _close(getattr(port, f"{which}_encoder")(torch.from_numpy(x)), ref, CONV)
        feat = _f32(_rng(11).standard_normal((2, 3, 48)))
        ref = jconv.decoder_apply(params["audio_decoder"], jmodel.decoder_cfg("audio"),
                                  jnp.asarray(feat))
        got = port.audio_decoder(torch.from_numpy(feat))
        assert got.shape == (2, 3, 32, 32, 1)
        _close(got, ref, CONV)


@pytest.mark.parametrize("coord_conv", [True, False])
def test_reference_width_encoder_matches_jax(coord_conv):
    """The reference encoder: CoordConv (input, yy, xx), 3 strided convs, a
    1×1 projection, 3 residual blocks, the head reading CHW-flattened maps."""
    jcfg = jconv.EncoderConfig(coord_conv=coord_conv)
    params = jconv.encoder_init(jax.random.PRNGKey(12), jcfg)
    enc = tconv.Encoder(tconv.EncoderConfig(**dataclasses.asdict(jcfg)))
    sd = {}
    _export_conv_component(sd, "e", params, encoder_head=True)
    enc.load_state_dict({k[2:]: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=True)
    x = _frames(13, (4,))
    with torch.no_grad():
        _close(enc(torch.from_numpy(x)), jconv.encoder_apply(params, jcfg, jnp.asarray(x)), CONV)


def test_reference_width_decoder_matches_jax():
    """The reference decoder: linears to 64×4×4, 3 residual blocks, three
    ConvTranspose2d (k4 s2 p1) to 32×32×1 and a Tanh."""
    jcfg = jconv.DecoderConfig(in_features=48)
    params = jconv.decoder_init(jax.random.PRNGKey(14), jcfg)
    dec = tconv.Decoder(tconv.DecoderConfig(**dataclasses.asdict(jcfg)))
    sd = {}
    _export_conv_component(sd, "d", params)
    dec.load_state_dict({k[2:]: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=True)
    feat = _f32(_rng(15).standard_normal((3, 48)))
    with torch.no_grad():
        got = dec(torch.from_numpy(feat))
    assert got.shape == (3, 32, 32, 1)
    _close(got, jconv.decoder_apply(params, jcfg, jnp.asarray(feat)), CONV)

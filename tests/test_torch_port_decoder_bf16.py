"""The fused decoder's plain version at bf16 against the JAX package's bf16
decoder, on the CPU.

``fused_decoder_plain`` on bf16 features and weights computes as the bf16
decoder kernels (``csrc/fused_decoder_bf16_*.cu``) do, JAX's ``_layer_fwd``
at ``dtype=bfloat16``: float32 sums of bf16 values, the bias and the
activation in float32, each layer's output rounded to bf16; its backward
(``fused_decoder_backward_plain``) keeps the cotangents in float32, takes
each activation derivative from the rounded output and rounds the
gradients to bf16 once. ``tests/test_torch_port_gpu.py`` holds the kernels
to it on the card.

Here it is held, on a decoder bridged from JAX's ``decoder_init`` (the
reference widths, 48-wide features), to JAX's pure-XLA twin of the fused
decoder at bf16 (``superrow_decoder_xla``, ``fused_conv.py:752``) and its
``jax.vjp``: frames within 1e-2 × max(1, max|JAX|) (measured ≤ 1e-3, one
bf16 ulp at the frames' scale of ~0.2) and every gradient, the features'
too, within 5e-2 × max(1, max|JAX|) per tensor (measured ≤ 2.6e-2: JAX's
VJP of the twin rounds the cotangent to bf16 at every layer, and its bias
gradients are bf16 sums). One tiny case runs JAX's Pallas decoder kernels
at bf16 in interpret mode (``fused_decoder_apply(..., interpret=True)``,
N=3 on a narrow decoder), the kernels' own numerics: four segments, the
cotangent rounded to bf16 at each cut, float32 weight-gradient sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_mtrssm_tpu.nn.conv import DecoderConfig as JaxDecoderConfig
from multimodal_mtrssm_tpu.nn.conv import decoder_init
from multimodal_mtrssm_tpu.ops.pallas import fused_conv as jax_fused
from multimodal_mtrssm_tpu.train.torch_export import _export_conv_component
from multimodal_mtrssm_tpu_torch.nn.conv import Decoder, DecoderConfig
from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

FWD_TOL, BWD_TOL = 1e-2, 5e-2  # × max(1, max|JAX|), per tensor
# A narrow reference-shaped decoder, for JAX's interpreted kernels.
NARROW = dict(in_features=48, linear_sizes=(32, 256), conv_in_shape=(16, 4, 4),
              channels=(8, 4, 1), num_residual_blocks=1, residual_intermediate_size=24,
              residual_input_size=16)


def _export(params) -> dict[str, np.ndarray]:
    sd: dict = {}
    _export_conv_component(sd, "decoder", params)
    return {k[len("decoder."):]: np.asarray(v, np.float32) for k, v in sd.items()}


def _bridged(kw: dict):
    """A JAX decoder's config and params, and the port's decoder on them."""
    jcfg = JaxDecoderConfig(**kw)
    params = jax.jit(lambda key: decoder_init(key, jcfg))(jax.random.PRNGKey(3))
    dec = Decoder(DecoderConfig(**kw))
    dec.load_state_dict({k: torch.from_numpy(v) for k, v in _export(params).items()})
    return jcfg, params, dec


def _case(seed: int, N: int, width: int):
    """bf16 features and frames' cotangent, made by numpy."""
    rng = np.random.default_rng(seed)
    f = jnp.asarray(rng.standard_normal((N, width)).astype(np.float32)).astype(jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((N, 32, 32, 1)).astype(np.float32)).astype(jnp.bfloat16)
    return f, g


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)


def _check(dec, feats, g, ref, ref_grads: dict, ref_dx) -> None:
    """The plain bf16 forward and backward of ``dec`` against JAX's frames
    ``ref``, parameter gradients (port names) and features' gradient."""
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.decoder_weights(dec)]
    x, gt = _torch(feats), _torch(g)
    out = fused_conv.fused_decoder_plain(w, dec.cfg, x)
    dx, dw = fused_conv.fused_decoder_backward_plain(w, dec.cfg, x, gt, True)
    assert out.dtype == dx.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in dw)
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), r, rtol=0,
                               atol=FWD_TOL * max(1.0, float(np.abs(r).max())))
    names = {id(p): n for n, p in dec.named_parameters()}
    got = {names[id(t)]: d for t, d in zip(fused_conv.decoder_weights(dec), dw)}
    assert set(got) == set(ref_grads)
    for n, want in [*ref_grads.items(), ("feats", np.asarray(ref_dx.astype(jnp.float32)))]:
        have = (dx if n == "feats" else got[n]).float().numpy()
        np.testing.assert_allclose(have, want, rtol=0,
                                   atol=BWD_TOL * max(1.0, float(np.abs(want).max())), err_msg=n)


def test_plain_bf16_decoder_matches_jax_xla_twin():
    jcfg, params, dec = _bridged({"in_features": 48})
    feats, g = _case(1, 5, 48)
    ref, vjp = jax.vjp(jax.jit(lambda p, v: jax_fused.superrow_decoder_xla(p, jcfg, v)),
                       params, feats)
    assert ref.dtype == jnp.bfloat16
    g_params, g_feats = vjp(g)
    _check(dec, feats, g, ref, _export(g_params), g_feats)


def test_plain_bf16_decoder_matches_jax_interpreted_kernels():
    jcfg, params, dec = _bridged(NARROW)
    feats, g = _case(2, 3, 48)
    ref, vjp = jax.vjp(jax.jit(lambda p, v: jax_fused.fused_decoder_apply(
        p, jcfg, v, tile=8, interpret=True)), params, feats)
    assert ref.dtype == jnp.bfloat16
    g_params, g_feats = vjp(g)
    _check(dec, feats, g, ref, _export(g_params), g_feats)

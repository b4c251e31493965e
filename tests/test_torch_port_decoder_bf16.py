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

``kernel_order_walk`` computes the forward GEMM by GEMM as the bf16 kernels
do (``csrc/fused_decoder_bf16.cuh``): the linears on the frames, each conv an
im2col GEMM with K tap-major, each transposed conv as four output-parity
class GEMMs with K = 4 taps × Ci. It is held to ``fused_decoder_plain`` at
bf16 on three decoders (frames within 1e-2 × max(1, max|plain|), the
kernels' gate; measured ≤ 1 bf16 ulp, from sums in another order) and to
both JAX outputs above (FWD_TOL), without running JAX again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def kernel_order_walk(weights, cfg: DecoderConfig, feats: torch.Tensor) -> torch.Tensor:
    """The bf16 decoder kernels' forward GEMM by GEMM on bf16 ``feats`` and
    weights, in float32: the first linear and the unflatten on the frames (N
    = the unflatten's units c·h·w + position, JAX's (c, h, w) order), each
    conv an im2col GEMM (M = frames × positions, K = taps × Ci tap-major, a
    padding tap's rows zero), each k4 s2 p1 transposed conv as four GEMMs, one
    an output-parity class (py, px): M = frames × Hi·Wi positions (ry, rx),
    K = taps (a, b) × Ci reading input (ry + py − a, rx + px − b) with weight
    tap (1 − py + 2a, 1 − px + 2b). Bias, skip and activation in float32,
    each layer's output rounded to bf16. NHWC frames out, bf16."""
    w = iter([t.float() for t in weights])
    rnd = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    elu = fused_conv._elu

    def conv(x, W, b, pad):
        n, h, wd, c = x.shape
        k = W.shape[-1]
        xp = F.pad(x, (0, 0, pad, pad, pad, pad))
        cols = torch.stack([xp[:, ky:ky + h, kx:kx + wd] for ky in range(k) for kx in range(k)], 3)
        B = W.permute(2, 3, 1, 0).reshape(k * k * c, -1)
        return (cols.reshape(n * h * wd, k * k * c) @ B + b).reshape(n, h, wd, -1)

    n = feats.shape[0]
    x = rnd(elu(feats.float() @ next(w).T + next(w)))
    c0, h0, w0 = cfg.conv_in_shape
    units = rnd(elu(x @ next(w).T + next(w)))
    x = units.reshape(n, c0, h0 * w0).permute(0, 2, 1).reshape(n, h0, w0, c0)
    if fused_conv._has_res_proj(cfg):
        x = rnd(elu(conv(x, next(w), next(w), 0)))
    for _ in range(cfg.num_residual_blocks):
        t = rnd(elu(conv(x, next(w), next(w), 1)))
        x = rnd(elu(x + conv(t, next(w), next(w), 1)))
    taps = [(a, b) for a in (0, 1) for b in (0, 1)]
    for i in range(len(cfg.channels)):
        W, bias = next(w), next(w)
        _, h, wd, c = x.shape
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        pre = x.new_zeros(n, 2 * h, 2 * wd, W.shape[1])
        for py in (0, 1):
            for px in (0, 1):
                cols = torch.stack([xp[:, 1 + py - a:1 + py - a + h, 1 + px - b:1 + px - b + wd]
                                    for a, b in taps], 3)
                B = torch.stack([W[:, :, 1 - py + 2 * a, 1 - px + 2 * b] for a, b in taps])
                pre[:, py::2, px::2] = (cols.reshape(n * h * wd, 4 * c) @ B.reshape(4 * c, -1)
                                        + bias).reshape(n, h, wd, -1)
        x = rnd(torch.tanh(pre) if i == len(cfg.channels) - 1 else elu(pre))
    return x.to(torch.bfloat16)


@pytest.fixture(scope="module")
def xla_twin():
    """The bridged reference decoder, its inputs, and JAX's XLA twin at bf16
    with its VJP."""
    jcfg, params, dec = _bridged({"in_features": 48})
    feats, g = _case(1, 5, 48)
    ref, vjp = jax.vjp(jax.jit(lambda p, v: jax_fused.superrow_decoder_xla(p, jcfg, v)),
                       params, feats)
    g_params, g_feats = vjp(g)
    return dec, feats, g, ref, _export(g_params), g_feats


@pytest.fixture(scope="module")
def interpreted():
    """The narrow bridged decoder, its inputs, and JAX's Pallas decoder
    kernels at bf16 in interpret mode with their VJP."""
    jcfg, params, dec = _bridged(NARROW)
    feats, g = _case(2, 3, 48)
    ref, vjp = jax.vjp(jax.jit(lambda p, v: jax_fused.fused_decoder_apply(
        p, jcfg, v, tile=8, interpret=True)), params, feats)
    g_params, g_feats = vjp(g)
    return dec, feats, g, ref, _export(g_params), g_feats


def test_plain_bf16_decoder_matches_jax_xla_twin(xla_twin):
    dec, feats, g, ref, grads, g_feats = xla_twin
    assert ref.dtype == jnp.bfloat16
    _check(dec, feats, g, ref, grads, g_feats)


def test_plain_bf16_decoder_matches_jax_interpreted_kernels(interpreted):
    dec, feats, g, ref, grads, g_feats = interpreted
    assert ref.dtype == jnp.bfloat16
    _check(dec, feats, g, ref, grads, g_feats)


@pytest.mark.parametrize("kw", [{}, NARROW, {
    "in_features": 96, "residual_input_size": 40, "residual_intermediate_size": 72,
    "channels": (24, 12, 1), "linear_sizes": (63, 1024)}], ids=["reference", "narrow", "not16"])
def test_kernel_order_walk_matches_plain_bf16(kw):
    torch.manual_seed(4)
    cfg = DecoderConfig(**{"in_features": 48, **kw})
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.decoder_weights(Decoder(cfg))]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((7, cfg.in_features)).astype(np.float32))
    x = x.to(torch.bfloat16)
    plain = fused_conv.fused_decoder_plain(w, cfg, x).float()
    got = kernel_order_walk(w, cfg, x)
    assert got.dtype == torch.bfloat16 and got.shape == plain.shape
    assert float((got.float() - plain).abs().max()) <= FWD_TOL * max(1.0, float(plain.abs().max()))


@pytest.mark.parametrize("which", ["xla_twin", "interpreted"])
def test_kernel_order_walk_matches_jax(which, request):
    dec, feats, _, ref, _, _ = request.getfixturevalue(which)
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.decoder_weights(dec)]
    got = kernel_order_walk(w, dec.cfg, _torch(feats)).float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got, r, rtol=0, atol=FWD_TOL * max(1.0, float(np.abs(r).max())))

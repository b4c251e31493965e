"""The pieces the fused decoder's forward kernel is built from, on the CPU.

``csrc/fused_decoder.cuh`` computes each decoder layer as an implicit GEMM
over packed weights:

- ``decoder_pack_kernel`` lays out every layer's torch weight as
  ``[Co][tap][Ci]``: a conv's ``[Co, Ci, k, k]``, the unflattening linear's
  ``[Co·h·w, Ci]`` and a transposed conv's ``[Ci, Co, 4, 4]``, whose taps it
  orders by output-parity class (``fdec::torch_tap``);
- a k4 s2 p1 transposed conv takes its output positions by parity class
  (``oy & 1, ox & 1``): class tap ``(a, b)`` of output ``(oy, ox)`` reads
  input ``((oy + 1) >> 1) − a, ((ox + 1) >> 1) − b``, so that each class is a
  dense 2×2-tap conv and no tap is wasted;
- the second linear with the reference's ``(c, h, w)`` unflatten is a
  transposed conv from the 1×1 map, output position ``t`` taking tap ``t``
  alone, with one bias per output element.

Here those identities run in float64 torch, indexed as the kernel indexes
them, against ``F.conv_transpose2d``, ``F.linear`` and the JAX package's
``nn/conv.py::conv_transpose_apply``; and the decoder built from them is
held at N ∈ {1, 5, 9} frames to ``fused_decoder_plain`` and to JAX's
``fused_decoder_apply(..., tile=8, interpret=True)`` on the same weights
(the 48- and 96-wide decoders and one with a ``res_proj``) within 1e-5, as
``test_torch_port_fused_decoder.py`` holds the port's decoder to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu.nn.conv import DecoderConfig as JaxDecoderConfig
from multimodal_mtrssm_tpu.nn.conv import conv_transpose_apply, decoder_init
from multimodal_mtrssm_tpu.ops.pallas import fused_conv as jax_fused
from multimodal_mtrssm_tpu.train.torch_export import _export_conv_component
from multimodal_mtrssm_tpu_torch.nn.conv import Decoder, DecoderConfig
from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

K, S, P = 4, 2, 1  # the transposed convs' kernel, stride and padding (fdec::kDeconv*)
CLASS_TAPS = 4
DECODERS = {
    "mrssm48": {"in_features": 48},
    "mmtrssm96": {"in_features": 96},
    "res_proj": {"in_features": 48, "residual_input_size": 32},
}
FRAMES = (1, 5, 9)
TOL = 1e-5


def torch_tap(kind: str, t: int) -> int:
    """``fdec::torch_tap``: the torch tap ky·k + kx of packed tap ``t``; a
    transposed conv's taps by output-parity class (py, px) = (t / 4 >> 1,
    t / 4 & 1), class tap (a, b) = (t % 4 >> 1, t % 4 & 1)."""
    if kind != "deconv":
        return t
    cls, j = divmod(t, CLASS_TAPS)
    ky = (((cls >> 1) + P) & 1) + 2 * (j >> 1)
    kx = (((cls & 1) + P) & 1) + 2 * (j & 1)
    return ky * K + kx


def weight_index(kind: str, n_ci: int, n_co: int, kk: int, ci, co, tap):
    """``fdec::weight_index``: the flat index in a layer's torch weight of
    (input channel, output channel, torch tap), for a conv ``[Co, Ci, k,
    k]``, the unflatten ``[Co·h·w, Ci]`` or a transposed conv ``[Ci, Co, k,
    k]``."""
    if kind == "conv":
        return (co * n_ci + ci) * kk + tap
    if kind == "deconv":
        return (ci * n_co + co) * kk + tap
    return (co * kk + tap) * n_ci + ci


def pack_index(kind: str, n_co: int, kk: int, n_ci: int) -> torch.Tensor:
    """``decoder_pack_kernel``'s index map, without the slices' row padding:
    packed[o][t][i] is the torch weight at ``weight_index(i, o,
    torch_tap(t))``. ``[Co, k·k, Ci]``."""
    o = torch.arange(n_co).view(-1, 1, 1)
    t = torch.tensor([torch_tap(kind, t) for t in range(kk)]).view(1, -1, 1)
    i = torch.arange(n_ci).view(1, 1, -1)
    return weight_index(kind, n_ci, n_co, kk, i, o, t)


def pack(kind: str, w: torch.Tensor, n_co: int, kk: int) -> torch.Tensor:
    """A layer's torch weight packed as the kernel packs it, ``[Co, k·k,
    Ci]``."""
    return w.reshape(-1)[pack_index(kind, n_co, kk, w.numel() // (n_co * kk))]


def class_walk(oy: int, ox: int, hi: int, wi: int) -> list[tuple[int, int, int]]:
    """The kernel's walk of a transposed conv at output (oy, ox): its parity
    class's 4 packed taps with the input position each reads, those inside
    the input map."""
    cls = (oy & 1) * 2 + (ox & 1)
    out = []
    for t in range(cls * CLASS_TAPS, (cls + 1) * CLASS_TAPS):
        iy = ((oy + P) >> 1) - ((t & 3) >> 1)
        ix = ((ox + P) >> 1) - (t & 1)
        if 0 <= iy < hi and 0 <= ix < wi:
            out.append((t, iy, ix))
    return out


def deconv_walk(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's transposed conv, position by position: NCHW ``x``, torch
    ``[Ci, Co, 4, 4]`` ``w``."""
    n, ci, hi, wi = x.shape
    co = w.shape[1]
    packed = pack("deconv", w, co, K * K)
    out = b.view(1, co, 1, 1).repeat(n, 1, 2 * hi, 2 * wi)
    for oy in range(2 * hi):
        for ox in range(2 * wi):
            for t, iy, ix in class_walk(oy, ox, hi, wi):
                out[:, :, oy, ox] += x[:, :, iy, ix] @ packed[:, t].T
    return out


def deconv_by_class(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same as the sum of its four output-parity classes, each a dense
    2×2 conv: class (py, px) at (2m + py, 2n + px) takes x[m + py − a,
    n + px − b] · tap (a, b), i.e. a 2×2 correlation of the zero-padded map
    from offset (py, px) with the class's taps reversed."""
    n, ci, hi, wi = x.shape
    co = w.shape[1]
    packed = pack("deconv", w, co, K * K)  # [Co, 16, Ci]
    xp = F.pad(x, (1, 1, 1, 1))
    out = x.new_zeros(n, co, 2 * hi, 2 * wi)
    for py in range(2):
        for px in range(2):
            taps = packed[:, (py * 2 + px) * CLASS_TAPS:(py * 2 + px + 1) * CLASS_TAPS]
            kern = taps.reshape(co, 2, 2, ci).flip(1, 2).permute(0, 3, 1, 2)  # [Co, Ci, u, v]
            out[:, :, py::2, px::2] = F.conv2d(xp[:, :, py:py + hi + 1, px:px + wi + 1], kern)
    return out + b.view(1, co, 1, 1)


def unflatten_walk(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, c: int,
                   h: int) -> torch.Tensor:
    """The kernel's unflattening linear: output (co, oy, ox) is the single
    tap oy·h + ox of the packed ``[Co][h·h][Ci]`` on the 1×1 map, plus the
    bias of that element."""
    packed = pack("unflatten", w, c, h * h)
    out = torch.einsum("ni,oti->not", x, packed) + b.view(1, c, h * h)
    return out.view(-1, c, h, h)


# ---- the identities ----------------------------------------------------------------------------

# The reference decoder's transposed convs: (Ci, Co, input side).
DECONVS = [(64, 32, 4), (32, 16, 8), (16, 1, 16)]


@pytest.mark.parametrize("ci,co,hi", DECONVS, ids=[f"{a}to{b}at{c}" for a, b, c in DECONVS])
def test_deconv_is_the_sum_of_its_parity_classes(ci, co, hi):
    """A k4 s2 p1 transposed conv, walked as the kernel walks it and as the
    sum of its four dense 2×2 parity-class convs, equals
    ``F.conv_transpose2d`` and JAX's ``conv_transpose_apply``."""
    rng = np.random.default_rng(ci + co)
    x = torch.from_numpy(rng.standard_normal((2, ci, hi, hi)))
    w = torch.from_numpy(rng.standard_normal((ci, co, K, K)) / np.sqrt(4 * ci))
    b = torch.from_numpy(rng.standard_normal(co))
    ref = F.conv_transpose2d(x, w, b, stride=S, padding=P)
    walked, by_class = deconv_walk(x, w, b), deconv_by_class(x, w, b)
    torch.testing.assert_close(walked, ref, rtol=0, atol=1e-12)
    torch.testing.assert_close(by_class, ref, rtol=0, atol=1e-12)
    params = {"w": jnp.asarray(w.permute(2, 3, 0, 1).numpy(), jnp.float32),
              "b": jnp.asarray(b.numpy(), jnp.float32)}
    jout = conv_transpose_apply(params, jnp.asarray(x.permute(0, 2, 3, 1).numpy(), jnp.float32),
                                S, P)
    np.testing.assert_allclose(walked.permute(0, 2, 3, 1).numpy(), np.asarray(jout), rtol=0,
                               atol=TOL * max(1.0, float(ref.abs().max())))


def test_class_taps_are_the_taps_that_divide():
    """Each output position's 4 class taps are exactly the taps ky, kx with
    o + p − k even, at input (o + p − k) / 2: none wasted, none missed."""
    hi = 4
    for oy in range(2 * hi):
        for ox in range(2 * hi):
            walked = {(torch_tap("deconv", t), iy, ix) for t, iy, ix in class_walk(oy, ox, hi, hi)}
            divide = {(ky * K + kx, (oy + P - ky) // 2, (ox + P - kx) // 2)
                      for ky in range(K) for kx in range(K)
                      if (oy + P - ky) % 2 == 0 and (ox + P - kx) % 2 == 0
                      and 0 <= (oy + P - ky) // 2 < hi and 0 <= (ox + P - kx) // 2 < hi}
            assert walked == divide
            assert len(class_walk(oy, ox, hi, hi)) == 4 or oy in (0, 2 * hi - 1) or \
                ox in (0, 2 * hi - 1)


@pytest.mark.parametrize("ci", [64, 24])
def test_unflatten_is_a_transposed_conv_from_a_1x1_map(ci):
    """The second linear, unflattened in (c, h, w) order, is a 4×4 transposed
    conv from the 1×1 map with one bias per output element, and the kernel's
    one-tap-a-position walk of the packed weights computes it."""
    c, h = 64, 4
    rng = np.random.default_rng(ci)
    x = torch.from_numpy(rng.standard_normal((3, ci)))
    w = torch.from_numpy(rng.standard_normal((c * h * h, ci)))
    b = torch.from_numpy(rng.standard_normal(c * h * h))
    ref = F.linear(x, w, b).view(3, c, h, h)
    as_deconv = F.conv_transpose2d(x[:, :, None, None], w.view(c, h, h, ci).permute(3, 0, 1, 2))
    torch.testing.assert_close(as_deconv + b.view(1, c, h, h), ref, rtol=0, atol=1e-12)
    torch.testing.assert_close(unflatten_walk(x, w, b, c, h), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,shape", [("conv", (64, 48, 1, 1)), ("conv", (128, 64, 3, 3)),
                                        ("unflatten", (1024, 64)), ("deconv", (64, 32, 4, 4))])
def test_pack_index_map_round_trips(kind, shape):
    """The pack's index map is a bijection onto each kind's torch weight:
    scattering the packed weights back by it gives the torch weight; and a
    transposed conv's packed taps are its torch taps grouped by class."""
    w = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(shape))
    n_co = {"conv": shape[0], "unflatten": 64, "deconv": shape[1]}[kind]
    kk = {"conv": shape[-1] ** 2, "unflatten": 16, "deconv": K * K}[kind]
    idx = pack_index(kind, n_co, kk, w.numel() // (n_co * kk))
    assert torch.equal(idx.reshape(-1).sort().values, torch.arange(w.numel()))
    back = torch.empty(w.numel(), dtype=w.dtype)
    back[idx.reshape(-1)] = pack(kind, w, n_co, kk).reshape(-1)
    assert torch.equal(back.reshape(shape), w)
    if kind == "deconv":
        for cls in range(4):
            ky = {torch_tap(kind, t) // K for t in range(4 * cls, 4 * cls + 4)}
            kx = {torch_tap(kind, t) % K for t in range(4 * cls, 4 * cls + 4)}
            # class (py, px) holds the taps ky ≡ py + 1, kx ≡ px + 1 (mod 2)
            assert ky == {((cls >> 1) + 1) % 2, ((cls >> 1) + 1) % 2 + 2}
            assert kx == {((cls & 1) + 1) % 2, ((cls & 1) + 1) % 2 + 2}


# ---- the decoder from the pieces ---------------------------------------------------------------


def decoder_from_pieces(weights, cfg: DecoderConfig, feats: torch.Tensor) -> torch.Tensor:
    """The forward kernel's layers in order, each as the kernel computes it:
    the first linear (a 1×1 conv on the 1×1 map), the unflatten by its
    one-tap walk, the projection and residual convs (their taps in the
    padding skipped: ``F.conv2d``'s zero padding), and the transposed convs
    by parity class; ELU, the residual in place, Tanh last. NHWC frames."""
    it = iter(weights)
    c, h, _ = cfg.conv_in_shape
    x = fused_conv._elu(feats @ next(it).T + next(it))
    x = fused_conv._elu(unflatten_walk(x, next(it), next(it), c, h))
    if cfg.num_residual_blocks > 0 and c != cfg.residual_input_size:
        x = fused_conv._elu(F.conv2d(x, next(it), next(it)))
    for _ in range(cfg.num_residual_blocks):
        t = fused_conv._elu(F.conv2d(x, next(it), next(it), padding=1))
        x = fused_conv._elu(x + F.conv2d(t, next(it), next(it), padding=1))
    for i in range(len(cfg.channels)):
        x = deconv_by_class(x, next(it), next(it))
        x = torch.tanh(x) if i == len(cfg.channels) - 1 else fused_conv._elu(x)
    return x.permute(0, 2, 3, 1)


@pytest.fixture(scope="module", params=list(DECODERS))
def bridged(request):
    """A JAX decoder's params and the port's ``Decoder`` with the same
    weights, through the JAX package's own export of a conv stack."""
    kw = DECODERS[request.param]
    jcfg = JaxDecoderConfig(**kw)
    params = decoder_init(jax.random.PRNGKey(23), jcfg)
    sd: dict[str, np.ndarray] = {}
    _export_conv_component(sd, "decoder", params)
    decoder = Decoder(DecoderConfig(**kw))
    load_reference_state_dict(decoder, {k[len("decoder."):]: v for k, v in sd.items()})
    return request.param, jcfg, params, decoder


@pytest.mark.parametrize("n", FRAMES)
def test_decoder_from_the_pieces_matches_plain_and_jax(bridged, n):
    """The decoder built from the identities above, in float64, against
    ``fused_decoder_plain`` and JAX's ``fused_decoder_apply(..., tile=8,
    interpret=True)`` on the same weights and numpy features, within
    1e-5."""
    name, jcfg, params, decoder = bridged
    assert fused_conv.fused_decoder_applicable(decoder.cfg)
    assert (decoder.res_proj is not None) == (name == "res_proj")
    feats = np.random.default_rng(30 + n).standard_normal((n, jcfg.in_features)).astype(np.float32)
    weights = [t.detach().double() for t in fused_conv.decoder_weights(decoder)]
    got = decoder_from_pieces(weights, decoder.cfg, torch.from_numpy(feats).double())
    assert got.shape == (n, 32, 32, 1)
    plain = fused_conv.fused_decoder_plain(weights, decoder.cfg, torch.from_numpy(feats).double())
    torch.testing.assert_close(got, plain, rtol=0, atol=TOL)
    ref = jax_fused.fused_decoder_apply(params, jcfg, jnp.asarray(feats), tile=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)

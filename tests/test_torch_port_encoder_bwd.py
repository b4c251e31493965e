"""The identities the fused encoder's backward kernels rely on, on the CPU.

``csrc/fused_encoder_bwd.cu`` computes the encoder's VJP in two passes:

- the cotangent pass takes each layer's input cotangent as a convolution of
  its pre-activation cotangent with the weights flipped in space and
  transposed to ``[Ci][tap][Co]`` (``encoder_bwd_pack_kernel``), walking the
  flipped taps that land on an output position; a stride-2 layer walks its
  input positions by parity class, each of which takes a fixed subset of
  the taps;
- the weight-gradient pass forms ``dW[ci·k·k + tap][co]`` as the im2col
  GEMM of the activation record and the cotangent record, summed over
  groups of frames of at most 256 terms (one frame where a layer has 256
  output positions), then over a chunk's groups, then over the chunks in
  order (the chunk of ``fused_conv._dims``).

Here those identities run in float64 torch, as the kernels index them, on
the ``ENCODER_VARIANTS``-like widths of ``test_torch_port_gpu.py`` (the
reference encoder, narrow 5/7/9 → 12/10 with a 33-wide head, no residual
blocks without CoordConv), and the whole backward built from them is held,
at N ∈ {1, 5, 9} frames, to autograd of ``fused_encoder_plain`` in float64
(1e-5 × max(1, max|plain|)) and to ``jax.grad`` through the JAX package's
``fused_encoder_apply(..., interpret=True)`` on the same weights (1e-4 ×
max(1, max|JAX|): JAX sums in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu.nn.conv import EncoderConfig as JaxEncoderConfig
from multimodal_mtrssm_tpu.nn.conv import encoder_init
from multimodal_mtrssm_tpu.ops.pallas import fused_conv as jax_fused
from multimodal_mtrssm_tpu.train.torch_export import _export_conv_component
from multimodal_mtrssm_tpu_torch.nn.conv import Encoder, EncoderConfig
from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

VARIANTS = {
    "default": {},
    "narrow": {"channels": (5, 7, 9), "residual_output_size": 12, "residual_intermediate_size": 10,
               "num_residual_blocks": 2, "linear_sizes": (33,)},
    "no_res": {"num_residual_blocks": 0, "coord_conv": False},
}
FRAMES = (1, 5, 9)


@pytest.fixture(scope="module", params=list(VARIANTS))
def bridged(request):
    """A variant's JAX encoder params and the port's ``Encoder`` with the
    same weights (through the JAX package's own export of a conv stack)."""
    kw = VARIANTS[request.param]
    jcfg = JaxEncoderConfig(**kw)
    params = jax.jit(lambda key: encoder_init(key, jcfg))(jax.random.PRNGKey(3))
    sd = {}
    _export_conv_component(sd, "enc", params, encoder_head=True)
    enc = Encoder(EncoderConfig(**kw)).double()
    enc.load_state_dict({k[len("enc."):]: torch.from_numpy(np.asarray(v, np.float64))
                         for k, v in sd.items()})
    return request.param, jcfg, params, enc


def _layers(cfg: EncoderConfig) -> list[dict]:
    """The kernels' layer table (``fenc::make_plan``): kernel, stride,
    padding, mode, and whether the input also feeds a residual skip."""
    out = [dict(k=k, s=s, p=p, mode="elu", skip_in=False)
           for k, s, p in zip(cfg.kernel_sizes, cfg.strides, cfg.paddings)]
    if cfg.num_residual_blocks > 0 and cfg.channels[-1] != cfg.residual_output_size:
        out.append(dict(k=1, s=1, p=0, mode="elu", skip_in=False))
    for _ in range(cfg.num_residual_blocks):
        out += [dict(k=3, s=1, p=1, mode="elu", skip_in=True),
                dict(k=3, s=1, p=1, mode="residual", skip_in=False)]
    h, _ = cfg.spatial_out()
    return out + [dict(k=h, s=1, p=0, mode="head", skip_in=False)]


def _conv_weights(weights, cfg: EncoderConfig) -> list[torch.Tensor]:
    """Every layer's weight as ``[Co, Ci, k, k]`` (the head's linear
    unflattened in its CHW order)."""
    ws = list(weights[0::2])
    h, w = cfg.spatial_out()
    ws[-1] = ws[-1].reshape(ws[-1].shape[0], -1, h, w)
    return ws


def _forward_records(weights, cfg: EncoderConfig, x: torch.Tensor):
    """NCHW inputs and outputs of every layer (the kernels' activation
    record), ``fused_encoder_plain``'s forward layer by layer."""
    n, h, w, _ = x.shape
    a = x.permute(0, 3, 1, 2)
    if cfg.coord_conv:
        c = fused_conv.coords(cfg, x.device).to(x.dtype)
        a = torch.cat([a, c[:h].view(1, 1, h, 1).expand(n, 1, h, w),
                       c[h:].view(1, 1, 1, w).expand(n, 1, h, w)], 1)
    ins, outs = [], []
    for L, wt, b in zip(_layers(cfg), _conv_weights(weights, cfg), weights[1::2]):
        ins.append(a)
        pre = F.conv2d(a, wt, b, stride=L["s"], padding=L["p"])
        if L["mode"] == "residual":
            pre = pre + ins[-2]
        a = pre if L["mode"] == "head" else fused_conv._elu(pre)
        outs.append(a)
    return ins, outs


def _pack_transposed(wt: torch.Tensor) -> torch.Tensor:
    """``encoder_bwd_pack_kernel``'s layout: ``[Ci][tap][Co]`` with tap t
    holding the torch weight's tap k·k − 1 − t (flipped in space)."""
    co, ci, k, _ = wt.shape
    return wt.reshape(co, ci, k * k).flip(-1).permute(1, 2, 0)


def _taps_reaching(iy: int, k: int, s: int, p: int, ho: int) -> list[tuple[int, int]]:
    """The flipped taps (ky, oy) of one input row that reach an output row:
    ``ty = iy − (k − 1 − p) + ky`` divides by s and ``ty / s`` is inside."""
    pt = k - 1 - p
    return [(ky, (iy - pt + ky) // s) for ky in range(k)
            if iy - pt + ky >= 0 and (iy - pt + ky) % s == 0 and (iy - pt + ky) // s < ho]


def _input_cotangent(dpre: torch.Tensor, wt: torch.Tensor, L: dict, hi: int, wi: int,
                     rows: int | None = None) -> torch.Tensor:
    """The cotangent pass's transposed conv as the kernel walks it: each
    input position sums, over the flipped taps that reach an output
    position, the pre-activation cotangent there times the packed slice.
    ``rows`` input channels (the first layer's image channels only)."""
    packed = _pack_transposed(wt)[:rows]
    k = L["k"]
    n, _, ho, wo = dpre.shape
    out = dpre.new_zeros(n, packed.shape[0], hi, wi)
    for iy in range(hi):
        for ix in range(wi):
            for ky, oy in _taps_reaching(iy, k, L["s"], L["p"], ho):
                for kx, ox in _taps_reaching(ix, k, L["s"], L["p"], wo):
                    out[:, :, iy, ix] += dpre[:, :, oy, ox] @ packed[:, ky * k + kx].T
    return out


def _input_cotangent_by_parity(dpre: torch.Tensor, wt: torch.Tensor, L: dict, hi: int,
                               wi: int) -> torch.Tensor:
    """A stride-2 layer's input cotangent by parity class: the positions
    (2a + py, 2b + px) take only the flipped taps ky ≡ py + k − 1 − p and
    kx ≡ px + k − 1 − p (mod 2), each a shift of the whole cotangent map."""
    assert L["s"] == 2 and hi % 2 == 0 and wi % 2 == 0
    k, pt = L["k"], L["k"] - 1 - L["p"]
    packed = _pack_transposed(wt)
    out = dpre.new_zeros(dpre.shape[0], wt.shape[1], hi, wi)
    for py in range(2):
        for px in range(2):
            for ky in range((py + pt) % 2, k, 2):
                for kx in range((px + pt) % 2, k, 2):
                    # input row 2a + py takes output row a + (py − pt + ky) / 2
                    dy, dx = (py - pt + ky) // 2, (px - pt + kx) // 2
                    src = F.pad(dpre, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)))
                    src = src[:, :, max(0, dy):max(0, dy) + hi // 2, max(0, dx):max(0, dx) + wi // 2]
                    out[:, :, py::2, px::2] += torch.einsum("nohw,co->nchw", src,
                                                            packed[:, ky * k + kx])
    return out


def _weight_gradient(a: torch.Tensor, dpre: torch.Tensor, L: dict, chunk: int):
    """The weight-gradient pass's sums: for each (torch-order) tap, the
    im2col GEMM of the input activations and the pre-activation cotangent
    per frame, summed over groups of frames of at most 256 terms, then over
    each chunk's groups in order, then over the chunks in order; ``[Co, Ci,
    k, k]`` and the bias."""
    k, s, p = L["k"], L["s"], L["p"]
    n, ci, hi, wi = a.shape
    _, co, ho, wo = dpre.shape
    per_frame = dpre.new_zeros(n, co, ci, k, k)
    for ky in range(k):
        for kx in range(k):
            for oy in range(ho):
                iy = oy * s - p + ky
                if not 0 <= iy < hi:
                    continue
                for ox in range(wo):
                    ix = ox * s - p + kx
                    if 0 <= ix < wi:
                        per_frame[:, :, :, ky, kx] += (dpre[:, :, oy, ox, None] *
                                                       a[:, None, :, iy, ix])
    bias_frame = dpre.sum((2, 3))
    group = max(1, 256 // (ho * wo))
    dw, db = torch.zeros_like(per_frame[0]), torch.zeros_like(bias_frame[0])
    for c0 in range(0, n, chunk):
        cw, cb = torch.zeros_like(dw), torch.zeros_like(db)
        for g0 in range(c0, min(n, c0 + chunk), group):
            gw, gb = torch.zeros_like(dw), torch.zeros_like(db)
            for f in range(g0, min(n, c0 + chunk, g0 + group)):
                gw, gb = gw + per_frame[f], gb + bias_frame[f]
            cw, cb = cw + gw, cb + gb
        dw, db = dw + cw, db + cb
    return dw, db


def _kernel_backward(weights, cfg: EncoderConfig, x: torch.Tensor, g: torch.Tensor):
    """The fused encoder's backward as the two passes compute it, from the
    identities above: ``(dx, weight grads)`` in torch layout."""
    layers, ws = _layers(cfg), _conv_weights(weights, cfg)
    ins, outs = _forward_records(weights, cfg, x)
    chunk = fused_conv._dims(cfg, x.shape[0]).chunk
    grads: list[torch.Tensor] = []
    cot = g[:, :, None, None]  # the head's output cotangent = its pre-activation's
    skip = None
    dx = None
    for i in reversed(range(len(layers))):
        L = layers[i]
        dpre = cot if L["mode"] == "head" else cot * torch.where(outs[i] > 0, 1.0, outs[i] + 1.0)
        dw, db = _weight_gradient(ins[i], dpre, L, chunk)
        grads[:0] = [dw.reshape(weights[2 * i].shape), db]
        hi, wi = ins[i].shape[2:]
        if i == 0:
            dx = _input_cotangent(dpre, ws[0], L, hi, wi, rows=cfg.in_channels)
            break
        cot = _input_cotangent(dpre, ws[i], L, hi, wi)
        if L["skip_in"]:
            cot = cot + skip
        if L["mode"] == "residual":
            skip = dpre
    return dx.permute(0, 2, 3, 1), grads


def _case(cfg: EncoderConfig, n: int):
    rng = np.random.default_rng(100 + n)
    x = rng.uniform(-1, 1, (n, 32, 32, 1)).astype(np.float32)
    g = rng.standard_normal((n, cfg.out_dim)).astype(np.float32)
    return x, g


def _assert_scaled(got: torch.Tensor, ref, tol: float, name: str) -> None:
    ref = torch.as_tensor(np.array(ref), dtype=torch.float64)
    scale = max(1.0, float(ref.abs().max()))
    err = float((got.double() - ref).abs().max())
    assert err <= tol * scale, f"{name}: max |err| {err:.3g} > {tol} x {scale:.3g}"


def _single_layer_cotangent(dpre, wt, L, a):
    """Autograd's input cotangent of one conv: the reference of the
    transposed conv."""
    a = a.detach().requires_grad_()
    out = F.conv2d(a, wt, stride=L["s"], padding=L["p"])
    return torch.autograd.grad(out, a, dpre)[0]


def test_stride1_input_cotangent_is_the_flipped_transposed_conv(bridged):
    """Every stride-1 layer (the projection, the residual convs, the head as
    a valid conv): the kernel's walk of the flipped, transposed slices
    equals the conv of the cotangent with ``W.flip(2, 3).transpose(0, 1)``
    at padding k − 1 − p, and autograd's input cotangent."""
    _, _, _, enc = bridged
    cfg = enc.cfg
    weights = [t.detach() for t in fused_conv.encoder_weights(enc)]
    x, _ = _case(cfg, 3)
    ins, outs = _forward_records(weights, cfg, torch.from_numpy(x).double())
    rng = np.random.default_rng(7)
    checked = 0
    for L, wt, a, o in zip(_layers(cfg), _conv_weights(weights, cfg), ins, outs):
        if L["s"] != 1:
            continue
        dpre = torch.from_numpy(rng.standard_normal(o.shape))
        got = _input_cotangent(dpre, wt, L, *a.shape[2:])
        flipped = F.conv2d(dpre, wt.flip(2, 3).transpose(0, 1), padding=L["k"] - 1 - L["p"])
        ref = _single_layer_cotangent(dpre, wt, L, a)
        _assert_scaled(got, flipped, 1e-12, "flipped conv")
        _assert_scaled(got, ref, 1e-12, "autograd")
        checked += 1
    assert checked == len(_layers(cfg)) - 3


def test_stride2_input_cotangent_by_parity_class(bridged):
    """The three stride-2 convs: the kernel's walk (taps that land between
    strided outputs skipped) equals the parity decomposition, each class of
    input positions taking its fixed subset of taps, and autograd."""
    _, _, _, enc = bridged
    cfg = enc.cfg
    weights = [t.detach() for t in fused_conv.encoder_weights(enc)]
    x, _ = _case(cfg, 2)
    ins, outs = _forward_records(weights, cfg, torch.from_numpy(x).double())
    rng = np.random.default_rng(8)
    for L, wt, a, o in list(zip(_layers(cfg), _conv_weights(weights, cfg), ins, outs))[:3]:
        assert L["s"] == 2
        dpre = torch.from_numpy(rng.standard_normal(o.shape))
        got = _input_cotangent(dpre, wt, L, *a.shape[2:])
        _assert_scaled(got, _input_cotangent_by_parity(dpre, wt, L, *a.shape[2:]), 1e-12,
                       "parity")
        _assert_scaled(got, _single_layer_cotangent(dpre, wt, L, a), 1e-12, "autograd")
        # An inner even row takes one row of taps, an odd row two: never all three.
        for py in range(2):
            assert len(_taps_reaching(2 + py, 3, 2, 1, o.shape[2])) == 1 + py


@pytest.mark.parametrize("n", [9, 33])
def test_weight_gradient_is_the_chunked_im2col_gemm(bridged, n):
    """Every layer's weight and bias gradient, summed per group of frames,
    per chunk and over the chunks in the kernel's order (N=9: chunks of 8
    and 1; N=33: the wrapper's chunk of 8, five chunks), equals autograd of
    the layer's conv on the recorded activations."""
    _, _, _, enc = bridged
    cfg = enc.cfg
    weights = [t.detach() for t in fused_conv.encoder_weights(enc)]
    chunk = fused_conv._dims(cfg, n).chunk
    assert -(-n // chunk) > 1
    x, _ = _case(cfg, n)
    ins, outs = _forward_records(weights, cfg, torch.from_numpy(x).double())
    rng = np.random.default_rng(n)
    for L, wt, a, o in zip(_layers(cfg), _conv_weights(weights, cfg), ins, outs):
        dpre = torch.from_numpy(rng.standard_normal(o.shape))
        dw, db = _weight_gradient(a, dpre, L, chunk)
        w_ = wt.detach().requires_grad_()
        b_ = torch.zeros(wt.shape[0], dtype=wt.dtype, requires_grad=True)
        ref_w, ref_b = torch.autograd.grad(F.conv2d(a, w_, b_, stride=L["s"], padding=L["p"]),
                                           [w_, b_], dpre)
        _assert_scaled(dw, ref_w, 1e-12, "dW")
        _assert_scaled(db, ref_b, 1e-12, "db")


@pytest.mark.parametrize("n", FRAMES)
def test_the_two_passes_match_plain_autograd_and_jax_grad(bridged, n):
    """The backward built from the two passes' identities, every weight
    gradient and the frames' cotangent, against autograd of
    ``fused_encoder_plain`` (float64) and ``jax.grad`` through the Pallas
    kernels' custom VJP in interpret mode, on bridged weights."""
    name, jcfg, params, enc = bridged
    cfg = enc.cfg
    weights = [t.detach() for t in fused_conv.encoder_weights(enc)]
    x, g = _case(cfg, n)
    xt, gt = torch.from_numpy(x).double(), torch.from_numpy(g).double()
    dx, dw = _kernel_backward(weights, cfg, xt, gt)
    ref_dx, ref_dw = fused_conv.fused_encoder_backward_plain(weights, cfg, xt, gt, True)
    for i, (a, b) in enumerate(zip([*dw, dx], [*ref_dw, ref_dx])):
        _assert_scaled(a, b.numpy(), 1e-5, f"{name} tensor {i} vs plain")

    def loss(p, xs):
        out = jax_fused.fused_encoder_apply(p, jcfg, xs, tile=8, interpret=True)
        return jnp.sum(out * g)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    sd = {}
    _export_conv_component(sd, "enc", g_params, encoder_head=True)
    order = [id(t) for t in fused_conv.encoder_weights(enc)]
    by_param = {k: dw[order.index(id(t))] for k, t in enc.named_parameters()}
    assert set(by_param) == {k[len("enc."):] for k in sd}
    for key, ref in sd.items():
        _assert_scaled(by_param[key[len("enc."):]], ref, 1e-4, f"{name} {key} vs JAX")
    _assert_scaled(dx, g_x, 1e-4, f"{name} dx vs JAX")


def test_variants_are_the_gpu_tests_widths():
    """The widths here are the GPU tests' (``ENCODER_VARIANTS``, the model's
    encoder as ``default``), and the JAX gate takes each of them."""
    from test_torch_port_gpu import ENCODER_VARIANTS

    for key in ("narrow", "no_res"):
        assert VARIANTS[key] == ENCODER_VARIANTS[key]
    for kw in VARIANTS.values():
        assert jax_fused.fused_encoder_applicable(JaxEncoderConfig(**kw))
        assert fused_conv.fused_encoder_applicable(EncoderConfig(**kw))

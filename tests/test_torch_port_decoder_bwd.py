"""The identities the fused decoder's backward kernels rely on, on the CPU.

``csrc/fused_decoder_bwd.cu`` computes the decoder's VJP in two passes:

- the cotangent pass takes each layer's input cotangent as an implicit GEMM
  of its pre-activation cotangent with transposed slices ``[Ci][tap][Co]``
  (``decoder_bwd_pack_kernel``), walking each input position's taps: a
  conv's taps flipped in space (a stride-1 conv of the cotangent), a k4 s2
  p1 transposed conv's in torch order (the direct stride-2 conv ``dx[i] =
  Σ dpre[2i − 1 + t] · W[ci][co][t]``), the unflatten's one output position
  a tap;
- the weight-gradient pass forms every tap's gradient as a GEMM over the
  activation and cotangent records, walking a conv's outputs and a
  transposed conv's inputs (the records' roles swapped: the activation at
  u, the cotangent at ``u·s − p + t``), summed over groups of frames of at
  most 256 terms, then over a chunk's groups, then over the chunks in order
  (``fused_conv._dec_dims``). Biases: a conv's from its tap (p, p); a
  transposed conv's from its tap (1, 1), each input position u adding the
  2×2 output block at 2u, which the four taps (1|2, 1|2) reach from u; the
  unflatten's element (co, pos) from its tap pos.

Here those identities run in float64 torch, indexed as the kernels index
them, against autograd of ``F.conv2d``, ``F.conv_transpose2d`` and
``F.linear`` and against the VJP of the JAX package's ``conv_transpose_apply``
and ``dense_apply``; and the backward built from them is held at N ∈ {1, 5,
9} frames to autograd of ``fused_decoder_plain`` in float64 (1e-9 ×
max(1, max|plain|)) and to ``jax.grad`` through JAX's ``fused_decoder_apply(...,
tile=8, interpret=True)`` on the same weights (the 48- and 96-wide decoders
and one with a ``res_proj``) within 1e-4 × max(1, max|JAX|), the tolerance
``test_torch_port_fused_decoder.py`` holds the port's gradients to (JAX sums
in float32). JAX's gradients at N frames are taken over 9 frames whose
cotangent is zero past the first N, which gives the same gradients and
compiles JAX's interpreted kernels once a decoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu.nn.conv import DecoderConfig as JaxDecoderConfig
from multimodal_mtrssm_tpu.nn.conv import conv_transpose_apply, decoder_init
from multimodal_mtrssm_tpu.nn.core import dense_apply
from multimodal_mtrssm_tpu.ops.pallas import fused_conv as jax_fused
from multimodal_mtrssm_tpu.train.torch_export import _export_conv_component
from multimodal_mtrssm_tpu_torch.nn.conv import Decoder, DecoderConfig
from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

K, S, P = 4, 2, 1  # the transposed convs' kernel, stride and padding (fdec::kDeconv*)
DECODERS = {
    "mrssm48": {"in_features": 48},
    "mmtrssm96": {"in_features": 96},
    "res_proj": {"in_features": 48, "residual_input_size": 32},
}
FRAMES = (1, 5, 9)
JAX_TOL = 1e-4  # × max(1, max|JAX|): JAX's gradients are float32 sums
EXACT = 1e-12  # float64 identities, summed in another order


# ---- the kernels' index maps, mirrored -------------------------------------------------------


def weight_index(kind: str, n_ci: int, n_co: int, kk: int, ci, co, tap):
    """``fdec::weight_index``: the flat index in a layer's torch weight of
    (input channel, output channel, torch tap), for a conv ``[Co, Ci, k,
    k]`` (the first linear ``[Co, Ci]``), the unflatten ``[Co·h·w, Ci]`` or
    a transposed conv ``[Ci, Co, k, k]``."""
    if kind == "conv":
        return (co * n_ci + ci) * kk + tap
    if kind == "deconv":
        return (ci * n_co + co) * kk + tap
    return (co * kk + tap) * n_ci + ci


def tslice_tap(kind: str, t: int, kk: int) -> int:
    """The torch tap of a transposed slice's tap ``t``: a conv's flipped in
    space, the other kinds' as they are."""
    return kk - 1 - t if kind == "conv" else t


def tpack_index(kind: str, n_ci: int, n_co: int, kk: int) -> torch.Tensor:
    """``decoder_bwd_pack_kernel``'s index map, without the slices' row
    padding: packed[i][t][o] is the torch weight at ``weight_index(i, o,
    tslice_tap(t))``. ``[Ci, k·k, Co]``."""
    i = torch.arange(n_ci).view(-1, 1, 1)
    t = torch.tensor([tslice_tap(kind, t, kk) for t in range(kk)]).view(1, -1, 1)
    o = torch.arange(n_co).view(1, 1, -1)
    return weight_index(kind, n_ci, n_co, kk, i, o, t)


def tpack(kind: str, w: torch.Tensor, n_ci: int, n_co: int, kk: int) -> torch.Tensor:
    """A layer's torch weight packed as the transposed slices hold it."""
    return w.reshape(-1)[tpack_index(kind, n_ci, n_co, kk)]


def walk(L: dict, iy: int, ix: int, tap: int, ho: int, wo: int):
    """The output position a transposed slice's tap reaches from input (iy,
    ix), or None: the unflatten's tap t its output t; a transposed conv's
    ``i·s − p + t``; a conv's (stride 1, taps flipped) ``i − (k − 1 − p) +
    t``."""
    if L["kind"] == "unflatten":
        return divmod(tap, wo)
    ky, kx = divmod(tap, L["k"])
    sh = L["p"] if L["kind"] == "deconv" else L["k"] - 1 - L["p"]
    oy, ox = iy * L["s"] - sh + ky, ix * L["s"] - sh + kx
    return (oy, ox) if 0 <= oy < ho and 0 <= ox < wo else None


def input_cotangent(dpre: torch.Tensor, packed: torch.Tensor, L: dict, hi: int,
                    wi: int) -> torch.Tensor:
    """The cotangent pass as the kernel walks it: each input position sums,
    over the taps that reach an output position, the pre-activation
    cotangent there times the packed ``[Ci, k·k, Co]`` slice."""
    n, _, ho, wo = dpre.shape
    out = dpre.new_zeros(n, packed.shape[0], hi, wi)
    for iy in range(hi):
        for ix in range(wi):
            for tap in range(packed.shape[1]):
                o = walk(L, iy, ix, tap, ho, wo)
                if o is not None:
                    out[:, :, iy, ix] += dpre[:, :, o[0], o[1]] @ packed[:, tap].T
    return out


def weight_gradient(a: torch.Tensor, dpre: torch.Tensor, L: dict, chunk: int):
    """The weight-gradient pass's sums, per tap: a conv walks its outputs
    and reads its input at ``o·s − p + t``; a transposed conv and the
    unflatten walk their inputs u and read the cotangent at ``u·s − p + t``.
    Per frame, then over groups of frames of at most 256 terms, then over
    each chunk's groups in order, then over the chunks in order. Returns
    ``[Ci, Co, k·k]`` and the bias (``[Co]``; the unflatten's ``[Co, k·k]``)
    as the kernel forms it."""
    kind, k, s, p = L["kind"], L["k"], L["s"], L["p"]
    n, ci, hi, wi = a.shape
    _, co, ho, wo = dpre.shape
    swap = kind != "conv"
    hw, ww, hm, wm = (hi, wi, ho, wo) if swap else (ho, wo, hi, wi)
    per_frame = a.new_zeros(n, ci, co, k * k)
    bias_frame = a.new_zeros(n, co, k * k) if kind == "unflatten" else a.new_zeros(n, co)
    for tap in range(k * k):
        ky, kx = divmod(tap, k)
        for wy in range(hw):
            for wx in range(ww):
                my, mx = wy * s - p + ky, wx * s - p + kx
                if not (0 <= my < hm and 0 <= mx < wm):
                    continue
                (ay, ax), (dy, dx) = ((wy, wx), (my, mx)) if swap else ((my, mx), (wy, wx))
                per_frame[..., tap] += a[:, :, ay, ax, None] * dpre[:, None, :, dy, dx]
                if kind == "unflatten":
                    bias_frame[..., tap] += dpre[:, :, dy, dx]
                elif kind == "deconv" and (ky, kx) == (1, 1):
                    bias_frame += ((dpre[:, :, dy, dx] + dpre[:, :, dy, dx + 1]) +
                                   (dpre[:, :, dy + 1, dx] + dpre[:, :, dy + 1, dx + 1]))
                elif kind == "conv" and (ky, kx) == (p, p):
                    bias_frame += dpre[:, :, dy, dx]
    group = max(1, 256 // (hw * ww))
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


def torch_layout(kind: str, dw: torch.Tensor, db: torch.Tensor, shape: tuple[int, ...]):
    """The pass's ``[Ci, Co, k·k]`` gradient and its bias in the torch
    layout of a weight of ``shape`` (what ``reduce_weight_grads`` writes)."""
    if kind == "conv":
        return dw.permute(1, 0, 2).reshape(shape), db
    if kind == "deconv":
        return dw.reshape(shape), db
    return dw.permute(1, 2, 0).reshape(shape), db.reshape(-1)


# ---- the layer table and the records ---------------------------------------------------------


def layers(cfg: DecoderConfig) -> list[dict]:
    """The kernels' layer table (``fdec::make_plan``): kind, kernel, stride,
    padding, whether the input also feeds a residual skip, whether the
    output adds one."""
    c0, h0, _ = cfg.conv_in_shape

    def layer(kind, k=1, s=1, p=0, skip_in=False, residual=False):
        return dict(kind=kind, k=k, s=s, p=p, skip_in=skip_in, residual=residual)

    out = [layer("conv"), layer("unflatten", k=h0)]
    if cfg.num_residual_blocks > 0 and c0 != cfg.residual_input_size:
        out.append(layer("conv"))
    for _ in range(cfg.num_residual_blocks):
        out += [layer("conv", k=3, p=1, skip_in=True), layer("conv", k=3, p=1, residual=True)]
    return out + [layer("deconv", K, S, P) for _ in cfg.channels]


def apply_layer(L: dict, a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One layer's pre-activation (without a residual skip), NCHW."""
    if L["kind"] == "unflatten":
        n = a.shape[0]
        return F.linear(a.flatten(1), w, b).view(n, -1, L["k"], L["k"])
    if L["kind"] == "deconv":
        return F.conv_transpose2d(a, w, b, stride=L["s"], padding=L["p"])
    return F.conv2d(a, w.view(w.shape[0], w.shape[1], L["k"], L["k"]), b, padding=L["p"])


def forward_records(weights, cfg: DecoderConfig, feats: torch.Tensor):
    """NCHW inputs and outputs of every layer (the kernels' activation
    record), ``fused_decoder_plain``'s forward layer by layer."""
    a = feats[:, :, None, None]
    ins, outs = [], []
    table = layers(cfg)
    for i, (L, w, b) in enumerate(zip(table, weights[0::2], weights[1::2])):
        ins.append(a)
        pre = apply_layer(L, a, w, b)
        if L["residual"]:
            pre = pre + ins[-2]
        a = torch.tanh(pre) if i == len(table) - 1 else fused_conv._elu(pre)
        outs.append(a)
    return ins, outs


def kernel_backward(weights, cfg: DecoderConfig, feats: torch.Tensor, g: torch.Tensor):
    """The fused decoder's backward as the two passes compute it, from the
    identities above: ``(d_feats, weight grads)`` in torch layout."""
    table = layers(cfg)
    ins, outs = forward_records(weights, cfg, feats)
    chunk = fused_conv._dec_dims(cfg, feats.shape[0]).chunk
    grads: list[torch.Tensor] = []
    dpre = g.permute(0, 3, 1, 2) * (1 - outs[-1] ** 2)  # the Tanh, where g is read
    skip = None
    for i in reversed(range(len(table))):
        L, w = table[i], weights[2 * i]
        ci, hi, wi = ins[i].shape[1:]
        co = dpre.shape[1]
        dw, db = weight_gradient(ins[i], dpre, L, chunk)
        grads[:0] = torch_layout(L["kind"], dw, db, tuple(w.shape))
        cot = input_cotangent(dpre, tpack(L["kind"], w, ci, co, L["k"] ** 2), L, hi, wi)
        if i == 0:
            return cot.reshape(feats.shape), grads
        if L["skip_in"]:
            cot = cot + skip
        if L["residual"]:
            skip = dpre
        dpre = cot * torch.where(outs[i - 1] > 0, 1.0, outs[i - 1] + 1.0)


def _assert_scaled(got: torch.Tensor, ref, tol: float, name: str) -> None:
    ref = torch.as_tensor(np.array(ref), dtype=torch.float64)
    scale = max(1.0, float(ref.abs().max()))
    err = float((got.double() - ref).abs().max())
    assert err <= tol * scale, f"{name}: max |err| {err:.3g} > {tol} x {scale:.3g}"


@pytest.fixture(scope="module", params=list(DECODERS))
def bridged(request):
    """A JAX decoder's params and the port's ``Decoder`` with the same
    weights, through the JAX package's own export of a conv stack."""
    kw = DECODERS[request.param]
    jcfg = JaxDecoderConfig(**kw)
    params = decoder_init(jax.random.PRNGKey(29), jcfg)
    sd: dict[str, np.ndarray] = {}
    _export_conv_component(sd, "decoder", params)
    decoder = Decoder(DecoderConfig(**kw))
    load_reference_state_dict(decoder, {k[len("decoder."):]: v for k, v in sd.items()})

    def loss(p, xs, g):
        return jnp.sum(jax_fused.fused_decoder_apply(p, jcfg, xs, tile=8, interpret=True) * g)

    return request.param, jcfg, params, decoder, jax.jit(jax.grad(loss, argnums=(0, 1)))


def _records(decoder: Decoder, n: int, seed: int):
    weights = [t.detach().double() for t in fused_conv.decoder_weights(decoder)]
    feats = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, decoder.cfg.in_features)))
    return weights, forward_records(weights, decoder.cfg, feats)


# ---- the cotangent pass ----------------------------------------------------------------------


def test_conv_input_cotangent_is_the_flipped_transposed_conv(bridged):
    """Every conv of the decoder (the first linear as a 1×1 conv on the 1×1
    map, the projection, the residual convs): the kernel's walk of the
    flipped, transposed slices equals the conv of the cotangent with
    ``W.flip(2, 3).transpose(0, 1)`` at padding k − 1 − p, and autograd's
    input cotangent."""
    decoder = bridged[3]
    weights, (ins, outs) = _records(decoder, 3, 1)
    rng = np.random.default_rng(2)
    checked = 0
    for L, w, a, o in zip(layers(decoder.cfg), weights[0::2], ins, outs):
        if L["kind"] != "conv":
            continue
        dpre = torch.from_numpy(rng.standard_normal(tuple(o.shape)))
        ci, hi, wi = a.shape[1:]
        got = input_cotangent(dpre, tpack("conv", w, ci, o.shape[1], L["k"] ** 2), L, hi, wi)
        w4 = w.view(w.shape[0], ci, L["k"], L["k"])
        flipped = F.conv2d(dpre, w4.flip(2, 3).transpose(0, 1), padding=L["k"] - 1 - L["p"])
        a_ = a.detach().requires_grad_()
        ref, = torch.autograd.grad(F.conv2d(a_, w4, padding=L["p"]), a_, dpre)
        _assert_scaled(got, flipped, EXACT, "flipped conv")
        _assert_scaled(got, ref, EXACT, "autograd")
        checked += 1
    assert checked == len(layers(decoder.cfg)) - 4


# The reference decoder's transposed convs: (Ci, Co, input side).
DECONVS = [(64, 32, 4), (32, 16, 8), (16, 1, 16)]


@pytest.mark.parametrize("ci,co,hi", DECONVS, ids=[f"{a}to{b}at{c}" for a, b, c in DECONVS])
def test_deconv_input_cotangent_is_the_direct_stride2_conv(ci, co, hi):
    """A k4 s2 p1 transposed conv's input cotangent, walked from its input
    positions over the unflipped ``[Ci][tap][Co]`` slices, is the direct
    stride-2 conv of the output's cotangent with the torch weight as it is,
    and equals autograd of ``F.conv_transpose2d`` and the VJP of JAX's
    ``conv_transpose_apply``; an interior input position uses all 16 taps,
    so no parity class is needed."""
    rng = np.random.default_rng(ci + co)
    x = torch.from_numpy(rng.standard_normal((2, ci, hi, hi)))
    w = torch.from_numpy(rng.standard_normal((ci, co, K, K)) / np.sqrt(4 * ci))
    dpre = torch.from_numpy(rng.standard_normal((2, co, 2 * hi, 2 * hi)))
    L = dict(kind="deconv", k=K, s=S, p=P)
    got = input_cotangent(dpre, tpack("deconv", w, ci, co, K * K), L, hi, hi)
    _assert_scaled(got, F.conv2d(dpre, w, stride=S, padding=P), EXACT, "direct stride-2 conv")
    x_ = x.clone().requires_grad_()
    ref, = torch.autograd.grad(F.conv_transpose2d(x_, w, stride=S, padding=P), x_, dpre)
    _assert_scaled(got, ref, EXACT, "autograd")
    params = {"w": jnp.asarray(w.permute(2, 3, 0, 1).numpy(), jnp.float32),
              "b": jnp.zeros((co,), jnp.float32)}
    _, vjp = jax.vjp(lambda xs: conv_transpose_apply(params, xs, S, P),
                     jnp.asarray(x.permute(0, 2, 3, 1).numpy(), jnp.float32))
    jdx, = vjp(jnp.asarray(dpre.permute(0, 2, 3, 1).numpy(), jnp.float32))
    _assert_scaled(got.permute(0, 2, 3, 1), jdx, JAX_TOL, "JAX VJP")
    inside = [t for t in range(K * K) if walk(L, 1, 1, t, 2 * hi, 2 * hi) is not None]
    assert inside == list(range(K * K))


@pytest.mark.parametrize("ci", [64, 24])
def test_unflatten_input_cotangent_is_a_gemm_over_positions(ci):
    """The unflatten's input cotangent, ``dx[ci] = Σ over pos, co of
    dpre[pos][co] · W[co·h·w + pos][ci]``, walked one output position a tap
    from the 1×1 map over its ``[Ci][tap][Co]`` slices, equals autograd of
    ``F.linear`` and the VJP of JAX's ``dense_apply`` and its (c, h, w)
    unflatten."""
    c, h = 64, 4
    rng = np.random.default_rng(ci)
    x = torch.from_numpy(rng.standard_normal((3, ci)))
    w = torch.from_numpy(rng.standard_normal((c * h * h, ci)))
    dpre = torch.from_numpy(rng.standard_normal((3, c, h, h)))
    L = dict(kind="unflatten", k=h, s=1, p=0)
    got = input_cotangent(dpre, tpack("unflatten", w, ci, c, h * h), L, 1, 1).reshape(3, ci)
    _assert_scaled(got, torch.einsum("nop,opi->ni", dpre.reshape(3, c, h * h),
                                     w.view(c, h * h, ci)), EXACT, "GEMM")
    x_ = x.clone().requires_grad_()
    ref, = torch.autograd.grad(F.linear(x_, w).view(3, c, h, h), x_, dpre)
    _assert_scaled(got, ref, EXACT, "autograd")
    params = {"w": jnp.asarray(w.T.numpy(), jnp.float32), "b": jnp.zeros((c * h * h,), jnp.float32)}
    _, vjp = jax.vjp(lambda xs: dense_apply(params, xs).reshape(-1, c, h, h).transpose(0, 2, 3, 1),
                     jnp.asarray(x.numpy(), jnp.float32))
    jdx, = vjp(jnp.asarray(dpre.permute(0, 2, 3, 1).numpy(), jnp.float32))
    _assert_scaled(got, jdx, JAX_TOL, "JAX VJP")


@pytest.mark.parametrize("kind,shape", [("conv", (64, 48)), ("conv", (128, 64, 3, 3)),
                                        ("unflatten", (1024, 64)), ("deconv", (64, 32, 4, 4))])
def test_transposed_pack_round_trips(kind, shape):
    """The transposed pack's index map is a bijection onto each kind's torch
    weight (the first linear, a residual conv, the unflatten, a transposed
    conv): scattering the packed slices back by it gives the torch weight;
    a conv's taps come flipped in space, the others' in torch order."""
    w = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(shape))
    kk = {"conv": shape[-1] ** 2 if len(shape) == 4 else 1, "unflatten": 16, "deconv": K * K}[kind]
    n_ci = {"conv": shape[1], "unflatten": shape[1], "deconv": shape[0]}[kind]
    n_co = w.numel() // (n_ci * kk)
    idx = tpack_index(kind, n_ci, n_co, kk)
    assert idx.shape == (n_ci, kk, n_co)
    assert torch.equal(idx.reshape(-1).sort().values, torch.arange(w.numel()))
    back = torch.empty(w.numel(), dtype=w.dtype)
    back[idx.reshape(-1)] = tpack(kind, w, n_ci, n_co, kk).reshape(-1)
    assert torch.equal(back.reshape(shape), w)
    packed = tpack(kind, w, n_ci, n_co, kk)
    if kind == "conv" and kk == 9:  # packed tap t is torch tap 8 − t
        assert torch.equal(packed[:, 0], w[:, :, 2, 2].T)
    if kind == "deconv":
        assert torch.equal(packed[:, 5], w[:, :, 1, 1])


# ---- the weight-gradient pass ----------------------------------------------------------------


@pytest.mark.parametrize("n", [9, 33])
def test_weight_gradient_as_the_kernel_forms_it(bridged, n):
    """Every layer's weight and bias gradient as the pass forms it (a
    transposed conv and the unflatten with the records' roles swapped; the
    biases from the (p, p) tap, the 2×2 blocks of tap (1, 1), each of the
    unflatten's taps), summed per group of frames, per chunk and over the
    chunks in order (N=9: chunks of 8 and 1; N=33: five chunks of 8 and 1),
    equals autograd of the layer on the recorded activations."""
    decoder = bridged[3]
    chunk = fused_conv._dec_dims(decoder.cfg, n).chunk
    assert -(-n // chunk) > 1
    weights, (ins, outs) = _records(decoder, n, n)
    rng = np.random.default_rng(n + 1)
    for L, w, b, a, o in zip(layers(decoder.cfg), weights[0::2], weights[1::2], ins, outs):
        dpre = torch.from_numpy(rng.standard_normal(tuple(o.shape)))
        dw, db = torch_layout(L["kind"], *weight_gradient(a, dpre, L, chunk), tuple(w.shape))
        w_, b_ = w.clone().requires_grad_(), torch.zeros_like(b, requires_grad=True)
        ref_w, ref_b = torch.autograd.grad(apply_layer(L, a, w_, b_), [w_, b_], dpre)
        _assert_scaled(dw, ref_w, EXACT, f"{L['kind']} dW")
        _assert_scaled(db, ref_b, EXACT, f"{L['kind']} db")


@pytest.mark.parametrize("hi", [4, 8, 16])
def test_deconv_bias_blocks_cover_every_output_once(hi):
    """The transposed conv's bias: the 2×2 output blocks at 2u over its
    input positions u tile the output map, each position once, and they are
    what the four taps (1|2, 1|2) reach from u."""
    L = dict(kind="deconv", k=K, s=S, p=P)
    seen = torch.zeros(2 * hi, 2 * hi, dtype=torch.int64)
    for uy in range(hi):
        for ux in range(hi):
            block = {(2 * uy + a, 2 * ux + b) for a in range(2) for b in range(2)}
            reached = {walk(L, uy, ux, ky * K + kx, 2 * hi, 2 * hi)
                       for ky in (1, 2) for kx in (1, 2)}
            assert reached == block
            for y, x in block:
                seen[y, x] += 1
    assert torch.equal(seen, torch.ones_like(seen))


# ---- the backward from the pieces ------------------------------------------------------------


@pytest.mark.parametrize("n", FRAMES)
def test_backward_from_the_pieces_matches_plain_and_jax(bridged, n):
    """The backward built from the two passes' identities, every weight
    gradient and the features' cotangent, against autograd of
    ``fused_decoder_plain`` (float64) and ``jax.grad`` through the Pallas
    kernels' custom VJP in interpret mode, on bridged weights."""
    name, _, params, decoder, jax_grad = bridged
    cfg = decoder.cfg
    assert (decoder.res_proj is not None) == (name == "res_proj")
    weights = [t.detach().double() for t in fused_conv.decoder_weights(decoder)]
    rng = np.random.default_rng(40 + n)
    feats = rng.standard_normal((max(FRAMES), cfg.in_features)).astype(np.float32)
    g = rng.standard_normal((max(FRAMES), 32, 32, 1)).astype(np.float32)
    g[n:] = 0.0
    ft, gt = torch.from_numpy(feats[:n]).double(), torch.from_numpy(g[:n]).double()
    dx, dw = kernel_backward(weights, cfg, ft, gt)
    ref_dx, ref_dw = fused_conv.fused_decoder_backward_plain(weights, cfg, ft, gt, True)
    for i, (a, b) in enumerate(zip([*dw, dx], [*ref_dw, ref_dx])):
        assert a.shape == b.shape
        _assert_scaled(a, b.numpy(), 1e-9, f"{name} tensor {i} vs plain")

    g_params, g_x = jax_grad(params, jnp.asarray(feats), jnp.asarray(g))
    sd: dict[str, np.ndarray] = {}
    _export_conv_component(sd, "decoder", g_params)
    order = [id(t) for t in fused_conv.decoder_weights(decoder)]
    by_param = {k: dw[order.index(id(t))] for k, t in decoder.named_parameters()}
    assert set(by_param) == {k[len("decoder."):] for k in sd}
    for key, ref in sd.items():
        _assert_scaled(by_param[key[len("decoder."):]], ref, JAX_TOL, f"{name} {key} vs JAX")
    _assert_scaled(dx, np.asarray(g_x)[:n], JAX_TOL, f"{name} d_feats vs JAX")

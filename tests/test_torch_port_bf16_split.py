"""The split-bf16 cotangent arithmetic of the bf16 fused encoder's and
decoder's backward kernels, on the CPU: the plain bf16 backward's walk with
every cotangent operand of a conv or the head replaced by its two bf16 terms
(``fused_conv.split_bf16``: ``hi = bf16(d)``, ``lo = bf16(d - hi)``), each
multiplied exactly and summed in float32, as the kernels feed the tensor
cores. At NARROW widths (channels not multiples of 16) its float32
gradients of every weight, bias and the frames stay within 1e-4 ×
max(1, max|ref|) of the unsplit walk's (JAX keeps these cotangents in
float32, ``_walk_bwd``), far below the kernels' gate against the plain
backward (``BF16_BWD_TOL`` 2e-2 × scale), while one bf16 rounding of the
operands (``hi`` alone) does not stay within it (measured: 7.4e-6 and
6.0e-3 × scale). Elementwise steps (the residual skip, the ELU
derivative) stay float32, as in the kernels.

The decoder's walk (``fused_conv._decoder_walk``) feeds every linear, conv
and transposed-conv cotangent as its two terms, each term's VJP taken exactly
in float32 by autograd, on a NARROW decoder (JAX's tiny reference shape)
and on one with a 1×1 projection and widths that are no multiple of 16
(``not16``), its features' gradient included: within the same 1e-4 ×
max(1, max|ref|) of the unsplit walk, while ``hi`` alone is not (measured:
2.6e-5 and 5.5e-3 × scale narrow, 1.2e-5 and 6.8e-3 not16).
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.conv import Decoder, DecoderConfig, Encoder, EncoderConfig
from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

NARROW = {"channels": (5, 7, 9), "residual_output_size": 12, "residual_intermediate_size": 10,
          "num_residual_blocks": 2, "linear_sizes": (33,)}
SPLIT_TOL = 1e-4
# Decoders: JAX's narrow reference shape (tests/test_torch_port_decoder_bf16.py),
# and a 1×1 projection 64 → 40 with residual convs 40 ↔ 72, transposed convs
# to 24 and 12, and a first linear of 63 (tests/test_torch_port_gpu.py's
# "not16").
DECODERS = {
    "narrow": dict(in_features=48, linear_sizes=(32, 256), conv_in_shape=(16, 4, 4),
                   channels=(8, 4, 1), num_residual_blocks=1, residual_intermediate_size=24,
                   residual_input_size=16),
    "not16": dict(in_features=48, linear_sizes=(63, 1024), residual_input_size=40,
                  residual_intermediate_size=72, channels=(24, 12, 1))}


def _terms(g: torch.Tensor, hi_only: bool) -> list[torch.Tensor]:
    hi, lo = fused_conv.split_bf16(g)
    return [hi] if hi_only else [hi, lo]


def _split_functional(hi_only: bool):
    """``torch.nn.functional`` for ``_encoder_walk`` with conv2d and linear
    whose backward takes the cotangent as its bf16 terms."""

    class Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b, stride, padding):
            ctx.save_for_backward(x, w)
            ctx.geom = (stride, padding)
            return F.conv2d(x, w, b, stride=stride, padding=padding)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            stride, padding = ctx.geom
            terms = _terms(g, hi_only)
            dx = sum(torch.nn.grad.conv2d_input(x.shape, w, t, stride, padding) for t in terms)
            dw = sum(torch.nn.grad.conv2d_weight(x, w.shape, t, stride, padding) for t in terms)
            return dx, dw, sum(t.sum((0, 2, 3)) for t in terms), None, None

    class Linear(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b):
            ctx.save_for_backward(x, w)
            return F.linear(x, w, b)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            terms = _terms(g, hi_only)
            return (sum(t @ w for t in terms), sum(t.T @ x for t in terms),
                    sum(t.sum(0) for t in terms))

    return types.SimpleNamespace(
        conv2d=lambda x, w, b, stride=1, padding=0: Conv.apply(x, w, b, stride, padding),
        linear=Linear.apply)


def _grads(weights, cfg, x, g):
    """Float32 gradients of the plain bf16 walk (rounded layer outputs, the
    ELU derivative from them) of bf16-valued weights and frames."""
    w = [t.float().requires_grad_() for t in weights]
    xs = x.float().requires_grad_()
    c = fused_conv.coords(cfg, "cpu", torch.bfloat16).float()
    out = fused_conv._encoder_walk(w, cfg, xs.permute(0, 3, 1, 2), c, fused_conv._RoundedElu.apply,
                                   fused_conv._Rounded.apply)
    return torch.autograd.grad(out, [*w, xs], g)


@pytest.fixture(scope="module")
def case():
    torch.manual_seed(3)
    enc = Encoder(EncoderConfig(**NARROW))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-1, 1, (6, 32, 32, 1)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((6, enc.cfg.out_dim)).astype(np.float32))
    weights = [t.detach().to(torch.bfloat16) for t in fused_conv.encoder_weights(enc)]
    return enc.cfg, weights, x.to(torch.bfloat16), g.to(torch.bfloat16).float()


def _scaled_errs(got, ref) -> list[float]:
    return [float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(got, ref)]


def test_split_bf16_terms():
    d = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = fused_conv.split_bf16(d)
    for t in (hi, lo):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    assert float(((hi + lo - d).abs() / d.abs()).max()) <= 2.0 ** -16
    assert float(((hi - d).abs() / d.abs()).max()) > 2.0 ** -10


def test_split_cotangents_keep_the_plain_backward(case, monkeypatch):
    cfg, weights, x, g = case
    ref = _grads(weights, cfg, x, g)
    with monkeypatch.context() as m:
        m.setattr(fused_conv, "F", _split_functional(hi_only=False))
        split = _grads(weights, cfg, x, g)
    with monkeypatch.context() as m:
        m.setattr(fused_conv, "F", _split_functional(hi_only=True))
        rounded = _grads(weights, cfg, x, g)
    errs = _scaled_errs(split, ref)
    assert max(errs) <= SPLIT_TOL, errs
    assert max(_scaled_errs(rounded, ref)) > SPLIT_TOL


def _split_op(op, hi_only: bool):
    """``op(x, w, b, **kw)`` whose backward takes the cotangent as its bf16
    terms, each term's VJP exact in float32 (autograd of the linear op)."""

    class Split(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b):
            ctx.save_for_backward(x, w, b)
            return op(x, w, b)

        @staticmethod
        def backward(ctx, g):
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
                out = op(*ins)
                vjps = [torch.autograd.grad(out, ins, t, retain_graph=True)
                        for t in _terms(g, hi_only)]
            return tuple(sum(v[i] for v in vjps) for i in range(3))

    return Split.apply


def _split_decoder_functional(hi_only: bool):
    """``torch.nn.functional`` for ``_decoder_walk`` with linear, conv2d and
    conv_transpose2d on split cotangents."""
    def conv2d(x, w, b, padding=0):
        return _split_op(lambda x, w, b: F.conv2d(x, w, b, padding=padding), hi_only)(x, w, b)

    def conv_transpose2d(x, w, b, stride=1, padding=0, output_padding=0):
        return _split_op(lambda x, w, b: F.conv_transpose2d(
            x, w, b, stride=stride, padding=padding, output_padding=output_padding),
            hi_only)(x, w, b)

    return types.SimpleNamespace(linear=_split_op(F.linear, hi_only), conv2d=conv2d,
                                 conv_transpose2d=conv_transpose2d)


def _decoder_grads(weights, cfg, feats, g):
    """Float32 gradients of the plain bf16 decoder walk (rounded layer
    outputs, the activation derivatives from them) of bf16-valued weights
    and features, the features' last."""
    w = [t.float().requires_grad_() for t in weights]
    xs = feats.float().requires_grad_()
    out = fused_conv._decoder_walk(w, cfg, xs, fused_conv._RoundedElu.apply,
                                   fused_conv._RoundedTanh.apply)
    return torch.autograd.grad(out, [*w, xs], g.permute(0, 3, 1, 2))


@pytest.fixture(scope="module", params=list(DECODERS))
def decoder_case(request):
    torch.manual_seed(3)
    dec = Decoder(DecoderConfig(**DECODERS[request.param]))
    rng = np.random.default_rng(8)
    feats = torch.from_numpy(rng.standard_normal((4, dec.cfg.in_features)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 32, 32, 1)).astype(np.float32))
    weights = [t.detach().to(torch.bfloat16) for t in fused_conv.decoder_weights(dec)]
    return dec.cfg, weights, feats.to(torch.bfloat16), g.to(torch.bfloat16).float()


def test_decoder_split_cotangents_keep_the_plain_backward(decoder_case, monkeypatch):
    cfg, weights, feats, g = decoder_case
    ref = _decoder_grads(weights, cfg, feats, g)
    with monkeypatch.context() as m:
        m.setattr(fused_conv, "F", _split_decoder_functional(hi_only=False))
        split = _decoder_grads(weights, cfg, feats, g)
    with monkeypatch.context() as m:
        m.setattr(fused_conv, "F", _split_decoder_functional(hi_only=True))
        rounded = _decoder_grads(weights, cfg, feats, g)
    errs = _scaled_errs(split, ref)
    assert max(errs) <= SPLIT_TOL, errs
    assert max(_scaled_errs(rounded, ref)) > SPLIT_TOL

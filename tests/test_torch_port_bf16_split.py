"""The split-bf16 cotangent arithmetic of the bf16 fused encoder's backward
kernels, on the CPU: the plain bf16 backward's walk with every cotangent
operand of a conv or the head replaced by its two bf16 terms
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
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.conv import Encoder, EncoderConfig
from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

NARROW = {"channels": (5, 7, 9), "residual_output_size": 12, "residual_intermediate_size": 10,
          "num_residual_blocks": 2, "linear_sizes": (33,)}
SPLIT_TOL = 1e-4


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

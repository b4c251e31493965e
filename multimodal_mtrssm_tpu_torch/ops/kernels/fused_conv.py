"""Kernels 8-9: the whole conv encoder in one kernel per tile of frames.

Port of the encoder entry of ``multimodal_mtrssm_tpu/ops/pallas/fused_conv.py``
(``fused_encoder_applicable`` ``:136``, ``_plan`` ``:151``,
``fused_encoder_apply`` ``:561``, and the kernels ``_fwd_kernel`` ``:455``
and ``_bwd_kernel`` ``:461`` it reaches). The function is the encoder's:
CoordConv channels, three k3 s2 p1 convs with ELU, the 1×1 ``res_proj``,
the residual blocks ``elu(x + conv2(elu(conv1(x))))`` and the linear head,
on NHWC frames ``[N, 32, 32, C]`` → ``[N, out]``.

The kernels read the port's own :class:`~..nn.conv.Encoder` weights as they
are (``Conv2d`` ``[Co, Ci, k, k]``, the head ``[out, C·4·4]`` in CHW flatten
order, which is a 4×4 valid conv with ``out`` channels). JAX's banded
super-row lane operators (``build_operators``, ``:170``) are a 128-lane TPU
layout, megabytes of mostly zeros; the kernels compute what the TPU kernels
compute, not their layout.

- ``fused_encoder_fwd`` (``csrc/fused_encoder_fwd.cu``): one block per tile
  of frames walks every layer with the tile's activations in shared memory;
  HBM sees the frames and the ``[N, out]`` embedding.
- ``fused_encoder_bwd`` (``csrc/fused_encoder_bwd.cu``): recomputes the
  activations from the frames, as the TPU backward does, then propagates
  the cotangent down the stack (``dx`` only where asked) and forms every
  weight and bias gradient, reduced over frames in a fixed order.

:func:`fused_encoder_plain` is the plain version: ``F.conv2d``/``F.linear``
in the kernels' order of layers and ELU as ``exp(x) - 1`` (``fused_conv.py:
232-236``). On a CPU tensor :func:`fused_encoder_apply` runs it; on a CUDA
tensor it launches the kernels or raises, never cuDNN.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.conv import Encoder, EncoderConfig

# The kernels' layer table holds at most 14 layers: 3 strided convs, the
# projection, two convs a residual block and the head.
MAX_RESIDUAL_BLOCKS = 4
# Frames per block of the forward and the backward's cotangent pass.
FRAMES_PER_BLOCK = 2
# Kernel launches since the last reset, forward and backward (plain ints).
launches = 0
bwd_launches = 0


def fused_encoder_applicable(cfg: EncoderConfig) -> bool:
    """The stacks the kernels take: JAX's (3 k3 s2 p1 convs, ELU, one linear
    head, Identity output), and also what JAX assumes without checking
    (``fused_conv.py:136``): 32×32 frames of one channel. At most
    :data:`MAX_RESIDUAL_BLOCKS` residual blocks."""
    return (
        tuple(cfg.kernel_sizes) == (3, 3, 3)
        and tuple(cfg.strides) == (2, 2, 2)
        and tuple(cfg.paddings) == (1, 1, 1)
        and len(cfg.channels) == 3
        and cfg.activation_name == "ELU"
        and cfg.out_activation_name == "Identity"
        and len(cfg.linear_sizes) == 1
        and tuple(cfg.in_hw) == (32, 32)
        and cfg.in_channels == 1
        and cfg.num_residual_blocks <= MAX_RESIDUAL_BLOCKS
    )


def resolve_conv_layout(layout: str, encoder_cfgs: Sequence[EncoderConfig]) -> str:
    """A ``conv_layout`` config value as the port runs it (JAX
    ``models/mrssm.py::_resolve_conv_layout``), for either model family:
    ``"fused_enc"`` runs the fused encoder kernels and raises ``ValueError``
    when an encoder is not eligible; ``"auto"``, ``"nhwc"`` and ``"s2d"``
    run the canonical cuDNN layout, ``"canonical"``. s2d is the same math
    re-expressed for the TPU's 128 lanes, not ported (ROADMAP "not to
    port")."""
    if layout in ("auto", "nhwc", "s2d"):
        return "canonical"
    if layout != "fused_enc":
        raise ValueError(
            f"conv_layout must be 'auto', 'nhwc', 's2d' or 'fused_enc', got {layout!r}")
    bad = [f"encoder[{i}]" for i, c in enumerate(encoder_cfgs) if not fused_encoder_applicable(c)]
    if bad:
        raise ValueError(
            "conv_layout='fused_enc' requires reference-shaped encoder stacks (3× k3 s2 p1 from "
            f"32×32×1 frames, ELU, one linear, ≤ {MAX_RESIDUAL_BLOCKS} residual blocks); "
            f"not: {bad}")
    return "fused_enc"


def encoder_weights(encoder: Encoder) -> tuple[torch.Tensor, ...]:
    """The encoder's tensors in the kernels' layer order, weight then bias
    of each: the strided convs, ``res_proj`` (if any), each residual block's
    two convs, the head."""
    convs = [*encoder.convs]
    if encoder.res_proj is not None:
        convs.append(encoder.res_proj)
    for block in encoder.res_blocks or ():
        convs += [block.conv1, block.conv2]
    return tuple(t for m in (*convs, encoder.linears[0]) for t in (m.weight, m.bias))


def weight_shapes(cfg: EncoderConfig) -> list[tuple[int, ...]]:
    """Torch-layout shapes of :func:`encoder_weights`' tensors."""
    cin = cfg.in_channels + (2 if cfg.coord_conv else 0)
    shapes: list[tuple[int, ...]] = []
    for ch, k in zip(cfg.channels, cfg.kernel_sizes):
        shapes += [(ch, cin, k, k), (ch,)]
        cin = ch
    out, mid = cfg.residual_output_size, cfg.residual_intermediate_size
    if cfg.num_residual_blocks > 0 and cin != out:
        shapes += [(out, cin, 1, 1), (out,)]
        cin = out
    for _ in range(cfg.num_residual_blocks):
        shapes += [(mid, cin, 3, 3), (mid,), (cin, mid, 3, 3), (cin,)]
    h, w = cfg.spatial_out()
    return shapes + [(cfg.out_dim, h * w * cin), (cfg.out_dim,)]


def _elu(x: torch.Tensor) -> torch.Tensor:
    """ELU as ``exp(x) - 1`` on the negative side, as the kernels (and the
    Pallas kernel, which has no expm1) compute it."""
    return torch.where(x > 0, x, torch.exp(torch.minimum(x, torch.zeros_like(x))) - 1.0)


def coords(cfg: EncoderConfig, device: torch.device | str) -> torch.Tensor:
    """The CoordConv maps' 1-D values, ``[H + W]``: the row coordinates, then
    the column coordinates (``Encoder.forward``'s ``linspace``)."""
    h, w = cfg.in_hw
    return torch.cat([torch.linspace(-1.0, 1.0, h, device=device),
                      torch.linspace(-1.0, 1.0, w, device=device)])


def fused_encoder_plain(weights: Sequence[torch.Tensor], cfg: EncoderConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: NHWC frames ``[N, H, W,
    C]`` → ``[N, out]`` on :func:`encoder_weights`' tensors."""
    n, h, w, _ = x.shape
    x = x.permute(0, 3, 1, 2)
    if cfg.coord_conv:
        c = coords(cfg, x.device).to(x.dtype)
        x = torch.cat([x, c[:h].view(1, 1, h, 1).expand(n, 1, h, w),
                       c[h:].view(1, 1, 1, w).expand(n, 1, h, w)], 1)
    it = iter(weights)
    for s, p in zip(cfg.strides, cfg.paddings):
        x = _elu(F.conv2d(x, next(it), next(it), stride=s, padding=p))
    if cfg.num_residual_blocks > 0 and cfg.channels[-1] != cfg.residual_output_size:
        x = _elu(F.conv2d(x, next(it), next(it)))
    for _ in range(cfg.num_residual_blocks):
        t = _elu(F.conv2d(x, next(it), next(it), padding=1))
        x = _elu(x + F.conv2d(t, next(it), next(it), padding=1))
    return F.linear(x.flatten(1), next(it), next(it))


def fused_encoder_backward_plain(weights: Sequence[torch.Tensor], cfg: EncoderConfig,
                                 x: torch.Tensor, g: torch.Tensor,
                                 want_dx: bool) -> tuple[torch.Tensor | None, tuple[torch.Tensor, ...]]:
    """Plain PyTorch version of the backward kernel: an autograd replay of
    :func:`fused_encoder_plain` under the cotangent ``g``. Returns ``(dx or
    None, weight grads)``."""
    with torch.enable_grad():
        w = [t.detach().requires_grad_() for t in weights]
        xs = x.detach().requires_grad_(want_dx)
        out = fused_encoder_plain(w, cfg, xs)
        grads = torch.autograd.grad(out, [*w, xs] if want_dx else w, g)
    return (grads[-1] if want_dx else None), tuple(grads[:len(w)])


def _dims(cfg: EncoderConfig, n: int):
    from multimodal_mtrssm_tpu_torch.ops.kernels.build import EncDims

    h, w = cfg.in_hw
    return EncDims(N=n, H=h, W=w, C0=cfg.in_channels, coord=int(cfg.coord_conv),
                   ch0=cfg.channels[0], ch1=cfg.channels[1], ch2=cfg.channels[2],
                   res_out=cfg.residual_output_size, res_mid=cfg.residual_intermediate_size,
                   n_res=cfg.num_residual_blocks, out_dim=cfg.out_dim, frames=FRAMES_PER_BLOCK,
                   chunk=max(8, -(-n // 64)))


def _check(weights: Sequence[torch.Tensor], cfg: EncoderConfig, x: torch.Tensor,
           extra: dict[str, tuple[torch.Tensor, tuple[int, ...]]] | None = None) -> None:
    """Device, dtype, shape and contiguity checks of a kernel launch."""
    from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import _check_inputs

    if not fused_encoder_applicable(cfg):
        raise ValueError(f"the fused encoder kernels do not take this encoder: {cfg}")
    if x.ndim != 4 or tuple(x.shape[1:]) != (*cfg.in_hw, cfg.in_channels):
        raise ValueError(f"the fused encoder takes [N, {cfg.in_hw[0]}, {cfg.in_hw[1]}, "
                         f"{cfg.in_channels}] frames, got {tuple(x.shape)}")
    shapes = weight_shapes(cfg)
    if len(weights) != len(shapes):
        raise ValueError(f"expected {len(shapes)} encoder tensors, got {len(weights)}")
    expect = {"x": (x, tuple(x.shape)), **(extra or {})}
    for i, (t, shape) in enumerate(zip(weights, shapes)):
        expect[f"weights[{i}]"] = (t, shape)
    _check_inputs(expect, x.device)


def _sizes(lib, dims) -> tuple[int, int, int, int]:
    """``(stash, dstash, grads, chunks)``: floats a frame of the backward's
    activation and cotangent records, weight-gradient floats, and frame
    chunks of its weight-gradient pass. Raises where a block's shared
    memory would not fit."""
    out = (ctypes.c_longlong * 4)()
    if lib.fused_encoder_sizes(dims, ctypes.cast(out, ctypes.c_void_p)) != 0:
        raise ValueError("the fused encoder kernels' shared memory does not fit one block "
                         f"at {dims.frames} frames a block for these widths")
    return tuple(int(v) for v in out)  # type: ignore[return-value]


def fused_encoder_forward_cuda(weights: Sequence[torch.Tensor], cfg: EncoderConfig,
                               x: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel (``csrc/fused_encoder_fwd.cu``): ``[N, 32,
    32, 1]`` frames → ``[N, out]``. Raises on any input it does not take."""
    global launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    _check(weights, cfg, x)
    out = x.new_empty((x.shape[0], cfg.out_dim))
    if x.shape[0] == 0:
        return out
    lib = build.load_library()
    dims = _dims(cfg, x.shape[0])
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    with torch.cuda.device(x.device):
        _sizes(lib, dims)
        c = coords(cfg, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_encoder_forward(ctypes.cast(ptrs, ctypes.c_void_p), len(weights),
                                        x.data_ptr(), c.data_ptr(), out.data_ptr(), dims, stream)
    build.check(err)
    launches += 1
    return out


def fused_encoder_backward_cuda(weights: Sequence[torch.Tensor], cfg: EncoderConfig,
                                x: torch.Tensor, g: torch.Tensor, want_dx: bool,
                                ) -> tuple[torch.Tensor | None, tuple[torch.Tensor, ...]]:
    """Launch the backward kernels (``csrc/fused_encoder_bwd.cu``): the
    recomputing forward, the cotangent pass, the weight-gradient pass and
    its fixed-order reduction. Same contract as
    :func:`fused_encoder_backward_plain`. Its device-memory scratch at the
    reference widths: 13,824 + 10,816 floats a frame of activation and
    cotangent records (~99 KB a frame: ~24 MB at N=240, ~378 MB at N=3840)
    and ≤ 64 frame chunks × 295,312 partial gradient floats (≤ 76 MB)."""
    global bwd_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    N = x.shape[0]
    _check(weights, cfg, x, {"g": (g, (N, cfg.out_dim))})
    grads = [torch.zeros_like(t) for t in weights]
    dx = torch.zeros_like(x) if want_dx else None
    if N == 0:
        return dx, tuple(grads)
    lib = build.load_library()
    dims = _dims(cfg, N)
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    with torch.cuda.device(x.device):
        stash, dstash, n_grad, chunks = _sizes(lib, dims)
        if n_grad != sum(t.numel() for t in weights):
            raise RuntimeError(f"the kernel's gradient layout ({n_grad} floats) does not match "
                               "the encoder's tensors")
        d_flat = x.new_empty(n_grad)
        grads = [v.view(t.shape) for v, t in
                 zip(d_flat.split([t.numel() for t in weights]), weights)]
        scratch = x.new_empty(N * (stash + dstash) + chunks * n_grad)
        c = coords(cfg, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        base = scratch.data_ptr()
        err = lib.fused_encoder_backward(
            ctypes.cast(ptrs, ctypes.c_void_p), len(weights), x.data_ptr(), c.data_ptr(),
            g.data_ptr(), None if dx is None else dx.data_ptr(), d_flat.data_ptr(), base,
            base + 4 * N * stash, base + 4 * N * (stash + dstash), dims, stream)
    build.check(err)
    bwd_launches += 1
    return dx, tuple(grads)


class FusedEncoderFunction(torch.autograd.Function):
    """The fused encoder under autograd: the forward kernel, and the backward
    kernels as its VJP (``fused_conv.py:530-558``), with the encoder's
    tensors as separate inputs so that their gradients reach the
    ``nn.Parameter``s. ``on_cuda`` picks the kernels; otherwise the plain
    versions run (CPU tensors), through the same wiring."""

    @staticmethod
    def forward(ctx, cfg: EncoderConfig, on_cuda: bool, x: torch.Tensor,
                *weights: torch.Tensor) -> torch.Tensor:
        if on_cuda:
            out = fused_encoder_forward_cuda(weights, cfg, x)
        else:
            out = fused_encoder_plain(weights, cfg, x)
        ctx.cfg, ctx.on_cuda = cfg, on_cuda
        ctx.save_for_backward(x, *weights)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        x, *weights = ctx.saved_tensors
        want_dx = ctx.needs_input_grad[2]
        if ctx.on_cuda:
            dx, d_w = fused_encoder_backward_cuda(weights, ctx.cfg, x, g.contiguous(), want_dx)
        else:
            dx, d_w = fused_encoder_backward_plain(weights, ctx.cfg, x, g, want_dx)
        return (None, None, dx, *d_w)


def fused_encoder_apply(encoder: Encoder, x: torch.Tensor) -> torch.Tensor:
    """The encoder on NHWC frames ``[..., 32, 32, 1]`` → ``[..., out]``
    through the fused kernels (CUDA tensors) or their plain versions (CPU
    tensors); differentiable with respect to the encoder's parameters and
    ``x``. Raises for an encoder or frames the kernels do not take."""
    cfg = encoder.cfg
    if not fused_encoder_applicable(cfg):
        raise ValueError(f"fused_enc: the fused encoder kernels do not take this encoder: {cfg}")
    if x.ndim < 4 or tuple(x.shape[-3:]) != (*cfg.in_hw, cfg.in_channels):
        raise ValueError(f"fused_enc: frames must be [..., {cfg.in_hw[0]}, {cfg.in_hw[1]}, "
                         f"{cfg.in_channels}], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused encoder route for device {x.device}")
    lead = x.shape[:-3]
    flat = x.reshape(-1, *x.shape[-3:]).contiguous()
    out = FusedEncoderFunction.apply(cfg, x.device.type == "cuda", flat, *encoder_weights(encoder))
    return out.reshape(*lead, out.shape[-1])

"""Kernels 8-11: the whole conv encoder, and the whole conv decoder, each in
one kernel per tile of frames, at f32 and at bf16.

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

- ``fused_encoder_fwd`` (``csrc/fused_encoder_fwd.cu``, design notes in
  ``csrc/fused_encoder.cuh``): one block of 256 threads per tile of 2
  frames (``kFwdFrames``) walks every layer with the tile's
  activations in shared memory; HBM sees the frames, the weights and the
  ``[N, out]`` embedding. Each layer is an implicit GEMM with a register
  micro-tile (a position of every frame × 4 output channels a thread,
  float4 reads of 4 input channels), fed by weight slices that a packing
  launch lays out tap-major and the Hopper bulk copy streams into two
  shared-memory buffers. It does 2.76 M multiply-adds a frame: bound by
  operations, 0.0196 ms at N=240 (f32 67 TFLOP/s). ``chip_smoke.py`` on an
  NVIDIA H100 80GB HBM3, 700.00 W: 0.3656 ms a call at N=240 (device time
  0.1566 ms; the rest is the wrapper's host time) and 2.2808 ms at N=3840
  (device 2.1307), against 1.8251 (5.5762) for :func:`fused_encoder_plain`
  and 0.8863 (4.9057) for the cuDNN ``Encoder`` (TF32 off); 127
  registers, a 48-byte stack, no spills. At ``conv_layout="fused_enc"`` a
  train step launches it twice, and the backward recomputes through it
  twice more.
- ``fused_encoder_bwd`` (``csrc/fused_encoder_bwd.cu``): recomputes the
  activations from the frames, as the TPU backward does, then propagates
  the cotangent down the stack (``dx`` only where asked) and forms every
  weight and bias gradient, reduced over frames in a fixed order. The
  cotangent pass is the forward's implicit GEMM transposed (weight slices
  flipped in space and laid out ``[Ci][tap][Co]``, streamed by the bulk
  copy; stride-2 layers by parity class), the weight-gradient pass a
  blocked GEMM per layer and tap over both records staged by ``cp.async``,
  4 × 4 gradient elements a thread. ``chip_smoke.py`` on an NVIDIA H100
  80GB HBM3, 700.00 W: ~0.52 ms of device time a call at N=240 (the
  passes' first forms: ~3.28) and ~7.1 ms at N=3840 (~48.6), below the
  cuDNN ``Encoder``'s forward + backward; ``PERF.md`` §6.

:func:`fused_encoder_plain` is the plain version: ``F.conv2d``/``F.linear``
in the kernels' order of layers and ELU as ``exp(x) - 1`` (``fused_conv.py:
232-236``). On a CPU tensor :func:`fused_encoder_apply` runs it; on a CUDA
tensor it launches the kernels or raises, never cuDNN.

bf16 frames (``trainer.precision: 16-mixed``, the model's ``conv_dtype``)
take the bf16 kernels, JAX's ``_fwd_kernel``/``_bwd_kernel`` at
``dtype=bfloat16``: ``fused_encoder_fwd_bf16`` and ``fused_encoder_bwd_bf16``
(``csrc/fused_encoder_bf16_{fwd,bwd}.cu``, design notes in
``csrc/fused_encoder_bf16.cuh``), on the tensor cores: every layer of the
forward, the cotangent pass and the weight-gradient pass an implicit GEMM
on ``mma.sync`` bf16 instructions, a tile of 2 frames a block with its
bf16 maps in shared memory and the weights streamed by the bulk copy. Each
layer rounds its output to bf16 after its f32 sums, bias and ELU; the
backward keeps its cotangents in f32 (split into two bf16 terms, hi and
lo, as tensor-core operands: :func:`split_bf16`) and rounds ``dx`` and the
weight gradients to bf16, as JAX does. :func:`fused_encoder_plain` and
:func:`fused_encoder_backward_plain` round alike on bf16 input (the ELU
derivative from the rounded output, the roundings passed straight through
by the backward); the f32 kernels and plain versions are unchanged.

The decoder entry (``fused_decoder_applicable`` ``:670``,
``fused_decoder_apply`` ``:766``, the same ``_fwd_kernel``/``_bwd_kernel``)
is ported the same way, on the port's own :class:`~..nn.conv.Decoder`
weights: the two linears (the second unflattened in the reference's
``(c, h, w)`` order), the optional 1×1 ``res_proj``, the residual blocks and
the three k4 s2 p1 transposed convs (ELU, ELU, Tanh), features ``[N, F]`` →
NHWC frames ``[N, 32, 32, 1]``.

- ``fused_decoder_fwd`` (``csrc/fused_decoder_fwd.cu``, design notes in
  ``csrc/fused_decoder.cuh``): the encoder forward's implicit GEMM a layer,
  built from the pieces both stacks share (``csrc/conv_common.cuh``): a
  packing launch lays out each layer's weights tap-major, a transposed
  conv's taps by output-parity class, and the bulk copy streams them; a
  thread owns a position of both frames of the tile and 4 output channels
  (1 in the last layer). ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3,
  700.00 W: ~0.29-0.32 ms of device time at N=240 and ~4.4-4.9 ms at
  N=3840, below the cuDNN ``Decoder``'s call; ``PERF.md`` §6.
- ``fused_decoder_bwd`` (``csrc/fused_decoder_bwd.cu``): recomputes through
  that forward, then runs the encoder backward's two passes over the
  decoder's layers: the cotangent pass an implicit GEMM over transposed
  ``[Ci][tap][Co]`` slices (a conv's taps flipped, a transposed conv's the
  direct stride-2 conv of its output's cotangent), the weight-gradient pass
  a blocked GEMM a tap over ``cp.async``-staged records (a transposed conv
  walked from its inputs), reduced over 16 chunks of frames in a fixed
  order. It also returns the features' cotangent, since in training the
  decoder sits on the latents. ``chip_smoke.py`` on an NVIDIA H100 80GB
  HBM3, 700.00 W: ~1.09-1.10 ms of device time a call at N=240 (the
  passes' first forms: ~7.3) and ~14.9 ms at N=3840 (~108), below the cuDNN
  ``Decoder``'s forward + backward; ``PERF.md`` §6.

bf16 features take the bf16 decoder kernels, JAX's ``_fwd_kernel``/
``_bwd_kernel`` at ``dtype=bfloat16`` as ``fused_decoder_apply`` reaches
them (``:781``): ``fused_decoder_fwd_bf16`` and ``fused_decoder_bwd_bf16``
(``csrc/fused_decoder_bf16_{fwd,bwd}.cu``, design notes in
``csrc/fused_decoder_bf16.cuh``), on the tensor cores as the bf16
encoder's: every GEMM of the forward, the cotangent pass and the
weight-gradient pass on ``mma.sync`` bf16 instructions (the pieces of
``csrc/bf16_mma.cuh``), a tile of 2 frames a block with its bf16 maps in
shared memory, each transposed conv as four output-parity class GEMMs.
bf16 features, weights and frames in device memory; every layer's output
rounded to bf16 after its f32 sums, bias and activation; the backward's
cotangents in f32 (split into two bf16 terms as tensor-core operands:
:func:`split_bf16`), the features' cotangent and the weight gradients
rounded to bf16 at the end. :func:`fused_decoder_plain` and
:func:`fused_decoder_backward_plain` round alike on bf16 input
(``PERF.md`` §6 has the kernels' times).

JAX's decoder operators (``build_decoder_operators`` ``:686``,
``_deconv_superrow_maps`` ``:615``, ``superrow_decoder_xla`` ``:752``) are
the same 128-lane TPU layout and are not ported, nor are the ``tile``,
``interpret`` and ``operators`` arguments of its entry: the kernels choose
their own tile, and a CPU tensor runs :func:`fused_decoder_plain`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from multimodal_mtrssm_tpu_torch.nn.conv import (
    Decoder,
    DecoderConfig,
    Encoder,
    EncoderConfig,
    coord_linspace,
)

# The kernels' layer table holds at most 14 layers: for the encoder 3
# strided convs, the projection, two convs a residual block and the head;
# for the decoder 2 linears, the projection, two convs a block and 3
# transposed convs.
MAX_RESIDUAL_BLOCKS = 4
# Frames per block of the decoder's kernels and of the encoder's forward and
# backward cotangent pass (kFwdFrames of csrc/fused_encoder.cuh and kFrames
# of csrc/fused_decoder.cuh, which the plans require).
FRAMES_PER_BLOCK = 2
# Chunks of frames of the encoder's and the decoder's weight-gradient
# passes: about this many, of at least 8 and at most 256 frames each (a
# chunk's sums over frames take at most 256 terms).
DW_CHUNKS = 16
# Kernel launches since the last reset, forward and backward (plain ints),
# of the encoder and of the decoder kernels.
launches = 0
bwd_launches = 0
dec_launches = 0
dec_bwd_launches = 0
# The bf16 encoder kernels' launches, forward and backward, and the bf16
# decoder kernels'.
bf16_launches = 0
bf16_bwd_launches = 0
dec_bf16_launches = 0
dec_bf16_bwd_launches = 0


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


def coords(cfg: EncoderConfig, device: torch.device | str,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The CoordConv maps' 1-D values in ``dtype``, ``[H + W]``: the row
    coordinates, then the column coordinates (``Encoder.forward``'s)."""
    h, w = cfg.in_hw
    return torch.cat([coord_linspace(h, dtype, device), coord_linspace(w, dtype, device)])


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even) and held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two bf16 terms the bf16 backward kernels feed the tensor cores
    for a float32 cotangent ``d``: ``hi = bf16(d)`` and ``lo = bf16(d - hi)``,
    held in float32. ``hi + lo`` keeps ~2^-17 of ``d``'s relative precision
    (2^-9 for ``hi`` alone), and a product of either with a bf16 value is
    exact in float32. The plain versions do not use it: it states the
    kernels' arithmetic for the tests."""
    hi = _round_bf16(d)
    return hi, _round_bf16(d - hi)


class _RoundedElu(torch.autograd.Function):
    """ELU in float32, its output rounded to bf16; the backward takes the
    derivative from the rounded output, ``o > 0 ? 1 : o + 1`` (JAX
    ``fused_conv.py::_act_deriv``), and passes the rounding straight
    through."""

    @staticmethod
    def forward(ctx, pre: torch.Tensor) -> torch.Tensor:
        out = _round_bf16(_elu(pre))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (out,) = ctx.saved_tensors
        return g * torch.where(out > 0, torch.ones_like(out), out + 1.0)


class _Rounded(torch.autograd.Function):
    """``x`` rounded to bf16, the rounding passed straight through by the
    backward (the head's output)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _round_bf16(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


def _encoder_walk(weights: Sequence[torch.Tensor], cfg: EncoderConfig, x: torch.Tensor,
                  c: torch.Tensor, act, head_round) -> torch.Tensor:
    """The encoder's layers in the kernels' order on NCHW ``x`` and the
    CoordConv values ``c``, each hidden layer through ``act``, the head
    through ``head_round``."""
    n, _, h, w = x.shape
    if cfg.coord_conv:
        x = torch.cat([x, c[:h].view(1, 1, h, 1).expand(n, 1, h, w),
                       c[h:].view(1, 1, 1, w).expand(n, 1, h, w)], 1)
    it = iter(weights)
    for s, p in zip(cfg.strides, cfg.paddings):
        x = act(F.conv2d(x, next(it), next(it), stride=s, padding=p))
    if cfg.num_residual_blocks > 0 and cfg.channels[-1] != cfg.residual_output_size:
        x = act(F.conv2d(x, next(it), next(it)))
    for _ in range(cfg.num_residual_blocks):
        t = act(F.conv2d(x, next(it), next(it), padding=1))
        x = act(x + F.conv2d(t, next(it), next(it), padding=1))
    return head_round(F.linear(x.flatten(1), next(it), next(it)))


def fused_encoder_plain(weights: Sequence[torch.Tensor], cfg: EncoderConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernels: NHWC frames ``[N, H, W,
    C]`` → ``[N, out]`` on :func:`encoder_weights`' tensors, in ``x``'s
    dtype. On bf16 frames (and bf16 weights) it computes as the bf16
    kernels do: float32 sums of the bf16 values, each layer's output
    rounded to bf16."""
    if x.dtype == torch.bfloat16:
        out = _encoder_walk([t.float() for t in weights], cfg, x.permute(0, 3, 1, 2).float(),
                            coords(cfg, x.device, torch.bfloat16).float(), _RoundedElu.apply,
                            _Rounded.apply)
        return out.to(torch.bfloat16)
    return _encoder_walk(weights, cfg, x.permute(0, 3, 1, 2), coords(cfg, x.device).to(x.dtype),
                         _elu, lambda y: y)


def fused_encoder_backward_plain(weights: Sequence[torch.Tensor], cfg: EncoderConfig,
                                 x: torch.Tensor, g: torch.Tensor,
                                 want_dx: bool) -> tuple[torch.Tensor | None, tuple[torch.Tensor, ...]]:
    """Plain PyTorch version of the backward kernels: an autograd replay of
    :func:`fused_encoder_plain` under the cotangent ``g``. Returns ``(dx or
    None, weight grads)``, in ``x``'s dtype (bf16: float32 cotangents and
    sums, rounded to bf16 at the end)."""
    with torch.enable_grad():
        w = [t.detach().requires_grad_() for t in weights]
        xs = x.detach().requires_grad_(want_dx)
        out = fused_encoder_plain(w, cfg, xs)
        # A bf16 leaf's gradient is its float32 sum rounded once (the cast's VJP).
        grads = torch.autograd.grad(out, [*w, xs] if want_dx else w, g)
    return (grads[-1] if want_dx else None), tuple(grads[:len(w)])


def _dw_chunk(n: int) -> int:
    """Frames a chunk of a stack's weight-gradient pass over ``n`` frames."""
    return min(256, max(8, -(-n // DW_CHUNKS)))


def _dims(cfg: EncoderConfig, n: int):
    from multimodal_mtrssm_tpu_torch.ops.kernels.build import EncDims

    h, w = cfg.in_hw
    return EncDims(N=n, H=h, W=w, C0=cfg.in_channels, coord=int(cfg.coord_conv),
                   ch0=cfg.channels[0], ch1=cfg.channels[1], ch2=cfg.channels[2],
                   res_out=cfg.residual_output_size, res_mid=cfg.residual_intermediate_size,
                   n_res=cfg.num_residual_blocks, out_dim=cfg.out_dim, frames=FRAMES_PER_BLOCK,
                   chunk=_dw_chunk(n))


def _check_tensors(weights: Sequence[torch.Tensor], shapes: list[tuple[int, ...]], stack: str,
                   inputs: dict[str, tuple[torch.Tensor, tuple[int, ...]]],
                   dtype: torch.dtype = torch.float32) -> None:
    """The count of a stack's tensors, then the device, dtype (``dtype``),
    shape and contiguity of them and of the launch's ``inputs``, on the
    device of the first input."""
    from multimodal_mtrssm_tpu_torch.ops.kernels.recurrence import _check_inputs

    if len(weights) != len(shapes):
        raise ValueError(f"expected {len(shapes)} {stack} tensors, got {len(weights)}")
    expect = dict(inputs)
    for i, (t, shape) in enumerate(zip(weights, shapes)):
        expect[f"weights[{i}]"] = (t, shape)
    _check_inputs(expect, next(iter(inputs.values()))[0].device, dtype)


def _check(weights: Sequence[torch.Tensor], cfg: EncoderConfig, x: torch.Tensor,
           extra: dict[str, tuple[torch.Tensor, tuple[int, ...]]] | None = None,
           dtype: torch.dtype = torch.float32) -> None:
    """Device, dtype (``dtype``), shape and contiguity checks of an encoder
    kernel launch."""
    if not fused_encoder_applicable(cfg):
        raise ValueError(f"the fused encoder kernels do not take this encoder: {cfg}")
    if x.ndim != 4 or tuple(x.shape[1:]) != (*cfg.in_hw, cfg.in_channels):
        raise ValueError(f"the fused encoder takes [N, {cfg.in_hw[0]}, {cfg.in_hw[1]}, "
                         f"{cfg.in_channels}] frames, got {tuple(x.shape)}")
    _check_tensors(weights, weight_shapes(cfg), "encoder",
                   {"x": (x, tuple(x.shape)), **(extra or {})}, dtype)


def _sizes(query, dims, stack: str) -> tuple[int, ...]:
    """``(stash, dstash, grads, chunks, packed, fwd_packed)`` from a stack's
    sizes entry point ``query``: floats a frame of the backward's activation
    and cotangent records, weight-gradient floats, frame chunks of its
    weight-gradient pass, and the floats of the backward's packed weights
    and of the forward's. Raises where a block's shared memory would not
    fit."""
    out = (ctypes.c_longlong * 6)()
    if query(dims, ctypes.cast(out, ctypes.c_void_p)) != 0:
        hint = ("; conv_layout='nhwc' runs the encoders on cuDNN" if stack == "encoder" else
                "; the Decoder module runs it on cuDNN")
        raise ValueError(f"the fused {stack} kernels' shared memory does not fit one block "
                         f"at {dims.frames} frames a block for these widths{hint}")
    return tuple(int(v) for v in out)


def _backward_buffers(sizes: tuple[int, ...], weights: Sequence[torch.Tensor],
                      x: torch.Tensor, stack: str):
    """A stack backward's gradient output and scratch for :func:`_sizes`'
    ``sizes`` and ``x.shape[0]`` frames: the gradient floats of every tensor
    back to back (torch layout), their views in the tensors' shapes, the
    scratch tensor (held until the launch is queued) and its pointers to
    the activation record, the cotangent record and the partial gradients."""
    stash, dstash, n_grad, chunks = sizes[:4]
    if n_grad != sum(t.numel() for t in weights):
        raise RuntimeError(f"the kernel's gradient layout ({n_grad} floats) does not match "
                           f"the {stack}'s tensors")
    N = x.shape[0]
    d_flat = x.new_empty(n_grad)
    grads = tuple(v.view(t.shape) for v, t in
                  zip(d_flat.split([t.numel() for t in weights]), weights))
    scratch = x.new_empty(N * (stash + dstash) + chunks * n_grad)
    base = scratch.data_ptr()
    return d_flat, grads, scratch, (base, base + 4 * N * stash, base + 4 * N * (stash + dstash))


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
        packed = x.new_empty(_sizes(lib.fused_encoder_sizes, dims, "encoder")[5])
        c = coords(cfg, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_encoder_forward(ctypes.cast(ptrs, ctypes.c_void_p), len(weights),
                                        x.data_ptr(), c.data_ptr(), packed.data_ptr(),
                                        out.data_ptr(), dims, stream)
    build.check(err)
    launches += 1
    return out


def fused_encoder_backward_cuda(weights: Sequence[torch.Tensor], cfg: EncoderConfig,
                                x: torch.Tensor, g: torch.Tensor, want_dx: bool,
                                ) -> tuple[torch.Tensor | None, tuple[torch.Tensor, ...]]:
    """Launch the backward kernels (``csrc/fused_encoder_bwd.cu``): the
    recomputing forward, the packing of the transposed weight slices, the
    cotangent pass, the weight-gradient pass and its fixed-order reduction.
    Same contract as :func:`fused_encoder_backward_plain`. Its device-memory
    scratch at the reference widths: 13,824 + 10,816 floats a frame of
    activation and cotangent records (~99 KB a frame: ~24 MB at N=240,
    ~378 MB at N=3840), ≤ 16 frame chunks × 295,312 partial gradient floats
    up to N=4096 (≤ 19 MB; more chunks of 256 frames beyond), and the
    packed weights of both directions (~2.4 MB)."""
    global bwd_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    N = x.shape[0]
    _check(weights, cfg, x, {"g": (g, (N, cfg.out_dim))})
    dx = torch.zeros_like(x) if want_dx else None
    if N == 0:
        return dx, tuple(torch.zeros_like(t) for t in weights)
    lib = build.load_library()
    dims = _dims(cfg, N)
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    with torch.cuda.device(x.device):
        sizes = _sizes(lib.fused_encoder_sizes, dims, "encoder")
        d_flat, grads, scratch, records = _backward_buffers(sizes, weights, x, "encoder")
        packed = x.new_empty(sizes[4])
        c = coords(cfg, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_encoder_backward(
            ctypes.cast(ptrs, ctypes.c_void_p), len(weights), x.data_ptr(), c.data_ptr(),
            g.data_ptr(), None if dx is None else dx.data_ptr(), d_flat.data_ptr(), *records,
            packed.data_ptr(), dims, stream)
    build.check(err)
    bwd_launches += 1
    return dx, grads


def bf16_sizes(lib, dims) -> dict[str, int]:
    """The bf16 kernels' sizes, the encoder's (``fused_encoder_bf16_sizes``,
    ``EncDims``) or the decoder's (``fused_decoder_bf16_sizes``,
    ``DecDims``): ``stash`` (bf16 elements a frame of the activation
    record), ``dpre`` (floats a frame of the pre-activation cotangent
    record, two bf16 terms each), ``grads``, ``slots`` (the weight-gradient
    pass's partial sums, ``grads`` floats each: its frame chunks, and for
    the encoder room for the first layers' parts of a chunk), ``packed``
    (bf16 elements, both directions), the frames a block of the forward
    (``fwd_frames``) and of the cotangent pass (``bwd_frames``), and the
    tiles of the weight-gradient pass (``dw_tiles``). Raises where the plan
    does not fit a block."""
    from multimodal_mtrssm_tpu_torch.ops.kernels.build import DecDims

    dec = isinstance(dims, DecDims)
    query = lib.fused_decoder_bf16_sizes if dec else lib.fused_encoder_bf16_sizes
    out = (ctypes.c_longlong * 8)()
    if query(dims, ctypes.cast(out, ctypes.c_void_p)) != 0:
        hint = ("the Decoder module runs it on cuDNN" if dec else
                "conv_layout='nhwc' runs the encoders on cuDNN")
        raise ValueError(f"the bf16 fused {'decoder' if dec else 'encoder'} kernels' shared "
                         f"memory does not fit one frame for these widths; {hint}")
    return dict(zip(("stash", "dpre", "grads", "slots", "packed", "fwd_frames", "bwd_frames",
                     "dw_tiles"), (int(v) for v in out)))


def fused_encoder_bf16_forward_cuda(weights: Sequence[torch.Tensor], cfg: EncoderConfig,
                                    x: torch.Tensor) -> torch.Tensor:
    """Launch the bf16 forward kernel (``csrc/fused_encoder_bf16_fwd.cu``):
    bf16 ``[N, 32, 32, 1]`` frames and bf16 weights → bf16 ``[N, out]``, as
    :func:`fused_encoder_plain` computes it on bf16 input. Raises on any
    input it does not take."""
    global bf16_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    _check(weights, cfg, x, dtype=torch.bfloat16)
    out = x.new_empty((x.shape[0], cfg.out_dim))
    if x.shape[0] == 0:
        return out
    lib = build.load_library()
    dims = _dims(cfg, x.shape[0])
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    with torch.cuda.device(x.device):
        packed = x.new_empty(bf16_sizes(lib, dims)["packed"])
        c = coords(cfg, x.device, torch.bfloat16).float()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_encoder_bf16_forward(ctypes.cast(ptrs, ctypes.c_void_p), len(weights),
                                             x.data_ptr(), c.data_ptr(), packed.data_ptr(),
                                             out.data_ptr(), dims, stream)
    build.check(err)
    bf16_launches += 1
    return out


def fused_encoder_bf16_backward_cuda(weights: Sequence[torch.Tensor], cfg: EncoderConfig,
                                     x: torch.Tensor, g: torch.Tensor, want_dx: bool,
                                     ) -> tuple[torch.Tensor | None, tuple[torch.Tensor, ...]]:
    """Launch the bf16 backward kernels (``csrc/fused_encoder_bf16_bwd.cu``:
    the packing and the recomputing forward, the cotangent pass, the
    weight-gradient pass and its fixed-order reduction); same contract as
    :func:`fused_encoder_backward_plain` on bf16 input: bf16 ``dx`` (when
    asked) and bf16 weight gradients. Its device-memory scratch at the
    reference widths: 17,424 bf16 activations (channels padded to 16, the
    input with a zero halo) and 12,864 floats of split cotangents a frame
    (~86 KB: ~21 MB at N=240, ~331 MB at N=3840), and 17 slots × 295,312
    partial gradient floats (~20 MB: 16 frame chunks, and the first two
    layers' parts of each chunk)."""
    global bf16_bwd_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    N = x.shape[0]
    _check(weights, cfg, x, {"g": (g, (N, cfg.out_dim))}, torch.bfloat16)
    dx = torch.zeros_like(x) if want_dx else None
    if N == 0:
        return dx, tuple(torch.zeros_like(t) for t in weights)
    lib = build.load_library()
    dims = _dims(cfg, N)
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    with torch.cuda.device(x.device):
        sz = bf16_sizes(lib, dims)
        if sz["grads"] != sum(t.numel() for t in weights):
            raise RuntimeError(f"the kernel's gradient layout ({sz['grads']} elements) does not "
                               "match the encoder's tensors")
        d_flat = x.new_empty(sz["grads"])
        grads = tuple(v.view(t.shape) for v, t in
                      zip(d_flat.split([t.numel() for t in weights]), weights))
        stash = x.new_empty(N * sz["stash"])
        dpre = torch.empty(N * sz["dpre"], dtype=torch.float32, device=x.device)
        partial = torch.empty(sz["slots"] * sz["grads"], dtype=torch.float32, device=x.device)
        packed = x.new_empty(sz["packed"])
        c = coords(cfg, x.device, torch.bfloat16).float()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_encoder_bf16_backward(
            ctypes.cast(ptrs, ctypes.c_void_p), len(weights), x.data_ptr(), c.data_ptr(),
            g.data_ptr(), None if dx is None else dx.data_ptr(), d_flat.data_ptr(),
            stash.data_ptr(), dpre.data_ptr(), partial.data_ptr(), packed.data_ptr(), dims,
            stream)
    build.check(err)
    bf16_bwd_launches += 1
    return dx, grads


class FusedStackFunction(torch.autograd.Function):
    """A fused conv stack under autograd: its forward, and its backward as
    the VJP (``fused_conv.py:530-558``). ``ops`` is the stack's (forward,
    backward) pair, the kernels' wrappers on CUDA tensors or their plain
    versions on CPU tensors, called as ``forward(weights, cfg, x)`` and
    ``backward(weights, cfg, x, g, want_dx)``. The input and every tensor of
    the stack are separate inputs, so that gradients reach the input and the
    ``nn.Parameter``s."""

    @staticmethod
    def forward(ctx, ops, cfg, x: torch.Tensor, *weights: torch.Tensor) -> torch.Tensor:
        ctx.ops, ctx.cfg = ops, cfg
        ctx.save_for_backward(x, *weights)
        return ops[0](weights, cfg, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        x, *weights = ctx.saved_tensors
        dx, d_w = ctx.ops[1](weights, ctx.cfg, x, g.contiguous(), ctx.needs_input_grad[2])
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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_enc: the fused encoder kernels take float32 or bfloat16 frames, "
                         f"got {x.dtype}")
    if x.device.type == "cpu":
        ops = (fused_encoder_plain, fused_encoder_backward_plain)
    elif x.dtype == torch.bfloat16:
        ops = (fused_encoder_bf16_forward_cuda, fused_encoder_bf16_backward_cuda)
    else:
        ops = (fused_encoder_forward_cuda, fused_encoder_backward_cuda)
    lead = x.shape[:-3]
    flat = x.reshape(-1, *x.shape[-3:]).contiguous()
    # bf16 frames take the float32 master weights cast inside the stack, so
    # their gradients reach the parameters in float32.
    weights = (w.to(x.dtype) for w in encoder_weights(encoder))
    out = FusedStackFunction.apply(ops, cfg, flat, *weights)
    return out.reshape(*lead, out.shape[-1])



# ---- the decoder entry ----------------------------------------------------------------------


def fused_decoder_applicable(cfg: DecoderConfig) -> bool:
    """The stacks the decoder kernels take: JAX's (two linears, a ``[C, 4,
    4]`` conv input, three k4 s2 p1 transposed convs without output padding,
    ELU inside and Tanh at the output, ``fused_conv.py:670``), and also what
    the kernels assume beyond it: 32×32×1 frames out (one output channel),
    a second linear as wide as ``conv_in_shape`` holds, and at most
    :data:`MAX_RESIDUAL_BLOCKS` residual blocks. A ``res_proj``
    (``residual_input_size != conv_in_shape[0]``) is taken."""
    return (
        len(cfg.linear_sizes) == 2
        and tuple(cfg.conv_in_shape[1:]) == (4, 4)
        and len(cfg.channels) == 3
        and tuple(cfg.kernel_sizes) == (4, 4, 4)
        and tuple(cfg.strides) == (2, 2, 2)
        and tuple(cfg.paddings) == (1, 1, 1)
        and tuple(cfg.output_paddings) == (0, 0, 0)
        and cfg.activation_name == "ELU"
        and cfg.out_activation_name == "Tanh"
        and cfg.channels[-1] == 1
        and cfg.linear_sizes[-1] == math.prod(cfg.conv_in_shape)
        and cfg.num_residual_blocks <= MAX_RESIDUAL_BLOCKS
    )


def _has_res_proj(cfg: DecoderConfig) -> bool:
    return cfg.num_residual_blocks > 0 and cfg.conv_in_shape[0] != cfg.residual_input_size


def decoder_weights(decoder: Decoder) -> tuple[torch.Tensor, ...]:
    """The decoder's tensors in the kernels' layer order, weight then bias
    of each: ``linears.0``, ``linears.1``, ``res_proj`` (if any), each
    residual block's two convs, the transposed convs (``ConvTranspose2d``
    weights ``[Ci, Co, 4, 4]``)."""
    layers = [*decoder.linears]
    if decoder.res_proj is not None:
        layers.append(decoder.res_proj)
    for block in decoder.res_blocks or ():
        layers += [block.conv1, block.conv2]
    return tuple(t for m in (*layers, *decoder.deconvs) for t in (m.weight, m.bias))


def decoder_weight_shapes(cfg: DecoderConfig) -> list[tuple[int, ...]]:
    """Torch-layout shapes of :func:`decoder_weights`' tensors."""
    (l0, l1), c = cfg.linear_sizes, cfg.conv_in_shape[0]
    shapes: list[tuple[int, ...]] = [(l0, cfg.in_features), (l0,), (l1, l0), (l1,)]
    if _has_res_proj(cfg):
        shapes += [(cfg.residual_input_size, c, 1, 1), (cfg.residual_input_size,)]
        c = cfg.residual_input_size
    mid = cfg.residual_intermediate_size
    for _ in range(cfg.num_residual_blocks):
        shapes += [(mid, c, 3, 3), (mid,), (c, mid, 3, 3), (c,)]
    for ch, k in zip(cfg.channels, cfg.kernel_sizes):
        shapes += [(c, ch, k, k), (ch,)]
        c = ch
    return shapes


class _RoundedTanh(torch.autograd.Function):
    """Tanh in float32, its output rounded to bf16; the backward takes the
    derivative from the rounded output, ``1 - o²`` (JAX ``_act_deriv``), and
    passes the rounding straight through (the decoder's last layer)."""

    @staticmethod
    def forward(ctx, pre: torch.Tensor) -> torch.Tensor:
        out = _round_bf16(torch.tanh(pre))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (out,) = ctx.saved_tensors
        return g * (1.0 - out * out)


def _decoder_walk(weights: Sequence[torch.Tensor], cfg: DecoderConfig, feats: torch.Tensor,
                  act, out_act) -> torch.Tensor:
    """The decoder's layers in the kernels' order on ``[N, F]`` features,
    each hidden layer through ``act``, the last through ``out_act``; NCHW
    out."""
    it = iter(weights)
    x = act(F.linear(feats, next(it), next(it)))
    x = act(F.linear(x, next(it), next(it))).reshape(-1, *cfg.conv_in_shape)
    if _has_res_proj(cfg):
        x = act(F.conv2d(x, next(it), next(it)))
    for _ in range(cfg.num_residual_blocks):
        t = act(F.conv2d(x, next(it), next(it), padding=1))
        x = act(x + F.conv2d(t, next(it), next(it), padding=1))
    last = len(cfg.channels) - 1
    for i, (s, p, op) in enumerate(zip(cfg.strides, cfg.paddings, cfg.output_paddings)):
        x = F.conv_transpose2d(x, next(it), next(it), stride=s, padding=p, output_padding=op)
        x = out_act(x) if i == last else act(x)
    return x


def fused_decoder_plain(weights: Sequence[torch.Tensor], cfg: DecoderConfig,
                        feats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the decoder's forward kernels: features
    ``[N, F]`` → NHWC frames ``[N, 32, 32, 1]`` on :func:`decoder_weights`'
    tensors, ELU as ``exp(x) - 1``, in ``feats``' dtype. On bf16 features
    (and bf16 weights) it computes as the bf16 kernels do, JAX's
    ``_layer_fwd`` at bf16: float32 sums of the bf16 values, the bias and
    the activation in float32, each layer's output rounded to bf16."""
    if feats.dtype == torch.bfloat16:
        out = _decoder_walk([t.float() for t in weights], cfg, feats.float(), _RoundedElu.apply,
                            _RoundedTanh.apply)
        return out.permute(0, 2, 3, 1).to(torch.bfloat16)
    return _decoder_walk(weights, cfg, feats, _elu, torch.tanh).permute(0, 2, 3, 1)


def fused_decoder_backward_plain(weights: Sequence[torch.Tensor], cfg: DecoderConfig,
                                 feats: torch.Tensor, g: torch.Tensor, want_dx: bool,
                                 ) -> tuple[torch.Tensor | None, tuple[torch.Tensor, ...]]:
    """Plain PyTorch version of the decoder's backward kernels: an autograd
    replay of :func:`fused_decoder_plain` under the cotangent ``g`` of the
    frames. Returns ``(d_feats or None, weight grads)``, in ``feats``' dtype
    (bf16: the activation derivatives from the rounded outputs, float32
    cotangents and sums through the whole stack, each gradient rounded to
    bf16 once at the end)."""
    with torch.enable_grad():
        w = [t.detach().requires_grad_() for t in weights]
        xs = feats.detach().requires_grad_(want_dx)
        out = fused_decoder_plain(w, cfg, xs)
        grads = torch.autograd.grad(out, [*w, xs] if want_dx else w, g)
    return (grads[-1] if want_dx else None), tuple(grads[:len(w)])


def _dec_dims(cfg: DecoderConfig, n: int):
    from multimodal_mtrssm_tpu_torch.ops.kernels.build import DecDims

    c0, h0, w0 = cfg.conv_in_shape
    return DecDims(N=n, F=cfg.in_features, lin0=cfg.linear_sizes[0], c0=c0, h0=h0, w0=w0,
                   res_in=cfg.residual_input_size, res_mid=cfg.residual_intermediate_size,
                   n_res=cfg.num_residual_blocks, ch0=cfg.channels[0], ch1=cfg.channels[1],
                   ch2=cfg.channels[2], frames=FRAMES_PER_BLOCK, chunk=_dw_chunk(n))


def _dec_frames_shape(cfg: DecoderConfig) -> tuple[int, int, int]:
    """``(H, W, C)`` of the decoder's output frames."""
    h = cfg.conv_in_shape[1]
    for k, s, p in zip(cfg.kernel_sizes, cfg.strides, cfg.paddings):
        h = (h - 1) * s - 2 * p + k
    return h, h, cfg.channels[-1]


def _check_dec(weights: Sequence[torch.Tensor], cfg: DecoderConfig, feats: torch.Tensor,
               extra: dict[str, tuple[torch.Tensor, tuple[int, ...]]] | None = None,
               dtype: torch.dtype = torch.float32) -> None:
    """Device, dtype (``dtype``), shape and contiguity checks of a decoder
    kernel launch."""
    if not fused_decoder_applicable(cfg):
        raise ValueError(f"the fused decoder kernels do not take this decoder: {cfg}")
    if feats.ndim != 2 or feats.shape[1] != cfg.in_features:
        raise ValueError(f"the fused decoder takes [N, {cfg.in_features}] features, "
                         f"got {tuple(feats.shape)}")
    _check_tensors(weights, decoder_weight_shapes(cfg), "decoder",
                   {"feats": (feats, tuple(feats.shape)), **(extra or {})}, dtype)


def fused_decoder_forward_cuda(weights: Sequence[torch.Tensor], cfg: DecoderConfig,
                               feats: torch.Tensor) -> torch.Tensor:
    """Launch the decoder's forward kernel (``csrc/fused_decoder_fwd.cu``):
    ``[N, F]`` features → ``[N, 32, 32, 1]`` frames. Raises on any input it
    does not take."""
    global dec_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    _check_dec(weights, cfg, feats)
    out = feats.new_empty((feats.shape[0], *_dec_frames_shape(cfg)))
    if feats.shape[0] == 0:
        return out
    lib = build.load_library()
    dims = _dec_dims(cfg, feats.shape[0])
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    with torch.cuda.device(feats.device):
        packed = feats.new_empty(_sizes(lib.fused_decoder_sizes, dims, "decoder")[5])
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.fused_decoder_forward(ctypes.cast(ptrs, ctypes.c_void_p), len(weights),
                                        feats.data_ptr(), packed.data_ptr(), out.data_ptr(), dims,
                                        stream)
    build.check(err)
    dec_launches += 1
    return out


def fused_decoder_backward_cuda(weights: Sequence[torch.Tensor], cfg: DecoderConfig,
                                feats: torch.Tensor, g: torch.Tensor, want_dx: bool,
                                ) -> tuple[torch.Tensor | None, tuple[torch.Tensor, ...]]:
    """Launch the decoder's backward kernels (``csrc/fused_decoder_bwd.cu``):
    the recomputing forward (its packing launch included), the packing of
    the transposed weight slices, the cotangent pass, the weight-gradient
    pass and its fixed-order reduction. Same
    contract as :func:`fused_decoder_backward_plain`. Its device-memory
    scratch at the reference widths (48-wide features): 17,520 + 17,472
    floats a frame of activation and cotangent records (~140 KB a frame:
    ~34 MB at N=240, ~537 MB at N=3840), ≤ 16 frame chunks × 553,905
    partial gradient floats up to N=4096 (≤ 35 MB; more chunks of 256
    frames beyond), and the packed weights of both directions (~4.5 MB)."""
    global dec_bwd_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    N = feats.shape[0]
    _check_dec(weights, cfg, feats, {"g": (g, (N, *_dec_frames_shape(cfg)))})
    dx = torch.zeros_like(feats) if want_dx else None
    if N == 0:
        return dx, tuple(torch.zeros_like(t) for t in weights)
    lib = build.load_library()
    dims = _dec_dims(cfg, N)
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    with torch.cuda.device(feats.device):
        sizes = _sizes(lib.fused_decoder_sizes, dims, "decoder")
        d_flat, grads, scratch, records = _backward_buffers(sizes, weights, feats, "decoder")
        packed = feats.new_empty(sizes[4])
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.fused_decoder_backward(
            ctypes.cast(ptrs, ctypes.c_void_p), len(weights), feats.data_ptr(), g.data_ptr(),
            None if dx is None else dx.data_ptr(), d_flat.data_ptr(), *records, packed.data_ptr(),
            dims, stream)
    build.check(err)
    dec_bwd_launches += 1
    return dx, grads


def fused_decoder_bf16_forward_cuda(weights: Sequence[torch.Tensor], cfg: DecoderConfig,
                                    feats: torch.Tensor) -> torch.Tensor:
    """Launch the bf16 decoder's forward kernels (``csrc/fused_decoder_bf16_fwd.cu``):
    bf16 ``[N, F]`` features and bf16 weights → bf16 ``[N, 32, 32, 1]``
    frames, as :func:`fused_decoder_plain` computes them on bf16 input.
    Raises on any input it does not take."""
    global dec_bf16_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    _check_dec(weights, cfg, feats, dtype=torch.bfloat16)
    out = feats.new_empty((feats.shape[0], *_dec_frames_shape(cfg)))
    if feats.shape[0] == 0:
        return out
    lib = build.load_library()
    dims = _dec_dims(cfg, feats.shape[0])
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    with torch.cuda.device(feats.device):
        packed = feats.new_empty(bf16_sizes(lib, dims)["packed"])
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.fused_decoder_bf16_forward(ctypes.cast(ptrs, ctypes.c_void_p), len(weights),
                                             feats.data_ptr(), packed.data_ptr(), out.data_ptr(),
                                             dims, stream)
    build.check(err)
    dec_bf16_launches += 1
    return out


def fused_decoder_bf16_backward_cuda(weights: Sequence[torch.Tensor], cfg: DecoderConfig,
                                     feats: torch.Tensor, g: torch.Tensor, want_dx: bool,
                                     ) -> tuple[torch.Tensor | None, tuple[torch.Tensor, ...]]:
    """Launch the bf16 decoder's backward kernels (``csrc/fused_decoder_bf16_bwd.cu``:
    the packing and the recomputing forward, the cotangent pass, the
    weight-gradient pass and its fixed-order reduction); same contract as
    :func:`fused_decoder_backward_plain` on bf16 input: the bf16 features'
    cotangent (when asked) and bf16 weight gradients. Its device-memory
    scratch at the reference widths (48-wide features): 17,520 bf16
    activations and 24,640 floats of split cotangents a frame (~134 KB: ~32
    MB at N=240, ~513 MB at N=3840), ≤ 16 frame chunks × 553,905 partial
    gradient floats up to N=4096 (≤ 35 MB), and 1,260,800 bf16 of packed
    weights (~2.5 MB)."""
    global dec_bf16_bwd_launches
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    N = feats.shape[0]
    _check_dec(weights, cfg, feats, {"g": (g, (N, *_dec_frames_shape(cfg)))}, torch.bfloat16)
    dx = torch.zeros_like(feats) if want_dx else None
    if N == 0:
        return dx, tuple(torch.zeros_like(t) for t in weights)
    lib = build.load_library()
    dims = _dec_dims(cfg, N)
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    with torch.cuda.device(feats.device):
        sz = bf16_sizes(lib, dims)
        if sz["grads"] != sum(t.numel() for t in weights):
            raise RuntimeError(f"the kernel's gradient layout ({sz['grads']} elements) does not "
                               "match the decoder's tensors")
        d_flat = feats.new_empty(sz["grads"])
        grads = tuple(v.view(t.shape) for v, t in
                      zip(d_flat.split([t.numel() for t in weights]), weights))
        stash = feats.new_empty(N * sz["stash"])
        dpre = torch.empty(N * sz["dpre"], dtype=torch.float32, device=feats.device)
        partial = torch.empty(sz["slots"] * sz["grads"], dtype=torch.float32,
                              device=feats.device)
        packed = feats.new_empty(sz["packed"])
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.fused_decoder_bf16_backward(
            ctypes.cast(ptrs, ctypes.c_void_p), len(weights), feats.data_ptr(), g.data_ptr(),
            None if dx is None else dx.data_ptr(), d_flat.data_ptr(), stash.data_ptr(),
            dpre.data_ptr(), partial.data_ptr(), packed.data_ptr(), dims, stream)
    build.check(err)
    dec_bf16_bwd_launches += 1
    return dx, grads


def fused_decoder_apply(decoder: Decoder, feats: torch.Tensor) -> torch.Tensor:
    """The decoder on features ``[..., F]`` → NHWC frames ``[..., 32, 32,
    1]`` through the fused kernels (CUDA tensors) or their plain versions
    (CPU tensors); differentiable with respect to the decoder's parameters
    and ``feats``. Raises for a decoder or features the kernels do not take,
    and for any other device. JAX's ``fused_decoder_apply(params, cfg,
    feats)``; no model config selects it, as in JAX."""
    cfg = decoder.cfg
    if not fused_decoder_applicable(cfg):
        raise ValueError(f"the fused decoder kernels do not take this decoder: {cfg}")
    if feats.ndim < 1 or feats.shape[-1] != cfg.in_features:
        raise ValueError(f"the fused decoder takes [..., {cfg.in_features}] features, "
                         f"got {tuple(feats.shape)}")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused decoder route for device {feats.device}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the fused decoder kernels take float32 or bfloat16 features, got "
                         f"{feats.dtype}")
    if feats.device.type == "cpu":
        ops = (fused_decoder_plain, fused_decoder_backward_plain)
    elif feats.dtype == torch.bfloat16:
        ops = (fused_decoder_bf16_forward_cuda, fused_decoder_bf16_backward_cuda)
    else:
        ops = (fused_decoder_forward_cuda, fused_decoder_backward_cuda)
    lead = feats.shape[:-1]
    flat = feats.reshape(-1, cfg.in_features).contiguous()
    # bf16 features take the float32 master weights cast inside the stack.
    weights = (w.to(feats.dtype) for w in decoder_weights(decoder))
    out = FusedStackFunction.apply(ops, cfg, flat, *weights)
    return out.reshape(*lead, *out.shape[1:])

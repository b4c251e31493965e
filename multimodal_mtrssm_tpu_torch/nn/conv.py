"""CoordConv residual encoder and deconv decoder (port of ``nn/conv.py``).

NCHW inside, as cuDNN prefers; the public ``forward``s keep the JAX
package's NHWC frame layout (``[..., 32, 32, 1]``) so both packages are
called alike. These modules are the canonical cuDNN layout; the JAX
package's s2d form is a TPU lane trick and is not ported. Its fused Pallas
conv kernels, the whole encoder and the whole decoder in one kernel each,
are ported as hand-written CUDA kernels in ``ops/kernels/fused_conv.py``
(``fused_encoder_apply``, ``fused_decoder_apply``), which read these
modules' weights as they are.

Module names follow the slot paths ``train/torch_export.py`` writes
(``convs.i``, ``res_proj``, ``res_blocks.i.conv{1,2}``, ``linears.i``,
``deconvs.i``). The encoder head reads the conv output flattened in CHW
order, torch's own, which is the order the exporter permutes the head
weights into.

Precision: :func:`cast_conv_in` and :func:`cast_conv_out` are the one pair
of casts every encoder and decoder call site of both families goes through
(JAX ``nn/conv.py:45-59``). The stacks run in their input's dtype: the
parameters stay float32 masters and are cast inside each layer, so their
gradients reach them in float32. A model's ``conv_dtype`` bf16
(``trainer.precision: 16-mixed``) runs the stacks in bf16 and casts their
outputs back to the model's ``compute_dtype``; with ``conv_dtype`` None the
stacks run in the dtype they are given, the ``compute_dtype`` to which
``shared_step`` casts its inputs (float32, or bf16 for a full-bf16 model).
No ``torch.autocast``, which would cast the recurrence's linears too.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_mtrssm_tpu_torch.nn.core import Act, Linear, activation


def cast_conv_in(model_cfg: object, x: torch.Tensor) -> torch.Tensor:
    """A conv stack's input in the model's ``conv_dtype`` (unchanged when it
    is None)."""
    cd = getattr(model_cfg, "conv_dtype", None)
    return x if cd is None else x.to(cd)


def cast_conv_out(model_cfg: object, x: torch.Tensor) -> torch.Tensor:
    """A conv stack's output back in the model's ``compute_dtype`` (float32
    where the config has none; unchanged when ``conv_dtype`` is None)."""
    cd = getattr(model_cfg, "conv_dtype", None)
    return x if cd is None else x.to(getattr(model_cfg, "compute_dtype", torch.float32))


def coord_linspace(n: int, dtype: torch.dtype, device: torch.device | str) -> torch.Tensor:
    """CoordConv's ``n`` coordinates from -1 to 1 in ``dtype``. Below 32
    bits they are computed as ``jnp.linspace`` computes them in that dtype,
    ``-1 · (1 - s) + 1 · s`` on the rounded steps ``s = i / (n - 1)``."""
    if dtype.itemsize >= 4:
        return torch.linspace(-1.0, 1.0, n, dtype=dtype, device=device)
    step = (torch.arange(n, dtype=torch.float32, device=device) / max(n - 1, 1)).to(dtype)
    return -(1 - step) + step


def _conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m(x)`` in ``x``'s dtype, the float32 parameters cast to it."""
    return F.conv2d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), m.stride, m.padding,
                    m.dilation, m.groups)


def _deconv(m: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """``m(x)`` in ``x``'s dtype, the float32 parameters cast to it."""
    return F.conv_transpose2d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), m.stride, m.padding,
                              m.output_padding, m.groups, m.dilation)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder hyperparameters (reference ``configs/default.yaml:31-45``)."""

    linear_sizes: tuple[int, ...] = (64,)
    activation_name: str = "ELU"
    out_activation_name: str = "Identity"
    channels: tuple[int, ...] = (8, 16, 32)
    kernel_sizes: tuple[int, ...] = (3, 3, 3)
    strides: tuple[int, ...] = (2, 2, 2)
    paddings: tuple[int, ...] = (1, 1, 1)
    num_residual_blocks: int = 3
    residual_intermediate_size: int = 64
    residual_output_size: int = 64
    coord_conv: bool = True
    in_channels: int = 1
    in_hw: tuple[int, int] = (32, 32)

    @property
    def out_dim(self) -> int:
        """Width of the embedding the encoder emits."""
        return self.linear_sizes[-1]

    def spatial_out(self) -> tuple[int, int]:
        """Spatial size of the last conv's output."""
        h, w = self.in_hw
        for k, s, p in zip(self.kernel_sizes, self.strides, self.paddings):
            h = (h + 2 * p - k) // s + 1
            w = (w + 2 * p - k) // s + 1
        return h, w


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoder hyperparameters (reference ``configs/default.yaml:61-92``).
    ``conv_in_shape`` is ``[C, H, W]``; ``in_features`` is the latent
    feature width (deter + stoch = 48 for MoPoE-MRSSM)."""

    in_features: int
    linear_sizes: tuple[int, ...] = (64, 1024)
    conv_in_shape: tuple[int, int, int] = (64, 4, 4)
    activation_name: str = "ELU"
    out_activation_name: str = "Tanh"
    channels: tuple[int, ...] = (32, 16, 1)
    kernel_sizes: tuple[int, ...] = (4, 4, 4)
    strides: tuple[int, ...] = (2, 2, 2)
    paddings: tuple[int, ...] = (1, 1, 1)
    output_paddings: tuple[int, ...] = (0, 0, 0)
    num_residual_blocks: int = 3
    residual_intermediate_size: int = 128
    residual_input_size: int = 64


class ResidualBlock(nn.Module):
    """``act(x + conv2(act(conv1(x))))`` with 3×3 convs."""

    def __init__(self, channels: int, intermediate: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, intermediate, 3, padding=1)
        self.conv2 = nn.Conv2d(intermediate, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, act: Act) -> torch.Tensor:
        """Apply the block with activation ``act``."""
        return act(x + _conv(self.conv2, act(_conv(self.conv1, x))))


def _residual_stack(c_in: int, target: int, blocks: int,
                    intermediate: int) -> tuple[nn.Conv2d | None, nn.ModuleList | None, int]:
    """The optional 1×1 projection to ``target`` channels and the blocks."""
    if blocks == 0:
        return None, None, c_in
    proj = nn.Conv2d(c_in, target, 1) if c_in != target else None
    return proj, nn.ModuleList(ResidualBlock(target, intermediate) for _ in range(blocks)), target


class Encoder(nn.Module):
    """Strided convs (+ CoordConv channels) → residual blocks → linear head."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        in_ch = cfg.in_channels + (2 if cfg.coord_conv else 0)
        convs = []
        for ch, k, s, p in zip(cfg.channels, cfg.kernel_sizes, cfg.strides, cfg.paddings):
            convs.append(nn.Conv2d(in_ch, ch, k, stride=s, padding=p))
            in_ch = ch
        self.convs = nn.ModuleList(convs)
        self.res_proj, self.res_blocks, in_ch = _residual_stack(
            in_ch, cfg.residual_output_size, cfg.num_residual_blocks, cfg.residual_intermediate_size)
        h, w = cfg.spatial_out()
        dims = [h * w * in_ch, *cfg.linear_sizes]
        self.linears = nn.ModuleList(Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Encode NHWC frames ``[..., H, W, C]`` → ``[..., out_dim]``."""
        cfg = self.cfg
        act = activation(cfg.activation_name)
        lead = x.shape[:-3]
        h, w, c = x.shape[-3:]
        x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        if cfg.coord_conv:
            n = x.shape[0]
            ys = coord_linspace(h, x.dtype, x.device)
            xs = coord_linspace(w, x.dtype, x.device)
            yy = ys.view(1, 1, h, 1).expand(n, 1, h, w)
            xx = xs.view(1, 1, 1, w).expand(n, 1, h, w)
            x = torch.cat([x, yy, xx], dim=1)  # (input, yy, xx), as the JAX encoder
        for conv in self.convs:
            x = act(_conv(conv, x))
        if self.res_proj is not None:
            x = act(_conv(self.res_proj, x))
        for block in self.res_blocks or ():
            x = block(x, act)
        x = x.flatten(1)
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < len(self.linears) - 1:
                x = act(x)
        x = activation(cfg.out_activation_name)(x)
        return x.reshape(*lead, x.shape[-1])


class Decoder(nn.Module):
    """Linears → reshape to ``conv_in_shape`` → residual blocks → deconvs."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.in_features, *cfg.linear_sizes]
        self.linears = nn.ModuleList(Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1))
        self.res_proj, self.res_blocks, c_in = _residual_stack(
            cfg.conv_in_shape[0], cfg.residual_input_size, cfg.num_residual_blocks,
            cfg.residual_intermediate_size)
        deconvs = []
        for ch, k, s, p, op in zip(cfg.channels, cfg.kernel_sizes, cfg.strides, cfg.paddings,
                                   cfg.output_paddings):
            deconvs.append(nn.ConvTranspose2d(c_in, ch, k, stride=s, padding=p, output_padding=op))
            c_in = ch
        self.deconvs = nn.ModuleList(deconvs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Decode ``[..., in_features]`` → NHWC frames ``[..., H, W, C]``."""
        cfg = self.cfg
        act = activation(cfg.activation_name)
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        for lin in self.linears:
            x = act(lin(x))
        x = x.reshape(-1, *cfg.conv_in_shape)
        if self.res_proj is not None:
            x = act(_conv(self.res_proj, x))
        for block in self.res_blocks or ():
            x = block(x, act)
        for i, deconv in enumerate(self.deconvs):
            x = _deconv(deconv, x)
            if i < len(self.deconvs) - 1:
                x = act(x)
        x = activation(cfg.out_activation_name)(x).permute(0, 2, 3, 1)
        return x.reshape(*lead, *x.shape[1:])

"""SD-style f=8 KL autoencoder with the geometry adaptors, port of
geo4d_tpu/models/autoencoder.py.

Channels-last frames, float32 GroupNorm statistics (eps 1e-6; kernel K1 on
CUDA), all frames of a call as one batch. `decode_with_conf` runs the
decoder once and feeds its pre-head features to the confidence adaptor.
Submodule names follow the original Geo4D PyTorch autoencoder.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from geo4d_ref.nn.attention import dot_product_attention
from geo4d_ref.nn.basics import Conv2d, GroupNorm32, nearest_upsample_2x, zero_


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Shipped SD-VAE shape (configs/inference_geo4d.yaml)."""

    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    in_channels: int = 3
    out_ch: int = 3
    double_z: bool = True
    adaptor_ch: int = 128
    adaptor_num_res_blocks: int = 1
    adaptor_out_ch: int = 1


class VAEResnetBlock(nn.Module):
    """norm-swish-conv x2 with a 1x1 shortcut when the width changes."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6, silu=True)
        self.conv1 = Conv2d(in_ch, out_ch, 3, dtype=dtype)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6, silu=True)
        self.conv2 = Conv2d(out_ch, out_ch, 3, dtype=dtype)
        self.nin_shortcut = Conv2d(in_ch, out_ch, 1, dtype=dtype) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over the h*w tokens (plain attention)."""

    def __init__(self, ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.q = Conv2d(ch, ch, 1, dtype=dtype)
        self.k = Conv2d(ch, ch, 1, dtype=dtype)
        self.v = Conv2d(ch, ch, 1, dtype=dtype)
        self.proj_out = Conv2d(ch, ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hgt, wid, c = x.shape
        h = self.norm(x)

        def tokens(conv):
            return conv(h).reshape(b, hgt * wid, 1, c)

        out = dot_product_attention(tokens(self.q), tokens(self.k), tokens(self.v))
        return x + self.proj_out(out.to(x.dtype).reshape(b, hgt, wid, c))


class _Level(nn.Module):
    """One resolution level: `block` list plus an optional resampling conv
    (`downsample.conv` / `upsample.conv`)."""

    def __init__(self, blocks, resample_name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample_name is not None:
            setattr(self, resample_name, resample)


class _Mid(nn.Module):
    def __init__(self, ch: int, dtype):
        super().__init__()
        self.block_1 = VAEResnetBlock(ch, ch, dtype)
        self.attn_1 = VAEAttnBlock(ch, dtype)
        self.block_2 = VAEResnetBlock(ch, ch, dtype)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class _ConvHolder(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, dtype=dtype)
        ch = cfg.ch
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(VAEResnetBlock(ch, cfg.ch * mult, dtype))
                ch = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                # stride-2 conv after the reference's asymmetric (0, 1) pad
                down = _ConvHolder(Conv2d(ch, ch, 3, stride=2, padding=0, dtype=dtype))
                self.down.append(_Level(blocks, "downsample", down))
            else:
                self.down.append(_Level(blocks))
        self.mid = _Mid(ch, dtype)
        self.norm_out = GroupNorm32(ch, eps=1e-6, silu=True)
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv2d(ch, zc, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample.conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        return self.conv_out(self.norm_out(self.mid(h)))


class VAEDecoder(nn.Module):
    """Returns (rgb, pre_head): the pre-head features feed the conf adaptor."""

    def __init__(self, cfg: VAEConfig, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, ch, 3, dtype=dtype)
        self.mid = _Mid(ch, dtype)
        up = {}
        for i in reversed(range(len(cfg.ch_mult))):
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(VAEResnetBlock(ch, cfg.ch * cfg.ch_mult[i], dtype))
                ch = cfg.ch * cfg.ch_mult[i]
            if i != 0:
                up[i] = _Level(blocks, "upsample", _ConvHolder(Conv2d(ch, ch, 3, dtype=dtype)))
            else:
                up[i] = _Level(blocks)
        self.up = nn.ModuleList(up[i] for i in range(len(cfg.ch_mult)))
        self.norm_out = GroupNorm32(ch, eps=1e-6, silu=True)
        self.conv_out = Conv2d(ch, cfg.out_ch, 3, dtype=dtype)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.mid(self.conv_in(z.to(self.dtype)))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample.conv(nearest_upsample_2x(h))
        return self.conv_out(self.norm_out(h)), h


class EncoderAdaptor(nn.Module):
    """Full-resolution residual refiner with a zero-init tail."""

    def __init__(self, cfg: VAEConfig, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        ch = cfg.adaptor_ch
        self.conv_in = Conv2d(cfg.in_channels, ch, 3, dtype=dtype)
        self.down = nn.ModuleList([_Level([VAEResnetBlock(ch, ch, dtype)
                                           for _ in range(cfg.adaptor_num_res_blocks)])])
        self.norm_out = GroupNorm32(ch, eps=1e-6, silu=True)
        self.conv_out = zero_(Conv2d(ch, cfg.in_channels, 3, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for block in self.down[0].block:
            h = block(h)
        h = self.conv_out(self.norm_out(h))
        return h + x.to(h.dtype)


class DecoderAdaptor(nn.Module):
    """Decoder pre-head features -> confidence map."""

    def __init__(self, cfg: VAEConfig, dtype=torch.bfloat16):
        super().__init__()
        ch = cfg.adaptor_ch
        self.up = nn.ModuleList([_Level([VAEResnetBlock(ch, ch, dtype)
                                         for _ in range(cfg.adaptor_num_res_blocks + 1)])])
        self.norm_out = GroupNorm32(ch, eps=1e-6, silu=True)
        self.conv_out = Conv2d(ch, cfg.adaptor_out_ch, 3, dtype=dtype)

    def forward(self, pre_head: torch.Tensor) -> torch.Tensor:
        h = pre_head
        for block in self.up[0].block:
            h = block(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """encode(x) -> (mean, logvar); decode(z) -> rgb;
    decode_with_conf(z) -> [rgb | confidence] from one decoder pass."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), with_adaptor: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.encoder = VAEEncoder(cfg, dtype)
        self.decoder = VAEDecoder(cfg, dtype)
        self.quant_conv = Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1, dtype=dtype)
        if with_adaptor:
            self.encoder_adaptor = EncoderAdaptor(cfg, dtype)
            self.decoder_adaptor = DecoderAdaptor(cfg, dtype)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(self.encoder(x)).float()
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode_with_adaptor(self, x: torch.Tensor):
        return self.encode(self.encoder_adaptor(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        rgb, _ = self.decoder(self.post_quant_conv(z.to(self.dtype)))
        return rgb.float()

    def decode_with_conf(self, z: torch.Tensor) -> torch.Tensor:
        rgb, pre_head = self.decoder(self.post_quant_conv(z.to(self.dtype)))
        conf = self.decoder_adaptor(pre_head)
        return torch.cat([rgb, conf], dim=-1).float()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample: bool = False):
        """(recon, mean, logvar) of x: with `sample`, decode a posterior sample
        mean + exp(logvar / 2) * noise, the noise drawn from `generator`;
        else decode the mean (JAX's `__call__`)."""
        mean, logvar = self.encode(x)
        z = mean
        if sample:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
            z = mean + torch.exp(0.5 * logvar) * noise
        return self.decode(z), mean, logvar

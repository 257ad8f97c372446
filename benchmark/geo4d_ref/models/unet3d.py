"""3-D denoising U-Net (spatial + temporal), port of geo4d_tpu/models/unet3d.py.

Shipped configuration: 20 input channels (16 noisy geometry latents + 4
video latents), 16 out, model width 320, mults (1, 2, 4, 4), 2 res blocks per
level, attention at ds {1, 2, 4} with 64-dim heads, spatial + temporal
transformers per level, an extra 8-head temporal attention after the stem
conv (`init_attn`), fps conditioning with a zero-init tail, and per-frame
context [text 77 | 16 image tokens of that frame]. `task_condition` adds
the pc_task modality's task embedding (an MLP on a max-period-100 sinusoid
of the integer task id, zero-init tail). With `remat` set, each block runs
under `torch.utils.checkpoint` (non-reentrant): its activations are
recomputed in the backward instead of kept, and its kernels' forward
launches run twice.

Frames are channels-last (B*T, H, W, C); temporal layers see (B, T, H, W, C).
Submodule names follow the original Geo4D PyTorch UNet (including its
`temopral_conv` spelling), so its state dicts load directly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from geo4d_ref.nn.attention import TEXT_CONTEXT_LEN, SpatialTransformer, TemporalTransformer
from geo4d_ref.nn.basics import (
    Conv2d,
    GroupNorm32,
    TemporalConv,
    nearest_upsample_2x,
    time_embed_mlp,
    timestep_embedding,
    zero_,
)

IMAGE_TOKENS_PER_FRAME = 16


class TemporalConvBlock(nn.Module):
    """Residual stack of four (norm + SiLU, (3,1,1) conv) on (B, T, H, W, C);
    the last conv is zero-init (identity at init)."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        for i in range(1, 5):
            conv = TemporalConv(channels, dtype)
            if i == 4:
                zero_(conv)
            # conv1 = (norm, silu, conv); conv2..4 = (norm, silu, dropout, conv)
            setattr(self, f"conv{i}", nn.ModuleDict(
                {"0": GroupNorm32(channels, silu=True), "2" if i == 1 else "3": conv}))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(1, 5):
            layer = getattr(self, f"conv{i}")
            h = layer["2" if i == 1 else "3"](layer["0"](h))
        return x + h


class ResBlock(nn.Module):
    """Timestep-conditioned residual block (+ temporal conv block).
    x: (B*T, H, W, C); emb: (B*T, emb_dim)."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, temporal_length: int,
                 use_temporal_conv: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.temporal_length = temporal_length
        self.in_layers = nn.ModuleDict({"0": GroupNorm32(in_ch, silu=True),
                                        "2": Conv2d(in_ch, out_ch, 3, dtype=dtype)})
        self.emb_layers = nn.ModuleDict({"1": nn.Linear(emb_dim, out_ch, dtype=dtype)})
        self.out_layers = nn.ModuleDict({"0": GroupNorm32(out_ch, silu=True),
                                         "3": zero_(Conv2d(out_ch, out_ch, 3, dtype=dtype))})
        self.skip_connection = Conv2d(in_ch, out_ch, 1, dtype=dtype) if in_ch != out_ch else None
        self.temopral_conv = TemporalConvBlock(out_ch, dtype) if use_temporal_conv else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers["2"](self.in_layers["0"](x))
        emb_out = self.emb_layers["1"](torch.nn.functional.silu(emb))
        h = h + emb_out[:, None, None, :].to(h.dtype)
        h = self.out_layers["3"](self.out_layers["0"](h))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        h = x + h
        if self.temopral_conv is not None:
            bt, hh, ww, cc = h.shape
            t = self.temporal_length
            h = self.temopral_conv(h.reshape(bt // t, t, hh, ww, cc)).reshape(bt, hh, ww, cc)
        return h


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class UNet3D(nn.Module):
    """The spatio-temporal denoising U-Net."""

    def __init__(self, in_channels: int = 20, out_channels: int = 16,
                 model_channels: int = 320, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_head_channels: int = 64,
                 transformer_depth: int = 1, context_dim: int = 1024,
                 temporal_length: int = 16, temporal_conv: bool = True,
                 temporal_attention: bool = True, use_relative_position: bool = False,
                 use_causal_attention: bool = False, addition_attention: bool = True,
                 image_cross_attention: bool = True, fs_condition: bool = True,
                 task_condition: bool = False, default_fs: int = 24, dtype=torch.bfloat16):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.model_channels = mc = model_channels
        self.context_dim = context_dim
        self.temporal_length = temporal_length
        self.fs_condition, self.default_fs = fs_condition, default_fs
        self.task_condition = task_condition
        self.dtype = dtype
        self.remat = False
        emb_dim = mc * 4
        t_len = temporal_length

        def res(cin, cout):
            return ResBlock(cin, cout, emb_dim, t_len, temporal_conv, dtype)

        def spatial(ch):
            return SpatialTransformer(ch, ch // num_head_channels, num_head_channels,
                                      transformer_depth, context_dim, image_cross_attention, dtype)

        def temporal(ch, heads=None):
            return TemporalTransformer(ch, heads or ch // num_head_channels, num_head_channels,
                                       transformer_depth, relative_position=use_relative_position,
                                       causal=use_causal_attention, temporal_length=t_len,
                                       dtype=dtype)

        self.time_embed = time_embed_mlp(mc, emb_dim, dtype=dtype)
        if fs_condition:
            self.fps_embedding = time_embed_mlp(mc, emb_dim, zero_out=True, dtype=dtype)
        if task_condition:
            self.task_embedding = time_embed_mlp(mc, emb_dim, zero_out=True, dtype=dtype)

        self.input_blocks = nn.ModuleList([nn.ModuleDict({"0": Conv2d(in_channels, mc, 3, dtype=dtype)})])
        self.init_attn = nn.ModuleList([temporal(mc, heads=8)]) if addition_attention else None
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                block = {"0": res(ch, mult * mc)}
                ch = mult * mc
                if ds in attention_resolutions:
                    block["1"] = spatial(ch)
                    if temporal_attention:
                        block["2"] = temporal(ch)
                self.input_blocks.append(nn.ModuleDict(block))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleDict({"0": Downsample(ch, dtype)}))
                chans.append(ch)
                ds *= 2

        middle = {"0": res(ch, ch), "1": spatial(ch), "3": res(ch, ch)}
        if temporal_attention:
            middle["2"] = temporal(ch)
        self.middle_block = nn.ModuleDict(middle)

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                skip = chans.pop()
                block = {"0": res(ch + skip, mult * mc)}
                ch = mult * mc
                sub = 1
                if ds in attention_resolutions:
                    block["1"] = spatial(ch)
                    sub = 2
                    if temporal_attention:
                        block["2"] = temporal(ch)
                        sub = 3
                if level and i == num_res_blocks:
                    block[str(sub)] = Upsample(ch, dtype)
                    ds //= 2
                self.output_blocks.append(nn.ModuleDict(block))

        self.out = nn.ModuleDict({"0": GroupNorm32(ch, silu=True),
                                  "2": zero_(Conv2d(ch, out_channels, 3, dtype=dtype))})

    def _run_block(self, block: nn.ModuleDict, h, emb, ctx, b, t):
        for key in sorted(block.keys()):
            layer = block[key]
            if isinstance(layer, ResBlock):
                h = layer(h, emb)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, context=ctx)
            elif isinstance(layer, TemporalTransformer):
                h = layer(h.reshape(b, t, *h.shape[1:])).reshape(h.shape)
            else:
                h = layer(h)
        return h

    def _block(self, block: nn.ModuleDict, h, emb, ctx, b, t):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._run_block, block, h, emb, ctx, b, t, use_reentrant=False)
        return self._run_block(block, h, emb, ctx, b, t)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                fs: Optional[torch.Tensor] = None, task: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x: (B, T, H, W, Cin); timesteps: (B,) or (B, T); context
        (B, 77 + T*16, ctx) or (B, L, ctx); fs: (B,) ints; task: (B,) int
        task ids (required with `task_condition`).
        Returns (B, T, H, W, Cout) float32."""
        b, t, hgt, wid, _ = x.shape
        mc, dtype = self.model_channels, self.dtype
        if timesteps.dim() == 1:
            emb = self.time_embed(timestep_embedding(timesteps, mc).to(dtype))
            emb = emb.repeat_interleave(t, dim=0)
        else:
            emb = self.time_embed(timestep_embedding(timesteps.reshape(-1), mc).to(dtype))
        if self.fs_condition:
            if fs is None:
                fs = torch.full((b,), self.default_fs, dtype=torch.int32, device=x.device)
            fs_emb = self.fps_embedding(timestep_embedding(fs, mc).to(dtype))
            emb = emb + fs_emb.repeat_interleave(t, dim=0)
        if self.task_condition:
            if task is None:
                raise ValueError("task_condition=True requires task ids")
            task_emb = self.task_embedding(timestep_embedding(task, mc, max_period=100.0).to(dtype))
            emb = emb + task_emb.repeat_interleave(t, dim=0)

        if context.shape[1] == TEXT_CONTEXT_LEN + t * IMAGE_TOKENS_PER_FRAME:
            ctx_text = context[:, :TEXT_CONTEXT_LEN].repeat_interleave(t, dim=0)
            ctx_img = context[:, TEXT_CONTEXT_LEN:].reshape(b * t, IMAGE_TOKENS_PER_FRAME, -1)
            ctx = torch.cat([ctx_text, ctx_img], dim=1)
        else:
            ctx = context.repeat_interleave(t, dim=0)
        ctx = ctx.to(dtype)

        h = self.input_blocks[0]["0"](x.reshape(b * t, hgt, wid, -1).to(dtype))
        if self.init_attn is not None:
            h = self.init_attn[0](h.reshape(b, t, *h.shape[1:])).reshape(h.shape)
        hs = [h]
        for block in self.input_blocks[1:]:
            h = self._block(block, h, emb, ctx, b, t)
            hs.append(h)
        h = self._block(self.middle_block, h, emb, ctx, b, t)
        for block in self.output_blocks:
            h = self._block(block, torch.cat([h, hs.pop()], dim=-1), emb, ctx, b, t)
        h = self.out["2"](self.out["0"](h))
        return h.reshape(b, t, hgt, wid, self.out_channels).float()

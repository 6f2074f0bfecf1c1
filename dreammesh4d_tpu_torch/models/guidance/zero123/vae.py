"""AutoencoderKL, the Stable Diffusion VAE, in PyTorch, NCHW (counterpart of
``dreammesh4d_tpu/models/guidance/zero123/vae.py``).

The modules carry the LDM names (``encoder.down.{l}.block.{i}``,
``encoder.down.{l}.downsample.conv``, ``encoder.mid.{block_1, attn_1,
block_2}``, ``decoder.up.{l}.block.{i}`` indexed by level, ``quant_conv``,
``post_quant_conv``), so that ``load_state_dict`` takes the
``first_stage_model.*`` entries of a checkpoint as they are.  256² rgb ↔ 32²
four-channel latents at the default widths (ch 128, ch_mult [1,2,4,4], two
res blocks).  GroupNorm eps 1e-6; precision as in ``unet.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet import Conv2d, GroupNorm32, upsample_nearest2


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else nn.Identity()

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return self.nin_shortcut(x) + h


class AttnBlock(nn.Module):
    """Single-head attention over the spatial positions, scaled by 1/√C."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)

        def tokens(conv):
            return conv(h).reshape(B, 1, C, H * W).transpose(-1, -2)

        out = F.scaled_dot_product_attention(tokens(self.q), tokens(self.k), tokens(self.v))
        return x + self.proj_out(out.transpose(-1, -2).reshape(B, C, H, W))


class Downsample(nn.Module):
    """Pad (0, 1) on the bottom and right, then a stride-2 valid 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest2(x))


class _Level(nn.Module):
    def __init__(self, blocks, resample=None, resample_name=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, resample_name, resample)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4):
        super().__init__()
        self.conv_in = Conv2d(3, ch, 3, padding=1)
        levels, c = [], ch
        for level, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(c, ch * mult))
                c = ch * mult
            last = level == len(ch_mult) - 1
            levels.append(_Level(blocks, None if last else Downsample(c), "downsample"))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(c)
        self.norm_out = GroupNorm32(c, eps=1e-6)
        self.conv_out = Conv2d(c, 2 * z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, out_ch: int = 3):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, c, 3, padding=1)
        self.mid = _Mid(c)
        levels = [None] * len(ch_mult)
        for level in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(c, ch * ch_mult[level]))
                c = ch * ch_mult[level]
            levels[level] = _Level(blocks, Upsample(c) if level else None, "upsample")
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(c, eps=1e-6)
        self.conv_out = Conv2d(c, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, embed_dim: int = 4, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, embed_dim)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, embed_dim)
        self.quant_conv = Conv2d(2 * embed_dim, 2 * embed_dim, 1)
        self.post_quant_conv = Conv2d(embed_dim, embed_dim, 1)

    def encode_moments(self, x):
        """x (B, 3, H, W) in [−1, 1] → (mean, logvar), each (B, 4, H/8, W/8);
        logvar clipped to [−30, 20]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode_mode(self, x):
        return self.encode_moments(x)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

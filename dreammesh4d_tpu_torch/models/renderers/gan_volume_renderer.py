"""The GAN volume renderer of Control4D: a low-resolution NeRF render
super-resolved by a conditional generator (counterpart of
``dreammesh4d_tpu/models/renderers/gan_volume_renderer.py``).

The base renderer draws the image at 1 / 2^(len(ch_mult) − 1) of the
output's side (the rays resized bilinearly, antialiased) with 3 rgb and
2·``z_channels`` latent channels (a diagonal Gaussian's mean and log
variance, clipped to [−30, 20]).  ``generator_level`` picks the sources:

- 0: z is the posterior's mode, the style code the global encoder's of the
  low-resolution rgb;
- 1: z is a sample (the normal draw given as ``noise`` or drawn from
  ``generator``; the mode without either), the code the global encoder's of
  ``gt_rgb`` resized to the base resolution;
- 2: as 1, and z is the local encoder's of the full-resolution ``gt_rgb``.

The networks: residual blocks of GroupNorm (min(8, C) groups, eps 1e-6,
affine), SiLU and 3×3 convolutions, FiLM-conditioned on the code in the
generator; the global encoder three stride-2 convolutions (32, 64, 128),
a spatial mean and a dense layer to the 64-wide code; the local encoder a
residual block and a stride-2 convolution per level past the first; the
generator a residual block per level from the deepest, a nearest ×2
upsample and a convolution between levels, then GroupNorm, SiLU, a
convolution to rgb and a sigmoid.  The modules are built at construction
(NCHW inside; images and rays are (B, H, W, C) outside); their parameters
are drawn from a generator seeded by ``cfg["seed"]`` (default 0).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_hw
from ...registry import register
from ..guidance.zero123.unet import init_weights, upsample_nearest2


class _ResBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, code_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(min(8, in_ch), in_ch, eps=1e-6)
        if code_dim is not None:  # FiLM conditioning (a class-conditional norm)
            self.film_s = nn.Linear(code_dim, in_ch)
            self.film_b = nn.Linear(code_dim, in_ch)
        self.conv1 = nn.Conv2d(in_ch, ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(min(8, ch), ch, eps=1e-6)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)
        self.skip = nn.Conv2d(in_ch, ch, 1) if in_ch != ch else None

    def forward(self, x, code=None):
        h = self.norm1(x)
        if code is not None:
            h = h * (1 + self.film_s(code)[:, :, None, None]) + self.film_b(code)[:, :, None, None]
        h = self.conv1(F.silu(h))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.skip is None else self.skip(x)) + h


class GlobalEncoder(nn.Module):
    """Low-resolution rgb (B, 3, h, w) → the global style code (B, code_dim)."""

    def __init__(self, code_dim: int = 64):
        super().__init__()
        chans = (3, 32, 64, 128)
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, stride=2, padding=1) for a, b in zip(chans, chans[1:]))
        self.dense = nn.Linear(chans[-1], code_dim)

    def forward(self, rgb):
        h = rgb
        for conv in self.convs:
            h = F.silu(conv(h))
        return self.dense(h.mean((2, 3)))


class LocalEncoder(nn.Module):
    """Full-resolution rgb (B, 3, H, W) → the latent z-map at the base
    resolution (B, z_channels, H / 2^(levels − 1), …)."""

    def __init__(self, z_channels: int = 4, ch_mult: Tuple[int, ...] = (1, 2, 4), ch: int = 32):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        blocks, downs, c = [], [], ch
        for m in ch_mult[1:]:
            blocks.append(_ResBlock(c, ch * m))
            c = ch * m
            downs.append(nn.Conv2d(c, c, 3, stride=2, padding=1))
        self.blocks, self.downs = nn.ModuleList(blocks), nn.ModuleList(downs)
        self.conv_out = nn.Conv2d(c, z_channels, 3, padding=1)

    def forward(self, rgb):
        h = self.conv_in(rgb)
        for block, down in zip(self.blocks, self.downs):
            h = down(block(h))
        return self.conv_out(h)


class Generator(nn.Module):
    """(low-resolution rgb ⊕ z (B, 3 + z, h, w), code (B, code_dim)) →
    full-resolution rgb (B, 3, h·2^(levels − 1), …) in (0, 1)."""

    def __init__(self, in_ch: int, ch: int = 64, out_ch: int = 3, ch_mult: Tuple[int, ...] = (1, 2, 4),
                 code_dim: int = 64):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(in_ch, c, 3, padding=1)
        blocks, ups = [], []
        for m in reversed(ch_mult):
            blocks.append(_ResBlock(c, ch * m, code_dim))
            c = ch * m
            if m != ch_mult[0]:
                ups.append(nn.Conv2d(c, c, 3, padding=1))
        self.blocks, self.ups = nn.ModuleList(blocks), nn.ModuleList(ups)
        self.norm_out = nn.GroupNorm(8, c, eps=1e-6)
        self.conv_out = nn.Conv2d(c, out_ch, 3, padding=1)

    def forward(self, x, code):
        h = self.conv_in(x)
        for i, block in enumerate(self.blocks):
            h = block(h, code)
            if i < len(self.ups):
                h = self.ups[i](upsample_nearest2(h))
        return torch.sigmoid(self.conv_out(F.silu(self.norm_out(h))))


def posterior_sample(latent: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The diagonal Gaussian over (..., 2k) moments (mean, log variance
    clipped to [−30, 20]): its mode without ``noise``, else mean + σ·noise."""
    k = latent.shape[-1] // 2
    mean, logvar = latent[..., :k], torch.clamp(latent[..., k:], -30.0, 20.0)
    if noise is None:
        return mean
    return mean + torch.exp(0.5 * logvar) * noise


@dataclass
class GANRendererConfig:
    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    z_channels: int = 4

    def __post_init__(self):
        self.ch_mult = tuple(self.ch_mult)


CODE_DIM = 64  # the global encoder's code (the JAX package's default)


@register("gan-volume-renderer")
class GANVolumeRenderer(nn.Module):
    """``renderer(base_renderer, rays_o, rays_d, gt_rgb=None,
    generator_level=0, noise=None, generator=None, **kw)``: rays (B, H, W,
    3); ``base_renderer(rays_o, rays_d, **kw)`` at the base resolution must
    return ``comp_rgb`` with 3 + 2·z_channels channels.  Returns its outputs
    plus ``comp_lr_rgb`` (B, h, w, 3) and ``comp_gan_rgb`` (B, H, W, 3)."""

    def __init__(self, cfg: GANRendererConfig | dict | None = None, device="cuda"):
        super().__init__()
        seed = 0
        if isinstance(cfg, dict):
            seed = int(cfg.get("seed", 0))
            names = {f.name for f in dataclasses.fields(GANRendererConfig)}
            cfg = GANRendererConfig(**{k: v for k, v in cfg.items() if k in names})
        self.cfg = c = cfg or GANRendererConfig()
        with torch.device("meta"):
            self.generator = Generator(3 + c.z_channels, ch=c.ch, ch_mult=c.ch_mult, code_dim=CODE_DIM)
            self.local_encoder = LocalEncoder(z_channels=c.z_channels, ch_mult=c.ch_mult)
            self.global_encoder = GlobalEncoder(CODE_DIM)
        self.to_empty(device=torch.device(device))
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    @property
    def scale(self) -> int:
        """The super-resolution factor 2^(len(ch_mult) − 1)."""
        return 2 ** (len(self.cfg.ch_mult) - 1)

    def forward(self, base_renderer: Callable[..., Dict[str, torch.Tensor]], rays_o: torch.Tensor,
                rays_d: torch.Tensor, gt_rgb: Optional[torch.Tensor] = None, generator_level: int = 0,
                noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                **kwargs) -> Dict[str, torch.Tensor]:
        B, H, W, _ = rays_o.shape
        h, w = H // self.scale, W // self.scale
        out = dict(base_renderer(resize_hw(rays_o, h, w, "bilinear"), resize_hw(rays_d, h, w, "bilinear"),
                                 **kwargs))
        comp = out["comp_rgb"]
        rgb_lr, latent = comp[..., :3], comp[..., 3:]
        out["comp_lr_rgb"] = rgb_lr
        if generator_level > 0 and noise is None and generator is not None:
            noise = torch.randn(latent[..., :latent.shape[-1] // 2].shape, generator=generator,
                                device=generator.device).to(latent)
        z = posterior_sample(latent, noise if generator_level > 0 else None)
        code_src = rgb_lr
        if generator_level >= 1 and gt_rgb is not None:
            code_src = resize_hw(gt_rgb, h, w, "bilinear")
        code = self.global_encoder(code_src.permute(0, 3, 1, 2))
        z = z.permute(0, 3, 1, 2)
        if generator_level == 2 and gt_rgb is not None:
            z = self.local_encoder(gt_rgb.permute(0, 3, 1, 2))
        gan = self.generator(torch.cat([rgb_lr.permute(0, 3, 1, 2), z], 1), code)
        out["comp_gan_rgb"] = gan.permute(0, 2, 3, 1)
        return out

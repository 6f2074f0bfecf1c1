"""ControlNet guidance: SDS whose score a condition image steers
(counterpart of ``dreammesh4d_tpu/models/guidance/controlnet.py``).

- :class:`ControlNetModel`: a copy of the UNet's down path and middle block
  (``zero123/unet.input_blocks``) fed the noisy latents plus an encoded
  hint image, emitting one residual per skip activation of the UNet
  (``zero_convs.{i}``, 1×1) and one for its middle block
  (``middle_block_out``); every projection out of the branch starts at
  zero, so at its initialisation the branch changes nothing.  The hint
  encoder (``input_hint_block``) is a stack of 3×3 convolutions with SiLU,
  widths ``[16] + [min(16·2^(i+1), 256) for i < n_down] + [256]``, stride 2
  at ``1 ≤ i ≤ n_down``, then a zero-initialised convolution to the model
  width; ``n_down`` halvings take the hint (``image_size``) to the latents'
  side (``image_size // 8``), and a call at another ratio is refused.
- :func:`canny_hint`: a Sobel-magnitude edge map (zero padding, eps 1e-12)
  ramped between ``low`` and ``high``; :func:`normal_hint`: rendered
  normals in [−1, 1] → [0, 1].
- :class:`ControlNetGuidance` (``stable-diffusion-controlnet-guidance``):
  Stable Diffusion's SDS with the residuals × ``condition_scale`` added to
  the UNet on the classifier-free-guidance batch; the hint is detached and
  resized (bilinear, antialiased) to ``image_size``.

Tensors are NCHW inside; renders and hints come in as (B, H, W, 3).  The
modules' ``state_dict()`` is Stable Diffusion's layout plus
``control_model.*``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_hw
from ...registry import register
from .stable_diffusion import (PromptEmbeddings, StableDiffusionConfig, StableDiffusionGuidance,
                               StableDiffusionModules, _filtered)
from .zero123.guidance import _draw, sds_timesteps
from .zero123.scheduler import add_noise
from .zero123.unet import (Conv2d, Linear, ResBlock, SpatialTransformer, TimestepEmbedSequential,
                           compute_dtype_of, input_blocks, set_compute_dtype, timestep_embedding,
                           zero_init_names)


def hint_depth(hint_size: int, latent_size: int) -> int:
    """The hint encoder's halvings: how often ``hint_size`` halves (integer
    division) before it is no larger than ``latent_size``."""
    n, s = 0, hint_size
    while s > latent_size:
        s //= 2
        n += 1
    return n


class ControlNetModel(nn.Module):
    """``forward(x (B, 4, h, w), hint (B, 3, H, W) in [0, 1], t (B,),
    context (B, L, C))`` → {"down": [one residual per UNet skip], "mid":
    the middle block's}; H / h is the ratio the model was built for
    (``hint_size`` / ``latent_size``)."""

    def __init__(self, model_channels: int = 320, channel_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                 attention_resolutions=(4, 2, 1), num_heads: int = 8, context_dim: int = 768,
                 hint_size: int = 512, latent_size: int = 64, in_channels: int = 4):
        super().__init__()
        mc = model_channels
        emb_ch = mc * 4
        self.model_channels = mc
        self.n_down = hint_depth(hint_size, latent_size)

        def transformer(ch):
            return SpatialTransformer(ch, num_heads, context_dim, 1)

        self.time_embed = nn.Sequential(Linear(mc, emb_ch), nn.SiLU(), Linear(emb_ch, emb_ch))
        widths = [16] + [min(16 * 2 ** (i + 1), 256) for i in range(self.n_down)] + [256]
        hint, c_in = [], 3
        for i, w in enumerate(widths):
            hint += [Conv2d(c_in, w, 3, stride=2 if 1 <= i <= self.n_down else 1, padding=1), nn.SiLU()]
            c_in = w
        self.input_hint_block = nn.Sequential(*hint, Conv2d(c_in, mc, 3, padding=1))
        self.input_blocks, chans, _ = input_blocks(in_channels, mc, channel_mult, num_res_blocks,
                                                   attention_resolutions, transformer)
        self.zero_convs = nn.ModuleList(nn.Sequential(Conv2d(c, c, 1)) for c in chans)
        ch = chans[-1]
        self.middle_block = TimestepEmbedSequential(ResBlock(ch, emb_ch, ch), transformer(ch),
                                                    ResBlock(ch, emb_ch, ch))
        self.middle_block_out = nn.Sequential(Conv2d(ch, ch, 1))

    def zero_init_names(self) -> list:
        """The zero-initialised parameters: the hint encoder's last
        convolution, every residual projection, and the copied blocks'
        zero-initialised layers."""
        last = f"input_hint_block.{len(self.input_hint_block) - 1}"
        outs = [f"zero_convs.{i}.0" for i in range(len(self.zero_convs))] + ["middle_block_out.0", last]
        return zero_init_names(self) + [f"{n}.{p}" for n in outs for p in ("weight", "bias")]

    def forward(self, x, hint, t, context) -> Dict[str, object]:
        n = hint_depth(hint.shape[-2], x.shape[-2])
        if n != self.n_down:
            raise ValueError(f"hint {tuple(hint.shape[-2:])} over latents {tuple(x.shape[-2:])} needs {n} "
                             f"halvings; the hint encoder was built for {self.n_down}")
        dtype = compute_dtype_of(self.time_embed[0])
        emb = self.time_embed(timestep_embedding(t, self.model_channels, dtype=dtype))
        g = hint
        for layer in self.input_hint_block:
            g = layer(g)
        down = []
        h = x
        for i, block in enumerate(self.input_blocks):
            h = block(h, emb, context)
            if i == 0:
                h = h + g
            down.append(self.zero_convs[i](h))
        h = self.middle_block(h, emb, context)
        return {"down": down, "mid": self.middle_block_out(h)}


def canny_hint(rgb: torch.Tensor, low: float = 0.1, high: float = 0.3) -> torch.Tensor:
    """Sobel-magnitude edge hint in [0, 1] of (B, H, W, 3) images, the same
    shape (a stand-in for cv2.Canny)."""
    gray = rgb.mean(-1, keepdim=True).permute(0, 3, 1, 2)
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=rgb.dtype, device=rgb.device)
    gx = F.conv2d(gray, kx[None, None], padding=1)
    gy = F.conv2d(gray, kx.T[None, None], padding=1)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    edge = torch.clamp((mag - low) / (high - low), 0.0, 1.0)
    return edge.permute(0, 2, 3, 1).expand(rgb.shape)


def normal_hint(normals: torch.Tensor) -> torch.Tensor:
    """Rendered world-space normals (B, H, W, 3) in [−1, 1] → a hint in [0, 1]."""
    return normals * 0.5 + 0.5


@dataclass
class ControlNetConfig(StableDiffusionConfig):
    guidance_scale: float = 7.5
    condition_scale: float = 1.5
    control_type: str = "normal"  # normal | canny


class ControlNetModules(StableDiffusionModules):
    """Stable Diffusion's UNet and VAE plus the ControlNet
    (``control_model``), built for hints at ``image_size`` over latents at
    ``image_size // 8`` (the VAE's factor, as the JAX package builds it)."""

    def __init__(self, cfg: ControlNetConfig, device="cuda"):
        super().__init__(cfg, device=device)
        with torch.device("meta"):
            self.control_model = ControlNetModel(
                model_channels=cfg.model_channels, channel_mult=cfg.channel_mult,
                num_res_blocks=cfg.num_res_blocks, num_heads=cfg.num_heads, context_dim=cfg.context_dim,
                hint_size=cfg.image_size, latent_size=cfg.image_size // 8)
        self.control_model.to_empty(device=torch.device(device))
        self.control_model.requires_grad_(False)
        set_compute_dtype(self.control_model, cfg.dtype)

    def zero_init_names(self) -> list:
        return super().zero_init_names() + [f"control_model.{n}" for n in self.control_model.zero_init_names()]


@register("stable-diffusion-controlnet-guidance")
class ControlNetGuidance(StableDiffusionGuidance):
    def __init__(self, cfg: ControlNetConfig | dict | None = None, modules=None, device="cuda"):
        if isinstance(cfg, dict):
            cfg = _filtered(ControlNetConfig, cfg)
        super().__init__(cfg or ControlNetConfig(), modules=modules, device=device)

    @staticmethod
    def make_modules(cfg, device) -> ControlNetModules:
        return ControlNetModules(cfg, device=device)

    def make_hint(self, rgb: torch.Tensor, normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The hint of ``control_type``: the normals' (``normal``, which
        needs them) or the renders' edges (``canny``)."""
        if self.cfg.control_type == "normal":
            if normals is None:
                raise ValueError("control_type=normal needs rendered normals")
            return normal_hint(normals)
        return canny_hint(rgb)

    def sds_loss(self, prompts: PromptEmbeddings, rgb: torch.Tensor, elevation: torch.Tensor,
                 azimuth: torch.Tensor, camera_distances: torch.Tensor, step: int,
                 generator: Optional[torch.Generator] = None, hint: Optional[torch.Tensor] = None,
                 u: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """SDS of ``rgb`` (B, H, W, 3) steered by ``hint`` (B, h, w, 3) in
        [0, 1] (default: the renders' canny edges).  ``u`` (B,) picks t and
        ``noise`` (B, 4, L, L) is ε, each drawn from ``generator`` (u first)
        when not given.  Returns ``loss_sds`` (its gradient reaches ``rgb``),
        ``grad_norm`` and ``t``."""
        cfg: ControlNetConfig = self.cfg
        mod = self.modules
        sched = mod.schedule
        dev = mod.device
        T = sched.num_train_timesteps
        B = rgb.shape[0]
        rgb = rgb.to(dev)
        latents = mod.encode_images(rgb)
        with torch.no_grad():
            if hint is None:
                hint = canny_hint(rgb.detach())
            S = cfg.image_size
            hint = resize_hw(hint.detach().to(dev), S, S, "bilinear").permute(0, 3, 1, 2)
            cond, uncond = prompts.get(elevation, azimuth)
            context = torch.cat([uncond, cond]).to(dev)
            if u is None:
                u = _draw(generator, (B,), False, dev)
            if noise is None:
                noise = _draw(generator, tuple(latents.shape), True, dev)
            noise = noise.to(dev, torch.float32)
            t, _, _ = sds_timesteps(cfg, u.to(dev, torch.float32), step, T)
            latents_noisy = add_noise(sched, latents.detach(), noise, t)
            x_in = torch.cat([latents_noisy, latents_noisy])
            t_in = torch.cat([t, t])
            control = mod.control_model(x_in, torch.cat([hint, hint]), t_in, context)
            control = {"down": [r * cfg.condition_scale for r in control["down"]],
                       "mid": control["mid"] * cfg.condition_scale}
            e_u, e_c = mod.unet(x_in, t_in, context, control=control).chunk(2)
            eps = e_u + cfg.guidance_scale * (e_c - e_u)
            grad = torch.nan_to_num(self._weight(t) * (eps - noise))
            if cfg.grad_clip is not None:
                grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
            target = latents.detach() - grad
        loss_sds = 0.5 * ((latents - target) ** 2).sum() / B
        return {"loss_sds": loss_sds, "grad_norm": torch.linalg.norm(grad), "t": t}

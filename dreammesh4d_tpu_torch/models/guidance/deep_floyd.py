"""DeepFloyd-IF guidance: pixel-space SDS (counterpart of
``dreammesh4d_tpu/models/guidance/deep_floyd.py``).

IF's stage I diffuses pixels: there is no VAE (the modules hold the UNet
alone).  The render is resized (bilinear, antialiased) to ``image_size``
(64) and mapped to [−1, 1], noised directly, and the UNet (3 channels in,
6 out: ε and a learned variance) runs on the classifier-free-guidance
batch; only the first 3 channels drive SDS.  The text context is 4096 wide
(T5-XXL's hidden size); the prompt processor supplies it
(``deep-floyd-prompt-processor`` is ``stable-diffusion-prompt-processor``
with ``context_dim: 4096``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ...ops.resize import resize_hw
from ...registry import register
from .stable_diffusion import (PromptEmbeddings, StableDiffusionConfig, StableDiffusionGuidance,
                               StableDiffusionModules, _filtered)
from .zero123.guidance import _draw, sds_timesteps
from .zero123.scheduler import add_noise


@dataclass
class DeepFloydConfig(StableDiffusionConfig):
    guidance_scale: float = 20.0
    context_dim: int = 4096  # T5-XXL hidden size
    image_size: int = 64  # IF stage I resolution
    latent_size: int = 64


@register("deep-floyd-guidance")
class DeepFloydGuidance(StableDiffusionGuidance):
    def __init__(self, cfg: DeepFloydConfig | dict | None = None, modules=None, device="cuda"):
        if isinstance(cfg, dict):
            cfg = _filtered(DeepFloydConfig, cfg)
        super().__init__(cfg or DeepFloydConfig(), modules=modules, device=device)

    @staticmethod
    def make_modules(cfg, device) -> StableDiffusionModules:
        return StableDiffusionModules(cfg, device=device, in_channels=3, out_channels=6, vae=False)

    def encode_images(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] → the pixel-space "latents" (B, 3, S, S)
        in [−1, 1]."""
        S = self.cfg.image_size
        return (resize_hw(rgb.to(self.modules.device), S, S, "bilinear") * 2.0 - 1.0).permute(0, 3, 1, 2)

    def sds_loss(self, prompts: PromptEmbeddings, rgb: torch.Tensor, elevation: torch.Tensor,
                 azimuth: torch.Tensor, camera_distances: torch.Tensor, step: int,
                 generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Pixel-space SDS of ``rgb`` (B, H, W, 3).  ``u`` (B,) picks t and
        ``noise`` (B, 3, S, S) is ε, each drawn from ``generator`` (u first)
        when not given.  Returns ``loss_sds`` (its gradient reaches ``rgb``),
        ``grad_norm`` and ``t``."""
        cfg: DeepFloydConfig = self.cfg
        mod = self.modules
        sched = mod.schedule
        dev = mod.device
        T = sched.num_train_timesteps
        B = rgb.shape[0]
        latents = self.encode_images(rgb)
        with torch.no_grad():
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
            out = mod.unet(x_in, torch.cat([t, t]), context)
            e_u, e_c = out[:, :3].chunk(2)  # the learned-variance channels dropped
            eps = e_u + cfg.guidance_scale * (e_c - e_u)
            grad = torch.nan_to_num(self._weight(t) * (eps - noise))
            if cfg.grad_clip is not None:
                grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
            target = latents.detach() - grad
        loss_sds = 0.5 * ((latents - target) ** 2).sum() / B
        return {"loss_sds": loss_sds, "grad_norm": torch.linalg.norm(grad), "t": t}

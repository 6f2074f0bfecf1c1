"""InstructPix2Pix guidance: the image-editing SDS (counterpart of
``dreammesh4d_tpu/models/guidance/instructpix2pix.py``).

The UNet takes 8 input channels: the 4 noisy latents and the 4 latents of
the condition image, the VAE's posterior mean without the latent scale.
The score is the three-way classifier-free guidance

    ε̂ = ε(∅, ∅) + s_text · (ε(c_img, c_txt) − ε(c_img, ∅)) + s_img · (ε(c_img, ∅) − ε(∅, ∅))

with the three branches in one UNet call on a 3B batch: contexts
[cond, uncond, uncond], image latents [c, c, 0].  ``guidance_scale`` is
s_text, ``condition_scale`` s_img.  ``systems/editing.ip2p_edit_images``
runs the DDIM edit with the same guidance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ...registry import register
from .stable_diffusion import (PromptEmbeddings, StableDiffusionConfig, StableDiffusionGuidance,
                               StableDiffusionModules, _filtered)
from .zero123.guidance import LATENT_SCALE, _draw, sds_timesteps
from .zero123.scheduler import add_noise


@dataclass
class InstructPix2PixConfig(StableDiffusionConfig):
    guidance_scale: float = 7.5  # text scale
    condition_scale: float = 1.5  # image scale
    fixed_size: int = -1


@register("stable-diffusion-instructpix2pix-guidance")
class InstructPix2PixGuidance(StableDiffusionGuidance):
    def __init__(self, cfg: InstructPix2PixConfig | dict | None = None, modules=None, device="cuda"):
        if isinstance(cfg, dict):
            cfg = _filtered(InstructPix2PixConfig, cfg)
        super().__init__(cfg or InstructPix2PixConfig(), modules=modules, device=device)

    @staticmethod
    def make_modules(cfg, device) -> StableDiffusionModules:
        return StableDiffusionModules(cfg, device=device, in_channels=8)

    def cond_latents(self, cond_rgb: torch.Tensor) -> torch.Tensor:
        """The condition images' latents: the posterior mean, unscaled."""
        return self.modules.encode_images(cond_rgb.to(self.modules.device)) / LATENT_SCALE

    def guided_eps(self, x: torch.Tensor, t: torch.Tensor, cond_latents: torch.Tensor,
                   context: torch.Tensor) -> torch.Tensor:
        """ε̂ of the noisy latents ``x`` (B, 4, L, L) at ``t`` (B,): the three
        branches in one UNet call, ``context`` the 3B contexts [cond,
        uncond, uncond]."""
        cfg: InstructPix2PixConfig = self.cfg
        zeros = torch.zeros_like(cond_latents)
        x_in = torch.cat([torch.cat([x, cond_latents], 1), torch.cat([x, cond_latents], 1),
                          torch.cat([x, zeros], 1)])
        e_full, e_img, e_un = self.modules.unet(x_in, torch.cat([t, t, t]), context).chunk(3)
        return e_un + cfg.guidance_scale * (e_full - e_img) + cfg.condition_scale * (e_img - e_un)

    def edit_loss(self, prompts: PromptEmbeddings, rgb: torch.Tensor, cond_rgb: torch.Tensor,
                  elevation: torch.Tensor, azimuth: torch.Tensor, step: int,
                  generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The editing SDS: pull the renders ``rgb`` (B, H, W, 3) toward the
        instruction's edit of the (detached) condition images ``cond_rgb``.
        ``u`` (B,) picks t and ``noise`` (B, 4, L, L) is ε, each drawn from
        ``generator`` (u first) when not given.  Returns ``loss_sds`` (its
        gradient reaches ``rgb``), ``grad_norm`` and ``t``."""
        mod = self.modules
        sched = mod.schedule
        dev = mod.device
        T = sched.num_train_timesteps
        B = rgb.shape[0]
        latents = mod.encode_images(rgb.to(dev))
        with torch.no_grad():
            cond_latents = self.cond_latents(cond_rgb.detach())
            cond, uncond = prompts.get(elevation, azimuth)
            context = torch.cat([cond, uncond, uncond]).to(dev)
            if u is None:
                u = _draw(generator, (B,), False, dev)
            if noise is None:
                noise = _draw(generator, tuple(latents.shape), True, dev)
            noise = noise.to(dev, torch.float32)
            t, _, _ = sds_timesteps(self.cfg, u.to(dev, torch.float32), step, T)
            latents_noisy = add_noise(sched, latents.detach(), noise, t)
            eps = self.guided_eps(latents_noisy, t, cond_latents, context)
            grad = torch.nan_to_num(self._weight(t) * (eps - noise))
            if self.cfg.grad_clip is not None:
                grad = torch.clamp(grad, -self.cfg.grad_clip, self.cfg.grad_clip)
            target = latents.detach() - grad
        loss_sds = 0.5 * ((latents - target) ** 2).sum() / B
        return {"loss_sds": loss_sds, "grad_norm": torch.linalg.norm(grad), "t": t}

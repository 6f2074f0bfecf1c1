"""Variational score distillation (ProlificDreamer's VSD; counterpart of
``dreammesh4d_tpu/models/guidance/vsd.py``, :1-222).

The frozen Stable Diffusion UNet gives the score of the target
distribution; a LoRA-adapted "phi" UNet, trained online on the renders,
models the score of the renders' distribution; the scene's gradient in the
latents is w(t)·(ε_pretrained,cfg − ε_phi).

- The phi UNet is the frozen UNet called through
  ``torch.func.functional_call`` with W + (A·B·alpha/r)ᵀ in place of the
  weight of every attention projection (``to_q``, ``to_k``, ``to_v``,
  ``to_out.0``): the float32 weights are merged before the layer casts to
  its compute dtype; no second module, the frozen weights untouched.
- The LoRA tree: ``{module name: {"A": (in, r) ~ N(0, 1/r), "B": (r, out)
  = 0}}`` (the JAX package's layout, so phi equals the pretrained UNet at
  step 0) and ``"camera_proj"`` ``{"w": (16, context_dim) · 0.02, "b": 0}``:
  the flattened camera (c2w) becomes one extra context token of phi.
- :meth:`VSDGuidance.vsd_loss` returns ``loss_vsd`` (its gradient reaches
  the render only: the LoRA is detached there) and ``loss_lora`` (phi's
  diffusion loss on the current render: its gradient reaches the LoRA
  only), so that one backward can drive the scene's and the LoRA's Adam.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.func import functional_call

from ...ops.resize import resize_hw
from ...registry import register
from .stable_diffusion import PromptEmbeddings, StableDiffusionConfig, StableDiffusionGuidance
from .zero123.guidance import _draw, sds_timesteps
from .zero123.scheduler import add_noise
from .zero123.unet import CrossAttention

# the projections of every attention that receive a LoRA adapter
LORA_PROJECTIONS = ("to_q", "to_k", "to_v", "to_out.0")


def lora_targets(unet) -> List[Tuple[str, int, int]]:
    """(module name, in, out) of every attention projection of ``unet``
    that receives a LoRA adapter, in ``named_modules`` order."""
    out = []
    for name, m in unet.named_modules():
        if isinstance(m, CrossAttention):
            for proj in LORA_PROJECTIONS:
                w = m.get_submodule(proj).weight
                out.append((f"{name}.{proj}", w.shape[1], w.shape[0]))
    return out


def init_lora(targets, rank: int, context_dim: int, generator: torch.Generator,
              device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The LoRA tree of ``targets`` on ``device``: A ~ N(0, 1/rank) drawn
    from ``generator`` in the targets' order, B = 0, then ``camera_proj``
    (w ~ N(0, 0.02²), b = 0); every leaf requires grad."""

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=generator.device).to(device) * std

    lora = {name: {"A": normal((d_in, rank), 1.0 / math.sqrt(rank)),
                   "B": torch.zeros((rank, d_out), device=device)}
            for name, d_in, d_out in targets}
    lora["camera_proj"] = {"w": normal((16, context_dim), 0.02), "b": torch.zeros((context_dim,), device=device)}
    for leaves in lora.values():
        for v in leaves.values():
            v.requires_grad_(True)
    return lora


def camera_token(lora, camera_condition: torch.Tensor) -> torch.Tensor:
    """The flattened camera (zero-padded or cut to 16) through
    ``camera_proj``: one context token (B, 1, C)."""
    flat = camera_condition.reshape(camera_condition.shape[0], -1).float()
    if flat.shape[-1] < 16:
        flat = torch.nn.functional.pad(flat, (0, 16 - flat.shape[-1]))
    tok = flat[:, :16] @ lora["camera_proj"]["w"] + lora["camera_proj"]["b"]
    return tok[:, None, :]


def phi_unet(unet, lora, scale: float, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    """``unet`` called with W + (A·B·scale)ᵀ in place of each adapted
    projection's weight (``torch.func.functional_call``; the float32
    weights are merged before the layer casts to its compute dtype)."""
    merged = {f"{name}.weight": unet.get_parameter(f"{name}.weight") + (ab["A"] @ ab["B"] * scale).T
              for name, ab in lora.items() if name != "camera_proj"}
    return functional_call(unet, merged, (x, t, context))


@dataclass
class VSDConfig(StableDiffusionConfig):
    guidance_scale: float = 7.5
    guidance_scale_lora: float = 1.0
    lora_rank: int = 8
    lora_alpha: float = 1.0
    camera_condition_type: str = "extrinsics"  # the flattened c2w
    lora_cfg_training: bool = True
    lora_uncond_prob: float = 0.1


@register("stable-diffusion-vsd-guidance")
class VSDGuidance(StableDiffusionGuidance):
    """``guidance_type: "stable-diffusion-vsd-guidance"``."""

    def __init__(self, cfg: VSDConfig | dict | None = None, modules=None, device="cuda"):
        if isinstance(cfg, dict):
            names = {f.name for f in dataclasses.fields(VSDConfig)}
            cfg = VSDConfig(**{k: v for k, v in cfg.items() if k in names})
        super().__init__(cfg or VSDConfig(), modules=modules, device=device)

    # -- the LoRA (phi) ------------------------------------------------------

    def lora_targets(self) -> List[Tuple[str, int, int]]:
        """(UNet module name, in, out) of every adapted projection."""
        return lora_targets(self.modules.unet)

    def init_lora_params(self, generator: torch.Generator) -> Dict[str, Dict[str, torch.Tensor]]:
        """A fresh LoRA tree on the guidance's device, drawn from
        ``generator``; every leaf requires grad."""
        cfg: VSDConfig = self.cfg
        return init_lora(self.lora_targets(), cfg.lora_rank, cfg.context_dim, generator, self.modules.device)

    def phi_eps(self, lora, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                camera_condition: torch.Tensor) -> torch.Tensor:
        """The phi UNet's ε: the frozen UNet with the LoRA merged into its
        attention projections and the camera token appended to ``context``."""
        cfg: VSDConfig = self.cfg
        ctx = torch.cat([context, camera_token(lora, camera_condition).to(context.dtype)], 1)
        return phi_unet(self.modules.unet, lora, cfg.lora_alpha / cfg.lora_rank, x, t, ctx)

    # -- the losses ----------------------------------------------------------

    def vsd_loss(self, lora, prompts: PromptEmbeddings, rgb: torch.Tensor, elevation: torch.Tensor,
                 azimuth: torch.Tensor, camera_condition: torch.Tensor, step: int,
                 generator: Optional[torch.Generator] = None, rgb_as_latents: bool = False,
                 u: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 u2: Optional[torch.Tensor] = None, noise2: Optional[torch.Tensor] = None,
                 drop: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """VSD of ``rgb`` (B, H, W, C) and phi's diffusion loss.  The draws,
        each taken from ``generator`` in this order when not given: ``u``
        (B,) picks t and ``noise`` (B, 4, L, L) is ε of the VSD term; ``u2``
        and ``noise2`` those of the LoRA term; ``drop`` (B,) bool replaces
        the LoRA term's condition by the unconditional one (with
        ``lora_cfg_training``; drawn as U[0, 1) < ``lora_uncond_prob``).
        Returns ``loss_vsd``, ``loss_lora`` and ``grad_norm``."""
        cfg: VSDConfig = self.cfg
        mod = self.modules
        sched = mod.schedule
        dev = mod.device
        T = sched.num_train_timesteps
        B = rgb.shape[0]
        if rgb_as_latents:
            L = cfg.latent_size
            latents = (resize_hw(rgb.to(dev), L, L, "bilinear") * 2 - 1).permute(0, 3, 1, 2)
        else:
            latents = mod.encode_images(rgb.to(dev))
        shape = tuple(latents.shape)
        draws = []
        for given, dshape, normal in ((u, (B,), False), (noise, shape, True), (u2, (B,), False),
                                      (noise2, shape, True)):
            draws.append((given if given is not None else _draw(generator, dshape, normal, dev)).to(
                dev, torch.float32))
        u, noise, u2, noise2 = draws
        if cfg.lora_cfg_training and drop is None:
            drop = _draw(generator, (B,), False, dev) < cfg.lora_uncond_prob
        cam = camera_condition.to(dev)
        latents_sg = latents.detach()
        with torch.no_grad():
            cond, uncond = prompts.get(elevation, azimuth)
            cond, uncond = cond.to(dev), uncond.to(dev)
            t, _, _ = sds_timesteps(cfg, u, step, T)
            latents_noisy = add_noise(sched, latents_sg, noise, t)
            x_in = torch.cat([latents_noisy, latents_noisy])
            t_in = torch.cat([t, t])
            ctx = torch.cat([uncond, cond])
            e_u, e_c = mod.unet(x_in, t_in, ctx).chunk(2)
            eps_pretrain = e_u + cfg.guidance_scale * (e_c - e_u)
            if cfg.guidance_scale_lora != 1.0:
                p_u, p_c = self.phi_eps(lora, x_in, t_in, ctx, torch.cat([cam, cam])).chunk(2)
                eps_phi = p_u + cfg.guidance_scale_lora * (p_c - p_u)
            else:
                eps_phi = self.phi_eps(lora, latents_noisy, t, cond, cam)
            grad = torch.nan_to_num(self._weight(t) * (eps_pretrain - eps_phi))
            if cfg.grad_clip is not None:
                grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
            target = latents_sg - grad
        loss_vsd = 0.5 * ((latents - target) ** 2).sum() / B

        t2 = torch.clamp((u2 * T).to(torch.int32), 1, T - 1).long()
        noisy2 = add_noise(sched, latents_sg, noise2, t2)
        ctx_lora = cond
        if cfg.lora_cfg_training:
            ctx_lora = torch.where(drop.to(dev).reshape(B, 1, 1), uncond, cond)
        eps_lora = self.phi_eps(lora, noisy2, t2, ctx_lora, cam)
        loss_lora = ((eps_lora - noise2) ** 2).mean()
        return {"loss_vsd": loss_vsd, "loss_lora": loss_lora, "grad_norm": torch.linalg.norm(grad)}

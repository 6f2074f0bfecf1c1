"""Unified guidance: SDS / VSD dispatch with Perp-Neg, for Stable Diffusion
and Zero123 (counterpart of ``dreammesh4d_tpu/models/guidance/unified.py``).

- ``stable-diffusion-unified-guidance`` (:class:`SDUnifiedGuidance`, on
  :class:`~.vsd.VSDGuidance`): ``guidance_type: sds | vsd``; with
  ``use_perp_neg`` the SDS score adds the weighted components of two
  negative view scores perpendicular to the positive one, all four scores
  from ONE UNet call on a 4B batch [pos, uncond, neg0, neg1].
- ``zero123-unified-guidance`` (:class:`Zero123UnifiedGuidance`, on the
  vanilla :class:`~.zero123.guidance.Zero123Guidance`): Zero123 SDS, or VSD
  whose phi model is the frozen Zero123 UNet with LoRA deltas merged
  through ``torch.func.functional_call``, camera-conditioned by one extra
  context token (with ``vsd_use_camera_condition``) and scored with
  ``vsd_guidance_scale_phi`` classifier-free guidance against a zero camera.

As in the JAX package, the VSD branch of the SD guidance reads
``guidance_scale_lora`` and ``lora_*`` (``vsd.py``), never
``vsd_guidance_scale_phi``.  Draws come from an explicit
``torch.Generator`` or are passed in as tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ...ops.resize import resize_hw
from ...registry import register
from .stable_diffusion import PromptEmbeddings, StableDiffusionGuidance, _filtered
from .vsd import VSDConfig, VSDGuidance, camera_token, init_lora, lora_targets, phi_unet
from .zero123.guidance import Zero123Config, Zero123Guidance, _draw, sds_timesteps
from .zero123.scheduler import add_noise


def shifted_expotional_decay(a: float, b: float, c: float, r: torch.Tensor) -> torch.Tensor:
    """a·e^(−b·r) + c (the reference's ``utils/ops.py:544-545``; the name
    is kept verbatim)."""
    return a * torch.exp(-b * r) + c


def perpendicular_component(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The component of x perpendicular to y, per batch element; |y|² is
    floored at 1e-6."""
    dims = tuple(range(1, x.ndim))
    num = (x * y).sum(dims, keepdim=True)
    den = torch.clamp((y * y).sum(dims, keepdim=True), min=1e-6)
    return x - (num / den) * y


@dataclass
class PerpNegCoeffs:
    # a·e^(−b·r) + c triples (the reference's PromptProcessor.Config)
    f_sb: Tuple[float, float, float] = (1.0, 0.5, -0.606)
    f_fsb: Tuple[float, float, float] = (1.0, 0.5, +0.967)
    f_fs: Tuple[float, float, float] = (4.0, 0.5, -2.426)
    f_sf: Tuple[float, float, float] = (4.0, 0.5, -2.426)


def get_perp_neg_embeddings(prompts: PromptEmbeddings, elevation: torch.Tensor, azimuth: torch.Tensor,
                            coeffs: PerpNegCoeffs):
    """(pos (B, L, C), uncond (B, L, C), neg (B, 2, L, C), neg_w (B, 2)).

    ``prompts.cond`` rows are [base, front, side, back, overhead], used
    whatever ``use_view_dependent_prompting`` says.  |azimuth| < 90° is the
    front-side branch: pos lerps front → side, the negatives [front, side];
    else pos lerps side → back, the negatives swapped to [side, front].
    Above ``overhead_threshold`` pos is the overhead row and both
    negatives are the unconditional embedding at weight 0."""
    cond = prompts.cond
    front, side, back, overhead = cond[1], cond[2], cond[3], cond[4]
    elevation = elevation.to(cond.device, torch.float32)
    az = torch.remainder(azimuth.to(cond.device, torch.float32) + 180.0, 360.0) - 180.0
    aaz = az.abs()
    fs = aaz < 90.0
    over = elevation > prompts.cfg.overhead_threshold
    fs3, over3 = fs[:, None, None], over[:, None, None]

    def lerp(r, a, b):
        r = r[:, None, None]
        return r * a[None] + (1.0 - r) * b[None]

    r_fs = 1.0 - aaz / 90.0  # 1 front, 0 side
    r_sb = 2.0 - aaz / 90.0  # 1 side, 0 back
    pos = torch.where(fs3, lerp(r_fs, front, side), lerp(r_sb, side, back))
    pos = torch.where(over3, overhead[None], pos)
    uncond = prompts.uncond[None].expand(pos.shape)
    neg0 = torch.where(over3, uncond, torch.where(fs3, front[None], side[None]))
    neg1 = torch.where(over3, uncond, torch.where(fs3, side[None], front[None]))
    w0 = torch.where(fs, -shifted_expotional_decay(*coeffs.f_fs, r_fs),
                     -shifted_expotional_decay(*coeffs.f_sb, r_sb))
    w1 = torch.where(fs, -shifted_expotional_decay(*coeffs.f_sf, 1.0 - r_fs),
                     -shifted_expotional_decay(*coeffs.f_fsb, r_sb))
    zero = torch.zeros((), device=cond.device)
    neg_w = torch.stack([torch.where(over, zero, w0), torch.where(over, zero, w1)], -1)
    return pos, uncond, torch.stack([neg0, neg1], 1), neg_w


# ---------------------------------------------------------------------------
# stable-diffusion-unified-guidance
# ---------------------------------------------------------------------------


@dataclass
class SDUnifiedConfig(VSDConfig):
    guidance_type: str = "sds"  # sds | vsd
    guidance_scale: float = 100.0
    use_perp_neg: bool = False
    vsd_guidance_scale_phi: float = 1.0  # read by nothing here, as in the JAX package
    perp_neg_f_sb: Tuple[float, float, float] = (1.0, 0.5, -0.606)
    perp_neg_f_fsb: Tuple[float, float, float] = (1.0, 0.5, +0.967)
    perp_neg_f_fs: Tuple[float, float, float] = (4.0, 0.5, -2.426)
    perp_neg_f_sf: Tuple[float, float, float] = (4.0, 0.5, -2.426)


@register("stable-diffusion-unified-guidance")
class SDUnifiedGuidance(VSDGuidance):
    """SDS or VSD on Stable Diffusion, with optional Perp-Neg guidance."""

    def __init__(self, cfg: SDUnifiedConfig | dict | None = None, modules=None, device="cuda"):
        if isinstance(cfg, dict):
            cfg = _filtered(SDUnifiedConfig, cfg)
        StableDiffusionGuidance.__init__(self, cfg or SDUnifiedConfig(), modules=modules, device=device)

    @property
    def coeffs(self) -> PerpNegCoeffs:
        c: SDUnifiedConfig = self.cfg
        return PerpNegCoeffs(tuple(c.perp_neg_f_sb), tuple(c.perp_neg_f_fsb), tuple(c.perp_neg_f_fs),
                             tuple(c.perp_neg_f_sf))

    def sds_loss_perp_neg(self, prompts: PromptEmbeddings, rgb: torch.Tensor, elevation: torch.Tensor,
                          azimuth: torch.Tensor, camera_distances: torch.Tensor, step: int,
                          generator: Optional[torch.Generator] = None, rgb_as_latents: bool = False,
                          u: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """SDS whose guided score is ε_unc + s·(Δ_pos + Σ_i w_i·(Δ_neg_i ⟂
        Δ_pos)), Δ = ε − ε_unc, the four scores from one UNet call on
        [pos, uncond, neg0, neg1].  ``u`` (B,) picks t and ``noise`` (B, 4,
        L, L) is ε, each drawn from ``generator`` (u first) when not given.
        Returns ``loss_sds`` (its gradient reaches ``rgb``) and
        ``grad_norm``."""
        cfg: SDUnifiedConfig = self.cfg
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
        with torch.no_grad():
            pos, uncond, neg, neg_w = get_perp_neg_embeddings(prompts, elevation, azimuth, self.coeffs)
            if u is None:
                u = _draw(generator, (B,), False, dev)
            if noise is None:
                noise = _draw(generator, tuple(latents.shape), True, dev)
            noise = noise.to(dev, torch.float32)
            t, _, _ = sds_timesteps(cfg, u.to(dev, torch.float32), step, T)
            latents_noisy = add_noise(sched, latents.detach(), noise, t)
            ctx = torch.cat([pos, uncond, neg[:, 0], neg[:, 1]]).to(dev)
            eps = mod.unet(torch.cat([latents_noisy] * 4), torch.cat([t] * 4), ctx)
            e_pos, e_unc, e_n0, e_n1 = eps.chunk(4)
            d_pos = e_pos - e_unc
            w = neg_w.to(dev)
            accum = (w[:, 0].reshape(-1, 1, 1, 1) * perpendicular_component(e_n0 - e_unc, d_pos)
                     + w[:, 1].reshape(-1, 1, 1, 1) * perpendicular_component(e_n1 - e_unc, d_pos))
            eps_guided = e_unc + cfg.guidance_scale * (d_pos + accum)
            grad = torch.nan_to_num(self._weight(t) * (eps_guided - noise))
            if cfg.grad_clip is not None:
                grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
            target = latents.detach() - grad
        loss_sds = 0.5 * ((latents - target) ** 2).sum() / B
        return {"loss_sds": loss_sds, "grad_norm": torch.linalg.norm(grad)}

    def loss(self, prompts: PromptEmbeddings, rgb: torch.Tensor, elevation: torch.Tensor,
             azimuth: torch.Tensor, camera_distances: torch.Tensor, step: int,
             generator: Optional[torch.Generator] = None, camera_condition: Optional[torch.Tensor] = None,
             lora=None, rgb_as_latents: bool = False, **draws) -> Dict[str, torch.Tensor]:
        """``guidance_type`` dispatch: ``vsd`` → :meth:`vsd_loss` (it needs
        ``lora`` and ``camera_condition``), else with ``use_perp_neg``
        :meth:`sds_loss_perp_neg`, else :meth:`sds_loss`.  ``draws`` are the
        chosen loss's given draws (``u``, ``noise``, …)."""
        cfg: SDUnifiedConfig = self.cfg
        if cfg.guidance_type == "vsd":
            if lora is None or camera_condition is None:
                raise ValueError("guidance_type vsd needs lora and camera_condition")
            return self.vsd_loss(lora, prompts, rgb, elevation, azimuth, camera_condition, step, generator,
                                 rgb_as_latents=rgb_as_latents, **draws)
        fn = self.sds_loss_perp_neg if cfg.use_perp_neg else self.sds_loss
        return fn(prompts, rgb, elevation, azimuth, camera_distances, step, generator,
                  rgb_as_latents=rgb_as_latents, **draws)


# ---------------------------------------------------------------------------
# zero123-unified-guidance
# ---------------------------------------------------------------------------


@dataclass
class Zero123UnifiedConfig(Zero123Config):
    guidance_type: str = "sds"  # sds | vsd
    guidance_scale: float = 5.0
    vsd_guidance_scale_phi: float = 1.0
    vsd_lora_rank: int = 8
    vsd_lora_alpha: float = 1.0
    vsd_use_camera_condition: bool = True
    vsd_lora_cfg_training: bool = False
    vsd_lora_uncond_prob: float = 0.1


@register("zero123-unified-guidance")
class Zero123UnifiedGuidance(Zero123Guidance):
    """Zero123 SDS (the vanilla ΔT) or VSD with a LoRA phi model."""

    def __init__(self, cfg: Zero123UnifiedConfig | dict | None = None, modules=None, device="cuda"):
        if isinstance(cfg, dict):
            cfg = _filtered(Zero123UnifiedConfig, cfg)
        super().__init__(cfg or Zero123UnifiedConfig(), modules, device=device)

    def lora_targets(self):
        """(UNet module name, in, out) of every adapted projection."""
        return lora_targets(self.modules.unet)

    def init_lora_params(self, generator: torch.Generator) -> Dict[str, Dict[str, torch.Tensor]]:
        """An A/B pair of rank ``vsd_lora_rank`` for every attention
        projection and ``camera_proj`` (16 × context_dim), drawn from
        ``generator``; every leaf requires grad."""
        cfg: Zero123UnifiedConfig = self.cfg
        return init_lora(self.lora_targets(), cfg.vsd_lora_rank, cfg.context_dim, generator, self.modules.device)

    def _apply_phi(self, lora, x, t, context, camera_condition) -> torch.Tensor:
        """The phi UNet's ε; the camera token joins ``context`` only with
        ``vsd_use_camera_condition``."""
        cfg: Zero123UnifiedConfig = self.cfg
        if cfg.vsd_use_camera_condition:
            context = torch.cat([context, camera_token(lora, camera_condition).to(context.dtype)], 1)
        return phi_unet(self.modules.unet, lora, cfg.vsd_lora_alpha / cfg.vsd_lora_rank, x, t, context)

    def vsd_loss(self, bank: Dict[str, torch.Tensor], lora, rgb: torch.Tensor, elevation: torch.Tensor,
                 azimuth: torch.Tensor, camera_distances: torch.Tensor, camera_condition: torch.Tensor,
                 frame_indices: Optional[torch.Tensor], step: int,
                 generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None, u2: Optional[torch.Tensor] = None,
                 noise2: Optional[torch.Tensor] = None,
                 drop: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """VSD of the renders ``rgb`` (B, H, W, 3) and phi's diffusion loss.
        The draws, each taken from ``generator`` in this order when not
        given: ``u`` (B,) and ``noise`` (B, 4, L, L) of the VSD term, ``u2``
        and ``noise2`` of the LoRA term, and with ``vsd_lora_cfg_training``
        ``drop`` (B,) bool (U[0, 1) < ``vsd_lora_uncond_prob``), which
        zeroes a view's flattened camera in the LoRA term.  Returns
        ``loss_vsd`` (its gradient reaches ``rgb`` only), ``loss_lora`` (the
        LoRA only) and ``grad_norm``."""
        cfg: Zero123UnifiedConfig = self.cfg
        mod = self.modules
        sched = mod.schedule
        dev = mod.device
        T = sched.num_train_timesteps
        B = rgb.shape[0]
        latents = mod.encode_images(rgb)
        shape = tuple(latents.shape)
        draws = []
        for given, dshape, normal in ((u, (B,), False), (noise, shape, True), (u2, (B,), False),
                                      (noise2, shape, True)):
            draws.append((given if given is not None else _draw(generator, dshape, normal, dev)).to(
                dev, torch.float32))
        u, noise, u2, noise2 = draws
        if cfg.vsd_lora_cfg_training and drop is None:
            drop = _draw(generator, (B,), False, dev) < cfg.vsd_lora_uncond_prob
        cam = camera_condition.to(dev)
        latents_sg = latents.detach()
        with torch.no_grad():
            context, c_concat_in = self._conditioning(bank, elevation, azimuth, camera_distances,
                                                      frame_indices, B)
            cc, c_concat = context[B:], c_concat_in[B:]
            t, _, _ = sds_timesteps(cfg, u, step, T)
            latents_noisy = add_noise(sched, latents_sg, noise, t)
            eps_pretrain = self._eps(latents_noisy, t, context, c_concat_in)
            x_cat = torch.cat([latents_noisy, c_concat], 1)
            if cfg.vsd_guidance_scale_phi != 1.0 and cfg.vsd_use_camera_condition:
                # the "unconditional" half: a zero camera, still one token
                p_cam, p_unc = self._apply_phi(lora, torch.cat([x_cat, x_cat]), torch.cat([t, t]),
                                               torch.cat([cc, cc]),
                                               torch.cat([cam, torch.zeros_like(cam)])).chunk(2)
                eps_phi = p_unc + cfg.vsd_guidance_scale_phi * (p_cam - p_unc)
            else:
                eps_phi = self._apply_phi(lora, x_cat, t, cc, cam)
            w = (1.0 - sched.alphas_cumprod[t]).reshape(-1, 1, 1, 1)
            grad = torch.nan_to_num(w * (eps_pretrain - eps_phi))
            if cfg.grad_clip is not None:
                grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
            target = latents_sg - grad
        loss_vsd = 0.5 * ((latents - target) ** 2).sum() / B

        t2 = torch.clamp((u2 * T).to(torch.int32), 1, T - 1).long()
        noisy2 = add_noise(sched, latents_sg, noise2, t2)
        cam_lora = cam
        if cfg.vsd_lora_cfg_training:
            flat = cam.reshape(B, -1)
            cam_lora = torch.where(drop.to(dev).reshape(B, 1), torch.zeros_like(flat), flat)
        eps_lora = self._apply_phi(lora, torch.cat([noisy2, c_concat], 1), t2, cc, cam_lora)
        loss_lora = ((eps_lora - noise2) ** 2).mean()
        return {"loss_vsd": loss_vsd, "loss_lora": loss_lora, "grad_norm": torch.linalg.norm(grad)}

    def loss(self, bank: Dict[str, torch.Tensor], rgb: torch.Tensor, elevation: torch.Tensor,
             azimuth: torch.Tensor, camera_distances: torch.Tensor, step: int,
             frame_indices: Optional[torch.Tensor] = None, camera_condition: Optional[torch.Tensor] = None,
             lora=None, generator: Optional[torch.Generator] = None, **draws) -> Dict[str, torch.Tensor]:
        """``guidance_type`` dispatch: ``vsd`` → :meth:`vsd_loss` (it needs
        ``lora`` and ``camera_condition``), else ``Zero123Guidance.sds_loss``."""
        cfg: Zero123UnifiedConfig = self.cfg
        if cfg.guidance_type == "vsd":
            if lora is None or camera_condition is None:
                raise ValueError("guidance_type vsd needs lora and camera_condition")
            return self.vsd_loss(bank, lora, rgb, elevation, azimuth, camera_distances, camera_condition,
                                 frame_indices, step, generator, **draws)
        return self.sds_loss(bank, rgb, elevation, azimuth, camera_distances, frame_indices, step, generator,
                             **draws)

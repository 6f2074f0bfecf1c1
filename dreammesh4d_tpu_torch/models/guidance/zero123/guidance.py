"""Stable Zero123 SDS guidance, static and temporal (counterpart of
``dreammesh4d_tpu/models/guidance/zero123/guidance.py``).

- conditioning: the CLIP image embedding ⊕ the camera ΔT [Δpolar,
  sin Δazimuth, cos Δazimuth, 90° − cond elevation] through
  ``cc_projection`` (772 → 768, identity-initialised); classifier-free
  guidance on a batch of 2B (zero conditioning first);
- a per-frame embedding bank (every frame's CLIP embedding and VAE latent,
  computed once), indexed by ``frame_indices`` in the temporal variant;
- SDS: the render resized to 256² (``ops.resize``, bilinear), VAE-encoded
  (× 0.18215), t ~ U[min_step, max_step], noise added, the UNet on the 2B
  batch, w(t) = 1 − ᾱ_t, and the reparameterised MSE whose gradient in the
  latents is w(t) (ε̂ − ε) / B;
- ``min/max_step_percent`` may be schedules, evaluated at the step.

The modules hold the LDM checkpoint's key layout as their own
``state_dict()``: ``model.diffusion_model.*`` (UNet),
``first_stage_model.*`` (VAE), ``cc_projection.*`` and, with CLIP,
``cond_stage_model.model.visual.*``.  Tensors are NCHW inside; renders come
in as (B, H, W, 3) in [0, 1].  The guidance's weights are frozen.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ....ops.resize import resize_hw
from ....registry import register
from ....utils.schedule import _normalize, _segments
from .clip import VisionTransformer
from .scheduler import add_noise, ddim_step, make_schedule
from .unet import UNetModel, init_weights, set_compute_dtype
from .vae import AutoencoderKL

LATENT_SCALE = 0.18215  # the LDM's scale_factor

DTYPES = {"float32": torch.float32, "fp32": torch.float32, "bfloat16": torch.bfloat16,
          "bf16": torch.bfloat16, "float16": torch.bfloat16, "fp16": torch.bfloat16}


@dataclass
class Zero123Config:
    pretrained_model_name_or_path: str = ""
    pretrained_config: str = ""
    cond_image_path: str = ""
    cond_elevation_deg: float = 0.0
    cond_azimuth_deg: float = 0.0
    cond_camera_distance: float = 1.2
    guidance_scale: float = 3.0
    grad_clip: Optional[float] = None
    min_step_percent: Any = 0.02
    max_step_percent: Any = 0.98
    num_train_timesteps: int = 1000
    # architecture (defaults: the shipped Stable Zero123; shrink for tests)
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    num_heads: int = 8
    context_dim: int = 768
    vae_ch: int = 128
    vae_ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    vae_num_res_blocks: int = 2
    latent_size: int = 32
    image_size: int = 256
    dtype: Any = torch.float32
    use_clip: bool = True  # False: a mean-colour projector stands in for CLIP (tests)
    # random weights (``random[:seed]``) keep the LDM's zero-initialised
    # output convolutions; False draws them too, so that every layer reaches
    # the noise prediction (a check of the UNet's tensor-parallel split)
    zero_init: bool = True
    # the CLIP vision tower (defaults: ViT-L/14); its projection is
    # clip_hidden_size → context_dim
    clip_hidden_size: int = 1024
    clip_layers: int = 24
    clip_heads: int = 16
    clip_intermediate: int = 4096
    clip_image_size: int = 224
    clip_patch_size: int = 14

    def __post_init__(self):
        # "float16"/"fp16" run in bfloat16, as in the JAX package
        if isinstance(self.dtype, str):
            try:
                self.dtype = DTYPES[self.dtype.lower()]
            except KeyError:
                raise ValueError(f"guidance.dtype {self.dtype!r} not in {sorted(DTYPES)}")
        self.channel_mult = tuple(self.channel_mult)
        self.vae_ch_mult = tuple(self.vae_ch_mult)


def config_from_dict(gcfg: dict) -> Zero123Config:
    """``Zero123Config`` from ``system.guidance``, ignoring the keys it does
    not have (``guidance_render_size``, ``allow_missing``, …)."""
    names = {f.name for f in dataclasses.fields(Zero123Config)}
    return Zero123Config(**{k: v for k, v in dict(gcfg).items() if k in names})


class _Holder(nn.Module):
    """A named level of the LDM checkpoint's key layout."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


class Zero123Modules(nn.Module):
    """The UNet, the VAE, ``cc_projection`` and the CLIP tower (or, with
    ``use_clip: false``, the mean-colour projector ``clip_proj``), placed on
    ``device`` with their weights frozen; ``state_dict()`` is the LDM
    checkpoint's layout.  Parameters are uninitialised until
    :meth:`init_params` or a ``load_state_dict``."""

    def __init__(self, cfg: Zero123Config, device="cuda"):
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            unet = UNetModel(in_channels=8, out_channels=4, model_channels=cfg.model_channels,
                             channel_mult=cfg.channel_mult, num_res_blocks=cfg.num_res_blocks,
                             num_heads=cfg.num_heads, context_dim=cfg.context_dim)
            vae = AutoencoderKL(embed_dim=4, ch=cfg.vae_ch, ch_mult=cfg.vae_ch_mult,
                                num_res_blocks=cfg.vae_num_res_blocks)
            self.model = _Holder(diffusion_model=unet)
            self.first_stage_model = vae
            self.cc_projection = nn.Linear(cfg.context_dim + 4, cfg.context_dim)
            if cfg.use_clip:
                visual = VisionTransformer(
                    image_size=cfg.clip_image_size, patch_size=cfg.clip_patch_size,
                    width=cfg.clip_hidden_size, layers=cfg.clip_layers, heads=cfg.clip_heads,
                    mlp=cfg.clip_intermediate, output_dim=cfg.context_dim)
                self.cond_stage_model = _Holder(model=_Holder(visual=visual))
        self.to_empty(device=torch.device(device))
        if not cfg.use_clip:
            self.register_buffer("clip_proj", torch.zeros(3, cfg.context_dim, device=device))
        self.requires_grad_(False)
        for part in (self.unet, self.vae, self.clip):
            if part is not None:
                set_compute_dtype(part, cfg.dtype)
        self.schedule = make_schedule(cfg.num_train_timesteps, device=device)

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    @property
    def vae(self) -> AutoencoderKL:
        return self.first_stage_model

    @property
    def clip(self) -> Optional[VisionTransformer]:
        return self.cond_stage_model.model.visual if self.cfg.use_clip else None

    @property
    def device(self) -> torch.device:
        return self.cc_projection.weight.device

    def ldm_keys(self) -> list:
        """The keys a Stable Zero123 checkpoint supplies (``clip_proj``, the
        stand-in for CLIP, is not one of them)."""
        return [k for k in self.state_dict() if k != "clip_proj"]

    def zero_init_names(self) -> list:
        return [f"model.diffusion_model.{n}" for n in self.unet.zero_init_names()]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator, zero_init: bool = True) -> "Zero123Modules":
        """Random weights drawn from ``generator`` (``unet.init_weights``;
        the draws differ from the JAX package's ``jax.random`` ones).
        ``zero_init`` keeps the LDM's zero-initialised output convolutions,
        as the JAX package's ``init_params`` does: the UNet then returns
        zeros.  ``cc_projection`` is the identity on the CLIP embedding and
        zero on the camera; without CLIP, ``clip_proj`` is N(0, 0.02²)."""
        init_weights(self, generator, set(self.zero_init_names()) if zero_init else set())
        ctx = self.cfg.context_dim
        self.cc_projection.weight.copy_(torch.eye(ctx, ctx + 4))
        self.cc_projection.bias.zero_()
        if self.clip is None:
            x = torch.randn(tuple(self.clip_proj.shape), generator=generator, device=generator.device)
            self.clip_proj.copy_(0.02 * x)
        return self

    # ---------------- apply ----------------
    def _vae_input(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] → (B, 3, S, S) in [−1, 1], bilinear to S."""
        S = self.cfg.image_size
        rgb = resize_hw(rgb, S, S, "bilinear")
        return (rgb * 2.0 - 1.0).permute(0, 3, 1, 2)

    def encode_images(self, rgb: torch.Tensor) -> torch.Tensor:
        """Latents (B, 4, L, L) × 0.18215: the posterior mean, differentiable
        in ``rgb``."""
        return (self.vae.encode_moments(self._vae_input(rgb))[0] * LATENT_SCALE).float()

    def encode_cond_latent(self, rgb: torch.Tensor) -> torch.Tensor:
        """The conditioning latent: the posterior mode, unscaled."""
        return self.vae.encode_mode(self._vae_input(rgb)).float()

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, 4, L, L) → (B, S, S, 3) in [0, 1]."""
        img = self.vae.decode(latents / LATENT_SCALE).float()
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)

    def clip_embed(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] → (B, context_dim)."""
        if self.clip is not None:
            return self.clip.embed(rgb)
        return rgb.mean(dim=(1, 2)) @ self.clip_proj


def camera_delta_T(elevation, azimuth, camera_distances, cond_elevation_deg: float,
                   cond_azimuth_deg: float) -> torch.Tensor:
    """Stable Zero123's relative camera: [Δpolar (rad), sin Δazimuth,
    cos Δazimuth, deg2rad(90 − cond elevation)] → (B, 4)."""
    d_polar = torch.deg2rad((90.0 - elevation) - (90.0 - cond_elevation_deg))
    d_azim = torch.deg2rad(azimuth - cond_azimuth_deg)
    last = torch.deg2rad(90.0 - torch.full_like(elevation, cond_elevation_deg))
    return torch.stack([d_polar, torch.sin(d_azim), torch.cos(d_azim), last], -1)


def schedule_f32(value: Any, step: int) -> np.float32:
    """A ``C()`` schedule at ``step`` in the float32 arithmetic, and order,
    of the JAX package's ``C_jax``: the SDS timestep is truncated from it, so
    a float64 evaluation would move t by one at integer boundaries."""
    f32 = np.float32
    if isinstance(value, (int, float)):
        return f32(value)
    segs = _segments(_normalize(list(value)))
    s = f32(step)
    out = f32(segs[0][1])
    for ss, sv, ev, es in segs:
        t = np.clip((s - f32(ss)) / f32(max(es - ss, 1e-8)), f32(0.0), f32(1.0))
        seg = f32(sv) + f32(ev - sv) * t
        if s >= f32(ss):
            out = seg
    return out


def linspace_int_f32(start: int, stop: int, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num).astype(int32)`` as XLA computes it:
    start·(1 − s) + stop·s in float32 with s = i·(1/div) (the division by
    ``div`` is a multiplication by its float32 reciprocal; a true division
    truncates e.g. 119.99999 where JAX gets 120), the stop appended."""
    div = num - 1
    step = np.arange(div, dtype=np.float32) * (np.float32(1.0) / np.float32(div))
    vals = np.float32(start) * (np.float32(1.0) - step) + np.float32(stop) * step
    return np.concatenate([vals, [np.float32(stop)]]).astype(np.int32)


def sds_timesteps(cfg: Zero123Config, u: torch.Tensor, step: int, T: int):
    """(t, min_p, max_p): t = int32(min_p·T + u·(max_p − min_p)·T) in
    float32, in the JAX package's order, clipped to [1, T − 1]."""
    min_p = torch.tensor(schedule_f32(cfg.min_step_percent, step), device=u.device)
    max_p = torch.tensor(schedule_f32(cfg.max_step_percent, step), device=u.device)
    t = (min_p * T + u * (max_p - min_p) * T).to(torch.int32)
    return torch.clamp(t, 1, T - 1).long(), min_p, max_p


def _draw(generator: torch.Generator, shape, normal: bool, device) -> torch.Tensor:
    fn = torch.randn if normal else torch.rand
    return fn(tuple(shape), generator=generator, device=generator.device).to(device)


class StableZero123Guidance:
    """The static guidance (one reference image); the temporal variant
    indexes the per-frame bank by ``frame_indices``.  Both share
    :meth:`sds_loss`."""

    def __init__(self, cfg: Zero123Config, modules: Optional[Zero123Modules] = None,
                 device="cuda"):
        self.cfg = cfg
        self.modules = modules if modules is not None else Zero123Modules(cfg, device=device)

    @torch.no_grad()
    def prepare_embeddings(self, images: torch.Tensor, chunk: int = 4) -> Dict[str, torch.Tensor]:
        """images (F, H, W, 3) in [0, 1] (white-composited) → the bank:
        ``c_crossattn`` (F, context_dim) and ``c_concat`` (F, 4, L, L),
        encoded ``chunk`` frames at a time."""
        mod = self.modules
        images = torch.as_tensor(images, dtype=torch.float32, device=mod.device)
        cc, cl = [], []
        for i in range(0, images.shape[0], chunk):
            part = images[i:i + chunk]
            cc.append(mod.clip_embed(part).float())
            cl.append(mod.encode_cond_latent(part))
        return {"c_crossattn": torch.cat(cc), "c_concat": torch.cat(cl)}

    def camera_embedding(self, elevation, azimuth, camera_distances) -> torch.Tensor:
        """The relative camera ΔT (B, 4) that joins the CLIP embedding."""
        return camera_delta_T(elevation, azimuth, camera_distances, self.cfg.cond_elevation_deg,
                              self.cfg.cond_azimuth_deg)

    def _conditioning(self, bank, elevation, azimuth, camera_distances, frame_indices, B):
        """The CFG batch's context (2B, 1, ctx) and conditioning latent (2B, 4, L, L)."""
        mod = self.modules
        dev = mod.device
        f_idx = (torch.zeros(B, dtype=torch.long, device=dev) if frame_indices is None
                 else torch.as_tensor(frame_indices, device=dev).long())
        T_cam = self.camera_embedding(elevation.to(dev), azimuth.to(dev), camera_distances.to(dev))
        cc = mod.cc_projection(torch.cat([bank["c_crossattn"][f_idx], T_cam], -1))[:, None, :]
        c_concat = bank["c_concat"][f_idx]
        return (torch.cat([torch.zeros_like(cc), cc]),
                torch.cat([torch.zeros_like(c_concat), c_concat]))

    def _eps(self, x, t, context, c_concat_in):
        """Classifier-free-guided noise prediction at x (B, 4, L, L)."""
        x_in = torch.cat([torch.cat([x, x]), c_concat_in], 1)
        e_u, e_c = self.modules.unet(x_in, torch.cat([t, t]), context).chunk(2)
        return e_u + self.cfg.guidance_scale * (e_c - e_u)

    def sds_loss(self, bank: Dict[str, torch.Tensor], rgb: torch.Tensor, elevation: torch.Tensor,
                 azimuth: torch.Tensor, camera_distances: torch.Tensor,
                 frame_indices: Optional[torch.Tensor], step: int,
                 generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 rows: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
        """SDS of the renders ``rgb`` (B, H, W, 3).  ``u`` (B,) in [0, 1)
        picks t and ``noise`` (B, 4, L, L) is ε; each is drawn from
        ``generator`` (u first) when not given.  ``rows = (offset, total)``
        says that ``rgb`` holds rows [offset, offset + B) of a batch of
        ``total`` (one data-parallel rank's share): the draws are then the
        whole batch's, of which these rows are kept.  Returns ``loss_sds``
        (its gradient reaches ``rgb``), ``grad_norm``, ``min_step``,
        ``max_step`` and the timesteps ``t``."""
        cfg, mod = self.cfg, self.modules
        sched = mod.schedule
        dev = mod.device
        T = sched.num_train_timesteps
        B = rgb.shape[0]
        latents = mod.encode_images(rgb)
        with torch.no_grad():
            context, c_concat_in = self._conditioning(bank, elevation, azimuth, camera_distances,
                                                      frame_indices, B)
            lo, total = rows or (0, B)
            if u is None:
                u = _draw(generator, (total,), False, dev)[lo:lo + B]
            if noise is None:
                noise = _draw(generator, (total,) + tuple(latents.shape[1:]), True, dev)[lo:lo + B]
            noise = noise.to(dev, torch.float32)
            t, min_p, max_p = sds_timesteps(cfg, u.to(dev, torch.float32), step, T)
            latents_noisy = add_noise(sched, latents.detach(), noise, t)
            eps = self._eps(latents_noisy, t, context, c_concat_in)
            w = (1.0 - sched.alphas_cumprod[t]).reshape(-1, 1, 1, 1)
            grad = torch.nan_to_num(w * (eps - noise))
            if cfg.grad_clip is not None:
                grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
            target = latents.detach() - grad
        loss_sds = 0.5 * ((latents - target) ** 2).sum() / B
        return {"loss_sds": loss_sds, "grad_norm": torch.linalg.norm(grad),
                "min_step": min_p * T, "max_step": max_p * T, "t": t}

    @torch.no_grad()
    def guidance_eval(self, bank, rgb, elevation, azimuth, camera_distances, frame_indices=None,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None, t_frac: float = 0.3,
                      n_denoise_steps: int = 25) -> Dict[str, torch.Tensor]:
        """What SDS sees: the noised render at t = t_frac·T, the one-step x0
        prediction and a DDIM denoise from t over ``n_denoise_steps`` even
        steps, each decoded to (B, S, S, 3)."""
        mod = self.modules
        sched = mod.schedule
        dev = mod.device
        B = rgb.shape[0]
        latents = mod.encode_images(rgb)
        context, c_concat_in = self._conditioning(bank, elevation, azimuth, camera_distances,
                                                  frame_indices, B)
        t0 = int(t_frac * sched.num_train_timesteps)
        t = torch.full((B,), t0, dtype=torch.long, device=dev)
        if noise is None:
            noise = _draw(generator, latents.shape, True, dev)
        x_t = add_noise(sched, latents, noise.to(dev, torch.float32), t)
        a_t = sched.alphas_cumprod[t].reshape(-1, 1, 1, 1)
        x0_1step = (x_t - torch.sqrt(1 - a_t) * self._eps(x_t, t, context, c_concat_in)) / torch.sqrt(a_t)
        ts = linspace_int_f32(t0, 0, n_denoise_steps + 1).tolist()
        x = x_t
        for t_cur, t_prev in zip(ts[:-1], ts[1:]):
            tc = torch.full((B,), t_cur, dtype=torch.long, device=dev)
            tp = torch.full((B,), t_prev if t_prev else -1, dtype=torch.long, device=dev)
            x = ddim_step(sched, x, self._eps(x, tc, context, c_concat_in), tc, tp)
        return {"img_noisy": mod.decode_latents(x_t), "img_1step": mod.decode_latents(x0_1step),
                "img_final": mod.decode_latents(x)}


@register("stable-zero123-guidance")
class StableZero123GuidanceComponent(StableZero123Guidance):
    pass


@register("temporal-stable-zero123-guidance")
class TemporalStableZero123Guidance(StableZero123Guidance):
    """The same computation; callers pass the frames' ``frame_indices``
    into the per-frame bank."""


def zero123_delta_T(elevation, azimuth, camera_distances, cond_elevation_deg: float,
                    cond_azimuth_deg: float, cond_camera_distance: float) -> torch.Tensor:
    """The vanilla Zero123 relative camera: [Δpolar (rad), sin Δazimuth,
    cos Δazimuth, distance − cond distance] → (B, 4)."""
    d_polar = torch.deg2rad((90.0 - elevation) - (90.0 - cond_elevation_deg))
    d_azim = torch.deg2rad(azimuth - cond_azimuth_deg)
    return torch.stack([d_polar, torch.sin(d_azim), torch.cos(d_azim),
                        camera_distances - cond_camera_distance], -1)


@register("zero123-guidance")
class Zero123Guidance(StableZero123Guidance):
    """The vanilla Zero123 conditioning (counterpart of
    ``unified.Zero123Guidance`` of the JAX package): the same SDS, with the
    distance delta as the camera embedding's fourth entry.

    ``find("zero123-guidance")`` gives this class.  The launcher does not:
    as the JAX launcher does, it builds the stable variant whatever
    ``system.guidance_type`` says (``systems/assembly.maybe_build_guidance``)."""

    def camera_embedding(self, elevation, azimuth, camera_distances) -> torch.Tensor:
        cfg = self.cfg
        return zero123_delta_T(elevation, azimuth, camera_distances, cfg.cond_elevation_deg,
                               cfg.cond_azimuth_deg, cfg.cond_camera_distance)

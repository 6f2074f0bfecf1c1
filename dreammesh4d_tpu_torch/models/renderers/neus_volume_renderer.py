"""NeuS volume renderer over the implicit SDF, ``neus-volume-renderer``
(counterpart of ``dreammesh4d_tpu/models/renderers/neus_volume_renderer.py``,
:32-122).

The NeRF renderer's static importance-sampling skeleton (``ray_bbox_intersect``,
``sample_pdf``) with NeuS alphas from the SDF at the samples and a learned
inverse standard deviation s = exp(log_s):

    α_i = clip((Φ_s(sdf_i) − Φ_s(sdf_{i+1})) / max(Φ_s(sdf_i), 1e-6), 0, 1),  Φ_s = sigmoid(s·x)

composited front to back.  The coarse SDF is evaluated without a graph
(the JAX package stops its gradient), but the importance samples stay a
function of log_s through the PDF.  Every ray of the call is rendered at
once; the eikonal residual is the mean of (|∇sdf| − 1)².  The random
numbers — the coarse jitter (R, S1), then the fine strata (R, S2) — are
given or drawn from a ``torch.Generator`` in that order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ...ops.safe_math import safe_norm, safe_normalize
from ..geometry.implicit_sdf import ImplicitSDFConfig, forward_field_sdf, forward_sdf, sdf_gradient
from .nerf_volume_renderer import draw_uniform, ray_bbox_intersect, sample_pdf


@dataclass
class NeuSRendererConfig:
    num_samples_coarse: int = 64
    num_samples_fine: int = 64
    radius: float = 2.0
    near: float = 0.05
    learned_variance_init: float = 0.3
    cos_anneal_end: int = 0


def init_neus_variance(cfg: NeuSRendererConfig, device="cuda") -> Dict[str, torch.Tensor]:
    """``{"log_s"}``: the log of the initial inverse standard deviation."""
    return {"log_s": torch.tensor(math.log(1.0 / cfg.learned_variance_init), dtype=torch.float32,
                                  device=device)}


def neus_alphas(sdf: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """sdf (R, S) at the samples → alphas (R, S − 1) by the CDF ratio."""
    cdf = torch.sigmoid(sdf * inv_s)
    alpha = (cdf[:, :-1] - cdf[:, 1:]) / torch.clamp(cdf[:, :-1], min=1e-6)
    return torch.clamp(alpha, 0.0, 1.0)


def render_rays_neus(geo_params, var_params, geo_cfg: ImplicitSDFConfig, rcfg: NeuSRendererConfig,
                     rays_o: torch.Tensor, rays_d: torch.Tensor, bg_color: torch.Tensor,
                     generator: Optional[torch.Generator] = None, level_mask=None,
                     jitter: Optional[torch.Tensor] = None,
                     jitter_fine: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Render (R,) rays.  Stratified when a ``generator`` or the draws are
    given (``jitter`` (R, S1), ``jitter_fine`` (R, S2)); bin centres
    otherwise."""
    R = rays_o.shape[0]
    dev = rays_o.device
    S1, S2 = rcfg.num_samples_coarse, rcfg.num_samples_fine
    t_near, t_far = ray_bbox_intersect(rays_o, rays_d, rcfg.radius, rcfg.near)
    inv_s = torch.exp(var_params["log_s"])
    if generator is not None and jitter is None:
        jitter = draw_uniform(generator, (R, S1), dev)
        jitter_fine = draw_uniform(generator, (R, S2), dev)

    su = (torch.arange(S1 + 1, dtype=torch.float32, device=dev) / S1)[None, :]
    bins = t_near[:, None] + (t_far - t_near)[:, None] * su
    if jitter is not None:
        t_coarse = bins[:, :-1] + jitter * (t_far - t_near)[:, None] / S1
    else:
        t_coarse = 0.5 * (bins[:, :-1] + bins[:, 1:])
    with torch.no_grad():
        pts_c = rays_o[:, None] + t_coarse[..., None] * rays_d[:, None]
        sdf_c = forward_sdf(geo_params, geo_cfg, pts_c, level_mask)[..., 0]
    w_c = neus_alphas(sdf_c, inv_s)
    w_c = torch.cat([w_c, torch.zeros_like(w_c[:, :1])], -1)

    t_fine = sample_pdf(bins, w_c[:, :-1] + 1e-3, S2, None, jitter=jitter_fine)
    t_all = torch.sort(torch.cat([t_coarse, t_fine], -1), -1).values  # (R, S)
    pts = rays_o[:, None] + t_all[..., None] * rays_d[:, None]
    sdf, features = forward_field_sdf(geo_params, geo_cfg, pts, level_mask)
    sdf = sdf[..., 0]

    alpha = neus_alphas(sdf, inv_s)  # (R, S-1)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    weights = alpha * trans
    opacity = weights.sum(-1, keepdim=True)

    grad = sdf_gradient(geo_params, geo_cfg, pts[:, :-1], level_mask)
    normal = safe_normalize(grad)
    albedo = torch.sigmoid(features[:, :-1, :3])
    comp_rgb_fg = (weights[..., None] * albedo).sum(-2)
    depth = (weights * t_all[:, :-1]).sum(-1, keepdim=True)
    comp_normal = safe_normalize((weights[..., None] * normal).sum(-2))
    comp_rgb = comp_rgb_fg + (1.0 - opacity) * bg_color.expand(comp_rgb_fg.shape)
    eik = ((safe_norm(grad) - 1.0) ** 2).mean()
    return {
        "comp_rgb": comp_rgb,
        "comp_normal": comp_normal * 0.5 + 0.5,
        "opacity": opacity,
        "depth": depth,
        "weights": weights,
        "normal": normal,
        "t_dirs": rays_d[:, None].expand(normal.shape),
        "sdf": sdf,
        "inv_std": inv_s,
        "eikonal": eik,
    }

"""SuGaR Gaussian renderer (rgb + normal + depth + mask), one view at a time
(counterpart of ``dreammesh4d_tpu/models/renderers/sugar_rasterizer.py``).

The per-Gaussian colour channels are CONCATENATED (rgb ⊕ normal) and blended
in one pass — six colour channels plus depth, C = 7 in the compositing
kernel.  Outputs are channel-last ``(B, H, W, C)``: comp_rgb / comp_depth /
comp_mask / comp_normal / raw_normal + radii / visibility_filter.  Normal
and depth gradients are kept only where alpha > 0.99.  :func:`depth_to_normal`
derives a normal map from a rendered depth map (the normal–depth consistency
term of the static refine stage).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ...ops.cameras import GSCameraInfo
from ...ops.gs.rasterize import RasterizerConfig, rasterize
from ...ops.quaternion import cross
from ...ops.safe_math import safe_normalize
from ...ops.sh import sh_to_rgb


class CameraBatch(NamedTuple):
    """Stacked per-view GS camera transforms (leading batch dim B)."""

    world_view: torch.Tensor  # (B, 4, 4)
    full_proj: torch.Tensor  # (B, 4, 4)
    camera_center: torch.Tensor  # (B, 3)


def _grad_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Keep the value everywhere, the gradient only where ``mask``."""
    return torch.where(mask, x, x.detach())


def render_view(means3d, quats, scales, opacities, sh, sh_degree: int,
                gs_normals: Optional[torch.Tensor], camera: GSCameraInfo,
                bg_color: torch.Tensor, cfg: RasterizerConfig) -> Dict[str, torch.Tensor]:
    """Render one view with fused rgb+normal channels (``gs_normals=None``
    drops the 3 normal channels)."""
    dirs = means3d - camera.camera_center[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8)
    rgb = sh_to_rgb(sh_degree, sh, dirs)  # (N,3)
    if gs_normals is None:
        colors, bg = rgb, bg_color
    else:
        colors = torch.cat([rgb, gs_normals], -1)  # (N,6)
        bg = torch.cat([bg_color, bg_color.new_zeros(3)], 0)

    out = rasterize(means3d, opacities, camera, cfg, bg, colors=colors, quats=quats,
                    scales=scales, device=means3d.device)
    alpha = out.alpha
    mask99 = alpha > 0.99
    res = {
        "comp_rgb": torch.clamp(out.rgb[..., :3], 0.0, 1.0),
        "comp_depth": _grad_mask(out.depth, mask99),
        "comp_mask": alpha,
        "radii": out.radii,
        "visibility_filter": out.radii > 0,
    }
    if gs_normals is not None:
        raw_normal = safe_normalize(out.rgb[..., 3:6])
        res["comp_normal"] = _grad_mask(raw_normal * 0.5 * alpha + 0.5, mask99)
        res["raw_normal"] = _grad_mask(raw_normal, mask99)
    return res


def render_batch(means3d, quats, scales, opacities, sh, sh_degree: int, gs_normals,
                 cameras: CameraBatch, bg_color: torch.Tensor, cfg: RasterizerConfig,
                 timed_attrs: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
    """Render the B views one after another and stack the outputs.  With
    ``timed_attrs = (means, quats, scales, normals)`` (leading B dim, the
    dynamic-stage path) each view takes its own attributes; otherwise the
    static ones broadcast.  ``bg_color`` may be (3,) shared or (B, 3)."""
    B = cameras.world_view.shape[0]
    bg_b = bg_color if bg_color.ndim == 2 else bg_color.expand(B, bg_color.shape[-1])
    outs = []
    for i in range(B):
        cam = GSCameraInfo(cameras.world_view[i], cameras.full_proj[i], cameras.camera_center[i])
        if timed_attrs is None:
            m, q, s, n = means3d, quats, scales, gs_normals
        else:
            t_means, t_quats, t_scales, t_normals = timed_attrs
            m, q, s = t_means[i], t_quats[i], t_scales[i]
            n = None if t_normals is None else t_normals[i]
        outs.append(render_view(m, q, s, opacities, sh, sh_degree, n, cam, bg_b[i], cfg))
    return {k: torch.stack([o[k] for o in outs], 0) for k in outs[0]}


def depth_to_normal(depth: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    alpha: torch.Tensor) -> torch.Tensor:
    """Normals from the depth map by finite differences of the world-space
    positions (``sugar_rasterizer.py:173``): depth/alpha (..., H, W, 1),
    rays (..., H, W, 3); returns n·0.5·alpha + 0.5 in [0, 1].  The
    differences are ``jnp.gradient``'s: central inside, one-sided at the
    edges (``torch.gradient``'s ``edge_order=1``)."""
    xyz = rays_o + depth * rays_d
    (dx,) = torch.gradient(xyz, dim=-2)
    (dy,) = torch.gradient(xyz, dim=-3)
    n = safe_normalize(cross(dy, dx))
    return n * 0.5 * alpha + 0.5

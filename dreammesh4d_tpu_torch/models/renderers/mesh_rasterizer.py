"""Mesh rasterization renderers, ``nvdiff-rasterizer`` and ``patch-renderer``
(counterpart of ``dreammesh4d_tpu/models/renderers/mesh_rasterizer.py``,
:28-144).

:class:`MeshRasterizer` index-renders a triangle mesh with the port's tile
z-buffer (``ops/mesh_raster.rasterize_mesh``), interpolates vertex normals
and positions at the hits and shades them with a ``material_fn`` and a
``background_fn`` (the materials and backgrounds of ``models/materials.py``
and ``models/background.py`` fit).  No screen-space antialiasing: the
silhouettes are hard and the vertex gradients come through the barycentric
interpolation, as in the JAX package.  Faces are binned by depth alone, so
zero-area faces (the masked slots of a marching-tets surface, all at
vertex 0) take tile slots around vertex 0's projection exactly as there.

:class:`PatchRenderer` renders a downsampled global image plus one
full-resolution patch and pastes the patch into the upsampled global
render; the resize is ``ops/resize.resize_hw`` (``jax.image.resize``'s
bilinear) and the patch offset is given or drawn from a generator.

Both render where their inputs are; ``device`` is accepted for the
registry's common signature.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ...ops.mesh_raster import interpolate_attribute, rasterize_mesh
from ...ops.meshops import vertex_normals
from ...ops.resize import resize_hw
from ...ops.safe_math import safe_normalize
from ...registry import register
from ..registry_names import _dc


@dataclass
class MeshRasterizerConfig:
    tile_capacity: int = 256
    max_tiles_per_face: int = 64


@register("nvdiff-rasterizer")
class MeshRasterizer:
    """Call with per-view ``GSCameraInfo`` cameras and the callables
    ``feature_fn(positions) -> features`` (the geometry's query),
    ``material_fn(features, viewdirs=, shading_normal=, positions=) -> rgb``
    and ``background_fn(dirs) -> rgb``."""

    def __init__(self, cfg: dict | None = None, device="cuda"):
        self.cfg = c = _dc(MeshRasterizerConfig, cfg)
        self.tile_capacity = c.tile_capacity
        self.max_tiles_per_face = c.max_tiles_per_face

    def render_view(self, verts: torch.Tensor, faces: torch.Tensor, camera, camera_position: torch.Tensor,
                    H: int, W: int, feature_fn: Optional[Callable] = None,
                    material_fn: Optional[Callable] = None, background_fn: Optional[Callable] = None,
                    v_nrm: Optional[torch.Tensor] = None, render_rgb: bool = True) -> Dict[str, torch.Tensor]:
        if v_nrm is None:
            v_nrm = vertex_normals(verts, faces)
        rast = rasterize_mesh(verts, faces, camera, W, H, self.tile_capacity, self.max_tiles_per_face)
        mask = (rast.face_idx >= 0)[..., None].float()
        gb_normal = safe_normalize(interpolate_attribute(rast, faces, v_nrm))
        out = {
            "opacity": mask,
            "comp_normal": (gb_normal + 1.0) / 2.0 * mask,
            "depth": torch.where(torch.isfinite(rast.depth), rast.depth, torch.zeros_like(rast.depth))[..., None],
        }
        if not render_rgb:
            return out
        gb_pos = interpolate_attribute(rast, faces, verts)
        gb_viewdirs = safe_normalize(gb_pos - camera_position[None, None, :])
        feats = feature_fn(gb_pos) if feature_fn is not None else gb_pos * 0.5 + 0.5
        if material_fn is not None:
            rgb_fg = material_fn(feats, viewdirs=gb_viewdirs, shading_normal=gb_normal, positions=gb_pos)
        else:
            rgb_fg = feats[..., :3]
        rgb_bg = background_fn(gb_viewdirs) if background_fn is not None else torch.ones_like(rgb_fg)
        out["comp_rgb_bg"] = rgb_bg
        out["comp_rgb"] = rgb_bg * (1 - mask) + rgb_fg * mask
        return out

    def __call__(self, verts, faces, cameras, camera_positions, H, W, **kw) -> Dict[str, torch.Tensor]:
        """Every view in turn, stacked (B, H, W, C)."""
        outs = [self.render_view(verts, faces, cam, camera_positions[i], H, W, **kw)
                for i, cam in enumerate(cameras)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


@dataclass
class PatchRendererConfig:
    patch_size: int = 128
    global_downsample: int = 4
    global_detach: bool = False


@register("patch-renderer")
class PatchRenderer:
    """A low-resolution global render plus one full-resolution patch."""

    def __init__(self, cfg: dict | None = None, device="cuda"):
        self.cfg = c = _dc(PatchRendererConfig, cfg)
        self.patch_size, self.global_downsample, self.global_detach = (
            c.patch_size, c.global_downsample, c.global_detach)

    def __call__(self, base_renderer: Callable[..., Dict[str, torch.Tensor]], rays_o: torch.Tensor,
                 rays_d: torch.Tensor, generator: Optional[torch.Generator] = None, training: bool = True,
                 patch_yx: Optional[torch.Tensor] = None, **kwargs) -> Dict[str, torch.Tensor]:
        """``rays_o`` / ``rays_d`` (B, H, W, 3).  In training with a
        ``generator`` or a ``patch_yx`` (2,) offset: the global render at
        1/``global_downsample`` resized back to (H, W), the patch rendered
        at full resolution pasted in at the offset (drawn in [0, H − PS) and
        [0, W − PS), y first, when not given), and ``patch_yx``."""
        B, H, W, _ = rays_o.shape
        if not training or (generator is None and patch_yx is None):
            return base_renderer(rays_o, rays_d, **kwargs)
        d = self.global_downsample
        g_o = resize_hw(rays_o, H // d, W // d, "bilinear")
        g_d = resize_hw(rays_d, H // d, W // d, "bilinear")
        out_global = base_renderer(g_o, g_d, **kwargs)

        PS = self.patch_size
        if patch_yx is None:
            dev = generator.device
            py = torch.randint(0, H - PS, (), generator=generator, device=dev)
            px = torch.randint(0, W - PS, (), generator=generator, device=dev)
            patch_yx = torch.stack([py, px]).to(rays_o.device)
        # the offset clamped so that the patch fits, as dynamic_slice does
        py = min(max(int(patch_yx[0]), 0), H - PS)
        px = min(max(int(patch_yx[1]), 0), W - PS)
        out_patch = base_renderer(rays_o[:, py:py + PS, px:px + PS], rays_d[:, py:py + PS, px:px + PS],
                                  **kwargs)
        out = {}
        for k, v in out_global.items():
            pv = out_patch.get(k)
            if pv is None or not torch.is_tensor(v) or v.ndim != 4 or tuple(pv.shape[:3]) != (B, PS, PS):
                out[k] = v
                continue
            up = resize_hw(v, H, W, "bilinear")
            if self.global_detach:
                up = up.detach()
            up = up.clone()
            up[:, py:py + PS, px:px + PS] = pv
            out[k] = up
        out["patch_yx"] = torch.as_tensor([py, px], device=rays_o.device)
        return out

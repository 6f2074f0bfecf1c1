"""The threestudio zoo's latentnerf, sjc, fantasia3d, magic3d-refine and
textmesh train steps (counterpart of
``dreammesh4d_tpu/systems/threestudio_zoo2.py``, :46-135, :139-212,
:219-284, :293-334 and :347-419).

- ``latentnerf-system``: the field's feature head emits 4 channels that
  the renderer composites over a zero background (its channel count is the
  background's) and SDS reads as the latents themselves
  (``rgb_as_latents``); ``refinement`` switches to 3-channel rgb SDS.  With
  a sketch-shape guide (``ops/shape_loss.ShapeLoss``) the occupancy term
  ``shape_loss(pts, σ(pts)) / N`` joins, at N points drawn uniformly over
  the geometry's box each step.
- ``sjc-system``: a white background, the emptiness term
  log(1 + s·w) averaged over the ray weights and, with ``lambda_depth``,
  the centre-against-border depth contrast.
- ``fantasia3d-system``: the DMTet surface (``models/geometry/dmtet.py``)
  rasterized per view (``models/renderers/mesh_rasterizer.py``); the
  geometry phase feeds the normal map and the opacity to the guidance, the
  texture phase (``texture=True``) the rgb of the feature head; plus the
  normal consistency of the two face slots of each tet.
- ``magic3d-system``'s refine stage: rgb SDS on the rasterized DMTet
  surface plus the same normal consistency.
- ``textmesh-system``: SDS on a NeuS render of the implicit SDF
  (``models/renderers/neus_volume_renderer.py``), the eikonal term, the
  scheduled orientation term, sparsity and opacity; the state's tree is
  ``{"geo": the SDF's parameters, "var": {"log_s"}}``.

The steps share ``_rand_render``, ``_total``, ``_regularizers`` and
``_make_step`` with ``threestudio_zoo.py``: Adam lives in the state, one
``torch.Generator`` draws the renderer's numbers and then the guidance's
(and the shape term's points); the guidance closure takes ``(generator,
image, batch)`` (latentnerf's also ``rgb_as_latents``).  The classes
registered as ``fantasia3d-system``, ``textmesh-system`` and
``zero123-simple-system`` hold their config, as the JAX package's do.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..models.geometry.dmtet import TetSDFGridConfig, forward_features, isosurface
from ..models.geometry.implicit_volume import ImplicitVolumeConfig, forward_density
from ..models.renderers.mesh_rasterizer import MeshRasterizer
from ..models.renderers.nerf_volume_renderer import NeRFRendererConfig
from ..ops.meshops import face_normals
from ..ops.safe_math import safe_normalize
from ..registry import register
from .threestudio_zoo import _make_step, _rand_render, _regularizers, _total


def draw_uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) draws of the shape term's points (a function of its own so
    that tests can hand both packages the same numbers)."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device).to(device)


# ---------------------------------------------------------------------------
# latentnerf-system
# ---------------------------------------------------------------------------


@dataclass
class LatentNeRFLosses:
    lambda_sds: Any = 1.0
    lambda_orient: Any = field(default_factory=lambda: [0, 10.0, 1000.0, 5000])
    lambda_sparsity: Any = 0.0005
    lambda_opaque: Any = 0.0
    lambda_shape: Any = 5.0  # the sketch-shape guide's weight


def make_latentnerf_train_step(geo_cfg: ImplicitVolumeConfig, rcfg: NeRFRendererConfig,
                               losses: LatentNeRFLosses, guidance_fn: Callable, refinement: bool = False,
                               shape_loss: Optional[Callable] = None, shape_loss_samples: int = 4096,
                               device="cuda"):
    """``geo_cfg.n_feature_dims`` must be 4 unless ``refinement``;
    ``guidance_fn(generator, image (B, H, W, C), batch, rgb_as_latents)``.
    ``batch`` as the dreamfusion step's."""
    dev = torch.device(device)
    bg = torch.zeros((3 if refinement else 4,), dtype=torch.float32, device=dev)
    weights = {"sds": losses.lambda_sds, "orient": losses.lambda_orient,
               "sparsity": losses.lambda_sparsity, "opaque": losses.lambda_opaque}
    if shape_loss is not None:
        weights["shape"] = losses.lambda_shape

    def loss_fn(geo_params, batch, generator, step):
        out, B, H, W = _rand_render(geo_params, geo_cfg, rcfg, batch, bg, generator, None)
        img = out["comp_rgb"].reshape(B, H, W, out["comp_rgb"].shape[-1])
        terms = {"sds": guidance_fn(generator, img, batch, not refinement)}
        if shape_loss is not None:
            r = geo_cfg.radius
            pts = draw_uniform(generator, (shape_loss_samples, 3), dev) * (2.0 * r) - r
            sigmas = forward_density(geo_params, geo_cfg, pts)[..., 0]
            terms["shape"] = shape_loss(pts, sigmas) / shape_loss_samples
        _regularizers(out, terms)
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)


# ---------------------------------------------------------------------------
# sjc-system
# ---------------------------------------------------------------------------


@dataclass
class SJCLosses:
    lambda_sds: Any = 1.0
    lambda_emptiness: Any = field(default_factory=lambda: [10000, 10.0, 200.0, 20000])
    emptiness_scale: float = 10.0
    lambda_depth: Any = 0.0
    center_ratio: float = 0.78125


def make_sjc_train_step(geo_cfg: ImplicitVolumeConfig, rcfg: NeRFRendererConfig, losses: SJCLosses,
                        guidance_fn: Callable, bg_color=(1.0, 1.0, 1.0), device="cuda"):
    """``guidance_fn(generator, rgb, batch)``; ``batch`` as the dreamfusion
    step's.  The depth contrast pulls the centre crop (``center_ratio`` of
    each side) nearer than the border, in depth + 10·(1 − opacity)."""
    dev = torch.device(device)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)

    def loss_fn(geo_params, batch, generator, step):
        out, B, H, W = _rand_render(geo_params, geo_cfg, rcfg, batch, bg, generator, None)
        terms = {"sds": guidance_fn(generator, out["comp_rgb"].reshape(B, H, W, 3), batch),
                 "emptiness": torch.log1p(losses.emptiness_scale * out["weights"]).mean()}
        weights = {"sds": losses.lambda_sds, "emptiness": losses.lambda_emptiness}
        if losses.lambda_depth:
            comp_depth = out["depth"].reshape(B, H, W) + 10.0 * (1.0 - out["opacity"].reshape(B, H, W))
            ch, cw = int(losses.center_ratio * H), int(losses.center_ratio * W)
            bh, bw = (H - ch) // 2, (W - cw) // 2
            center = comp_depth[:, bh:bh + ch, bw:bw + cw]
            border_sum = comp_depth.sum((1, 2)) - center.sum((1, 2))
            terms["depth"] = -(border_sum / (H * W - ch * cw) - center.mean((1, 2))).mean()
            weights["depth"] = losses.lambda_depth
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)


# ---------------------------------------------------------------------------
# fantasia3d-system and magic3d's refine stage (the DMTet surface)
# ---------------------------------------------------------------------------


def _dmtet_normal_consistency(verts: torch.Tensor, faces: torch.Tensor, fmask: torch.Tensor) -> torch.Tensor:
    """Mean (1 − cos) between the two face slots of each tet (rows 2i and
    2i + 1 share an edge whenever both are real).  The normals divide by
    rsqrt(|n|² + eps), so a masked zero-area face gets a zero gradient, not
    a NaN."""
    n = safe_normalize(face_normals(verts, faces, normalize=False))  # (2T, 3)
    both = (fmask[0::2] & fmask[1::2]).float()
    cos = (n[0::2] * n[1::2]).sum(-1)
    return ((1.0 - cos) * both).sum() / torch.clamp(both.sum(), min=1.0)


def _render_dmtet_views(geo_params, geo_cfg: TetSDFGridConfig, cameras, camera_positions, H: int, W: int,
                        raster: MeshRasterizer, with_rgb: bool):
    """Every view of the current surface, its masked slots as (0, 0, 0)
    faces; returns (outputs, (verts, faces, face_mask))."""
    surf = isosurface(geo_params, geo_cfg)
    feature_fn = (lambda p: forward_features(geo_params, geo_cfg, p)) if with_rgb else None
    out = raster(surf.verts, surf.faces, cameras, camera_positions, H, W, feature_fn=feature_fn)
    return out, (surf.verts, surf.faces, surf.face_mask)


@dataclass
class Fantasia3DLosses:
    lambda_sds: Any = 1.0
    lambda_normal_consistency: Any = 10000.0


def make_fantasia3d_train_step(geo_cfg: TetSDFGridConfig, losses: Fantasia3DLosses, guidance_fn: Callable,
                               raster: Optional[MeshRasterizer] = None, texture: bool = False, H: int = 64,
                               W: int = 64, device="cuda"):
    """``batch``: ``cameras`` (a list of ``GSCameraInfo``), ``camera_positions``
    (B, 3) and what the guidance reads.  The geometry phase
    (``texture=False``) hands the guidance the normal map in [0, 1] with the
    opacity (B, H, W, 4); the texture phase the rgb (B, H, W, 3)."""
    dev = torch.device(device)
    raster = raster or MeshRasterizer(device=dev)
    weights = {"sds": losses.lambda_sds, "normal_consistency": losses.lambda_normal_consistency}

    def loss_fn(geo_params, batch, generator, step):
        out, (verts, faces, fmask) = _render_dmtet_views(
            geo_params, geo_cfg, batch["cameras"], batch["camera_positions"], H, W, raster, with_rgb=texture)
        image = out["comp_rgb"] if texture else torch.cat([out["comp_normal"], out["opacity"]], -1)
        terms = {"sds": guidance_fn(generator, image, batch),
                 "normal_consistency": _dmtet_normal_consistency(verts, faces, fmask)}
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)


@dataclass
class Magic3DLosses:
    lambda_sds: Any = 1.0
    lambda_normal_consistency: Any = 1000.0


def make_magic3d_refine_train_step(geo_cfg: TetSDFGridConfig, losses: Magic3DLosses, guidance_fn: Callable,
                                   raster: Optional[MeshRasterizer] = None, H: int = 64, W: int = 64,
                                   device="cuda"):
    """Rgb SDS on the rasterized DMTet surface plus normal consistency;
    ``batch`` as the fantasia3d step's."""
    dev = torch.device(device)
    raster = raster or MeshRasterizer(device=dev)
    weights = {"sds": losses.lambda_sds, "normal_consistency": losses.lambda_normal_consistency}

    def loss_fn(geo_params, batch, generator, step):
        out, (verts, faces, fmask) = _render_dmtet_views(
            geo_params, geo_cfg, batch["cameras"], batch["camera_positions"], H, W, raster, with_rgb=True)
        terms = {"sds": guidance_fn(generator, out["comp_rgb"], batch),
                 "normal_consistency": _dmtet_normal_consistency(verts, faces, fmask)}
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)


# ---------------------------------------------------------------------------
# textmesh-system (the NeuS-rendered implicit SDF)
# ---------------------------------------------------------------------------


@dataclass
class TextMeshLosses:
    lambda_sds: Any = 1.0
    lambda_orient: Any = field(default_factory=lambda: [0, 10.0, 1000.0, 5000])
    lambda_sparsity: Any = 1.0
    lambda_opaque: Any = 0.0
    lambda_eikonal: Any = 1000.0


def make_textmesh_train_step(geo_cfg, rcfg, losses: TextMeshLosses, guidance_fn: Callable,
                             bg_color=(1.0, 1.0, 1.0), device="cuda"):
    """``batch``: ``rays_o`` / ``rays_d`` (B, H, W, 3) and what the guidance
    reads; the state's tree is ``{"geo", "var"}`` (``init_scene_state`` of
    it).  The surface exports through ``implicit_sdf.export_sdf_grid`` and
    the mc-cpu isosurface."""
    from ..models.renderers.neus_volume_renderer import render_rays_neus

    dev = torch.device(device)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    weights = {"sds": losses.lambda_sds, "eikonal": losses.lambda_eikonal, "orient": losses.lambda_orient,
               "sparsity": losses.lambda_sparsity, "opaque": losses.lambda_opaque}

    def loss_fn(params, batch, generator, step):
        B, H, W = batch["rays_o"].shape[:3]
        out = render_rays_neus(params["geo"], params["var"], geo_cfg, rcfg, batch["rays_o"].reshape(-1, 3),
                               batch["rays_d"].reshape(-1, 3), bg, generator)
        terms = {"sds": guidance_fn(generator, out["comp_rgb"].reshape(B, H, W, 3), batch),
                 "eikonal": out["eikonal"]}
        _regularizers(out, terms)
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)


@register("fantasia3d-system")
@register("textmesh-system")
@register("zero123-simple-system")
class ConfigSystem:
    """The systems that only hold their config, as in the JAX package: their
    steps are the ``make_*_train_step`` above (the simplified zero123's is
    ``zero123_system``'s); registered for the configs' names."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

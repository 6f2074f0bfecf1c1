"""3D Gaussian splatting rasterizer — public API (counterpart of
``dreammesh4d_tpu/ops/gs/rasterize.py``).

    rasterize(means3d, opacities, camera, cfg, background, colors|sh,
              scales+quats|cov3d, device="cuda") -> (rgb, radii, depth, alpha)

Pipeline: EWA projection (projection.py) → binning with exact tile culling
(binning.py, on detached inputs: which pairs exist is not differentiated) →
per-tile front-to-back compositing.  Differentiable in means3d, scales,
quats / cov3d, colors / sh, opacities and the background.

Backends (``RasterizerConfig.backend``):
- ``pallas_resident`` — pair binning on ``tile_px`` tiles and the pair
  compositing of ``resident_blend.py``.  On CUDA tensors that is the
  hand-written Hopper kernel ``csrc/resident_fwd.cu`` (B1) and its backward
  ``csrc/resident_bwd.cu`` — ``bwd_accum: true`` sums the gradients per
  Gaussian inside the kernel (``resident_bwd_accum``, B2), ``false`` writes
  them per pair (``resident_bwd_pairs``, B3) and sums them with
  ``index_add_``; on CPU tensors their plain PyTorch versions.
- ``pallas`` — the (T, K) index table of ``bin_gaussians`` on fixed 16-px
  tiles whatever ``tile_px`` says, K = ``tile_capacity``, and the table
  compositing of ``table_blend.py``: on CUDA tensors the Hopper kernels B6
  and B7 (``table_fwd`` / ``table_bwd``, B1's and B2's bodies in
  ``csrc/resident_fwd.cu`` / ``resident_bwd.cu``), on CPU tensors their
  plain versions.  Tiles with more than K entries drop the farthest, and a
  Gaussian spanning more than ``max_tiles_per_gaussian`` 16-px tiles loses
  the rest, as in the JAX package.  The group (the entries between two
  tile-exit checks) comes from ``_auto_group``, which counts ``tile_px``
  tiles even here, as the JAX package does.
- ``xla`` — the pair path with the plain PyTorch compositing, forward and
  backward, on any device.

``RasterizerConfig`` accepts every field of the JAX package's config so every
YAML loads.  Fields that only chose a TPU strategy and that the port ignores:
``interpret`` (Pallas interpreter mode), ``group`` beyond its role as the
number of entries between two tile-exit checks, ``bf16_matmuls`` and
``grad_reduce`` (the port composites and reduces gradients in exact
float32), ``stream_rows`` (row dump for the TPU backward), ``chunk`` (the
XLA scan's chunk size).  ``binning: rank`` raises
``NotImplementedError`` (ROADMAP.md queue A, ``bin_gaussians_ranks``).
Unlike the JAX ``xla`` backend, which bins on fixed 16-px tiles, the port's
``xla`` backend uses ``tile_px`` like ``pallas_resident``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cameras import GSCameraInfo
from ..sh import sh_to_rgb
from .binning import bin_gaussians, bin_gaussians_pairs
from .projection import ProjectedGaussians, project_gaussians, project_gaussians_sq
from .resident_blend import blend_image_resident
from .table_blend import blend_image_table


class RasterizeOutput(NamedTuple):
    rgb: torch.Tensor  # (H, W, C)
    radii: torch.Tensor  # (N,) int32
    depth: torch.Tensor  # (H, W, 1)
    alpha: torch.Tensor  # (H, W, 1)


class RasterizerConfig(NamedTuple):
    """Rasterization settings; same fields and defaults as the JAX package.
    ``bf16_matmuls``, ``grad_reduce`` and ``stream_rows`` chose a TPU
    strategy and are ignored: the port computes in exact float32."""

    width: int
    height: int
    tan_fovx: float
    tan_fovy: float
    tile_capacity: int = 512
    max_tiles_per_gaussian: int = 16
    chunk: int = 32
    near: float = 0.2
    backend: str = "xla"
    interpret: bool = False
    group: int = 0  # pairs between tile-exit checks; 0 = auto (_auto_group)
    bwd_accum: bool = True
    bf16_matmuls: bool = False
    binning: str = "pairs"
    stream_rows: bool = True
    tile_px: int = 16
    grad_reduce: str = "vpu"


def rasterize(means3d, opacities, camera: GSCameraInfo, cfg: RasterizerConfig,
              background, colors=None, sh=None, sh_degree: int = 0, scales=None,
              quats=None, cov3d=None, means2d_offset=None,
              device="cuda") -> RasterizeOutput:
    """Render one view.  Pass either (scales, quats) or cov3d, and either
    per-Gaussian colors or SH coefficients (evaluated toward the camera).
    Every input is placed on ``device`` (default the card)."""
    dev = torch.device(device)

    def f32(x):
        if x is None or torch.is_tensor(x):
            return None if x is None else x.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    means3d, opacities, background = f32(means3d), f32(opacities), f32(background)
    colors, sh, scales, quats, cov3d = f32(colors), f32(sh), f32(scales), f32(quats), f32(cov3d)
    camera = GSCameraInfo(*(f32(x) for x in camera))
    if colors is None:
        if sh is None:
            raise ValueError("rasterize needs colors or sh")
        dirs = means3d - camera.camera_center[None, :]
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8)
        colors = sh_to_rgb(sh_degree, sh, dirs)

    if cov3d is None:
        if scales is None or quats is None:
            raise ValueError("rasterize needs cov3d or both scales and quats")
        proj = project_gaussians_sq(
            means3d, scales, quats, camera.world_view_transform,
            camera.full_proj_transform, cfg.tan_fovx, cfg.tan_fovy,
            cfg.width, cfg.height, cfg.near,
        )
    else:
        proj = project_gaussians(
            means3d, cov3d, camera.world_view_transform, camera.full_proj_transform,
            cfg.tan_fovx, cfg.tan_fovy, cfg.width, cfg.height, cfg.near,
        )
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + f32(means2d_offset))
    return _rasterize_projected(proj, colors, opacities, cfg, background)


def _auto_group(cfg: RasterizerConfig, n_gaussians: int) -> int:
    """Group size from the expected pairs per tile (the JAX package's
    heuristic; here it sets how often a tile checks for its exit)."""
    if cfg.group:
        return cfg.group
    tp = cfg.tile_px
    tiles = ((cfg.width + tp - 1) // tp) * ((cfg.height + tp - 1) // tp)
    avg = n_gaussians * cfg.max_tiles_per_gaussian / max(tiles, 1)
    return 128 if avg >= 640 else 32


def _rasterize_projected(proj: ProjectedGaussians, colors: torch.Tensor,
                         opacities: torch.Tensor, cfg: RasterizerConfig,
                         background: torch.Tensor) -> RasterizeOutput:
    group = _auto_group(cfg, proj.means2d.shape[0])
    if cfg.backend == "pallas":
        assign = bin_gaussians(
            proj.means2d.detach(), proj.radii, proj.depths.detach(), proj.mask, cfg.width,
            cfg.height, cfg.tile_capacity, cfg.max_tiles_per_gaussian,
            conics=proj.conics.detach(), opacities=opacities.detach(),
        )
        rgb, alpha, depth = blend_image_table(
            assign.tile_gauss, torch.clamp(assign.tile_counts, max=cfg.tile_capacity),
            proj.means2d, proj.conics, colors, opacities, proj.depths, cfg.width, cfg.height,
            background, group=group,
        )
        return RasterizeOutput(rgb, proj.radii, depth, alpha)
    if cfg.backend not in ("pallas_resident", "xla"):
        raise ValueError(f"unknown rasterizer backend {cfg.backend!r}")
    if cfg.backend == "pallas_resident" and cfg.binning == "rank":
        raise NotImplementedError(
            "binning 'rank' is not ported yet: ROADMAP.md queue A, bin_gaussians_ranks; "
            "use binning 'pairs'")
    pa = bin_gaussians_pairs(
        proj.means2d.detach(), proj.radii, proj.depths.detach(), proj.mask, cfg.width,
        cfg.height, cfg.max_tiles_per_gaussian, conics=proj.conics.detach(),
        opacities=opacities.detach(), tile=cfg.tile_px,
    )
    rgb, alpha, depth = blend_image_resident(
        pa, proj.means2d, proj.conics, colors, opacities, proj.depths,
        cfg.width, cfg.height, background, cap=cfg.tile_capacity, group=group, tile=cfg.tile_px,
        plain=cfg.backend == "xla", bwd_accum=cfg.bwd_accum,
    )
    return RasterizeOutput(rgb, proj.radii, depth, alpha)

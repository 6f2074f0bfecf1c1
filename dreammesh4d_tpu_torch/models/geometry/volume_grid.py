"""Dense voxel-grid geometry, ``volume-grid`` (counterpart of
``dreammesh4d_tpu/models/geometry/volume_grid.py``, :24-109).

A dense (1 + n_feature_dims, gx, gy, gz) grid holds the raw density and
the features; a query is a trilinear lookup (:func:`_trilerp`, the 8 corner
cells gathered and summed in the JAX package's order), the density takes
the ``blob_magic3d`` bias and the ``implicit-volume`` activations, the
features a sigmoid, and the normal is the negated finite-difference
gradient of the density.  The sketch-shape loss reads its baked grids
through :func:`_trilerp` too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops.safe_math import safe_normalize
from .implicit_volume import ImplicitVolumeConfig, _activate_density


@dataclass
class VolumeGridConfig:
    radius: float = 2.0
    grid_size: Tuple[int, int, int] = (100, 100, 100)
    n_feature_dims: int = 3
    density_activation: str = "softplus"
    density_bias: Any = "blob_magic3d"
    density_blob_scale: float = 5.0
    density_blob_std: float = 0.5
    normal_type: str = "finite_difference"
    finite_difference_eps: float = 0.01


def init_volume_grid(cfg: VolumeGridConfig, generator: Optional[torch.Generator] = None,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """The grid, N(0, 1e-2) per entry."""
    dev = torch.device(device)
    gen_dev = generator.device if generator is not None else dev
    shape = (1 + cfg.n_feature_dims,) + tuple(int(s) for s in cfg.grid_size)
    return {"grid": (1e-2 * torch.randn(shape, generator=generator, device=gen_dev)).to(dev)}


def _trilerp(grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation: ``grid`` (C, gx, gy, gz), ``x`` (N, 3) in
    [0, 1] (clipped) → (N, C).  The 8 corner cells are gathered and summed
    in the JAX package's order."""
    C = grid.shape[0]
    size = torch.tensor(grid.shape[1:], device=x.device)
    pos = torch.clamp(x, 0.0, 1.0) * (size.float() - 1)
    i0 = torch.minimum(torch.clamp(torch.floor(pos).long(), min=0), size - 2)
    f = pos - i0.float()  # (N, 3)
    out = torch.zeros((x.shape[0], C), dtype=grid.dtype, device=x.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                v = grid[:, i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]  # (C, N)
                out = out + w[:, None] * v.T
    return out


def _density_blob(cfg: VolumeGridConfig, points: torch.Tensor) -> torch.Tensor:
    if cfg.density_bias == "blob_magic3d":
        r = torch.linalg.norm(points, dim=-1)
        return cfg.density_blob_scale * (1 - r / cfg.density_blob_std)
    if isinstance(cfg.density_bias, (int, float)):
        return torch.full(points.shape[:-1], float(cfg.density_bias), device=points.device)
    raise ValueError(f"unknown density_bias {cfg.density_bias!r}")


def forward_field(params, cfg: VolumeGridConfig, points: torch.Tensor):
    """points (N, 3) in world space → (density (N, 1), features (N, F))."""
    x = (points / cfg.radius + 1.0) / 2.0
    vals = _trilerp(params["grid"], x)
    raw = vals[:, :1] + _density_blob(cfg, points)[:, None]
    density = _activate_density(ImplicitVolumeConfig(density_activation=cfg.density_activation), raw)
    features = torch.sigmoid(vals[:, 1:]) if cfg.n_feature_dims else vals[:, 1:]
    return density, features


def forward_density(params, cfg: VolumeGridConfig, points: torch.Tensor) -> torch.Tensor:
    return forward_field(params, cfg, points)[0]


def forward_normal(params, cfg: VolumeGridConfig, points: torch.Tensor) -> torch.Tensor:
    """−normalize(∇σ) by central differences at ± eps·radius per axis."""
    eps = cfg.finite_difference_eps * cfg.radius
    offs = points.new_tensor([[eps, 0, 0], [-eps, 0, 0], [0, eps, 0], [0, -eps, 0],
                              [0, 0, eps], [0, 0, -eps]])
    q = (points[:, None, :] + offs[None]).reshape(-1, 3)
    d = forward_density(params, cfg, q).reshape(-1, 6)
    grad = torch.stack([d[:, 0] - d[:, 1], d[:, 2] - d[:, 3], d[:, 4] - d[:, 5]], -1)
    return -safe_normalize(grad)


@torch.no_grad()
def export_density_grid(params, cfg: VolumeGridConfig, resolution: int) -> torch.Tensor:
    """The density on a ``resolution``³ lattice over the box (the mc-cpu
    export's input), on the grid's device."""
    dev = params["grid"].device
    lin = torch.as_tensor(np.linspace(-cfg.radius, cfg.radius, resolution, dtype=np.float32), device=dev)
    X, Y, Z = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([X, Y, Z], -1).reshape(-1, 3)
    return forward_density(params, cfg, pts).reshape(resolution, resolution, resolution)

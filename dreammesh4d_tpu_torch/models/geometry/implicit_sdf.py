"""Implicit SDF geometry, ``implicit-sdf`` (counterpart of
``dreammesh4d_tpu/models/geometry/implicit_sdf.py``, :25-106).

A corner hash grid over the box [-radius, radius]³ feeds an SDF MLP and a
feature MLP (ReLU,
``n_neurons`` × ``n_hidden_layers``).  The sphere shape init adds the
analytic sphere as a residual, sdf = 0.1·raw + |p| − r, so the zero level
set starts on the sphere.  ∇sdf, the eikonal term's input,
is analytic (``torch.autograd.grad`` with the graph kept inside a loss, so
the loss differentiates it once more) or central differences of six offset
queries (the default).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops.hashgrid import HashGridConfig, hashgrid_encode, init_hashgrid
from ...ops.safe_math import safe_norm, safe_normalize
from .implicit_volume import _mlp_apply, _mlp_init


@dataclass
class ImplicitSDFConfig:
    radius: float = 2.0
    n_feature_dims: int = 3
    shape_init: Optional[str] = "sphere"  # sphere | none
    shape_init_params: float = 0.5  # the sphere's radius
    normal_type: str = "finite_difference"  # analytic | finite_difference
    finite_difference_eps: float = 0.01
    hashgrid: HashGridConfig = field(default_factory=HashGridConfig)
    n_neurons: int = 64
    n_hidden_layers: int = 2


def init_implicit_sdf(cfg: ImplicitSDFConfig, generator: Optional[torch.Generator] = None,
                      device="cuda") -> Dict[str, Any]:
    dims = [cfg.hashgrid.out_dim] + [cfg.n_neurons] * cfg.n_hidden_layers
    return {
        "encoding": init_hashgrid(cfg.hashgrid, generator, device),
        "sdf_mlp": _mlp_init(generator, dims + [1], device),
        "feature_mlp": _mlp_init(generator, dims + [cfg.n_feature_dims], device),
    }


def _contract(cfg: ImplicitSDFConfig, points: torch.Tensor) -> torch.Tensor:
    return (points + cfg.radius) / (2 * cfg.radius)


def _sdf_of(params, cfg: ImplicitSDFConfig, points, enc) -> torch.Tensor:
    raw = _mlp_apply(params["sdf_mlp"], enc)
    if cfg.shape_init == "sphere":
        return raw * 0.1 + safe_norm(points, keepdims=True) - cfg.shape_init_params
    return raw


def forward_sdf(params, cfg: ImplicitSDFConfig, points: torch.Tensor, level_mask=None) -> torch.Tensor:
    """(..., 3) → (..., 1) signed distance, negative inside."""
    enc = hashgrid_encode(params["encoding"], cfg.hashgrid, _contract(cfg, points), level_mask)
    return _sdf_of(params, cfg, points, enc)


def forward_field_sdf(params, cfg: ImplicitSDFConfig, points: torch.Tensor,
                      level_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sdf (..., 1), features (..., n_feature_dims)) from one encoding."""
    enc = hashgrid_encode(params["encoding"], cfg.hashgrid, _contract(cfg, points), level_mask)
    return _sdf_of(params, cfg, points, enc), _mlp_apply(params["feature_mlp"], enc)


def sdf_gradient(params, cfg: ImplicitSDFConfig, points: torch.Tensor, level_mask=None) -> torch.Tensor:
    """Unnormalised ∇sdf (..., 3).  Analytic: differentiated where the
    points are (a learned sampler in front of them stays in the graph), the
    graph kept when grad mode is on.  Else central differences."""
    if cfg.normal_type == "analytic":
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            p = points if points.requires_grad else points.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(forward_sdf(params, cfg, p, level_mask).sum(), p,
                                       create_graph=keep)
        return g if keep else g.detach()
    eps = cfg.finite_difference_eps
    offsets = points.new_tensor([[eps, 0, 0], [-eps, 0, 0], [0, eps, 0], [0, -eps, 0],
                                 [0, 0, eps], [0, 0, -eps]])
    d = forward_sdf(params, cfg, points[..., None, :] + offsets, level_mask)[..., 0]
    return torch.stack([d[..., 0] - d[..., 1], d[..., 2] - d[..., 3], d[..., 4] - d[..., 5]],
                       -1) / (2 * eps)


def sdf_normal(params, cfg: ImplicitSDFConfig, points: torch.Tensor, level_mask=None) -> torch.Tensor:
    """Outward normals, normalize(∇sdf)."""
    return safe_normalize(sdf_gradient(params, cfg, points, level_mask))


@torch.no_grad()
def export_sdf_grid(params, cfg: ImplicitSDFConfig, resolution: int, chunk: int = 65536,
                    level_mask=None) -> np.ndarray:
    """The negated SDF (inside > 0, so the density-style isosurface export
    applies) on a ``resolution``³ lattice over the box, ``chunk`` points at
    a time on the parameters' device."""
    dev = params["sdf_mlp"][0]["w"].device
    lin = np.linspace(-cfg.radius, cfg.radius, resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    out = torch.empty((len(grid),), dtype=torch.float32, device=dev)
    for i in range(0, len(grid), chunk):
        pts = torch.as_tensor(grid[i: i + chunk], device=dev)
        out[i: i + chunk] = -forward_sdf(params, cfg, pts, level_mask)[..., 0]
    return out.cpu().numpy().reshape(resolution, resolution, resolution)

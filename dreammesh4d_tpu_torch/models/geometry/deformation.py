"""K-Planes/HexPlane deformation field + residual decoder heads (counterpart
of ``dreammesh4d_tpu/models/geometry/deformation.py``).

- 6 plane grids over (x, y, z, t) — all pairs of the 4 input dims — at
  resolutions ``multires × base_resolution`` (time resolution not scaled),
  ``grid_channels`` channels, bilinear interpolation, product over the 6
  planes, concatenation over scales;
- spatial planes init U(0.1, 0.5); time-touching planes init to 1;
- decoder: Linear trunk + four zero-init residual heads dx(3) /
  d-strain(6) / drot(4) / dopacity(1).

Parameters are a plain nested dict with the same tree as the JAX package's
``init_deformation`` (``grids[scale][plane]`` of shape (H, W, C),
``trunk[i].w/b``, ``head_*.res/out.w/b``), so weights carry across one to
one (``dreammesh4d_tpu_torch/convert.py``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


@dataclass
class DeformationConfig:
    net_width: int = 64
    defor_depth: int = 1
    grid_channels: int = 32
    base_resolution: Tuple[int, int, int, int] = (64, 64, 64, 25)
    multires: Tuple[int, ...] = (1, 2, 4, 8)
    bounds: float = 1.0
    d_scale: bool = True  # strain head
    d_rot: bool = True  # rotation head
    d_opacity: bool = True  # hybrid skinning blend weight


_COMBS = list(itertools.combinations(range(4), 2))  # [(0,1),(0,2),(0,3),(1,2),(1,3),(2,3)]


def _bilinear_sample(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample a (H, W, C) plane at normalized coords uv in [-1, 1]
    (align_corners semantics).  uv: (..., 2) ordered (x, y), x indexing W.
    The lower corner is clipped to [0, size-2] and the fractions to [0, 1]
    — written by hand because ``F.grid_sample`` differs at the borders."""
    H, W, C = plane.shape
    x = (uv[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (uv[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.clamp(torch.floor(x), 0, W - 2).long()
    y0 = torch.clamp(torch.floor(y), 0, H - 2).long()
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    p00 = plane[y0, x0]
    p01 = plane[y0, x0 + 1]
    p10 = plane[y0 + 1, x0]
    p11 = plane[y0 + 1, x0 + 1]
    return (
        p00 * (1 - fx) * (1 - fy)
        + p01 * fx * (1 - fy)
        + p10 * (1 - fx) * fy
        + p11 * fx * fy
    )


def init_deformation(cfg: DeformationConfig, generator: Optional[torch.Generator] = None,
                     device="cuda") -> Params:
    """Build the parameter tree.  Random draws come from ``generator`` (a
    ``torch.Generator`` on ``device``; a fresh one seeded 0 when omitted)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return lo + (hi - lo) * u

    grids: List[List[torch.Tensor]] = []
    for res_mult in cfg.multires:
        reso = [r * res_mult for r in cfg.base_resolution[:3]] + [cfg.base_resolution[3]]
        scale_planes = []
        for (a, b) in _COMBS:
            # stored (reso[b], reso[a], C) so uv=(coord_a, coord_b) samples (x=a, y=b)
            shape = (reso[b], reso[a], cfg.grid_channels)
            if 3 in (a, b):
                plane = torch.ones(shape, dtype=torch.float32, device=device)
            else:
                plane = uniform(shape, 0.1, 0.5)
            scale_planes.append(plane)
        grids.append(scale_planes)

    feat_dim = cfg.grid_channels * len(cfg.multires)
    W = cfg.net_width

    def dense(n_in, n_out):
        lim = float(np.sqrt(6.0 / (n_in + n_out)))  # xavier-uniform
        return {"w": uniform((n_in, n_out), -lim, lim),
                "b": torch.zeros((n_out,), dtype=torch.float32, device=device)}

    trunk = [dense(feat_dim, W)]
    for _ in range(cfg.defor_depth - 1):
        trunk.append(dense(W, W))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def res_head(n_out):
        # Linear_Res(W) + Linear(W, out), zero-init (residual)
        return {"res": {"w": zeros(W, W), "b": zeros(W)},
                "out": {"w": zeros(W, n_out), "b": zeros(n_out)}}

    return {
        "grids": grids,
        "trunk": trunk,
        "head_dx": res_head(3),
        "head_dstrain": res_head(6),
        "head_drot": res_head(4),
        "head_dopacity": res_head(1),
    }


def _apply_dense(p, x):
    return x @ p["w"] + p["b"]


def _apply_res_head(p, h):
    x = torch.relu(h)
    x = x + _apply_dense(p["res"], x)
    return _apply_dense(p["out"], x)


def hexplane_features(params: Params, pts: torch.Tensor, t: torch.Tensor,
                      bounds: float) -> torch.Tensor:
    """pts (..., 3) in world coords, t (...,) in [-1, 1].  Returns (..., feat)."""
    xyz = torch.clamp(pts / bounds, -1.0, 1.0)
    coords4 = torch.cat([xyz, t[..., None]], -1)  # (..., 4)
    feats = []
    for scale_planes in params["grids"]:
        interp = None
        for plane, (a, b) in zip(scale_planes, _COMBS):
            uv = torch.stack([coords4[..., a], coords4[..., b]], -1)
            s = _bilinear_sample(plane, uv)
            interp = s if interp is None else interp * s
        feats.append(interp)
    return torch.cat(feats, -1)


class DeformationDeltas(NamedTuple):
    dx: torch.Tensor  # (..., 3)
    drot: Optional[torch.Tensor]  # (..., 4) residual quaternion (added to identity)
    dstrain: Optional[torch.Tensor]  # (..., 6) strain tensor components
    dopacity: Optional[torch.Tensor]  # (..., 1)


def forward_dynamic_delta(params: Params, cfg: DeformationConfig,
                          pts: torch.Tensor, t: torch.Tensor) -> DeformationDeltas:
    """Query deltas at points/times."""
    h = hexplane_features(params, pts, t, cfg.bounds)
    for layer in params["trunk"][:1]:
        h = _apply_dense(layer, h)
    for layer in params["trunk"][1:]:
        h = _apply_dense(layer, torch.relu(h))
    dx = _apply_res_head(params["head_dx"], h)
    drot = _apply_res_head(params["head_drot"], h) if cfg.d_rot else None
    dstrain = _apply_res_head(params["head_dstrain"], h) if cfg.d_scale else None
    dop = _apply_res_head(params["head_dopacity"], h) if cfg.d_opacity else None
    return DeformationDeltas(dx, drot, dstrain, dop)


def strain_tensor_to_matrix(strain: torch.Tensor) -> torch.Tensor:
    """6-vector -> symmetric 3x3 strain matrix I + diag(s[:3]) + off-diag(s[3:])."""
    s0, s1, s2, o0, o1, o2 = strain.unbind(-1)
    one = torch.ones_like(s0)
    rows = [
        torch.stack([one + s0, o0, o1], -1),
        torch.stack([o0, one + s1, o2], -1),
        torch.stack([o1, o2, one + s2], -1),
    ]
    return torch.stack(rows, -2)


def plane_tv_loss(params: Params, only_time_planes: bool = False) -> torch.Tensor:
    """Total variation over the plane grids, averaged over the planes;
    ``only_time_planes`` keeps the three planes that touch t."""
    total = 0.0
    count = 0
    for scale_planes in params["grids"]:
        for plane, (a, b) in zip(scale_planes, _COMBS):
            if only_time_planes and 3 not in (a, b):
                continue
            dh = plane[1:] - plane[:-1]
            dw = plane[:, 1:] - plane[:, :-1]
            total = total + (dh ** 2).mean() + (dw ** 2).mean()
            count += 1
    return total / max(count, 1)

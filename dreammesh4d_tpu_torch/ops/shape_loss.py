"""The sketch-shape loss of latent-NeRF (counterpart of
``dreammesh4d_tpu/ops/shape_loss.py``, :1-130).

A guide mesh constrains the NeRF's occupancy: the cross-entropy between
the occupancy 1 − exp(−δ·σ) at detached points and the guide's
inside/outside indicator, weighted by 1 − exp(−d²/2σ_p²) so that the
geometry may leave the sketch near its surface but not far from it.

As in the JAX package the guide is baked once, at construction, into two
dense grids over [-bound, bound]³ (``grid_res``³ cells): the winding-number
occupancy (the exact van Oosterom–Strackee solid-angle sum, on the device,
in point chunks) and the weight from the nearest-VERTEX distance
(``scipy.spatial.cKDTree`` on the host).  Each step then reads both grids
by trilinear lookup (``models/geometry/volume_grid._trilerp``).

Kept from the JAX package (ROADMAP watch list): the grids cover
[-1, 1]³ (``bound`` 1) while the zoo's latentnerf step draws its points
over [-radius, radius]³ = [-2, 2]³, so most lookups clip to the grids'
boundary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..export.mesh_io import load_mesh
from ..models.geometry.volume_grid import _trilerp

# the fixed reorientation of guide shapes: rot_x(90°) @ rot_y(90°)
_GUIDE_ROT = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32) @ np.array(
    [[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)

# bytes of one (chunk, F, 3) float32 block of the winding number, by device
# type: about eight such blocks are alive at once; on the CPU blocks that stay
# in cache run twice as fast as large ones
WINDING_BLOCK_BYTES = {"cuda": 1 << 26, "cpu": 1 << 20}


def winding_number(points: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """Generalised winding number of ``points`` (N, 3) with respect to the
    triangle mesh (``verts`` (V, 3), ``faces`` (F, 3)): Σ_f ω_f / 4π with
    ω_f = 2·atan2(det[a b c], |a||b||c| + (a·b)|c| + (b·c)|a| + (c·a)|b|),
    a, b, c the corners relative to the point.  ``chunk`` points at a time
    (by default as many as keep a (chunk, F, 3) block within the device
    type's WINDING_BLOCK_BYTES)."""
    tv = verts[faces.long()]  # (F, 3, 3)
    if chunk is None:
        block = WINDING_BLOCK_BYTES.get(points.device.type, WINDING_BLOCK_BYTES["cuda"])
        chunk = max(1, block // (tv.shape[0] * 3 * 4))
    out = []
    for p in points.split(chunk):
        a = tv[None, :, 0] - p[:, None]  # (B, F, 3)
        b = tv[None, :, 1] - p[:, None]
        c = tv[None, :, 2] - p[:, None]
        la, lb, lc = a.norm(dim=-1), b.norm(dim=-1), c.norm(dim=-1)
        det = (a * torch.cross(b, c, dim=-1)).sum(-1)
        denom = la * lb * lc + (a * b).sum(-1) * lc + (b * c).sum(-1) * la + (c * a).sum(-1) * lb
        out.append((2.0 * torch.atan2(det, denom)).sum(-1) / (4.0 * math.pi))
    return torch.cat(out)


def _ce_pq(p: torch.Tensor, q: torch.Tensor, weight: Optional[torch.Tensor] = None,
           T: float = 1e-4) -> torch.Tensor:
    """Σ −[p·log q + (1 − p)·log(1 − q)], q clipped to [T, 1 − T]."""
    qc = torch.clamp(q, T, 1.0 - T)
    ce = -(p * torch.log(qc) + (1.0 - p) * torch.log(1.0 - qc))
    if weight is not None:
        ce = ce * weight
    return ce.sum()


@dataclass
class ShapeLoss:
    """``loss(xyzs (N, 3) world points, sigmas (N,)) -> scalar``; the points
    are detached, the gradient reaches ``sigmas``."""

    guide_shape: str
    mesh_scale: float = 0.7
    proximal_surface: float = 0.3
    delta: float = 0.2
    grid_res: int = 64
    bound: float = 1.0  # the grids cover [-bound, bound]^3
    device: Any = "cuda"

    def __post_init__(self):
        from scipy.spatial import cKDTree

        dev = torch.device(self.device)
        mesh = load_mesh(self.guide_shape)
        v = np.asarray(mesh.v_pos, np.float32)
        f = np.asarray(mesh.t_pos_idx, np.int32)
        # centre on the vertex mean, the largest radius scaled to mesh_scale, then reoriented
        v = v - v.mean(0)
        v = v / max(np.linalg.norm(v, axis=1).max(), 1e-8) * self.mesh_scale
        v = v @ _GUIDE_ROT.T
        self.n_faces = int(f.shape[0])

        R = self.grid_res
        axis = np.linspace(-self.bound, self.bound, R, dtype=np.float32)
        gx, gy, gz = np.meshgrid(axis, axis, axis, indexing="ij")
        pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
        with torch.no_grad():
            wn = winding_number(torch.as_tensor(pts, device=dev), torch.as_tensor(v, device=dev),
                                torch.as_tensor(f, device=dev))
        self.occ_grid = (wn > 0.5).float().reshape(R, R, R)
        self.weight_grid = None
        if self.proximal_surface > 0:
            d2, _ = cKDTree(v).query(pts, k=1)
            d2 = (d2 ** 2).astype(np.float32).reshape(R, R, R)
            self.weight_grid = torch.as_tensor(1.0 - np.exp(-d2 / (2.0 * self.proximal_surface ** 2)),
                                               device=dev)

    def _lookup(self, grid: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        u = torch.clamp((xyz + self.bound) / (2.0 * self.bound), 0.0, 1.0)
        return _trilerp(grid[None], u)[:, 0]

    def __call__(self, xyzs: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
        xyz = xyzs.detach().reshape(-1, 3)
        indicator = self._lookup(self.occ_grid, xyz)
        weight = self._lookup(self.weight_grid, xyz) if self.weight_grid is not None else None
        nerf_occ = torch.clamp(1.0 - torch.exp(-self.delta * sigmas.reshape(-1)), 0.0, 1.1)
        return _ce_pq(nerf_occ, indicator, weight)

"""3D Gaussian -> screen-space projection, EWA splatting (counterpart of
``dreammesh4d_tpu/ops/gs/projection.py``).

Conventions the rasterizer depends on:
- row-major GS camera transforms (p' = [p, 1] @ M);
- pixel means ``((ndc + 1)·W − 1)/2`` (no +0.5);
- 2D covariance J W Σ Wᵀ Jᵀ with the frustum-clamped Jacobian plus the
  0.3-pixel low-pass dilation;
- ``radius = ceil(3·sqrt(λ1))`` with the eigen-discriminant floored at
  sqrt(0.1); culled where depth ≤ near, det ≤ 0 or off screen;
- wxyz quaternions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..quaternion import quat_to_matrix


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixel coordinates
    depths: torch.Tensor  # (N,) view-space z
    conics: torch.Tensor  # (N, 3) upper-triangular inverse cov2d (a, b, c)
    radii: torch.Tensor  # (N,) int32 pixel radius (0 = culled)
    mask: torch.Tensor  # (N,) bool — in front of camera & nonzero extent


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Σ = R S Sᵀ Rᵀ from scales (N,3) and wxyz quats (N,4)."""
    R = quat_to_matrix(quats)
    M = R * scales[..., None, :]
    return M @ M.transpose(-1, -2)


def _conic_radius(a, b, c, means_x, means_y, depths, W, H, near):
    det = a * c - b * b
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))
    on_screen = (
        (means_x + radius_f > 0) & (means_x - radius_f < W)
        & (means_y + radius_f > 0) & (means_y - radius_f < H)
    )
    valid = (depths > near) & (det > 0) & on_screen
    radii = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    return conics, radii, valid


def project_gaussians_sq(means3d: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
                         world_view: torch.Tensor, full_proj: torch.Tensor,
                         tan_fovx: float, tan_fovy: float, W: int, H: int,
                         near: float = 0.2) -> ProjectedGaussians:
    """Projection from (scales, quats): cov2d = U Uᵀ with
    U[i,k] = s_k · (t_i · R[:,k]), t_i the rows of J·R_wv."""
    focal_x = W / (2.0 * tan_fovx)
    focal_y = H / (2.0 * tan_fovy)
    m0, m1, m2 = means3d.unbind(-1)

    def xform(M, j):  # row-vector convention: out_j = Σ_i p_i M[i, j] + M[3, j]
        return m0 * M[0, j] + m1 * M[1, j] + m2 * M[2, j] + M[3, j]

    pv0 = xform(world_view, 0)
    pv1 = xform(world_view, 1)
    depths = xform(world_view, 2)
    p_w = 1.0 / (xform(full_proj, 3) + 1e-7)
    ndc0 = xform(full_proj, 0) * p_w
    ndc1 = xform(full_proj, 1) * p_w
    mean_x = ((ndc0 + 1.0) * W - 1.0) * 0.5
    mean_y = ((ndc1 + 1.0) * H - 1.0) * 0.5
    means2d = torch.stack([mean_x, mean_y], -1)

    tz = depths
    lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(pv0 / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(pv1 / tz, -lim_y, lim_y) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z

    R_wv = world_view[:3, :3].T  # (3,3) world->view rotation
    a0 = focal_x * inv_z
    b0 = -focal_x * tx * inv_z2
    a1 = focal_y * inv_z
    b1 = -focal_y * ty * inv_z2
    t0j = [a0 * R_wv[0, j] + b0 * R_wv[2, j] for j in range(3)]
    t1j = [a1 * R_wv[1, j] + b1 * R_wv[2, j] for j in range(3)]

    w, x, y, z = quats.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    Rm = [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]
    s = scales.unbind(-1)
    u0 = [s[k] * (t0j[0] * Rm[0][k] + t0j[1] * Rm[1][k] + t0j[2] * Rm[2][k]) for k in range(3)]
    u1 = [s[k] * (t1j[0] * Rm[0][k] + t1j[1] * Rm[1][k] + t1j[2] * Rm[2][k]) for k in range(3)]

    a = u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2] + 0.3
    b = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2]
    c = u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2] + 0.3
    conics, radii, valid = _conic_radius(a, b, c, mean_x, mean_y, depths, W, H, near)
    return ProjectedGaussians(means2d, depths, conics, radii, valid)


def project_gaussians(means3d: torch.Tensor, cov3d: torch.Tensor,
                      world_view: torch.Tensor, full_proj: torch.Tensor,
                      tan_fovx: float, tan_fovy: float, W: int, H: int,
                      near: float = 0.2) -> ProjectedGaussians:
    """Projection from a precomputed 3D covariance (N, 3, 3)."""
    N = means3d.shape[0]
    focal_x = W / (2.0 * tan_fovx)
    focal_y = H / (2.0 * tan_fovy)
    hom = torch.cat([means3d, means3d.new_ones((N, 1))], -1)
    p_view = hom @ world_view[:, :3]
    p_hom = hom @ full_proj
    p_w = 1.0 / (p_hom[:, 3:4] + 1e-7)
    p_ndc = p_hom[:, :3] * p_w
    mean_x = ((p_ndc[:, 0] + 1.0) * W - 1.0) * 0.5
    mean_y = ((p_ndc[:, 1] + 1.0) * H - 1.0) * 0.5
    depths = p_view[:, 2]

    tz = depths
    lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(p_view[:, 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -lim_y, lim_y) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([focal_x * inv_z, zeros, -focal_x * tx * inv_z2], -1),
        torch.stack([zeros, focal_y * inv_z, -focal_y * ty * inv_z2], -1),
    ], -2)  # (N,2,3)
    T = J @ world_view[:3, :3].T
    cov2d = T @ cov3d @ T.transpose(-1, -2)
    a = cov2d[:, 0, 0] + 0.3
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + 0.3
    conics, radii, valid = _conic_radius(a, b, c, mean_x, mean_y, depths, W, H, near)
    return ProjectedGaussians(torch.stack([mean_x, mean_y], -1), depths, conics, radii, valid)

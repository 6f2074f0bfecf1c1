"""Camera and ray math (counterpart of ``dreammesh4d_tpu/ops/cameras.py``).

Cameras are OpenGL-style c2w matrices (camera looks down -z, y up).  NeRF
rays use them as they are (:func:`get_ray_directions`, :func:`get_rays`);
the GS path flips (y, z) to COLMAP convention and builds ROW-MAJOR
world->view and projection transforms (row-vector convention:
p' = [p, 1] @ M).  All functions broadcast over a leading batch axis and
compute in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .quaternion import cross


def get_ray_directions(H: int, W: int, focal: Union[float, Tuple[float, float]],
                       principal: Optional[Tuple[float, float]] = None,
                       use_pixel_centers: bool = True, device="cuda") -> torch.Tensor:
    """Per-pixel ray directions in the camera frame (H, W, 3); -z forward."""
    pixel_center = 0.5 if use_pixel_centers else 0.0
    if isinstance(focal, (int, float)):
        fx = fy = float(focal)
        cx, cy = W / 2.0, H / 2.0
    else:
        fx, fy = focal
        if principal is None:
            raise ValueError("a (fx, fy) focal needs the principal point")
        cx, cy = principal
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=device) + pixel_center,
        torch.arange(H, dtype=torch.float32, device=device) + pixel_center, indexing="xy")
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], -1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor, keepdim: bool = False,
             normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame directions -> world rays (rays_o, rays_d), for
    directions (N,3) / (H,W,3) / (B,H,W,3) with c2w (4,4) / (B,4,4)."""
    if directions.shape[-1] != 3:
        raise ValueError(f"directions must end in 3, got {tuple(directions.shape)}")
    if directions.ndim == 2:
        if c2w.ndim == 2:
            c2w = c2w[None]
        rays_d = (directions[:, None, :] * c2w[:, :3, :3]).sum(-1)
        rays_o = c2w[:, :3, 3].expand(rays_d.shape)
    elif directions.ndim == 3:
        if c2w.ndim == 2:
            rays_d = (directions[:, :, None, :] * c2w[None, None, :3, :3]).sum(-1)
            rays_o = c2w[None, None, :3, 3].expand(rays_d.shape)
        else:
            rays_d = (directions[None, :, :, None, :] * c2w[:, None, None, :3, :3]).sum(-1)
            rays_o = c2w[:, None, None, :3, 3].expand(rays_d.shape)
    elif directions.ndim == 4:
        if c2w.ndim != 3:
            raise ValueError("(B,H,W,3) directions need (B,4,4) c2w")
        rays_d = (directions[:, :, :, None, :] * c2w[:, None, None, :3, :3]).sum(-1)
        rays_o = c2w[:, None, None, :3, 3].expand(rays_d.shape)
    else:
        raise ValueError(f"Unsupported directions rank {directions.ndim}")
    if normalize:
        rays_d = rays_d / (torch.linalg.norm(rays_d, dim=-1, keepdim=True) + 1e-12)
    if not keepdim:
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    return rays_o, rays_d


def convert_pose(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL -> COLMAP pose conversion: flip the y and z axes."""
    flip = torch.diag(c2w.new_tensor([1.0, -1.0, -1.0, 1.0]))
    return c2w @ flip


def get_projection_matrix_gaussian(znear: float, zfar: float, fovx, fovy,
                                   device="cuda") -> torch.Tensor:
    """GS-style perspective projection, +z forward.  ``fovx``/``fovy`` may be
    (B,) tensors, giving (B, 4, 4)."""
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=device)
    fovx = torch.as_tensor(fovx, dtype=torch.float32, device=device)
    tan_y = torch.tan(fovy / 2.0)
    tan_x = torch.tan(fovx / 2.0)
    top = tan_y * znear
    right = tan_x * znear
    P = torch.zeros(fovy.shape + (4, 4), dtype=torch.float32, device=fovy.device)
    P[..., 0, 0] = 2.0 * znear / (2 * right)
    P[..., 1, 1] = 2.0 * znear / (2 * top)
    P[..., 3, 2] = 1.0
    P[..., 2, 2] = zfar / (zfar - znear)
    P[..., 2, 3] = -(zfar * znear) / (zfar - znear)
    return P


class GSCameraInfo(NamedTuple):
    """Row-major transforms consumed by the rasterizer."""

    world_view_transform: torch.Tensor  # (4,4) row-major w2c
    full_proj_transform: torch.Tensor  # (4,4) row-major w2c@proj
    camera_center: torch.Tensor  # (3,)


def get_cam_info_gaussian(c2w: torch.Tensor, fovx, fovy, znear: float,
                          zfar: float) -> GSCameraInfo:
    """c2w (4,4) or (B,4,4) OpenGL -> GS camera transforms (batched alike)."""
    c2w = convert_pose(torch.as_tensor(c2w, dtype=torch.float32))
    w2c = torch.linalg.inv(c2w)
    world_view = w2c.transpose(-1, -2)
    proj = get_projection_matrix_gaussian(znear, zfar, fovx, fovy,
                                          device=c2w.device).transpose(-1, -2)
    full_proj = world_view @ proj
    cam_center = c2w[..., :3, 3]
    return GSCameraInfo(world_view, full_proj, cam_center)


def camera_position_from_spherical(elevation_deg, azimuth_deg, distance,
                                   device="cuda") -> torch.Tensor:
    """x = d·cos(el)·cos(az), y = d·cos(el)·sin(az), z = d·sin(el)."""
    el = torch.deg2rad(torch.as_tensor(elevation_deg, dtype=torch.float32, device=device))
    az = torch.deg2rad(torch.as_tensor(azimuth_deg, dtype=torch.float32, device=device))
    d = torch.as_tensor(distance, dtype=torch.float32, device=device)
    return torch.stack(
        [d * torch.cos(el) * torch.cos(az), d * torch.cos(el) * torch.sin(az),
         d * torch.sin(el)], -1)


def look_at_c2w(camera_position: torch.Tensor, center: Optional[torch.Tensor] = None,
                up: Optional[torch.Tensor] = None) -> torch.Tensor:
    """OpenGL c2w from eye/center/up: rotation columns [right, up, -lookat]."""
    pos = torch.as_tensor(camera_position, dtype=torch.float32)
    batched = pos.ndim == 2
    if not batched:
        pos = pos[None]
    B = pos.shape[0]
    if center is None:
        center = torch.zeros_like(pos)
    else:
        center = torch.as_tensor(center, dtype=torch.float32, device=pos.device).expand_as(pos)
    if up is None:
        up = pos.new_tensor([0.0, 0.0, 1.0]).expand_as(pos)
    else:
        up = torch.as_tensor(up, dtype=torch.float32, device=pos.device).expand_as(pos)

    def norm(v):
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)

    lookat = norm(center - pos)
    right = norm(cross(lookat, up))
    up_real = norm(cross(right, lookat))
    rot = torch.stack([right, up_real, -lookat], dim=-1)  # columns
    c2w = torch.zeros((B, 4, 4), dtype=torch.float32, device=pos.device)
    c2w[:, :3, :3] = rot
    c2w[:, :3, 3] = pos
    c2w[:, 3, 3] = 1.0
    return c2w if batched else c2w[0]


def binary_cross_entropy(inputs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE written out, inputs clipped to [1e-6, 1 - 1e-6]."""
    eps = 1e-6
    x = torch.clamp(inputs, eps, 1.0 - eps)
    return -(target * torch.log(x) + (1 - target) * torch.log(1 - x)).mean()


def make_c2w_numpy(elevation_deg: float, azimuth_deg: float, distance: float,
                   center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """OpenGL c2w (4, 4) as numpy, computed on the host."""
    pos = camera_position_from_spherical(elevation_deg, azimuth_deg, distance, device="cpu")
    return look_at_c2w(pos, torch.as_tensor(center, dtype=torch.float32)).numpy()

"""Random-camera sampling on the host (numpy) and camera / ray batch assembly
on the device (counterpart of ``dreammesh4d_tpu/data/uncond.py``).

``RandomCameraSampler`` draws spherical cameras — elevation as a 50/50 mix
of uniform-in-angle and uniform-on-sphere, azimuth optionally stratified
over the batch, distance and fovy uniform in their ranges, optional camera /
centre / up perturbations, ``dreamfusion`` light positions — from
``np.random.RandomState(seed)``, in the same order of draws as the JAX
module: the same seed gives the same cameras, lights and rays, call for
call.  ``update(step)`` applies the resolution milestones and the
progressive view widening; ``orbit`` gives the deterministic evaluation
views.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models.renderers.sugar_rasterizer import CameraBatch
from ..ops import cameras as cam_ops
from ..registry import register


@dataclass
class RandomCameraConfig:
    # height / width / batch_size may be lists paired with resolution_milestones
    height: Any = 512
    width: Any = 512
    batch_size: Any = 4
    resolution_milestones: Tuple[int, ...] = ()
    eval_height: int = 512
    eval_width: int = 512
    eval_batch_size: int = 1
    elevation_range: Tuple[float, float] = (-10.0, 80.0)
    azimuth_range: Tuple[float, float] = (-180.0, 180.0)
    camera_distance_range: Tuple[float, float] = (3.8, 3.8)
    fovy_range: Tuple[float, float] = (20.0, 20.0)
    camera_perturb: float = 0.0
    center_perturb: float = 0.0
    up_perturb: float = 0.0
    light_position_perturb: float = 1.0
    light_distance_range: Tuple[float, float] = (7.5, 10.0)
    light_sample_strategy: str = "dreamfusion"
    batch_uniform_azimuth: bool = False
    progressive_until: int = 0
    eval_elevation_deg: float = 5.0
    eval_camera_distance: float = 3.8
    eval_fovy_deg: float = 20.0
    n_val_views: int = 30
    n_test_views: int = 120
    rays_d_normalize: bool = False
    znear: float = 0.01
    zfar: float = 100.0


def camera_batch_from_c2w(c2w, fovx, fovy, znear: float = 0.01, zfar: float = 100.0,
                          device="cuda") -> CameraBatch:
    """GS camera transforms of a batch of OpenGL c2w matrices (B, 4, 4) with
    per-view fovx / fovy (B,) in radians."""
    f32 = dict(dtype=torch.float32, device=device)
    info = cam_ops.get_cam_info_gaussian(torch.as_tensor(c2w, **f32), torch.as_tensor(fovx, **f32),
                                         torch.as_tensor(fovy, **f32), znear, zfar)
    return CameraBatch(info.world_view_transform, info.full_proj_transform, info.camera_center)


def assemble_camera_batch(positions: torch.Tensor, center: torch.Tensor, up: torch.Tensor,
                          fovy: torch.Tensor, znear: float = 0.01,
                          zfar: float = 100.0) -> CameraBatch:
    """GS camera transforms for B look-at cameras: positions/center/up
    (B, 3), fovy (B,) radians (square pixels: fovx = fovy)."""
    c2w = cam_ops.look_at_c2w(positions, center, up)  # (B,4,4)
    info = cam_ops.get_cam_info_gaussian(c2w, fovy, fovy, znear, zfar)
    return CameraBatch(info.world_view_transform, info.full_proj_transform,
                       info.camera_center)


def assemble_camera_rays(positions: torch.Tensor, center: torch.Tensor, up: torch.Tensor,
                         fovy: torch.Tensor, H: int, W: int, normalize: bool = False):
    """The ray half of the JAX ``assemble_camera_batch``: (c2w (B,4,4),
    rays_o (B,H,W,3), rays_d (B,H,W,3)) with pixel-centre directions from
    each view's own focal length."""
    c2w = cam_ops.look_at_c2w(positions, center, up)
    B = fovy.shape[0]
    f = (0.5 * H / torch.tan(0.5 * fovy))[:, None, None]
    i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=fovy.device) + 0.5,
                          torch.arange(H, dtype=torch.float32, device=fovy.device) + 0.5,
                          indexing="xy")
    dirs = torch.stack([i[None].expand(B, H, W) / f - (W / 2.0) / f,
                        -(j[None].expand(B, H, W) / f - (H / 2.0) / f),
                        -torch.ones((B, H, W), dtype=torch.float32, device=fovy.device)], -1)
    rays_o, rays_d = cam_ops.get_rays(dirs, c2w, keepdim=True, normalize=normalize)
    return c2w, rays_o, rays_d


def _spherical_positions(distances, elevation_deg, azimuth_deg) -> np.ndarray:
    el, az = np.radians(elevation_deg), np.radians(azimuth_deg)
    return np.stack([distances * np.cos(el) * np.cos(az), distances * np.cos(el) * np.sin(az),
                     distances * np.sin(el)], -1).astype(np.float32)


@register("random-camera-datamodule")
class RandomCameraSampler:
    """``random-camera-datamodule``: ``sample()`` draws a training batch,
    ``orbit()`` the evaluation views; tensors are placed on ``device``."""

    def __init__(self, cfg: RandomCameraConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.rng = np.random.RandomState(seed)
        self.elevation_range = list(cfg.elevation_range)
        self.azimuth_range = list(cfg.azimuth_range)
        as_list = lambda v: list(v) if isinstance(v, (list, tuple)) else [v]  # noqa: E731
        self.heights, self.widths = as_list(cfg.height), as_list(cfg.width)
        self.batch_sizes = as_list(cfg.batch_size)
        n = max(len(self.heights), len(self.batch_sizes))
        self.heights += [self.heights[-1]] * (n - len(self.heights))
        self.widths += [self.widths[-1]] * (n - len(self.widths))
        self.batch_sizes += [self.batch_sizes[-1]] * (n - len(self.batch_sizes))
        self.milestones = [-1] + list(cfg.resolution_milestones)[: n - 1]
        self.height = int(self.heights[0])
        self.width = int(self.widths[0])
        self.batch_size = int(self.batch_sizes[0])

    def update(self, step: int):
        """Resolution milestones and progressive view widening at ``step``."""
        cfg = self.cfg
        i = bisect.bisect_right(self.milestones, step) - 1
        self.height = int(self.heights[i])
        self.width = int(self.widths[i])
        self.batch_size = int(self.batch_sizes[i])
        if cfg.progressive_until > 0:
            r = min(1.0, step / cfg.progressive_until)
            self.elevation_range = [
                (1 - r) * cfg.eval_elevation_deg + r * cfg.elevation_range[0],
                (1 - r) * cfg.eval_elevation_deg + r * cfg.elevation_range[1],
            ]
            self.azimuth_range = [(1 - r) * 0.0 + r * cfg.azimuth_range[0],
                                  (1 - r) * 0.0 + r * cfg.azimuth_range[1]]

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def sample(self, batch_size: Optional[int] = None) -> dict:
        cfg = self.cfg
        B = batch_size or self.batch_size
        rng = self.rng

        # elevation: 50/50 uniform in angle / uniform on the sphere
        if rng.rand() < 0.5:
            elevation_deg = (rng.rand(B) * (self.elevation_range[1] - self.elevation_range[0])
                             + self.elevation_range[0])
        else:
            elo = math.sin(math.radians(self.elevation_range[0]))
            ehi = math.sin(math.radians(self.elevation_range[1]))
            elevation_deg = np.degrees(np.arcsin(rng.rand(B) * (ehi - elo) + elo))

        if cfg.batch_uniform_azimuth:
            span = (self.azimuth_range[1] - self.azimuth_range[0]) / B
            azimuth_deg = self.azimuth_range[0] + (np.arange(B) + rng.rand(B)) * span
        else:
            azimuth_deg = (rng.rand(B) * (self.azimuth_range[1] - self.azimuth_range[0])
                           + self.azimuth_range[0])

        distances = (rng.rand(B) * (cfg.camera_distance_range[1] - cfg.camera_distance_range[0])
                     + cfg.camera_distance_range[0])
        fovy_deg = rng.rand(B) * (cfg.fovy_range[1] - cfg.fovy_range[0]) + cfg.fovy_range[0]
        fovy = np.radians(fovy_deg)

        positions = _spherical_positions(distances, elevation_deg, azimuth_deg)
        center = np.zeros_like(positions) + rng.randn(B, 3).astype(np.float32) * cfg.center_perturb
        up = (np.asarray([[0, 0, 1.0]], np.float32).repeat(B, 0)
              + rng.randn(B, 3).astype(np.float32) * cfg.up_perturb)
        positions = positions + (rng.rand(B, 3).astype(np.float32) * 2 - 1) * cfg.camera_perturb

        # light positions, dreamfusion strategy
        light_distances = (rng.rand(B) * (cfg.light_distance_range[1] - cfg.light_distance_range[0])
                           + cfg.light_distance_range[0])
        local_z = positions / np.linalg.norm(positions, axis=-1, keepdims=True)
        light_direction = local_z + rng.randn(B, 3) * cfg.light_position_perturb
        light_direction = light_direction / np.linalg.norm(light_direction, axis=-1, keepdims=True)
        light_positions = (light_direction * light_distances[:, None]).astype(np.float32)

        pos_t, center_t, up_t, fovy_t = (self._f32(v) for v in (positions, center, up, fovy))
        c2w, rays_o, rays_d = assemble_camera_rays(pos_t, center_t, up_t, fovy_t, self.height,
                                                   self.width, cfg.rays_d_normalize)
        return {
            "rand_cameras": assemble_camera_batch(pos_t, center_t, up_t, fovy_t, cfg.znear, cfg.zfar),
            "c2w": c2w,
            "rays_o": rays_o,
            "rays_d": rays_d,
            "elevation": self._f32(elevation_deg),
            "azimuth": self._f32(azimuth_deg),
            "camera_distances": self._f32(distances),
            "light_positions": self._f32(light_positions),
            "fovy": fovy_t,
            "height": self.height,
            "width": self.width,
        }

    def mask_ray_directions(self, H: int, W: int, s_H: int, s_W: int) -> np.ndarray:
        """Flat pixel indices of an (s_H, s_W) stride grid with a random
        offset over the (H, W) image, denser toward the inner 3/4 crop."""
        rng = self.rng
        xs = np.linspace(0, 0.75 * W, s_W).astype(np.int64)
        ys = np.linspace(0, 0.75 * H, s_H).astype(np.int64)
        off_x = rng.randint(0, W // 8 + 1)
        off_y = rng.randint(0, H // 8 + 1)
        gx, gy = np.meshgrid(xs + off_x, ys + off_y, indexing="xy")
        return (gy * W + gx).reshape(-1)

    def sample_efficient(self, sample_height: int, sample_width: int,
                         batch_size: Optional[int] = None) -> dict:
        """Cameras at full (height, width) resolution with the rays
        subsampled to a (sample_height, sample_width) offset grid;
        ``ray_indices`` maps them back into the full image."""
        batch = self.sample(batch_size)
        H, W = self.height, self.width
        idx = self.mask_ray_directions(H, W, sample_height, sample_width)
        idx_t = torch.as_tensor(idx, device=self.device)
        B = batch["rays_o"].shape[0]
        for k in ("rays_o", "rays_d"):
            batch[k] = batch[k].reshape(B, H * W, 3)[:, idx_t].reshape(
                B, sample_height, sample_width, 3)
        batch.update({"ray_indices": idx_t.to(torch.int32), "sample_height": sample_height,
                      "sample_width": sample_width})
        return batch

    def orbit(self, n_views: Optional[int] = None, height: Optional[int] = None,
              width: Optional[int] = None) -> dict:
        """Deterministic evaluation orbit at the evaluation elevation."""
        cfg = self.cfg
        n = n_views or cfg.n_val_views
        azimuth_deg = np.linspace(0, 360.0, n + 1)[:n]
        elevation_deg = np.full(n, cfg.eval_elevation_deg)
        distances = np.full(n, cfg.eval_camera_distance)
        fovy = np.radians(np.full(n, cfg.eval_fovy_deg))
        positions = _spherical_positions(distances, elevation_deg, azimuth_deg)
        c2w = cam_ops.look_at_c2w(self._f32(positions))
        return {
            "rand_cameras": camera_batch_from_c2w(c2w, fovy, fovy, cfg.znear, cfg.zfar,
                                                  device=self.device),
            "c2w": c2w,
            "elevation": self._f32(elevation_deg),
            "azimuth": self._f32(azimuth_deg),
            "camera_distances": self._f32(distances),
            "fovy": self._f32(fovy),
            "height": height or cfg.eval_height,
            "width": width or cfg.eval_width,
        }

"""Single-image dataset: one reference RGBA image and a fixed camera
(``single-image-datamodule``, counterpart of ``dreammesh4d_tpu/data/image.py``).

Loads ``<name>_rgba.png`` (and, when a loss asks for them, ``_depth.png`` /
``_normal.png``), white-composites it, places the fixed camera from the
default elevation / azimuth / distance / fovy, pairs every train batch with
a random-camera batch, and switches the reference-view resolution at
``resolution_milestones``.  Images are read and resized by :mod:`.png` the
way ``cv2.imread`` + ``cv2.resize(INTER_AREA)`` read and resize them.
"""

from __future__ import annotations

import bisect
import math
import os
from dataclasses import dataclass, field
from typing import Any, Tuple

import numpy as np
import torch

from ..ops import cameras as cam_ops
from ..registry import register
from .png import read_png, resize_area
from .uncond import RandomCameraConfig, RandomCameraSampler, camera_batch_from_c2w


@dataclass
class SingleImageConfig:
    image_path: str = ""
    # int or list (paired with resolution_milestones)
    height: Any = 512
    width: Any = 512
    resolution_milestones: Tuple[int, ...] = ()
    default_elevation_deg: float = 5.0
    default_azimuth_deg: float = 0.0
    default_camera_distance: float = 3.8
    default_fovy_deg: float = 20.0
    requires_depth: bool = False
    requires_normal: bool = False
    use_random_camera: bool = True
    random_camera: RandomCameraConfig = field(default_factory=RandomCameraConfig)
    znear: float = 0.01
    zfar: float = 100.0


def load_rgba(path: str, height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """An RGBA image -> (rgb white-composited (H, W, 3), mask (H, W, 1)),
    float32 in [0, 1]."""
    img = read_png(path)
    if img.ndim != 3 or img.shape[-1] != 4:
        raise ValueError(f"{path} is not an RGBA image (shape {img.shape})")
    img = resize_area(img, height, width).astype(np.float32) / 255.0
    mask = img[..., 3:4]
    rgb = img[..., :3] * mask + (1.0 - mask)
    return rgb, (mask > 0.5).astype(np.float32)


def _load_gray(path: str, height: int, width: int) -> np.ndarray:
    """(H, W, 1) float in [0, 1] (a depth map); of a colour file the blue
    channel, the first of cv2's BGR order."""
    img = resize_area(read_png(path), height, width)
    if img.ndim == 3:
        img = img[..., 2]
    return (img.astype(np.float32) / 255.0)[..., None]


def _load_rgb(path: str, height: int, width: int) -> np.ndarray:
    """(H, W, 3) float in [0, 1] (a normal map)."""
    img = resize_area(read_png(path)[..., :3], height, width)
    return img.astype(np.float32) / 255.0


@register("single-image-datamodule")
class SingleImageDataModule:
    """Batches on ``device`` (default the card); the random cameras come
    from :class:`RandomCameraSampler` seeded with ``seed``."""

    def __init__(self, cfg: SingleImageConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.random_sampler = (RandomCameraSampler(cfg.random_camera, seed, device=device)
                               if cfg.use_random_camera else None)
        self.heights = cfg.height if isinstance(cfg.height, (list, tuple)) else [cfg.height]
        self.widths = cfg.width if isinstance(cfg.width, (list, tuple)) else [cfg.width]
        self.milestones = [-1] + list(cfg.resolution_milestones)[: len(self.heights) - 1]
        self.height = int(self.heights[0])
        self.width = int(self.widths[0])
        self._ref_cache = {}

    def ref_camera_c2w(self) -> np.ndarray:
        cfg = self.cfg
        return cam_ops.make_c2w_numpy(cfg.default_elevation_deg, cfg.default_azimuth_deg,
                                      cfg.default_camera_distance)

    def update(self, step: int) -> None:
        i = bisect.bisect_right(self.milestones, step) - 1
        self.height = int(self.heights[i])
        self.width = int(self.widths[min(i, len(self.widths) - 1)])

    def ref_batch(self) -> dict:
        """The fixed reference-view batch at the current milestone resolution
        (cached per resolution)."""
        key = (self.height, self.width)
        if key in self._ref_cache:
            return self._ref_cache[key]
        cfg, dev = self.cfg, self.device
        H, W = self.height, self.width
        rgb, mask = load_rgba(cfg.image_path, H, W)
        fovy = math.radians(cfg.default_fovy_deg)
        c2w = self.ref_camera_c2w()[None]
        cam = camera_batch_from_c2w(c2w, np.asarray([fovy]), np.asarray([fovy]), cfg.znear,
                                    cfg.zfar, device=dev)
        directions = cam_ops.get_ray_directions(H, W, 0.5 * H / math.tan(0.5 * fovy), device=dev)
        rays_o, rays_d = cam_ops.get_rays(directions, torch.as_tensor(c2w[0], device=dev),
                                          keepdim=True)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        batch = {
            "ref_cameras": cam,
            "ref_rgb": f32(rgb)[None],
            "ref_mask": f32(mask)[None],
            "ref_rays_o": rays_o[None],
            "ref_rays_d": rays_d[None],
            "ref_elevation": f32([cfg.default_elevation_deg]),
            "ref_azimuth": f32([cfg.default_azimuth_deg]),
            "ref_distance": f32([cfg.default_camera_distance]),
        }
        for wanted, suffix, loader, key_out in ((cfg.requires_depth, "depth", _load_gray, "ref_depth"),
                                                (cfg.requires_normal, "normal", _load_rgb,
                                                 "ref_normal")):
            if wanted:
                path = cfg.image_path.replace("_rgba.png", f"_{suffix}.png")
                if not os.path.exists(path):
                    raise FileNotFoundError(f"requires_{suffix} set but {path} is missing")
                batch[key_out] = f32(loader(path, H, W))[None]
        self._ref_cache[key] = batch
        return batch

    def train_batch(self, step: int = 0) -> dict:
        self.update(step)
        batch = dict(self.ref_batch())
        if self.random_sampler is not None:
            self.random_sampler.update(step)
            batch.update(self.random_sampler.sample())
        return batch

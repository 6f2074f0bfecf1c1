"""Temporal (video) dataset of the dynamic stage
(``temporal-image-datamodule``, counterpart of
``dreammesh4d_tpu/data/temporal_image.py``).

- Frames in the Consistent4D layout under ``video_frames_dir``:
  ``{i:03d}_rgba.png``, ``{i}.png`` or ``{i:03d}.png``, white-composited
  RGBA with masks (read by :mod:`.png`, as cv2 reads them);
- a fixed reference camera from the default elevation / azimuth / distance /
  fovy;
- train batches: ``num_frames`` distinct frames drawn from
  ``np.random.RandomState(seed)`` with their timestamps
  ``linspace(0, 1, L+2)[1:-1]``, paired with a frame-aligned random-camera
  batch;
- val/test: 5 fixed azimuths [0, −75, 15, 105, 195] × all timestamps;
  predict: ``n_predict_views`` orbit views at ``predict_height/width``.
"""

from __future__ import annotations

import bisect
import logging
import math
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import cameras as cam_ops
from ..registry import register
from .image import _load_gray, _load_rgb, load_rgba
from .uncond import RandomCameraConfig, RandomCameraSampler, camera_batch_from_c2w

EVAL_AZIMUTHS = [0.0, -75.0, 15.0, 105.0, 195.0]


@dataclass
class TemporalImageConfig:
    video_frames_dir: str = ""
    num_frames: int = 4  # frames sampled per train batch
    video_length: int = 32
    # int or list (paired with resolution_milestones); with a scalar height the
    # milestones are warned about and ignored
    height: object = 512
    width: object = 512
    resolution_milestones: Tuple[int, ...] = ()
    # accepted for the YAML's sake and read by no code path: timestamps are
    # always the normalized linspace(0, 1, L+2)[1:-1]
    norm_timestamp: bool = False
    # per-frame {i:03d}_depth.png / {i:03d}_normal.png supervision
    requires_depth: bool = False
    requires_normal: bool = False
    default_elevation_deg: float = 5.0
    default_azimuth_deg: float = 0.0
    default_camera_distance: float = 3.8
    default_fovy_deg: float = 20.0
    use_random_camera: bool = True
    random_camera: RandomCameraConfig = field(default_factory=RandomCameraConfig)
    znear: float = 0.01
    zfar: float = 100.0
    n_predict_views: int = 120
    predict_height: int = 1024
    predict_width: int = 1024


def frame_timestamps(video_length: int) -> np.ndarray:
    """linspace(0, 1, L+2)[1:-1]: L frame times strictly inside (0, 1)."""
    return np.linspace(0.0, 1.0, video_length + 2)[1:-1].astype(np.float32)


def find_frame_paths(frames_dir: str, length: Optional[int] = None) -> List[str]:
    """Frame files 0, 1, … in order, each named ``{i:03d}_rgba.png``,
    ``{i}.png`` or ``{i:03d}.png``; stops at the first missing index or
    after ``length`` frames."""
    paths = []
    i = 0
    while length is None or i < length:
        cands = [os.path.join(frames_dir, f"{i:03d}_rgba.png"),
                 os.path.join(frames_dir, f"{i}.png"),
                 os.path.join(frames_dir, f"{i:03d}.png")]
        hit = next((c for c in cands if os.path.exists(c)), None)
        if hit is None:
            break
        paths.append(hit)
        i += 1
    return paths


@register("temporal-image-datamodule")
class TemporalImageDataModule:
    """Batches on ``device`` (default the card); the frames stay numpy on
    the host until a consumer moves them."""

    def __init__(self, cfg: TemporalImageConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.rng = np.random.RandomState(seed)
        self.random_sampler = (RandomCameraSampler(cfg.random_camera, seed, device=device)
                               if cfg.use_random_camera else None)
        self.heights = list(cfg.height) if isinstance(cfg.height, (list, tuple)) else [cfg.height]
        self.widths = list(cfg.width) if isinstance(cfg.width, (list, tuple)) else [cfg.width]
        if len(self.heights) == 1 and cfg.resolution_milestones:
            logging.getLogger(__name__).warning(
                "Ignoring resolution_milestones since height and width are not changing")
            self.milestones = [-1]
        else:
            self.milestones = [-1] + list(cfg.resolution_milestones)[: len(self.heights) - 1]
        self.height = int(self.heights[0])
        self.width = int(self.widths[0])
        self._pinned = False
        self._frames_cache: dict = {}
        self._ref_camera_cache: dict = {}

    def update(self, step: int) -> None:
        """Resolution milestone at ``step``; frames load at a new size lazily
        through the per-resolution cache."""
        if self._pinned:
            return
        i = bisect.bisect_right(self.milestones, step) - 1
        self.height = int(self.heights[i])
        self.width = int(self.widths[min(i, len(self.widths) - 1)])

    def set_final_resolution(self) -> None:
        """Pin the module to the last milestone's resolution."""
        self.height = int(self.heights[-1])
        self.width = int(self.widths[-1])
        self._pinned = True

    # ---------------- loading ----------------
    def load_frames(self):
        return self.frames_at(self.height, self.width)

    def frames_at(self, height: int, width: int):
        """(rgb (L, H, W, 3), mask (L, H, W, 1)) float32 numpy at an explicit
        resolution (cached)."""
        key = (height, width)
        if key in self._frames_cache:
            return self._frames_cache[key]
        cfg = self.cfg
        paths = find_frame_paths(cfg.video_frames_dir, cfg.video_length)
        if not paths:
            raise FileNotFoundError(f"No frames found under {cfg.video_frames_dir}")
        rgbs, masks = zip(*(load_rgba(p, height, width) for p in paths))
        self._frames_cache[key] = (np.stack(rgbs), np.stack(masks))
        return self._frames_cache[key]

    def _load_sidecar(self, suffix: str, loader, height: int, width: int):
        """Per-frame ``_depth`` / ``_normal`` maps; a missing one raises."""
        out = []
        for p in find_frame_paths(self.cfg.video_frames_dir, self.cfg.video_length):
            sp = p.replace("_rgba.png", f"_{suffix}.png")
            if sp == p:  # {i}.png naming: the suffix goes before .png
                sp = p[:-4] + f"_{suffix}.png"
            if not os.path.exists(sp):
                raise FileNotFoundError(f"requires_{suffix} set but {sp} is missing")
            out.append(loader(sp, height, width))
        return np.stack(out)

    def load_depths(self, height=None, width=None):
        h, w = int(height or self.height), int(width or self.width)
        key = ("depth", h, w)
        if key not in self._frames_cache:
            self._frames_cache[key] = self._load_sidecar("depth", _load_gray, h, w)
        return self._frames_cache[key]

    def load_normals(self, height=None, width=None):
        h, w = int(height or self.height), int(width or self.width)
        key = ("normal", h, w)
        if key not in self._frames_cache:
            self._frames_cache[key] = self._load_sidecar("normal", _load_rgb, h, w)
        return self._frames_cache[key]

    @property
    def video_length(self) -> int:
        return len(self.load_frames()[0])

    def _ref_camera(self, n: int):
        """The fixed reference camera repeated ``n`` times (cached)."""
        if n not in self._ref_camera_cache:
            cfg = self.cfg
            fovy = math.radians(cfg.default_fovy_deg)
            c2w = cam_ops.make_c2w_numpy(cfg.default_elevation_deg, cfg.default_azimuth_deg,
                                         cfg.default_camera_distance)[None].repeat(n, 0)
            self._ref_camera_cache[n] = camera_batch_from_c2w(
                c2w, np.full(n, fovy), np.full(n, fovy), cfg.znear, cfg.zfar, device=self.device)
        return self._ref_camera_cache[n]

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # ---------------- batches ----------------
    def train_batch(self, step: int = 0) -> dict:
        cfg = self.cfg
        self.update(step)
        rgbs, masks = self.load_frames()
        L = len(rgbs)
        ts_all = frame_timestamps(L)
        idx = np.sort(self.rng.choice(L, size=min(cfg.num_frames, L), replace=False))
        T = len(idx)
        batch = {
            "frame_indices": torch.as_tensor(idx, dtype=torch.int64, device=self.device),
            "timestamps": self._f32(ts_all[idx]),
            "ref_cameras": self._ref_camera(T),
            # numpy: a consumer that keeps the whole video on the device
            # (video_frames of the train step) never moves these
            "ref_rgb": rgbs[idx],
            "ref_mask": masks[idx],
            "ref_elevation": self._f32(np.full(T, cfg.default_elevation_deg)),
            "ref_azimuth": self._f32(np.full(T, cfg.default_azimuth_deg)),
            "ref_distance": self._f32(np.full(T, cfg.default_camera_distance)),
        }
        if cfg.requires_depth:
            batch["ref_depth"] = self.load_depths()[idx]
        if cfg.requires_normal:
            batch["ref_normal"] = self.load_normals()[idx]
        if self.random_sampler is not None:
            self.random_sampler.update(step)
            batch.update(self.random_sampler.sample(batch_size=T))
        return batch

    def inter_frame_timestamps(self, num_inter: int, length_inter: float) -> torch.Tensor:
        """A window of ``num_inter`` evenly spaced timestamps of length
        ``length_inter`` at a random start."""
        start = self.rng.rand() * (1.0 - length_inter)
        return self._f32(np.linspace(start, start + length_inter, num_inter))

    def eval_batches(self, height=None, width=None):
        """5 fixed azimuths × all timestamps (one batch per azimuth)."""
        cfg = self.cfg
        H, W = height or self.height, width or self.width
        L = self.video_length
        ts_all = frame_timestamps(L)
        fovy = math.radians(cfg.default_fovy_deg)
        for az in EVAL_AZIMUTHS:
            c2w = cam_ops.make_c2w_numpy(cfg.default_elevation_deg, az,
                                         cfg.default_camera_distance)[None].repeat(L, 0)
            yield {
                "azimuth": az,
                "cameras": camera_batch_from_c2w(c2w, np.full(L, fovy), np.full(L, fovy),
                                                 cfg.znear, cfg.zfar, device=self.device),
                "timestamps": self._f32(ts_all),
                "frame_indices": torch.arange(L, device=self.device),
                "height": H,
                "width": W,
            }

    def predict_batch(self) -> dict:
        """``n_predict_views`` orbit views for texture baking."""
        cfg = self.cfg
        n = cfg.n_predict_views
        azimuth = np.linspace(-180, 180, n, endpoint=False)
        elevation = np.full(n, cfg.default_elevation_deg)
        dist = np.full(n, cfg.default_camera_distance)
        fovy = np.full(n, math.radians(cfg.default_fovy_deg))
        el, az = np.radians(elevation), np.radians(azimuth)
        pos = np.stack([dist * np.cos(el) * np.cos(az), dist * np.cos(el) * np.sin(az),
                        dist * np.sin(el)], -1).astype(np.float32)
        c2w = cam_ops.look_at_c2w(self._f32(pos))
        return {
            "cameras": camera_batch_from_c2w(c2w, fovy, fovy, cfg.znear, cfg.zfar,
                                             device=self.device),
            "c2w": c2w,
            "height": cfg.predict_height,
            "width": cfg.predict_width,
            "elevation": self._f32(elevation),
            "azimuth": self._f32(azimuth),
        }

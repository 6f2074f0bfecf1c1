"""Serving surface: render a trained dynamic-stage scene at any (camera, time)
(counterpart of ``dreammesh4d_tpu/serving.py:29`` ``Viewer4D``).

    viewer = Viewer4D.from_trial("outputs/sugar-dynamic/<tag>")   # a trial of the port
    viewer = Viewer4D(sugar_params, static, deform_params, dyn_cfg, raster_cfg,
                      height=512, width=512, fovy_deg=20, num_frames=32)
    rgb = viewer.render(elevation_deg=15, azimuth_deg=30, distance=2.2, t=0.4)
    frames = viewer.orbit(n_views=60, t=0.0)          # orbit at a fixed time
    frames = viewer.play(azimuth_deg=30, n_frames=32) # fixed view, time sweep

Each call is camera assembly + HexPlane deltas at the graph nodes + hybrid
skinning + re-derived Gaussians + one rasterization per view, all on
``device`` (default the card).  Frames come back as (H, W, 3) float32 numpy
arrays.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from .config import load_config
from .data.temporal_image import frame_timestamps
from .data.uncond import assemble_camera_batch
from .export.mesh_io import load_mesh
from .models.geometry.dynamic_sugar import build_dynamic_static
from .models.geometry.sugar import create_sugar
from .systems.assembly import build_raster_config, dynamic_config, load_static_weights, sugar_config
from .systems.sugar_4dgen import make_dynamic_render_eval
from .utils.checkpoint import restore_checkpoint
from .utils.tree import tree_to


class Viewer4D:
    def __init__(self, sugar_params, static, deform_params, dyn_cfg, raster_cfg,
                 height: int, width: int, fovy_deg: float, num_frames: int,
                 bg_color=(1.0, 1.0, 1.0), device="cuda"):
        self.device = torch.device(device)
        sugar_params = tree_to(sugar_params, self.device)
        self.static = static = tree_to(static, self.device)
        self.dyn_cfg = dyn_cfg
        self.deform_params = tree_to(deform_params, self.device)
        self.height, self.width = height, width
        self.fovy = math.radians(fovy_deg)
        self.num_frames = num_frames
        self._render = make_dynamic_render_eval(
            sugar_params, static, dyn_cfg.deformation, raster_cfg, bg_color)

    @classmethod
    def from_trial(cls, trial_dir: str, checkpoint: str = "LAST", height: Optional[int] = None,
                   width: Optional[int] = None, device="cuda"):
        """Load a dynamic-stage trial that the port's launcher wrote:
        ``configs/parsed.yaml``, the bind mesh, the static stage's refined
        weights (``system.weights``, loaded before the deformation graph is
        built from them, as the experiment does), and the checkpoint
        (``"LAST"``: the newest).  The size is ``height``/``width``, else the
        random camera's ``eval_height``/``eval_width`` (its ``height``/``width``
        when those are absent; the last milestone when they are lists).  A
        trial of the JAX package (orbax checkpoints) raises ``ValueError``."""
        dev = torch.device(device)
        cfg = load_config(os.path.join(trial_dir, "configs", "parsed.yaml"), makedirs=False)
        system = cfg.system
        geo = dict(system.get("geometry", {}))
        sugar_params, sugar_static = create_sugar(
            sugar_config(geo), load_mesh(str(geo["surface_mesh_to_bind_path"])), device=dev)
        if system.get("weights"):
            sugar_params = load_static_weights(system["weights"], sugar_params, dev)
        dyn_cfg = dynamic_config(geo)
        static = build_dynamic_static(dyn_cfg, sugar_static, sugar_params.points.cpu().numpy(),
                                      device=dev)

        if checkpoint == "LAST":
            checkpoint = os.path.join(trial_dir, "ckpts", "LAST")
        deform_params = restore_checkpoint(str(checkpoint), dev)["deform_params"]

        d = dict(cfg.data.get("random_camera", {}))
        H = int(height or d.get("eval_height", d.get("height", 512)))
        W = int(width or d.get("eval_width", d.get("width", 512)))
        if isinstance(d.get("height"), (list, tuple)):
            H = int(height or d["height"][-1])
            W = int(width or d["width"][-1])
        fovy_deg = float(cfg.data.get("default_fovy_deg", 40.0))
        return cls(sugar_params, static, deform_params, dyn_cfg,
                   build_raster_config(H, W, fovy_deg, system), H, W, fovy_deg,
                   dyn_cfg.num_frames, device=dev)

    # ------------------------------------------------------------------
    def _cameras(self, elevation_deg, azimuth_deg, distance):
        f32 = dict(dtype=torch.float32, device=self.device)
        el = torch.atleast_1d(torch.as_tensor(elevation_deg, **f32))
        az = torch.atleast_1d(torch.as_tensor(azimuth_deg, **f32))
        di = torch.atleast_1d(torch.as_tensor(distance, **f32)).expand(el.shape)
        elr, azr = torch.deg2rad(el), torch.deg2rad(az)
        pos = torch.stack([di * torch.cos(elr) * torch.cos(azr),
                           di * torch.cos(elr) * torch.sin(azr),
                           di * torch.sin(elr)], -1)
        fovy = torch.full(el.shape, self.fovy, **f32)
        up = torch.tensor([0.0, 0.0, 1.0], **f32).expand(pos.shape)
        return assemble_camera_batch(pos, torch.zeros_like(pos), up, fovy, 0.01, 100.0)

    def _frame_indices(self, ts: torch.Tensor) -> torch.Tensor:
        L = self.num_frames
        return torch.clamp(torch.round(ts * (L - 1)).long(), 0, L - 1)

    def _frames(self, cams, ts, fi):
        with torch.inference_mode():
            out = self._render(self.deform_params, cams, ts, fi)
            return list(out["comp_rgb"].cpu().numpy())

    def render(self, elevation_deg: float = 0.0, azimuth_deg: float = 0.0,
               distance: float = 2.2, t: float = 0.0) -> np.ndarray:
        """One (H, W, 3) float frame at spherical camera + normalized time."""
        cams = self._cameras(elevation_deg, azimuth_deg, distance)
        ts = torch.tensor([t], dtype=torch.float32, device=self.device)
        return self._frames(cams, ts, self._frame_indices(ts))[0]

    def orbit(self, n_views: int = 30, elevation_deg: float = 15.0,
              distance: float = 2.2, t: float = 0.0):
        """Frames on an azimuth orbit at a fixed time."""
        az = np.linspace(0.0, 360.0, n_views, endpoint=False)
        cams = self._cameras(np.full(n_views, elevation_deg), az, np.full(n_views, distance))
        ts = torch.full((n_views,), t, dtype=torch.float32, device=self.device)
        return self._frames(cams, ts, self._frame_indices(ts))

    def play(self, elevation_deg: float = 0.0, azimuth_deg: float = 0.0,
             distance: float = 2.2, n_frames: Optional[int] = None):
        """Frames at a fixed view sweeping time over the trained video."""
        n = n_frames or self.num_frames
        ts = torch.as_tensor(frame_timestamps(n), device=self.device)
        cams = self._cameras(np.full(n, elevation_deg), np.full(n, azimuth_deg),
                             np.full(n, distance))
        fi = (torch.arange(n, device=self.device) if n == self.num_frames
              else self._frame_indices(ts))
        return self._frames(cams, ts, fi)


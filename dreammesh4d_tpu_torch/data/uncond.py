"""Camera batch assembly (the ``CameraBatch`` half of
``dreammesh4d_tpu/data/uncond.py:86`` ``assemble_camera_batch``; the ray
half and the random camera sampler come with the training slice)."""

from __future__ import annotations

import torch

from ..models.renderers.sugar_rasterizer import CameraBatch
from ..ops import cameras as cam_ops


def assemble_camera_batch(positions: torch.Tensor, center: torch.Tensor, up: torch.Tensor,
                          fovy: torch.Tensor, znear: float = 0.01,
                          zfar: float = 100.0) -> CameraBatch:
    """GS camera transforms for B look-at cameras: positions/center/up
    (B, 3), fovy (B,) radians (square pixels: fovx = fovy)."""
    c2w = cam_ops.look_at_c2w(positions, center, up)  # (B,4,4)
    info = cam_ops.get_cam_info_gaussian(c2w, fovy, fovy, znear, zfar)
    return CameraBatch(info.world_view_transform, info.full_proj_transform,
                       info.camera_center)

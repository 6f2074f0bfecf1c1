"""Trilinear lookup in a dense voxel grid (counterpart of ``_trilerp`` in
``dreammesh4d_tpu/models/geometry/volume_grid.py``, :43-61).

Only the lookup is ported (the sketch-shape loss reads its baked grids
through it); the ``volume-grid`` geometry itself is not ported yet
(ROADMAP A8).
"""

from __future__ import annotations

import torch


def _trilerp(grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation: ``grid`` (C, gx, gy, gz), ``x`` (N, 3) in
    [0, 1] (clipped) → (N, C).  The 8 corner cells are gathered and summed
    in the JAX package's order."""
    C = grid.shape[0]
    size = torch.tensor(grid.shape[1:], device=x.device)
    pos = torch.clamp(x, 0.0, 1.0) * (size.float() - 1)
    i0 = torch.minimum(torch.clamp(torch.floor(pos).long(), min=0), size - 2)
    f = pos - i0.float()  # (N, 3)
    out = torch.zeros((x.shape[0], C), dtype=grid.dtype, device=x.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                v = grid[:, i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]  # (C, N)
                out = out + w[:, None] * v.T
    return out

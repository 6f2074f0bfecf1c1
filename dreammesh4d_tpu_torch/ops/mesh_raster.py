"""Z-buffer mesh rasterizer in plain PyTorch (counterpart of
``dreammesh4d_tpu/ops/mesh_raster.py``: ``MeshRasterOutput`` :25,
``rasterize_mesh`` :31, ``interpolate_attribute`` :135).

It renders the recovery benchmark's ground truth and maps texels in the
texture bake.  Triangles are binned to the Gaussian rasterizer's fixed
16-px tiles by their screen circumradius (``bin_gaussians``: a stable depth
order, the ``tile_capacity`` nearest kept per tile); each tile tests its K
candidate triangles against its 256 pixels with barycentric inside tests, and
a depth argmin gives per-pixel face index and barycentric coordinates.
``torch.argmin`` keeps the first minimum, as ``jnp.argmin`` does, so equal
depths resolve alike in both packages.

Memory: the (T, K, 256) float32 tensors of one view are materialised at
once — at 1024² (T = 4096, K = 256) about 1 GiB each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cameras import GSCameraInfo
from .gs.binning import TILE, bin_gaussians, num_tiles


class MeshRasterOutput(NamedTuple):
    face_idx: torch.Tensor  # (H, W) int64, -1 = background
    bary: torch.Tensor  # (H, W, 3) barycentric coordinates of the hit
    depth: torch.Tensor  # (H, W) view z of the hit (inf = background)


def rasterize_mesh(verts: torch.Tensor, faces: torch.Tensor, camera: GSCameraInfo, W: int, H: int,
                   tile_capacity: int = 256, max_tiles_per_face: int = 64) -> MeshRasterOutput:
    """Index-rasterize ``verts`` (V, 3) world / ``faces`` (F, 3) from
    ``camera`` at (H, W); everything on ``verts``' device, in float32, or in
    float64 where ``verts`` are float64."""
    dev = verts.device
    dtype = torch.float64 if verts.dtype == torch.float64 else torch.float32
    verts = verts.to(dtype)
    faces = faces.long()
    F = faces.shape[0]
    hom = torch.cat([verts, torch.ones_like(verts[:, :1])], -1)
    p_view = hom @ camera.world_view_transform[:, :3].to(dtype)  # (V, 3)
    p_hom = hom @ camera.full_proj_transform.to(dtype)
    p_w = 1.0 / (p_hom[:, 3:4] + 1e-7)
    ndc = p_hom[:, :3] * p_w
    px = ((ndc[:, 0] + 1.0) * W - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5
    pix = torch.stack([px, py], -1)  # (V, 2)
    z = p_view[:, 2]

    # gathered with index_select: its backward adds with atomics, where
    # indexing's sorts its indices (seconds on CUDA when millions of faces
    # share a vertex, as a marching-tets surface's masked slots do)
    flat = faces.reshape(-1)
    tri_pix = torch.index_select(pix, 0, flat).reshape(F, 3, 2)  # (F, 3, 2)
    tri_z = torch.index_select(z, 0, flat).reshape(F, 3)  # (F, 3)
    center = tri_pix.mean(1)
    radius = torch.ceil(torch.linalg.norm(tri_pix - center[:, None, :], dim=-1).amax(1)).int() + 1
    valid = (tri_z > 0.05).all(-1)
    depth_f = tri_z.mean(-1)

    assign = bin_gaussians(center, radius, depth_f, valid, W, H, tile_capacity, max_tiles_per_face)
    g = assign.tile_gauss.long()  # (T, K), F past a tile's count
    T = g.shape[0]
    tiles_x, tiles_y = num_tiles(W, H)

    # sentinel triangle F: degenerate, never hits
    tri_pix_p = torch.cat([tri_pix, torch.full((1, 3, 2), 1e9, dtype=dtype, device=dev)], 0)
    tri_z_p = torch.cat([tri_z, torch.full((1, 3), float("inf"), dtype=dtype, device=dev)], 0)
    v_pix = tri_pix_p[g]  # (T, K, 3, 2)
    v_z = tri_z_p[g]  # (T, K, 3)

    t_idx = torch.arange(T, device=dev)
    tx, ty = t_idx % tiles_x, t_idx // tiles_x
    xs = torch.arange(TILE, dtype=dtype, device=dev)
    px_row = tx[:, None].to(dtype) * TILE + xs[None, :]  # (T, 16)
    py_row = ty[:, None].to(dtype) * TILE + xs[None, :]
    # pixel order within a tile is (y, x) row-major, matching untile below
    P = TILE * TILE
    pix_x = px_row[:, None, :].expand(T, TILE, TILE).reshape(T, P)
    pix_y = py_row[:, :, None].expand(T, TILE, TILE).reshape(T, P)

    # edge functions for the barycentric coordinates of (a, b, c)
    a, b, c = v_pix[:, :, 0, :], v_pix[:, :, 1, :], v_pix[:, :, 2, :]  # (T, K, 2)
    det = ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
           - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))  # (T, K)
    det_safe = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)

    dx = pix_x[:, None, :] - a[..., 0:1]  # (T, K, P)
    dy = pix_y[:, None, :] - a[..., 1:2]
    w1 = ((c[..., 1] - a[..., 1])[..., None] * dx
          - (c[..., 0] - a[..., 0])[..., None] * dy) / det_safe[..., None]
    w2 = (-(b[..., 1] - a[..., 1])[..., None] * dx
          + (b[..., 0] - a[..., 0])[..., None] * dy) / det_safe[..., None]
    del dx, dy
    w0 = 1.0 - w1 - w2
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (det.abs()[..., None] > 1e-9)

    depth = w0 * v_z[..., 0:1] + w1 * v_z[..., 1:2] + w2 * v_z[..., 2:3]  # (T, K, P)
    depth = torch.where(inside, depth, torch.full_like(depth, float("inf")))
    del inside

    best = torch.argmin(depth, dim=1)  # (T, P), the first minimum
    best_depth = torch.gather(depth, 1, best[:, None, :])[:, 0, :]
    del depth
    hit = torch.isfinite(best_depth)
    best_face = torch.gather(g, 1, best)
    best_face = torch.where(hit & (best_face < F), best_face, torch.full_like(best_face, -1))
    bary = torch.stack([torch.gather(w, 1, best[:, None, :])[:, 0, :] for w in (w0, w1, w2)],
                       -1)  # (T, P, 3)

    def untile(x, ch=None):
        if ch is None:
            img = x.reshape(tiles_y, tiles_x, TILE, TILE)
            return img.permute(0, 2, 1, 3).reshape(tiles_y * TILE, tiles_x * TILE)[:H, :W]
        img = x.reshape(tiles_y, tiles_x, TILE, TILE, ch)
        return img.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, ch)[:H, :W]

    return MeshRasterOutput(
        face_idx=untile(best_face),
        bary=untile(bary, 3),
        depth=untile(torch.where(hit, best_depth, torch.full_like(best_depth, float("inf")))),
    )


def interpolate_attribute(out: MeshRasterOutput, faces: torch.Tensor,
                          vert_attr: torch.Tensor) -> torch.Tensor:
    """Per-vertex attributes (V, C) interpolated at the hits → (H, W, C),
    0 on the background."""
    f = torch.clamp(out.face_idx, min=0)
    idx = faces.long()[f]  # (H, W, 3)
    tri_attr = torch.index_select(vert_attr, 0, idx.reshape(-1)).reshape(idx.shape + vert_attr.shape[1:])
    val = (out.bary[..., None] * tri_attr).sum(-2)
    return torch.where((out.face_idx >= 0)[..., None], val, torch.zeros_like(val))

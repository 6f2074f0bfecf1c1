"""UV texture baking: square-atlas UVs and multi-view projection (counterpart
of ``dreammesh4d_tpu/export/texture_bake.py``: ``build_square_atlas`` :25,
``bake_texture`` :50, ``export_textured_mesh`` :117).

Every triangle gets its own small square in the texture atlas (or a chart of
``uv_unwrap.unwrap_uv`` with ``atlas="charts"``); each view is rendered by
the caller's renderer, the mesh is index-rasterized from the same camera
(``ops.mesh_raster``), and every hit pixel's colour is scatter-added
(``index_add_``) into the texel its UV maps to, on the device of the mesh.
The texture is the per-texel mean; texels no view reached take the mean
colour of the filled ones.  The 4D export shares one baked texture across
all timestamps' meshes.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.cameras import GSCameraInfo
from ..ops.mesh_raster import rasterize_mesh
from .mesh_io import MeshData, save_obj


def build_square_atlas(n_faces: int, tex_size: int = 1024,
                       margin: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """Per-face UV squares: (v_tex (3F, 2), t_tex_idx (F, 3)).  Face i takes
    the lower-left triangle of its square, inset by ``margin`` of the side so
    that bilinear lookups do not bleed across faces."""
    n = int(np.ceil(np.sqrt(n_faces)))
    side = 1.0 / n
    pad = margin * side
    uvs = np.zeros((n_faces, 3, 2), np.float32)
    idx = np.arange(n_faces)
    cx = (idx % n).astype(np.float32) * side
    cy = (idx // n).astype(np.float32) * side
    uvs[:, 0, 0] = cx + pad
    uvs[:, 0, 1] = cy + pad
    uvs[:, 1, 0] = cx + side - pad
    uvs[:, 1, 1] = cy + pad
    uvs[:, 2, 0] = cx + pad
    uvs[:, 2, 1] = cy + side - pad
    return uvs.reshape(-1, 2), np.arange(n_faces * 3, dtype=np.int32).reshape(-1, 3)


def bake_view(tex_acc: torch.Tensor, tex_w: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
              face_uvs: torch.Tensor, camera: GSCameraInfo, rgb: torch.Tensor, W: int, H: int,
              tex_size: int, mesh_tile_capacity: int = 256) -> None:
    """Add one view's hit pixels ``rgb`` (H, W, 3) into the (S², 3) colour and
    (S²,) weight accumulators, in place."""
    S = tex_size
    out = rasterize_mesh(verts, faces, camera, W, H, tile_capacity=mesh_tile_capacity)
    hit = (out.face_idx >= 0).reshape(-1)
    f = out.face_idx.reshape(-1)[hit]
    uv = (out.bary.reshape(-1, 3)[hit][..., None] * face_uvs[f]).sum(-2)  # (n, 2)
    tx = torch.clamp((uv[:, 0] * S).long(), 0, S - 1)
    ty = torch.clamp((uv[:, 1] * S).long(), 0, S - 1)
    texel = ty * S + tx
    tex_acc.index_add_(0, texel, rgb.reshape(-1, 3)[hit].to(tex_acc.dtype))
    tex_w.index_add_(0, texel, torch.ones_like(texel, dtype=tex_w.dtype))


def bake_texture(verts: torch.Tensor, faces: torch.Tensor, cameras_ww: torch.Tensor,
                 cameras_fp: torch.Tensor, cameras_cc: torch.Tensor,
                 render_rgb_fn: Callable[[GSCameraInfo], torch.Tensor], W: int, H: int,
                 tex_size: int = 1024, mesh_tile_capacity: int = 256,
                 atlas: str = "square") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(texture (S, S, 3) float32, v_tex, t_tex_idx) from the views
    (world_view (B, 4, 4), full_proj (B, 4, 4), centre (B, 3)); the bake runs
    on ``verts``' device.  ``atlas``: ``"square"`` (per-face squares, the
    reference's bake) or ``"charts"`` (``uv_unwrap.unwrap_uv``)."""
    dev = verts.device
    F = int(faces.shape[0])
    if atlas == "charts":
        from .uv_unwrap import unwrap_uv

        v_tex, t_tex = unwrap_uv(verts.detach().cpu().numpy(), faces.cpu().numpy())
        face_uvs = v_tex[t_tex]  # (F, 3, 2)
    else:
        v_tex, t_tex = build_square_atlas(F, tex_size)
        face_uvs = v_tex.reshape(F, 3, 2)
    face_uvs = torch.as_tensor(face_uvs, device=dev)

    S = tex_size
    tex_acc = torch.zeros((S * S, 3), dtype=torch.float32, device=dev)
    tex_w = torch.zeros((S * S,), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for i in range(cameras_ww.shape[0]):
            cam = GSCameraInfo(cameras_ww[i], cameras_fp[i], cameras_cc[i])
            bake_view(tex_acc, tex_w, verts, faces, face_uvs, cam, render_rgb_fn(cam), W, H, S,
                      mesh_tile_capacity)
        tex = (tex_acc / torch.clamp(tex_w, min=1.0)[:, None]).reshape(S, S, 3).cpu().numpy()
    filled = tex_w.reshape(S, S).cpu().numpy() > 0
    if filled.any() and not filled.all():
        # unfilled texels take the mean colour (no black seams)
        tex[~filled] = tex[filled].mean(0)
    return tex, v_tex, t_tex


def export_textured_mesh(path: str, verts: np.ndarray, faces: np.ndarray, texture, v_tex: np.ndarray,
                         t_tex_idx: np.ndarray, mtl_name: str = "material0") -> None:
    """An OBJ with UVs and ``<mtl_name>.mtl``; ``texture`` (S, S, 3) is
    written as ``<mtl_name>.png``, or not at all when None (a frame that
    shares the texture of an earlier one)."""
    mesh = MeshData(v_pos=np.asarray(verts, np.float32), t_pos_idx=np.asarray(faces, np.int32),
                    v_tex=np.asarray(v_tex, np.float32), t_tex_idx=np.asarray(t_tex_idx, np.int32))
    save_obj(path, mesh, mtl_name=mtl_name, texture_map=texture)

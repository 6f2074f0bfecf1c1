"""Procedural test meshes and the recovery benchmark's scene (counterpart of
``dreammesh4d_tpu/utils/procedural.py``: ``make_icosphere`` :10,
``deform_recovery`` :65, ``render_vertex_color_view`` :79).

The recovery scene is a procedurally animated vertex-coloured mesh whose
ground truth renders through the port's mesh rasterizer at any (view, time).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..export.mesh_io import MeshData


def make_icosphere(subdivisions: int = 2, radius: float = 1.0) -> MeshData:
    """Vertex-colored icosphere: 20·4^s faces, colors (xyz + 1)/2."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts = verts / np.linalg.norm(verts, axis=-1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid: dict = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts_list[a] + verts_list[b]) / 2.0
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)

    v = (verts * radius).astype(np.float32)
    rgb = ((verts + 1.0) / 2.0).astype(np.float32)
    return MeshData(v_pos=v, t_pos_idx=faces.astype(np.int32), v_rgb=rgb)


def deform_recovery(rest: np.ndarray, t: float, max_angle_deg: float = 25.0,
                    squash: float = 0.12) -> np.ndarray:
    """Rotation about the up (z) axis by ``max_angle_deg·sin(2πt)`` composed
    with a volume-compensated x-stretch (host-side numpy, float32)."""
    a = np.radians(max_angle_deg) * np.sin(2.0 * np.pi * t)
    ca, sa = np.cos(a), np.sin(a)
    rot = np.asarray([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]], np.float32)
    s = 1.0 + squash * np.sin(2.0 * np.pi * t)
    scale = np.asarray([s, 1.0 / np.sqrt(s), 1.0 / np.sqrt(s)], np.float32)
    return ((rest * scale[None, :]) @ rot.T).astype(np.float32)


def render_vertex_color_view(verts, faces, colors, elevation_deg: float, azimuth_deg: float,
                             distance: float, fovy_deg: float, H: int, W: int,
                             bg=(1.0, 1.0, 1.0), device="cuda"):
    """(rgb (H, W, 3), mask (H, W, 1)) float32 numpy: the ground-truth render
    of a vertex-coloured mesh from a spherical camera, rasterized on
    ``device`` with the data pipeline's camera convention."""
    from ..ops import cameras as cam_ops
    from ..ops.mesh_raster import interpolate_attribute, rasterize_mesh

    dev = torch.device(device)
    c2w = cam_ops.make_c2w_numpy(elevation_deg, azimuth_deg, distance)
    fov = math.radians(fovy_deg)
    cam = cam_ops.get_cam_info_gaussian(torch.as_tensor(c2w, device=dev), fov, fov, 0.01, 100.0)
    faces_t = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    out = rasterize_mesh(torch.as_tensor(np.asarray(verts, np.float32), device=dev), faces_t,
                         cam, W, H)
    rgb = interpolate_attribute(out, faces_t,
                                torch.as_tensor(np.asarray(colors, np.float32), device=dev))
    mask = (out.face_idx >= 0).float()[..., None]
    rgb = rgb * mask + torch.as_tensor(bg, dtype=torch.float32, device=dev) * (1.0 - mask)
    return rgb.cpu().numpy().astype(np.float32), mask.cpu().numpy()

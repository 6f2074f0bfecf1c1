"""Procedural test meshes, host-side numpy (counterpart of
``dreammesh4d_tpu/utils/procedural.py:10`` ``make_icosphere``)."""

from __future__ import annotations

import numpy as np

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

"""Chart-based UV unwrapping, host-side numpy (own copy of
``dreammesh4d_tpu/export/uv_unwrap.py``: ``grow_charts`` :53,
``_project_chart`` :84, ``unwrap_uv`` :101) — the ``atlas: charts`` layout
of the texture bake, an xatlas-style unwrap:

1. faces cluster into charts by BFS over edge adjacency, admitting a
   neighbour while its normal stays within ``max_angle`` of the chart's
   running mean normal;
2. each chart projects onto the plane of its mean normal;
3. charts are scaled together (relative scale kept), sorted by height and
   shelf-packed into the unit square with a margin.

Returns the (v_tex, t_tex_idx) contract of ``texture_bake.build_square_atlas``.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Tuple

import numpy as np


def _face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def _face_adjacency(faces: np.ndarray):
    edge_owner: dict = {}
    adj = defaultdict(list)
    for f, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            key = (min(u, v), max(u, v))
            if key in edge_owner:
                g = edge_owner[key]
                adj[f].append(g)
                adj[g].append(f)
            else:
                edge_owner[key] = f
    return adj


def grow_charts(verts: np.ndarray, faces: np.ndarray, max_angle_deg: float = 60.0) -> np.ndarray:
    """(F,) int32 chart id per face: normal-bounded BFS region growing."""
    F = len(faces)
    normals = _face_normals(verts, faces)
    adj = _face_adjacency(faces)
    chart = np.full(F, -1, np.int32)
    cos_t = float(np.cos(np.radians(max_angle_deg)))
    next_chart = 0
    for seed in range(F):
        if chart[seed] >= 0:
            continue
        cid = next_chart
        next_chart += 1
        chart[seed] = cid
        mean_n = normals[seed].copy()
        q = deque([seed])
        while q:
            f = q.popleft()
            for g in adj[f]:
                if chart[g] >= 0:
                    continue
                if normals[g] @ (mean_n / np.linalg.norm(mean_n)) >= cos_t:
                    chart[g] = cid
                    mean_n += normals[g]
                    q.append(g)
    return chart


def _project_chart(verts: np.ndarray, faces: np.ndarray, normals: np.ndarray, face_ids: np.ndarray):
    """Planar projection of one chart: (its vertex ids, uv (V_c, 2))."""
    n = normals[face_ids].mean(0)
    n = n / max(np.linalg.norm(n), 1e-12)
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    t = np.cross(n, a)
    t /= max(np.linalg.norm(t), 1e-12)
    b = np.cross(n, t)
    vids = np.unique(faces[face_ids].reshape(-1))
    p = verts[vids]
    uv = np.stack([p @ t, p @ b], -1)
    uv -= uv.min(0)
    return vids, uv


def unwrap_uv(verts: np.ndarray, faces: np.ndarray, max_angle_deg: float = 60.0,
              margin: float = 0.004) -> Tuple[np.ndarray, np.ndarray]:
    """(v_tex (V', 2) in [0, 1]², t_tex_idx (F, 3)); vertices are duplicated
    per chart (UV seams at chart boundaries)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    normals = _face_normals(verts, faces)
    chart = grow_charts(verts, faces, max_angle_deg)
    n_charts = int(chart.max()) + 1

    charts = []  # (height, width, chart faces, vids, uv)
    for cid in range(n_charts):
        fids = np.nonzero(chart == cid)[0]
        vids, uv = _project_chart(verts, faces, normals, fids)
        w, h = np.maximum(uv.max(0), 1e-9)
        charts.append([h, w, fids, vids, uv])

    # shelf packing at one global scale, tallest chart first
    total_area = sum(h * w for h, w, *_ in charts)
    scale = 1.0 / np.sqrt(total_area * 1.6)  # ~62 % occupancy headroom
    order = sorted(range(n_charts), key=lambda i: -charts[i][0])

    placements = [None] * n_charts
    x = y = row_h = max_row_w = 0.0
    for i in order:
        h, w = charts[i][0] * scale, charts[i][1] * scale
        if x + w + margin > 1.0 and x > 0.0:
            x = 0.0
            y += row_h + margin
            row_h = 0.0
        placements[i] = (x, y)
        x += w + margin
        row_h = max(row_h, h)
        max_row_w = max(max_row_w, x - margin)
    used_h = y + row_h
    # fit both axes: rows overflow down, a chart wider than the square right
    fit = min(1.0, (1.0 - margin) / max(used_h, 1e-9), (1.0 - margin) / max(max_row_w, 1e-9))

    v_tex_parts = []
    t_tex = np.zeros((len(faces), 3), np.int64)
    offset = 0
    for i, (h, w, fids, vids, uv) in enumerate(charts):
        px, py = placements[i]
        uvn = (uv * scale + np.asarray([px, py])) * fit + margin * 0.5
        local = {int(v): j for j, v in enumerate(vids)}
        t_tex[fids] = np.vectorize(local.__getitem__)(faces[fids]) + offset
        v_tex_parts.append(uvn)
        offset += len(vids)
    v_tex = np.concatenate(v_tex_parts, 0).astype(np.float32)
    # the fit guarantees containment; the clip below only swallows round-off
    if v_tex.size and (v_tex.min() < -1e-4 or v_tex.max() > 1.0 + 1e-4):
        raise AssertionError(f"uv packing overflow: range [{v_tex.min():.4f}, {v_tex.max():.4f}]")
    return np.clip(v_tex, 0.0, 1.0), t_tex.astype(np.int32)

"""SuGaR geometry: 3D Gaussians bound to a triangle mesh (counterpart of
``dreammesh4d_tpu/models/geometry/sugar.py``).

- :class:`SuGaRStatic` — topology and constants built once on the host;
- :class:`SuGaRParams` — the learnable tensors (vertex positions, in-plane
  log-scales, in-plane rotation as a complex number, SH coefficients,
  opacity logits);
- pure functions mapping (params, static) -> renderable Gaussian attributes.

Barycentric layouts, the face-frame orientation and the scale/opacity/SH
conventions follow the JAX package line for line.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...export.mesh_io import MeshData
from ...ops.meshops import build_edge_adjacency, build_one_ring, face_normals
from ...ops.quaternion import cross, matrix_to_quat, quat_normalize
from ...ops.sh import num_sh_bases, rgb_to_sh_dc

# barycentric layouts + incircle radius factors
_BARY_LAYOUTS = {
    1: (1.0 / (2.0 * np.sqrt(3.0)), [[1 / 3, 1 / 3, 1 / 3]]),
    3: (1.0 / (2.0 * (np.sqrt(3.0) + 1.0)),
        [[1 / 2, 1 / 4, 1 / 4], [1 / 4, 1 / 2, 1 / 4], [1 / 4, 1 / 4, 1 / 2]]),
    4: (1.0 / (4.0 * np.sqrt(3.0)),
        [[1 / 3, 1 / 3, 1 / 3], [2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6],
         [1 / 6, 1 / 6, 2 / 3]]),
    6: (1.0 / (4.0 + 2.0 * np.sqrt(3.0)),
        [[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3],
         [1 / 6, 5 / 12, 5 / 12], [5 / 12, 1 / 6, 5 / 12], [5 / 12, 5 / 12, 1 / 6]]),
}


@dataclass
class SuGaRConfig:
    n_gaussians_per_surface_triangle: int = 6
    sh_degree: int = 3
    surface_mesh_thickness_factor: float = 1e-3  # × scene spatial extent
    init_gs_scales_s: float = 1.4
    init_gs_opacity: float = 0.9999
    color_clip: float = 2.0
    learn_positions: bool = True
    learn_scales: bool = True
    learn_quaternions: bool = True
    learn_opacities: bool = False
    mesh_component_min_ratio: float = 0.75
    spatial_extent: float = 1.0


class SuGaRStatic(NamedTuple):
    faces: torch.Tensor  # (F, 3) int64
    bary_coords: torch.Tensor  # (G, 3)
    n_per_face: int
    sh_degree: int
    surface_mesh_thickness: float
    color_clip: float
    edge_face_pairs: torch.Tensor  # (E, 2)
    ring_idx: torch.Tensor  # (V, K)
    ring_mask: torch.Tensor  # (V, K)


class SuGaRParams(NamedTuple):
    points: torch.Tensor  # (V, 3) vertex positions
    log_scales: torch.Tensor  # (N, 2) in-plane log scales
    complex_rot: torch.Tensor  # (N, 2) in-plane rotation
    sh_dc: torch.Tensor  # (N, 1, 3)
    sh_rest: torch.Tensor  # (N, B-1, 3)
    density_logits: torch.Tensor  # (N,)


class GaussianAttrs(NamedTuple):
    means3d: torch.Tensor  # (N, 3)
    quats: torch.Tensor  # (N, 4) wxyz
    scales: torch.Tensor  # (N, 3)
    opacities: torch.Tensor  # (N,)
    sh: torch.Tensor  # (N, 3, B) channel-major for ops.sh.eval_sh


def _largest_components(faces: np.ndarray, num_verts: int, min_ratio: float) -> np.ndarray:
    """Keep faces of connected components with ≥ min_ratio × the largest
    component's vertex count."""
    adj = collections.defaultdict(list)
    for a, b, c in faces:
        adj[a].append(b); adj[b].append(a)
        adj[b].append(c); adj[c].append(b)
        adj[c].append(a); adj[a].append(c)
    comp = -np.ones(num_verts, np.int64)
    n_comp = 0
    for seed in range(num_verts):
        if comp[seed] >= 0:
            continue
        stack = [seed]
        comp[seed] = n_comp
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if comp[v] < 0:
                    comp[v] = n_comp
                    stack.append(v)
        n_comp += 1
    sizes = np.bincount(comp, minlength=n_comp)
    keep_comps = np.where(sizes >= min_ratio * sizes.max())[0]
    keep_mask = np.isin(comp[faces[:, 0]], keep_comps)
    return faces[keep_mask]


def create_sugar(cfg: SuGaRConfig, mesh: MeshData, max_ring_degree: int = 16,
                 device="cuda") -> Tuple[SuGaRParams, SuGaRStatic]:
    """Build (params, static) from a coarse (vertex-colored) mesh."""
    faces = np.asarray(mesh.t_pos_idx, np.int64)
    if cfg.mesh_component_min_ratio > 0 and len(faces):
        faces = _largest_components(faces, mesh.n_verts, cfg.mesh_component_min_ratio)
    # prune degenerate (near-zero-area) faces
    if len(faces):
        vp = np.asarray(mesh.v_pos, np.float32)
        fv0 = vp[faces]
        n_raw = np.cross(fv0[:, 1] - fv0[:, 0], fv0[:, 2] - fv0[:, 0])
        a2 = (n_raw * n_raw).sum(-1)
        s2 = np.maximum(((fv0[:, 1] - fv0[:, 0]) ** 2).sum(-1)
                        * ((fv0[:, 2] - fv0[:, 0]) ** 2).sum(-1), 1e-30)
        keep = a2 > 1e-8 * s2
        if not keep.all():
            faces = faces[keep]
    # compact to used vertices
    used = np.unique(faces)
    remap = -np.ones(mesh.n_verts, np.int64)
    remap[used] = np.arange(len(used))
    faces = remap[faces]
    v_pos = np.asarray(mesh.v_pos, np.float32)[used]
    v_rgb = mesh.v_rgb[used] if mesh.v_rgb is not None else None

    F = len(faces)
    G = cfg.n_gaussians_per_surface_triangle
    radius_factor, bary = _BARY_LAYOUTS[G]
    bary = np.asarray(bary, np.float32)
    N = F * G
    n_bases = num_sh_bases(cfg.sh_degree)

    # init scales: min triangle edge × incircle factor × s
    fv = v_pos[faces]  # (F,3,3)
    edge_len = np.linalg.norm(fv - fv[:, [1, 2, 0]], axis=-1)  # (F,3)
    scale0 = edge_len.min(-1) * radius_factor * cfg.init_gs_scales_s  # (F,)
    scale0 = np.clip(scale0, 1e-7, None)
    log_scales = np.log(np.repeat(scale0[:, None], G, 1))[..., None].repeat(2, -1)  # (F,G,2)

    complex_rot = np.zeros((N, 2), np.float32)
    complex_rot[:, 0] = 1.0

    # SH DC from vertex colors sampled at the barycentric points
    if v_rgb is not None:
        pts_rgb = np.einsum("gk,fkc->fgc", bary, v_rgb[faces])  # (F,G,3)
        sh_dc = np.asarray(rgb_to_sh_dc(pts_rgb.reshape(N, 3).astype(np.float32)),
                           np.float32)[:, None, :]
    else:
        sh_dc = np.zeros((N, 1, 3), np.float32)
    sh_rest = np.zeros((N, n_bases - 1, 3), np.float32)

    op = cfg.init_gs_opacity
    density_logits = np.full((N,), float(np.log(op / (1 - op))), np.float32)

    ring = build_one_ring(faces, len(v_pos), max_ring_degree)
    adj = build_edge_adjacency(faces)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    params = SuGaRParams(
        points=f32(v_pos),
        log_scales=f32(log_scales.reshape(N, 2)),
        complex_rot=f32(complex_rot),
        sh_dc=f32(sh_dc),
        sh_rest=f32(sh_rest),
        density_logits=f32(density_logits),
    )
    static = SuGaRStatic(
        faces=torch.as_tensor(faces, dtype=torch.int64, device=device),
        bary_coords=f32(bary),
        n_per_face=G,
        sh_degree=cfg.sh_degree,
        surface_mesh_thickness=cfg.surface_mesh_thickness_factor * cfg.spatial_extent,
        color_clip=cfg.color_clip,
        edge_face_pairs=torch.as_tensor(adj.face_pairs, dtype=torch.int64, device=device),
        ring_idx=torch.as_tensor(ring.neighbor_idx, dtype=torch.int64, device=device),
        ring_mask=torch.as_tensor(ring.neighbor_mask, device=device),
    )
    return params, static


def gaussian_centers(points: torch.Tensor, static: SuGaRStatic) -> torch.Tensor:
    """(..., N, 3) barycentric combinations of face vertices."""
    fv = points[..., static.faces, :]  # (..., F, 3, 3)
    pts = torch.einsum("gk,...fkc->...fgc", static.bary_coords, fv)
    return pts.reshape(points.shape[:-2] + (-1, 3))


def face_frame_quaternions(points: torch.Tensor, complex_rot: torch.Tensor,
                           static: SuGaRStatic) -> torch.Tensor:
    """Per-Gaussian wxyz quaternions from the face frame ⊗ the learned
    in-plane 2D rotation."""
    G = static.n_per_face
    fv = points[..., static.faces, :]
    n = face_normals(points, static.faces)  # (..., F, 3) = R_0
    e01 = fv[..., 0, :] - fv[..., 1, :]
    base1 = e01 / (torch.linalg.norm(e01, dim=-1, keepdim=True) + 1e-12)
    base2 = cross(n, base1)
    base2 = base2 / (torch.linalg.norm(base2, dim=-1, keepdim=True) + 1e-12)

    c = quat_normalize(complex_rot) if complex_rot.shape[-1] == 4 else (
        complex_rot / (torch.linalg.norm(complex_rot, dim=-1, keepdim=True) + 1e-12)
    )
    c = c.reshape(c.shape[:-2] + (-1, G, 2))  # (..., F, G, 2)
    R1 = c[..., 0:1] * base1[..., None, :] + c[..., 1:2] * base2[..., None, :]
    R2 = -c[..., 1:2] * base1[..., None, :] + c[..., 0:1] * base2[..., None, :]
    R0 = n[..., None, :].expand(R1.shape)
    R = torch.stack([R0, R1, R2], dim=-1)  # columns (..., F, G, 3, 3)
    return matrix_to_quat(R.reshape(R.shape[:-4] + (-1, 3, 3)))


def gaussian_attributes(params: SuGaRParams, static: SuGaRStatic,
                        points_override: Optional[torch.Tensor] = None) -> GaussianAttrs:
    """Full renderable attribute bundle from the current parameters."""
    pts = params.points if points_override is None else points_override
    means = gaussian_centers(pts, static)
    quats = face_frame_quaternions(pts, params.complex_rot, static)
    s2 = torch.exp(params.log_scales)
    thickness = torch.full(s2.shape[:-1] + (1,), static.surface_mesh_thickness,
                           dtype=s2.dtype, device=s2.device)
    scales = torch.cat([thickness, s2], -1)
    opac = torch.sigmoid(params.density_logits)
    dc = torch.clamp(params.sh_dc, -static.color_clip, static.color_clip)
    sh = torch.cat([dc, params.sh_rest], -2)  # (N, B, 3)
    sh = sh.transpose(-1, -2)  # (N, 3, B)
    return GaussianAttrs(means, quats, scales, opac, sh)

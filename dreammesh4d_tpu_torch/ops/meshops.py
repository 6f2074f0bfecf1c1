"""Mesh ops (counterpart of ``dreammesh4d_tpu/ops/meshops.py``): face normals
and the differentiable mesh losses in torch, and the host-side numpy
topology constructors (``build_edge_adjacency`` :63, ``build_one_ring`` :85,
``cotangent_weights`` :103)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .quaternion import cross, quat_apply


def face_normals(verts: torch.Tensor, faces: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Per-face normals (..., F, 3), counter-clockwise winding; ``verts`` may
    carry leading batch dims (..., V, 3).  The corners are gathered with
    ``index_select``, whose backward adds into the vertices with atomics:
    indexing's backward sorts its indices, which on CUDA takes seconds when
    millions of faces share a vertex (a marching-tets surface's masked slots)."""
    faces = faces.long()
    v0 = torch.index_select(verts, -2, faces[:, 0])
    v1 = torch.index_select(verts, -2, faces[:, 1])
    v2 = torch.index_select(verts, -2, faces[:, 2])
    n = cross(v1 - v0, v2 - v0)
    if normalize:
        # rsqrt(|n|²+eps): finite at zero-area faces
        n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-20)
    return n


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals (V, 3) by scatter-add (``vertex_normals``
    :42); rsqrt(|n|²+eps) keeps vertices without a face finite."""
    fn = face_normals(verts, faces, normalize=False)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(-2, faces[:, k].long(), fn)
    return vn * torch.rsqrt((vn * vn).sum(-1, keepdim=True) + 1e-20)


class EdgeAdjacency(NamedTuple):
    """Pairs of faces sharing an interior edge (for normal consistency)."""

    face_pairs: np.ndarray  # (E, 2) int32


def build_edge_adjacency(faces: np.ndarray) -> EdgeAdjacency:
    edges = {}
    faces = np.asarray(faces)
    for f_idx, (a, b, c) in enumerate(faces):
        for (u, v) in ((a, b), (b, c), (c, a)):
            key = (min(u, v), max(u, v))
            edges.setdefault(key, []).append(f_idx)
    pairs = [fs[:2] for fs in edges.values() if len(fs) >= 2]
    if not pairs:
        pairs = [[0, 0]]
    return EdgeAdjacency(np.asarray(pairs, np.int32))


class OneRing(NamedTuple):
    """Fixed-capacity one-ring neighbourhoods (padded arrays)."""

    neighbor_idx: np.ndarray  # (V, K) int32, padded with self-index
    neighbor_mask: np.ndarray  # (V, K) bool
    degrees: np.ndarray  # (V,) int32


def build_one_ring(faces: np.ndarray, num_verts: int, max_degree: int = 16) -> OneRing:
    nbrs = [set() for _ in range(num_verts)]
    for (a, b, c) in np.asarray(faces):
        nbrs[a].update((b, c))
        nbrs[b].update((a, c))
        nbrs[c].update((a, b))
    idx = np.zeros((num_verts, max_degree), np.int32)
    mask = np.zeros((num_verts, max_degree), bool)
    deg = np.zeros((num_verts,), np.int32)
    for v, ns in enumerate(nbrs):
        ns = sorted(ns)[:max_degree]
        deg[v] = len(ns)
        idx[v, : len(ns)] = ns
        idx[v, len(ns):] = v
        mask[v, : len(ns)] = True
    return OneRing(idx, mask, deg)


def cotangent_weights(verts: np.ndarray, faces: np.ndarray, ring: OneRing,
                      clamp_min: float = 0.0) -> np.ndarray:
    """Per-directed-edge cotangent weights in one-ring layout (V, K):
    w_ij = 0.5 (cot α_ij + cot β_ij), both wing triangles accumulated per
    undirected edge, clamped at ``clamp_min``."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    V, K = ring.neighbor_idx.shape
    w_edge: dict = {}
    for (a, b, c) in faces:
        # the angle at `opp` is opposite to the edge (u, v)
        for (u, v, opp) in ((a, b, c), (b, c, a), (c, a, b)):
            e1 = verts[u] - verts[opp]
            e2 = verts[v] - verts[opp]
            cr = np.linalg.norm(np.cross(e1, e2))
            cot = float(np.dot(e1, e2) / max(cr, 1e-12))
            key = (min(u, v), max(u, v))
            w_edge[key] = w_edge.get(key, 0.0) + 0.5 * cot
    W = np.zeros((V, K), np.float32)
    for v in range(V):
        for k in range(K):
            if ring.neighbor_mask[v, k]:
                key = (min(v, ring.neighbor_idx[v, k]), max(v, ring.neighbor_idx[v, k]))
                W[v, k] = max(w_edge.get(key, 0.0), clamp_min)
    return W


# ---------------------------------------------------------------------------
# Losses (differentiable)
# ---------------------------------------------------------------------------


def normal_consistency_loss(verts: torch.Tensor, faces: torch.Tensor,
                            face_pairs: torch.Tensor) -> torch.Tensor:
    """Mean (1 − cos) between the normals of adjacent faces.  Near-zero-area
    faces are excluded through a detached indicator, so a sliver contributes
    nothing to the loss or to its gradient (its normalized normal's gradient
    is ~rsqrt(eps))."""
    v0 = verts[..., faces[:, 0], :]
    v1 = verts[..., faces[:, 1], :]
    v2 = verts[..., faces[:, 2], :]
    n_raw = cross(v1 - v0, v2 - v0)
    a2 = (n_raw * n_raw).sum(-1)  # (2·area)²
    scale2 = torch.clamp(((v1 - v0) ** 2).sum(-1) * ((v2 - v0) ** 2).sum(-1), min=1e-30)
    ok = (a2 > 1e-8 * scale2).detach()  # relative sliver test
    n = n_raw * torch.rsqrt(a2[..., None] + 1e-20)
    cos = (n[..., face_pairs[:, 0], :] * n[..., face_pairs[:, 1], :]).sum(-1)
    w = (ok[..., face_pairs[:, 0]] & ok[..., face_pairs[:, 1]]).to(verts.dtype)
    return ((1.0 - cos) * w).sum() / torch.clamp(w.sum(), min=1.0)


def laplacian_smoothing_loss(verts: torch.Tensor,
                             ring: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Uniform Laplacian magnitude mean_i ‖(1/deg_i) Σ_j v_j − v_i‖, with
    sqrt(· + eps) instead of a norm: the norm's gradient is 0/0 at a vertex
    that sits at its ring centroid."""
    idx, mask = ring
    nb = verts[..., idx, :]  # (..., V, K, 3)
    m = mask[..., None].to(verts.dtype)
    deg = torch.clamp(mask.sum(-1), min=1)[..., None].to(verts.dtype)
    lap = (nb * m).sum(-2) / deg - verts
    return torch.sqrt((lap * lap).sum(-1) + 1e-20).mean()


def arap_energy(verts_ref: torch.Tensor, verts_def: torch.Tensor, neighbor_idx: torch.Tensor,
                neighbor_mask: torch.Tensor, weights: torch.Tensor,
                rotations: Optional[torch.Tensor] = None) -> torch.Tensor:
    """As-rigid-as-possible energy Σ_i Σ_j w_ij ‖(p'_i − p'_j) − R_i (p_i − p_j)‖²
    over the weight sum.  Without ``rotations`` (..., V, 3, 3), per-vertex
    best-fit rotations come from the SVD of the weighted covariance
    S_i = Σ_j w_ij e_ij e'_ijᵀ with the det flip, as constants (S detached)."""
    m = (neighbor_mask & (neighbor_idx >= 0)).to(verts_ref.dtype) * weights  # (V, K)
    e_ref = verts_ref[..., :, None, :] - verts_ref[..., neighbor_idx, :]  # (V, K, 3)
    e_def = verts_def[..., :, None, :] - verts_def[..., neighbor_idx, :]
    if rotations is None:
        S = torch.einsum("...vk,...vki,...vkj->...vij", m, e_ref, e_def).detach()
        U, _, Vt = torch.linalg.svd(S)
        det = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
        D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
        R = Vt.transpose(-1, -2) @ (D[..., :, None] * U.transpose(-1, -2))
    else:
        R = rotations
    rot_e = torch.einsum("...vij,...vkj->...vki", R, e_ref)
    diff = e_def - rot_e
    return (m * (diff ** 2).sum(-1)).sum() / torch.clamp(m.sum(), min=1.0)


def arap_energy_quat_planar(e_ref_p: torch.Tensor, idx_t: torch.Tensor, m_t: torch.Tensor,
                            verts_def: torch.Tensor, rot_quats: torch.Tensor) -> torch.Tensor:
    """ARAP with given per-vertex rotation quaternions, the dynamic stage's
    path: the same energy as :func:`arap_energy` with ``rotations`` given,
    summed over all leading batch dims and divided by the weight sum.

    Same arguments as the JAX package: e_ref_p (3, K, V) rest-pose edges
    (``rest.T[:, None, :] - rest.T[:, idx_t]``), idx_t (K, V) transposed
    neighbour indices, m_t (K, V) mask·weights, verts_def (..., V, 3),
    rot_quats (..., V, 4) wxyz.  Inside, the component axis goes last, the
    layout of the port's quaternion functions."""
    e_ref = e_ref_p.permute(1, 2, 0)  # (K, V, 3)
    e_def = verts_def[..., None, :, :] - verts_def[..., idx_t, :]  # (..., K, V, 3)
    rot_e = quat_apply(rot_quats[..., None, :, :], e_ref)  # (..., K, V, 3)
    diff = e_def - rot_e
    return (m_t * (diff * diff).sum(-1)).sum() / torch.clamp(m_t.sum(), min=1.0)


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """Total variation on (..., H, W, C) images."""
    dh = img[..., 1:, :, :] - img[..., :-1, :, :]
    dw = img[..., :, 1:, :] - img[..., :, :-1, :]
    return (dh ** 2).mean() + (dw ** 2).mean()

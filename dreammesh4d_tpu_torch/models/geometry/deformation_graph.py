"""Deformation-graph construction, host-side numpy/scipy (own copy of
``dreammesh4d_tpu/models/geometry/deformation_graph.py``; the same seed gives
the same graph, bit for bit, under the same numpy/scipy).

- graph nodes: area-weighted uniform samples on the mesh surface;
- per-vertex K nearest nodes by euclidean distance (``eucdisc``, cKDTree) or
  by GEODESIC distance (``geodisc``) ranked with the heat method (Crane et
  al. 2013) on scipy sparse LU solves;
- binding weights ``(1 − d_i/d_{K+1})²`` on euclidean vert→node distances,
  normalized — geodesics only drive the ranking.

The heat method solves from the ``n_nodes`` node-anchor vertices (one
factorization, batched right-hand sides).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


class DeformationGraph(NamedTuple):
    node_xyz: np.ndarray  # (M, 3) float32
    neighbor_idx: np.ndarray  # (V, K) int32 — per-vertex K nearest nodes
    neighbor_weights: np.ndarray  # (V, K) float32, normalized
    node_anchor_vertex: np.ndarray  # (M,) int32 nearest mesh vertex per node


def sample_points_on_mesh(verts: np.ndarray, faces: np.ndarray, n: int,
                          seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface samples (o3d sample_points_uniformly)."""
    rng = np.random.RandomState(seed)
    v = verts[faces]  # (F,3,3)
    areas = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
    probs = areas / areas.sum()
    face_idx = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    a, b, c = v[face_idx, 0], v[face_idx, 1], v[face_idx, 2]
    return ((1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c).astype(np.float32)


def _cotangent_laplacian(verts: np.ndarray, faces: np.ndarray) -> Tuple[sp.csc_matrix, np.ndarray]:
    """(L, vertex_masses): positive semi-definite cotan Laplacian L = D − W and
    lumped (barycentric) vertex areas."""
    V = len(verts)
    i_all, j_all, w_all = [], [], []
    areas = np.zeros(V)
    v = verts[faces].astype(np.float64)
    face_area = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
    for k in range(3):
        areas += np.bincount(faces[:, k], weights=face_area / 3.0, minlength=V)
    for k in range(3):
        # edge (a, b) opposite vertex c
        a = faces[:, k]
        b = faces[:, (k + 1) % 3]
        c = faces[:, (k + 2) % 3]
        e1 = verts[a] - verts[c]
        e2 = verts[b] - verts[c]
        cross = np.linalg.norm(np.cross(e1, e2), axis=-1)
        cot = (e1 * e2).sum(-1) / np.maximum(cross, 1e-12)
        w = 0.5 * cot
        i_all += [a, b]
        j_all += [b, a]
        w_all += [w, w]
    i = np.concatenate(i_all)
    j = np.concatenate(j_all)
    w = np.concatenate(w_all)
    W = sp.coo_matrix((w, (i, j)), shape=(V, V)).tocsr()
    D = sp.diags(np.asarray(W.sum(1)).ravel())
    L = (D - W).tocsc()
    return L, areas


def heat_geodesic_distances(verts: np.ndarray, faces: np.ndarray,
                            sources: np.ndarray) -> np.ndarray:
    """Geodesic distances from each source vertex to all vertices: (S, V).

    Heat method: (M + tL) u = δ; X = −∇u/‖∇u‖ per face; solve L φ = ∇·X.
    One splu factorization each, batched over all sources."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    V = len(verts)
    S = len(sources)
    L, mass = _cotangent_laplacian(verts, faces)
    edge_len = np.linalg.norm(verts[faces[:, 0]] - verts[faces[:, 1]], axis=-1)
    t = float(np.mean(edge_len)) ** 2

    A = (sp.diags(mass) + t * L).tocsc()
    heat_solver = spla.splu(A)
    delta = np.zeros((V, S))
    delta[sources, np.arange(S)] = 1.0
    u = heat_solver.solve(delta)  # (V, S)

    # per-face gradient of u: grad u = Σ_i u_i (n × e_opp_i) / (2A_f)
    fv = verts[faces]  # (F,3,3)
    n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    dblA = np.linalg.norm(n, axis=-1, keepdims=True)
    n_unit = n / np.maximum(dblA, 1e-12)
    grads = np.zeros((len(faces), 3, S))
    for k in range(3):
        e_opp = fv[:, (k + 2) % 3] - fv[:, (k + 1) % 3]  # edge opposite vertex k
        rot = np.cross(n_unit, e_opp)  # (F,3)
        grads += rot[:, :, None] * u[faces[:, k]][:, None, :]
    grads /= np.maximum(dblA[:, :, None], 1e-12)
    norm = np.linalg.norm(grads, axis=1, keepdims=True)
    X = -grads / np.maximum(norm, 1e-12)  # (F,3,S)

    # integrated divergence at vertices
    div = np.zeros((V, S))
    for k in range(3):
        # at vertex k of each face: 0.5*(cot θ1 e1·X + cot θ2 e2·X)
        i0 = faces[:, k]
        i1 = faces[:, (k + 1) % 3]
        i2 = faces[:, (k + 2) % 3]
        e1 = verts[i1] - verts[i0]
        e2 = verts[i2] - verts[i0]
        # angles opposite the edges
        o1 = verts[i1] - verts[i2]  # at vertex i2, opposite e1
        o2 = verts[i0] - verts[i2]
        cot1 = (o1 * o2).sum(-1) / np.maximum(np.linalg.norm(np.cross(o1, o2), axis=-1), 1e-12)
        p1 = verts[i2] - verts[i1]  # at vertex i1, opposite e2
        p2 = verts[i0] - verts[i1]
        cot2 = (p1 * p2).sum(-1) / np.maximum(np.linalg.norm(np.cross(p1, p2), axis=-1), 1e-12)
        contrib = 0.5 * (
            cot1[:, None] * np.einsum("fc,fcs->fs", e1, X)
            + cot2[:, None] * np.einsum("fc,fcs->fs", e2, X)
        )
        np.add.at(div, i0, contrib)

    L_reg = (L + sp.eye(V) * 1e-8).tocsc()
    phi_solver = spla.splu(L_reg)
    phi = phi_solver.solve(div)  # (V, S)
    phi = phi - phi[sources, np.arange(S)][None, :]
    return np.abs(phi.T)  # (S, V), distances >= 0 with d(source)=0


def build_deformation_graph(
    verts: np.ndarray,
    faces: np.ndarray,
    n_nodes: int = 1000,
    nodes_connectivity: int = 4,
    mode: str = "geodisc",
    seed: int = 0,
    node_xyz: np.ndarray | None = None,
) -> DeformationGraph:
    """Parity with dynamic_sugar.py:745-861 (see module docstring)."""
    from scipy.spatial import cKDTree

    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    if node_xyz is None:
        node_xyz = sample_points_on_mesh(verts, faces, n_nodes, seed)
    else:
        node_xyz = np.asarray(node_xyz, np.float32)
        n_nodes = len(node_xyz)

    vert_tree = cKDTree(verts)
    _, node_anchor = vert_tree.query(node_xyz, k=1)  # nearest mesh vertex per node

    K = nodes_connectivity
    if mode == "eucdisc":
        node_tree = cKDTree(node_xyz)
        d, idx = node_tree.query(verts, k=K)
        neighbor_idx = idx.astype(np.int32)
        weights = d.astype(np.float32)  # reference uses raw knn distances here
    elif mode == "geodisc":
        geo = heat_geodesic_distances(verts, faces, node_anchor.astype(np.int64))  # (M, V)
        geo_vn = geo.T  # (V, M) distance vertex -> node (via anchor)
        order = np.argsort(geo_vn, axis=1)
        knn = order[:, :K]  # (V, K)
        knn_p1 = order[:, :K + 1]
        # euclidean vert->node distances of the K+1 geodesic-nearest nodes
        d_eu = np.linalg.norm(verts[:, None, :] - node_xyz[knn_p1], axis=-1)  # (V,K+1)
        weights = (1.0 - d_eu[:, :K] / np.maximum(d_eu[:, K:K + 1], 1e-12)) ** 2
        neighbor_idx = knn.astype(np.int32)
        weights = weights.astype(np.float32)
    else:
        raise ValueError("mode must be eucdisc or geodisc")

    weights = weights / np.maximum(weights.sum(-1, keepdims=True), 1e-12)
    return DeformationGraph(
        node_xyz=np.asarray(node_xyz, np.float32),
        neighbor_idx=neighbor_idx,
        neighbor_weights=weights,
        node_anchor_vertex=node_anchor.astype(np.int32),
    )

"""Mesh ops (counterpart of ``dreammesh4d_tpu/ops/meshops.py``): face normals
in torch, and the host-side numpy topology constructors the SuGaR geometry
needs (``build_edge_adjacency`` :63, ``build_one_ring`` :85).  The mesh
losses come with the training slice."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .quaternion import cross


def face_normals(verts: torch.Tensor, faces: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Per-face normals (..., F, 3), counter-clockwise winding; ``verts`` may
    carry leading batch dims (..., V, 3)."""
    v0 = verts[..., faces[:, 0], :]
    v1 = verts[..., faces[:, 1], :]
    v2 = verts[..., faces[:, 2], :]
    n = cross(v1 - v0, v2 - v0)
    if normalize:
        # rsqrt(|n|²+eps): finite at zero-area faces
        n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-20)
    return n


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

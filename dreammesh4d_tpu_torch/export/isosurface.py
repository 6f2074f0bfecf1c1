"""Host-side isosurface extraction, the ``mc-cpu`` path (counterpart of
``dreammesh4d_tpu/export/isosurface.py``).

The extractor is marching tetrahedra in host C++ (``native/marching_tets.cpp``,
the port's own copy of the JAX package's source), built by ``host_build`` and
called through ``ctypes``.  Around it the reference geometry's behaviour: the
auto threshold, the grid -> world map onto the box and the removal of small
connected components (by ``scipy.sparse.csgraph``, where the JAX package runs
a Python union-find over every face: the same components, kept faces and
vertex order).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

from .. import host_build
from .mesh_io import MeshData

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)
_MT_ARGS = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(_I32P), ctypes.POINTER(ctypes.c_int)]


def marching_cubes(grid: np.ndarray, iso: float) -> Tuple[np.ndarray, np.ndarray]:
    """The iso-surface of a dense (nx, ny, nz) scalar grid: vertices (V, 3)
    float32 in GRID coordinates and faces (F, 3) int32, outward for the
    region above ``iso`` (the contract of ``mcubes.marching_cubes``)."""
    grid = np.ascontiguousarray(grid, np.float32)
    nx, ny, nz = grid.shape
    extract = host_build.entry("marching_tets", "mt_extract", _MT_ARGS)
    release = host_build.entry("marching_tets", "mt_free", [ctypes.c_void_p], restype=None)
    verts_p, faces_p = _F32P(), _I32P()
    nv, nf = ctypes.c_int(), ctypes.c_int()
    ret = extract(grid.ctypes.data_as(_F32P), nx, ny, nz, ctypes.c_float(iso),
                  ctypes.byref(verts_p), ctypes.byref(nv), ctypes.byref(faces_p), ctypes.byref(nf))
    if ret != 0:
        raise RuntimeError(f"mt_extract failed with code {ret}")
    try:
        verts = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(faces_p, shape=(nf.value, 3)).copy()
    finally:
        release(verts_p)
        release(faces_p)
    return verts.astype(np.float32), faces.astype(np.int32)


def extract_isosurface(
    density: np.ndarray,
    threshold: Optional[float] = None,
    bbox_min=(-1.0, -1.0, -1.0),
    bbox_max=(1.0, 1.0, 1.0),
    remove_outliers: bool = True,
    outlier_ratio: float = 0.1,
) -> MeshData:
    """The mesh of a density grid over the box: ``threshold`` None takes
    mean(density[density > 1e-5]) (0 when no cell is above); vertices mapped
    from grid to world coordinates; components with fewer than
    ``outlier_ratio`` × the largest's faces removed."""
    if threshold is None:
        sel = density > 1e-5
        threshold = float(density[sel].mean()) if sel.any() else 0.0
    verts, faces = marching_cubes(density, threshold)
    if len(verts) == 0:
        return MeshData(v_pos=np.zeros((0, 3), np.float32), t_pos_idx=np.zeros((0, 3), np.int32))
    res = np.asarray(density.shape, np.float32)
    lo = np.asarray(bbox_min, np.float32)
    hi = np.asarray(bbox_max, np.float32)
    mesh = MeshData(v_pos=(lo + verts / (res - 1.0) * (hi - lo)).astype(np.float32), t_pos_idx=faces)
    if remove_outliers and len(faces):
        mesh = remove_small_components(mesh, outlier_ratio)
    return mesh


def remove_small_components(mesh: MeshData, min_ratio: float = 0.1) -> MeshData:
    """Drop the connected components (faces sharing vertices) with fewer than
    ``min_ratio`` × the largest component's faces; the kept vertices in
    ascending order of their old index."""
    faces = mesh.t_pos_idx
    n = mesh.n_verts
    a = faces[:, 0].astype(np.int64)
    graph = sp.coo_matrix((np.ones(2 * len(faces), np.int8),
                           (np.concatenate([a, a]), np.concatenate([faces[:, 1], faces[:, 2]]))),
                          shape=(n, n))
    _, labels = connected_components(graph, directed=False)
    face_label = labels[a]
    sizes = np.bincount(face_label)
    keep = sizes[face_label] >= min_ratio * sizes.max()
    new_faces = faces[keep]
    used = np.unique(new_faces)
    remap = -np.ones(n, np.int64)
    remap[used] = np.arange(len(used))
    return MeshData(
        v_pos=mesh.v_pos[used],
        t_pos_idx=remap[new_faces].astype(np.int32),
        v_rgb=mesh.v_rgb[used] if mesh.v_rgb is not None else None,
    )

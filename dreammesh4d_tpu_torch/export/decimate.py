"""Quadric edge-collapse mesh decimation (counterpart of
``dreammesh4d_tpu/export/decimate.py``).

Garland-Heckbert QEM with area-weighted plane quadrics, boundary constraint
quadrics, optimal-placement collapses and normal-flip rejection, in host C++
(``native/qem_decimate.cpp``, the port's own copy of the JAX package's
source), built by ``host_build`` and called through ``ctypes``.  Vertex
colours are carried by averaging the original vertices that collapse into
each output vertex.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .. import host_build
from .mesh_io import MeshData

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)
_QEM_ARGS = [_F32P, ctypes.c_int, _I32P, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(_I32P), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(_I32P)]


def quadric_decimate(mesh: MeshData, target_faces: Optional[int] = None,
                     ratio: Optional[float] = None) -> MeshData:
    """``mesh`` decimated to ``target_faces`` (or ``ratio`` of its faces, at
    least 4); colours averaged over each output vertex's collapsed sources."""
    if target_faces is None:
        if ratio is None:
            raise ValueError("pass target_faces or ratio")
        target_faces = max(4, int(round(mesh.n_faces * float(ratio))))
    target_faces = max(0, int(target_faces))

    verts = np.ascontiguousarray(mesh.v_pos, np.float32)
    faces = np.ascontiguousarray(mesh.t_pos_idx, np.int32)
    nv, nf = len(verts), len(faces)
    decimate = host_build.entry("qem_decimate", "qem_decimate", _QEM_ARGS)
    release = host_build.entry("qem_decimate", "qem_free", [ctypes.c_void_p], restype=None)
    overts, ofaces, omap = _F32P(), _I32P(), _I32P()
    onv, onf = ctypes.c_int(), ctypes.c_int()
    ret = decimate(verts.ctypes.data_as(_F32P), nv, faces.ctypes.data_as(_I32P), nf, target_faces,
                   ctypes.byref(overts), ctypes.byref(onv), ctypes.byref(ofaces), ctypes.byref(onf),
                   ctypes.byref(omap))
    if ret != 0:
        raise RuntimeError(f"qem_decimate failed with code {ret}")
    try:
        new_v = np.ctypeslib.as_array(overts, shape=(onv.value, 3)).copy()
        new_f = np.ctypeslib.as_array(ofaces, shape=(onf.value, 3)).copy()
        vmap = np.ctypeslib.as_array(omap, shape=(nv,)).copy()
    finally:
        release(overts)
        release(ofaces)
        release(omap)

    new_rgb = None
    if mesh.v_rgb is not None and onv.value > 0:
        src = np.asarray(mesh.v_rgb, np.float64)
        valid = vmap >= 0
        counts = np.maximum(np.bincount(vmap[valid], minlength=onv.value).astype(np.float64), 1.0)
        new_rgb = np.stack([np.bincount(vmap[valid], weights=src[valid, d], minlength=onv.value)
                            for d in range(3)], -1)
        new_rgb = (new_rgb / counts[:, None]).astype(np.float32)
    return MeshData(v_pos=new_v.astype(np.float32), t_pos_idx=new_f.astype(np.int32), v_rgb=new_rgb)

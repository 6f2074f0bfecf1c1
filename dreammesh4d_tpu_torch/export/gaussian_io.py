"""Gaussian PLY IO in the standard 3DGS attribute layout, numpy only
(counterpart of ``dreammesh4d_tpu/export/gaussian_io.py``:
``save_gaussians_ply`` :18, ``load_gaussians_ply`` :60): x/y/z, nx/ny/nz,
f_dc_0..2, f_rest_*, opacity, scale_0..2, rot_0..3 — files that 3DGS viewers
and the reference loader read."""

from __future__ import annotations

import os

import numpy as np

from .mesh_io import load_ply


def save_gaussians_ply(path: str, xyz: np.ndarray, sh: np.ndarray, opacity_logits: np.ndarray,
                       log_scales: np.ndarray, quats: np.ndarray) -> None:
    """xyz (N, 3); sh (N, B, 3) with DC first (band-major); opacity logits
    (N,) or (N, 1); log scales (N, 3); quaternions (N, 4) wxyz."""
    N = len(xyz)
    sh = np.asarray(sh, np.float32)
    f_dc = sh[:, 0, :]  # (N, 3)
    f_rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(N, -1)  # channel-major, as 3DGS writes it
    opacity = np.asarray(opacity_logits, np.float32).reshape(N, 1)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    data = np.concatenate([
        np.asarray(xyz, np.float32), np.zeros((N, 3), np.float32), f_dc, f_rest,
        opacity, np.asarray(log_scales, np.float32), np.asarray(quats, np.float32),
    ], -1).astype("<f4")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {N}"]
    header += [f"property float {n}" for n in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data).tobytes())


def load_gaussians_ply(path: str) -> dict:
    """-> dict(xyz, sh (N, B, 3), opacity_logits, log_scales, quats wxyz)."""
    ply = load_ply(path)["vertex"]
    xyz = np.stack([ply["x"], ply["y"], ply["z"]], -1).astype(np.float32)
    N = len(xyz)
    f_dc = np.stack([ply[f"f_dc_{i}"] for i in range(3)], -1)  # (N, 3)
    rest_keys = sorted((k for k in ply if k.startswith("f_rest_")),
                       key=lambda s: int(s.split("_")[-1]))
    if rest_keys:
        f_rest = np.stack([ply[k] for k in rest_keys], -1).reshape(N, 3, -1).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((N, 0, 3), np.float32)
    return {
        "xyz": xyz,
        "sh": np.concatenate([f_dc[:, None, :], f_rest], 1).astype(np.float32),
        "opacity_logits": np.asarray(ply["opacity"], np.float32),
        "log_scales": np.stack([ply[f"scale_{i}"] for i in range(3)], -1).astype(np.float32),
        "quats": np.stack([ply[f"rot_{i}"] for i in range(4)], -1).astype(np.float32),
    }

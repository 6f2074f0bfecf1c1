"""Mesh simplification, stage 3 of the recipe (counterpart of the
repository's ``scripts/mesh_simplification.py``, with the same command line):

    python3 -m dreammesh4d_tpu_torch.scripts.mesh_simplification --mesh_path coarse.obj --scale 30
    python3 -m dreammesh4d_tpu_torch.scripts.mesh_simplification --mesh_path coarse.obj \\
        --method quadric --target_faces 5000

``cluster`` (the default): vertex clustering with voxel size = bbox diagonal
/ ``scale``, vertices (and colours) averaged per voxel, written as
``{name}_{scale}_{nverts}.ply`` next to the input.  ``quadric``: QEM edge
collapse to ``target_faces`` (default a quarter of the faces), written as
``{name}_qem{faces}_{nverts}.ply``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..export.mesh_io import MeshData, load_mesh, save_ply_mesh


def simplify_vertex_clustering(mesh: MeshData, voxel_size: float) -> MeshData:
    """One vertex per occupied voxel at the mean of its vertices (and
    colours); faces mapped onto them, degenerate ones dropped, duplicates
    (in any rotation) kept once in the order of their first appearance."""
    v = np.asarray(mesh.v_pos, np.float64)
    keys = np.floor((v - v.min(0)) / voxel_size).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    n_clusters = len(uniq)
    counts = np.bincount(inverse, minlength=n_clusters).astype(np.float64)

    def cluster_mean(x):
        x = np.asarray(x, np.float64)
        return np.stack([np.bincount(inverse, weights=x[:, d], minlength=n_clusters)
                         for d in range(3)], -1) / counts[:, None]

    new_v = cluster_mean(v)
    new_rgb = cluster_mean(mesh.v_rgb) if mesh.v_rgb is not None else None
    faces = inverse[mesh.t_pos_idx]
    nondegenerate = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                     & (faces[:, 0] != faces[:, 2]))
    faces = faces[nondegenerate]
    _, first = np.unique(np.sort(faces, axis=1), axis=0, return_index=True)
    faces = faces[np.sort(first)]
    return MeshData(v_pos=new_v.astype(np.float32), t_pos_idx=faces.astype(np.int32),
                    v_rgb=new_rgb.astype(np.float32) if new_rgb is not None else None)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mesh_path", required=True)
    parser.add_argument("--scale", type=float, default=30.0,
                        help="bbox diagonal / scale = clustering voxel size")
    parser.add_argument("--method", choices=["cluster", "quadric"], default="cluster",
                        help="cluster = vertex clustering; quadric = QEM edge collapse")
    parser.add_argument("--target_faces", type=int, default=None,
                        help="quadric method: face budget (default n_faces/4)")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    """Simplify ``--mesh_path``, write the result beside it and print one
    line; returns the written path."""
    args = parse_args(argv)
    mesh = load_mesh(args.mesh_path)
    if args.method == "quadric":
        from ..export.decimate import quadric_decimate

        out = quadric_decimate(mesh, target_faces=args.target_faces or max(4, mesh.n_faces // 4))
        suffix = f"qem{out.n_faces}"
    else:
        diag = float(np.linalg.norm(mesh.v_pos.max(0) - mesh.v_pos.min(0)))
        out = simplify_vertex_clustering(mesh, diag / args.scale)
        suffix = f"{int(args.scale)}"
    out_path = f"{os.path.splitext(args.mesh_path)[0]}_{suffix}_{out.n_verts}.ply"
    save_ply_mesh(out_path, out)
    print(f"{mesh.n_verts} verts -> {out.n_verts} verts; saved {out_path}")
    return out_path


if __name__ == "__main__":
    main()

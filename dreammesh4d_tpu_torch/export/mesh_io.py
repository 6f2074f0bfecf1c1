"""Host-side mesh IO, numpy only (own copy of
``dreammesh4d_tpu/export/mesh_io.py``: ``MeshData`` :22, ``load_obj``,
``save_obj`` :83, ``load_ply``/``load_ply_mesh``, ``save_ply_mesh`` :237 and
``load_mesh`` :279).  The writers give the JAX package's bytes; a texture
PNG goes through the port's own encoder (``data/png.write_png``) in place of
imageio."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class MeshData:
    v_pos: np.ndarray  # (V, 3) float32
    t_pos_idx: np.ndarray  # (F, 3) int32
    v_rgb: Optional[np.ndarray] = None  # (V, 3) float [0,1]
    v_nrm: Optional[np.ndarray] = None  # (V, 3)
    v_tex: Optional[np.ndarray] = None  # (V, 2) uv
    t_tex_idx: Optional[np.ndarray] = None  # (F, 3)

    @property
    def n_verts(self):
        return len(self.v_pos)

    @property
    def n_faces(self):
        return len(self.t_pos_idx)


def load_obj(path: str) -> MeshData:
    verts, colors, normals, uvs = [], [], [], []
    faces, face_uvs = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
                if len(t) >= 7:
                    colors.append([float(x) for x in t[4:7]])
            elif t[0] == "vn":
                normals.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                uvs.append([float(x) for x in t[1:3]])
            elif t[0] == "f":
                idx = []
                uv_idx = []
                for tok in t[1:]:
                    parts = tok.split("/")
                    idx.append(int(parts[0]) - 1)
                    if len(parts) > 1 and parts[1]:
                        uv_idx.append(int(parts[1]) - 1)
                # triangulate fan
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
                    if uv_idx:
                        face_uvs.append([uv_idx[0], uv_idx[i], uv_idx[i + 1]])
    return MeshData(
        v_pos=np.asarray(verts, np.float32),
        t_pos_idx=np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32),
        v_rgb=np.asarray(colors, np.float32) if colors else None,
        v_nrm=np.asarray(normals, np.float32) if normals else None,
        v_tex=np.asarray(uvs, np.float32) if uvs else None,
        t_tex_idx=np.asarray(face_uvs, np.int32) if face_uvs else None,
    )


def save_obj(path: str, mesh: MeshData, mtl_name: Optional[str] = None,
             texture_map: Optional[np.ndarray] = None) -> None:
    """Write an OBJ; vertex colours inline (``v x y z r g b``); with
    ``mtl_name`` also ``<mtl_name>.mtl`` and, given ``texture_map`` (H, W, 3)
    in [0, 1], ``<mtl_name>.png`` beside it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lines = []
    if mtl_name is not None:
        lines.append(f"mtllib {mtl_name}.mtl")
    for i, v in enumerate(mesh.v_pos):
        if mesh.v_rgb is not None:
            c = mesh.v_rgb[i]
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}")
        else:
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    if mesh.v_tex is not None:
        for uv in mesh.v_tex:
            lines.append(f"vt {uv[0]:.6f} {uv[1]:.6f}")
    if mesh.v_nrm is not None:
        for n in mesh.v_nrm:
            lines.append(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}")
    if mtl_name is not None:
        lines.append(f"usemtl {mtl_name}")
    has_uv = mesh.v_tex is not None and mesh.t_tex_idx is not None
    for fi, f in enumerate(mesh.t_pos_idx):
        if has_uv:
            tf = mesh.t_tex_idx[fi]
            lines.append(f"f {f[0]+1}/{tf[0]+1} {f[1]+1}/{tf[1]+1} {f[2]+1}/{tf[2]+1}")
        else:
            lines.append(f"f {f[0]+1} {f[1]+1} {f[2]+1}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    if mtl_name is None:
        return
    out_dir = os.path.dirname(os.path.abspath(path))
    tex_file = f"{mtl_name}.png"
    with open(os.path.join(out_dir, f"{mtl_name}.mtl"), "w") as fh:
        fh.write(f"newmtl {mtl_name}\nKa 1.000 1.000 1.000\nKd 1.000 1.000 1.000\n"
                 f"Ks 0.000 0.000 0.000\nd 1.0\nillum 1\nmap_Kd {tex_file}\n")
    if texture_map is not None:
        from ..data.png import write_png

        img = np.clip(texture_map, 0.0, 1.0)
        write_png(os.path.join(out_dir, tex_file), (img * 255).astype(np.uint8))


_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def load_ply(path: str) -> dict:
    """Parse a PLY file (ascii or binary_little_endian) into
    {element_name: {prop: ndarray}}; list properties come back as (N, L)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append((t[4], _PLY_TYPES[t[3]], True, _PLY_TYPES[t[2]]))
            else:
                elements[-1][2].append((t[2], _PLY_TYPES[t[1]], False, None))

    out: dict = {}
    if fmt == "ascii":
        text_rows = body.decode("ascii").split("\n")
        row_i = 0
        for name, count, props in elements:
            cols: dict = {p[0]: [] for p in props}
            for _ in range(count):
                vals = text_rows[row_i].split()
                row_i += 1
                ci = 0
                for pname, _dt, is_list, _cdt in props:
                    if is_list:
                        ln = int(vals[ci]); ci += 1
                        cols[pname].append([float(x) for x in vals[ci: ci + ln]])
                        ci += ln
                    else:
                        cols[pname].append(float(vals[ci])); ci += 1
            out[name] = {p[0]: np.asarray(cols[p[0]], dtype=p[1]) for p in props}
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if not any(p[2] for p in props):
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                out[name] = {p[0]: np.ascontiguousarray(arr[p[0]]) for p in props}
            else:
                cols = {p[0]: [] for p in props}
                for _ in range(count):
                    for pname, dt_s, is_list, cdt in props:
                        if is_list:
                            cnt = np.frombuffer(body, dtype="<" + cdt, count=1, offset=off)[0]
                            off += np.dtype(cdt).itemsize
                            vals = np.frombuffer(body, dtype="<" + dt_s, count=int(cnt), offset=off)
                            off += np.dtype(dt_s).itemsize * int(cnt)
                            cols[pname].append(vals)
                        else:
                            v = np.frombuffer(body, dtype="<" + dt_s, count=1, offset=off)[0]
                            off += np.dtype(dt_s).itemsize
                            cols[pname].append(v)
                out[name] = {k: np.asarray(v) for k, v in cols.items()}
    else:
        raise ValueError(f"Unsupported PLY format {fmt!r}")
    return out


def load_ply_mesh(path: str) -> MeshData:
    ply = load_ply(path)
    v = ply["vertex"]
    v_pos = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    v_rgb = None
    if "red" in v:
        v_rgb = np.stack([v["red"], v["green"], v["blue"]], -1).astype(np.float32)
        if v_rgb.max() > 1.0:
            v_rgb = v_rgb / 255.0
    faces = np.zeros((0, 3), np.int32)
    if "face" in ply:
        key = "vertex_indices" if "vertex_indices" in ply["face"] else "vertex_index"
        faces = np.asarray(ply["face"][key], np.int32).reshape(-1, 3)
    return MeshData(v_pos=v_pos, t_pos_idx=faces, v_rgb=v_rgb)


def save_ply_mesh(path: str, mesh: MeshData, binary: bool = True) -> None:
    """Write a PLY mesh (binary little-endian or ascii), with uchar vertex
    colours when ``mesh.v_rgb`` is set."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    V, F = mesh.n_verts, mesh.n_faces
    has_rgb = mesh.v_rgb is not None
    header = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
              f"element vertex {V}",
              "property float x", "property float y", "property float z"]
    if has_rgb:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {F}", "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if has_rgb:
                dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("r", "u1"), ("g", "u1"), ("b", "u1")])
                arr = np.empty(V, dt)
                arr["x"], arr["y"], arr["z"] = mesh.v_pos.T
                rgb = np.clip(mesh.v_rgb * 255, 0, 255).astype(np.uint8)
                arr["r"], arr["g"], arr["b"] = rgb.T
            else:
                arr = mesh.v_pos.astype("<f4")
            f.write(arr.tobytes())
            fdt = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
            farr = np.empty(F, fdt)
            farr["n"] = 3
            farr["i"] = mesh.t_pos_idx
            f.write(farr.tobytes())
        else:
            lines = []
            for i in range(V):
                row = f"{mesh.v_pos[i,0]} {mesh.v_pos[i,1]} {mesh.v_pos[i,2]}"
                if has_rgb:
                    rgb = np.clip(mesh.v_rgb[i] * 255, 0, 255).astype(int)
                    row += f" {rgb[0]} {rgb[1]} {rgb[2]}"
                lines.append(row)
            for i in range(F):
                t = mesh.t_pos_idx[i]
                lines.append(f"3 {t[0]} {t[1]} {t[2]}")
            f.write(("\n".join(lines) + "\n").encode("ascii"))


def load_mesh(path: str) -> MeshData:
    if path.endswith(".obj"):
        return load_obj(path)
    if path.endswith(".ply"):
        return load_ply_mesh(path)
    raise ValueError(f"Unsupported mesh format: {path}")

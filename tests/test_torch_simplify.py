"""The port's stage 3, mesh simplification, against the JAX package's tool
(CPU).

On a seeded, noisy, coloured icosphere(4) (5120 faces):

- ``simplify_vertex_clustering`` equals the JAX tool's function exactly at
  several voxel sizes (vertices, colours, faces and their order);
- ``quadric_decimate`` equals the JAX function exactly (by face target and by
  ratio), its colours averaged through the collapse map the same way;
- the command line (``--method cluster --scale``, ``--method quadric
  --target_faces`` and the default target of a quarter of the faces) writes
  the same file name with the same bytes and prints the same line as
  ``scripts/mesh_simplification.py``.

The QEM library is built from the port's own copy of the C++ source.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from dreammesh4d_tpu.export.decimate import quadric_decimate as j_quadric_decimate
from dreammesh4d_tpu.export.mesh_io import MeshData as JMeshData
from dreammesh4d_tpu_torch.export.decimate import quadric_decimate
from dreammesh4d_tpu_torch.export.mesh_io import MeshData, save_obj
from dreammesh4d_tpu_torch.scripts import mesh_simplification as tool
from dreammesh4d_tpu_torch.utils.procedural import make_icosphere

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_mesh_simplification", os.path.join(REPO, "scripts", "mesh_simplification.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JTOOL = _jax_tool()


def noisy_sphere():
    sphere = make_icosphere(4, radius=0.8)
    rng = np.random.default_rng(0)
    v = sphere.v_pos * (1.0 + 0.05 * rng.normal(size=(len(sphere.v_pos), 1)))
    rgb = np.clip(sphere.v_rgb + 0.1 * rng.normal(size=sphere.v_rgb.shape), 0, 1)
    return MeshData(v_pos=v.astype(np.float32), t_pos_idx=sphere.t_pos_idx.astype(np.int32),
                    v_rgb=rgb.astype(np.float32))


def as_jax(mesh):
    return JMeshData(v_pos=mesh.v_pos, t_pos_idx=mesh.t_pos_idx, v_rgb=mesh.v_rgb)


def assert_mesh_equal(got, ref):
    for k in ("v_pos", "t_pos_idx", "v_rgb"):
        a, b = getattr(got, k), getattr(ref, k)
        assert (a is None) == (b is None), k
        if b is not None:
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("scale", [4.0, 8.0, 16.0, 30.0])
@pytest.mark.parametrize("colours", [True, False])
def test_vertex_clustering_matches_jax(scale, colours):
    mesh = noisy_sphere()
    if not colours:
        mesh.v_rgb = None
    voxel = float(np.linalg.norm(mesh.v_pos.max(0) - mesh.v_pos.min(0))) / scale
    got = tool.simplify_vertex_clustering(mesh, voxel)
    ref = JTOOL.simplify_vertex_clustering(as_jax(mesh), voxel)
    assert 0 < got.n_faces < mesh.n_faces
    assert_mesh_equal(got, ref)


@pytest.mark.parametrize("target,ratio", [(2000, None), (300, None), (50, None), (None, 0.1)])
def test_quadric_decimate_matches_jax(target, ratio):
    mesh = noisy_sphere()
    got = quadric_decimate(mesh, target_faces=target, ratio=ratio)
    ref = j_quadric_decimate(as_jax(mesh), target_faces=target, ratio=ratio)
    assert_mesh_equal(got, ref)
    want = target if target is not None else round(0.1 * mesh.n_faces)
    assert got.n_faces <= want and got.n_faces > 0.8 * want
    assert got.v_rgb.min() >= 0.0 and got.v_rgb.max() <= 1.0
    with pytest.raises(ValueError):
        quadric_decimate(mesh)


@pytest.mark.parametrize("argv", [["--scale", "16"], ["--scale", "30"],
                                  ["--method", "quadric", "--target_faces", "500"],
                                  ["--method", "quadric"]])
def test_command_line_matches_jax(argv, tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "coarse.obj")
    save_obj(path, noisy_sphere())
    full = ["--mesh_path", path] + argv
    monkeypatch.setattr(sys, "argv", ["mesh_simplification.py"] + full)
    JTOOL.main()
    ref_line = capsys.readouterr().out
    (ref_name,) = [n for n in os.listdir(tmp_path) if n.endswith(".ply")]
    ref_bytes = (tmp_path / ref_name).read_bytes()
    os.remove(tmp_path / ref_name)

    out_path = tool.main(full)
    assert capsys.readouterr().out == ref_line
    assert os.path.basename(out_path) == ref_name
    assert (tmp_path / ref_name).read_bytes() == ref_bytes
    n_verts = int(ref_name.rsplit("_", 1)[1][:-4])
    assert ref_line == f"2562 verts -> {n_verts} verts; saved {out_path}\n"
    if argv[:2] == ["--method", "quadric"]:
        want = int(argv[3]) if len(argv) > 2 else 5120 // 4
        faces = int(ref_name.split("_qem")[1].split("_")[0])
        assert faces <= want
    else:
        assert ref_name.startswith(f"coarse_{argv[1]}_")

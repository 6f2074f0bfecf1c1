"""The port's ``mc-cpu`` isosurface export against the JAX package's (CPU).

``marching_cubes``, ``extract_isosurface`` and ``remove_small_components``
of ``dreammesh4d_tpu_torch.export.isosurface`` equal the JAX functions
exactly (vertices, faces, colours, bit for bit) on ``tests/test_isosurface.py``'s
sphere grids, a seeded random field of many components, and a coloured mesh
of several components.  The port's extractor is built from its own copy of
the C++ source into ``dreammesh4d_tpu_torch/_build/``; a failed build raises.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter

from dreammesh4d_tpu.export import isosurface as jiso
from dreammesh4d_tpu.export.mesh_io import MeshData as JMeshData
from dreammesh4d_tpu_torch import host_build
from dreammesh4d_tpu_torch.export import isosurface as tiso
from dreammesh4d_tpu_torch.export.mesh_io import MeshData

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_density(res=48, radius=0.6):
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return (radius - np.sqrt(x**2 + y**2 + z**2)).astype(np.float32)


def blob_density():
    d = sphere_density()
    d[2:5, 2:5, 2:5] = 0.5
    return d


def random_field():
    """Smoothed seeded noise: many blobs of many sizes, density-like (≥ 0)."""
    rng = np.random.default_rng(0)
    noise = uniform_filter(rng.uniform(size=(40, 36, 44)).astype(np.float32), size=5)
    return np.maximum(noise - np.quantile(noise, 0.8), 0.0).astype(np.float32) * 50


GRIDS = {"sphere24": lambda: sphere_density(24), "sphere48": sphere_density,
         "sphere_blob": blob_density, "random": random_field,
         "density": lambda: np.maximum(sphere_density(), 0.0) * 10}


def assert_mesh_equal(got, ref):
    np.testing.assert_array_equal(got.v_pos, ref.v_pos)
    np.testing.assert_array_equal(got.t_pos_idx, ref.t_pos_idx)
    assert got.v_pos.dtype == ref.v_pos.dtype and got.t_pos_idx.dtype == ref.t_pos_idx.dtype
    if ref.v_rgb is None:
        assert got.v_rgb is None
    else:
        np.testing.assert_array_equal(got.v_rgb, ref.v_rgb)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_marching_cubes_matches_jax(name):
    grid = GRIDS[name]()
    iso = 0.0 if name.startswith("sphere") else float(grid[grid > 1e-5].mean())
    verts, faces = tiso.marching_cubes(grid, iso)
    jverts, jfaces = jiso.marching_cubes(grid, iso)
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    assert verts.dtype == np.float32 and faces.dtype == np.int32


@pytest.mark.parametrize("remove_outliers", [True, False])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_extract_isosurface_matches_jax(name, remove_outliers):
    grid = GRIDS[name]()
    threshold = 0.0 if name.startswith("sphere") else None
    box = ((-2.0, -1.5, -1.0), (2.0, 1.5, 1.0))
    got = tiso.extract_isosurface(grid, threshold, *box, remove_outliers=remove_outliers)
    ref = jiso.extract_isosurface(grid, threshold, *box, remove_outliers=remove_outliers)
    assert got.n_faces > 100
    assert_mesh_equal(got, ref)
    if name == "sphere_blob":
        kept = tiso.extract_isosurface(grid, threshold, remove_outliers=False)
        assert (got.n_faces < kept.n_faces) == remove_outliers


def test_extract_isosurface_empty():
    grid = np.zeros((8, 8, 8), np.float32)
    got = tiso.extract_isosurface(grid)
    assert got.v_pos.shape == (0, 3) and got.t_pos_idx.shape == (0, 3)
    assert jiso.extract_isosurface(grid).n_verts == 0


@pytest.mark.parametrize("min_ratio", [0.0, 0.05, 0.1, 0.5, 1.0])
def test_remove_small_components_matches_jax(min_ratio):
    """A coloured mesh of the random field's components, its vertex order
    shuffled (so that the kept vertices' order is not the extractor's)."""
    verts, faces = tiso.marching_cubes(random_field(), 0.5)
    rng = np.random.default_rng(1)
    perm = rng.permutation(len(verts))
    inv = np.argsort(perm)
    mesh = MeshData(v_pos=verts[perm], t_pos_idx=inv[faces].astype(np.int32),
                    v_rgb=rng.uniform(size=(len(verts), 3)).astype(np.float32))
    jmesh = JMeshData(v_pos=mesh.v_pos, t_pos_idx=mesh.t_pos_idx, v_rgb=mesh.v_rgb)
    got = tiso.remove_small_components(mesh, min_ratio)
    ref = jiso.remove_small_components(jmesh, min_ratio)
    assert_mesh_equal(got, ref)
    assert 0 < got.n_faces <= mesh.n_faces
    if min_ratio == 0.0:
        assert got.n_faces == mesh.n_faces
    if min_ratio == 0.1:
        assert got.n_faces < mesh.n_faces  # the random field has small components


def test_library_is_the_ports_own_build(tmp_path, monkeypatch):
    tiso.marching_cubes(sphere_density(8), 0.0)
    path = host_build.library_path("marching_tets")
    assert path.exists() and path.parent == host_build.PKG_DIR / "_build"
    assert host_build.SRC_DIR == host_build.PKG_DIR / "native"
    # a source that does not compile raises, with no fallback
    (tmp_path / "broken.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(host_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="host library build failed"):
        host_build.load("broken")

"""The port's marching tetrahedra and ``tetrahedra-sdf-grid``
(``models/geometry/dmtet.py``) against the JAX package's (CPU).

- ``build_tet_grid`` equal (vertices, tets, edges, tet edges) at two
  resolutions, and the tables;
- ``marching_tets`` on a carried SDF and deformation (random signs around a
  sphere, so every sign configuration occurs): ``faces``, ``face_mask`` and
  ``vert_mask`` equal, ``verts`` within 1e-6; the masked slots point at
  vertex 0;
- the gradients of a weighted sum of the surface's vertices and of the
  feature head at them with respect to ``sdf``, ``deform``, the hash
  tables and the MLP within 1e-4 of each one's max (``fix_geometry``:
  none reaches ``sdf``);
- ``init_tet_sdf_grid``'s sphere SDF and ``export_mesh`` equal;
- ``registry.find("tetrahedra-sdf-grid")`` builds on the CPU.

The JAX references run under ``jax.jit`` with XLA's cheaper passes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import jit_fast

from dreammesh4d_tpu.models.geometry import dmtet as jdm
from dreammesh4d_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.geometry import dmtet as pdm
from dreammesh4d_tpu_torch.registry import find
from dreammesh4d_tpu_torch.utils.tree import tree_leaves

RES = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    print(f"{what}: {err:.3g} (band {rel:g})")
    assert err <= rel, (what, err)


def _cfg(fix_geometry=False):
    return jdm.TetSDFGridConfig(isosurface_resolution=RES, n_neurons=8, fix_geometry=fix_geometry,
                                hashgrid=JHashGridConfig(n_levels=2, log2_hashmap_size=8, base_resolution=4))


@pytest.fixture(scope="module")
def params():
    cfg = _cfg()
    p = jax.tree.map(np.asarray, jax.jit(lambda k: jdm.init_tet_sdf_grid(cfg, k))(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    p["sdf"] = (p["sdf"] + rng.normal(scale=0.15, size=p["sdf"].shape)).astype(np.float32)
    p["deform"] = rng.normal(scale=0.8, size=p["deform"].shape).astype(np.float32)
    p["encoding"]["tables"] = rng.uniform(-0.3, 0.3, p["encoding"]["tables"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("res", [3, RES])
def test_tet_grid_equal(res):
    want, got = jdm.build_tet_grid(res), pdm.build_tet_grid(res)
    for name in ("verts", "tets", "edges", "tet_edges"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(pdm._TRIANGLE_TABLE, jdm._TRIANGLE_TABLE)
    np.testing.assert_array_equal(pdm._NUM_TRIANGLES, jdm._NUM_TRIANGLES)
    assert pdm.build_tet_grid(res) is got  # cached


def test_init_and_export_mesh_equal():
    cfg = dataclasses.replace(_cfg(), isosurface_resolution=12, init_shape_radius=0.45)
    want = jax.tree.map(np.asarray, jax.jit(lambda k: jdm.init_tet_sdf_grid(cfg, k))(jax.random.PRNGKey(0)))
    pc = convert.geometry_config(cfg)
    got = pdm.init_tet_sdf_grid(pc, device="cpu")
    _close(got["sdf"], want["sdf"], 1e-6, "sphere sdf")
    assert not got["deform"].any() and got["deform"].shape == want["deform"].shape
    wv, wf = jdm.export_mesh(want, cfg)
    gv, gf = pdm.export_mesh(convert.geometry_params(want, "cpu"), pc)
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_array_equal(gv, wv)
    assert gf.dtype == np.int32 and len(gf) > 100


@pytest.mark.parametrize("fix_geometry", [False, True])
def test_marching_tets_and_gradients_match_jax(params, fix_geometry):
    cfg = _cfg(fix_geometry)
    rng = np.random.default_rng(6)
    E = len(jdm.build_tet_grid(RES).edges)
    wv = rng.normal(size=(E, 3)).astype(np.float32)
    wf = rng.normal(size=(E, 3)).astype(np.float32)

    def loss(p):
        surf = jdm.isosurface(p, cfg)
        m = surf.vert_mask[:, None].astype(jnp.float32)
        feats = jdm.forward_features(p, cfg, surf.verts)
        return (surf.verts * wv * m).sum() + (feats * wf * m).sum(), surf

    (_, want), grads = jit_fast(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tp = convert.geometry_params(params, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    pc = convert.geometry_config(cfg)
    surf = pdm.isosurface(tp, pc)
    np.testing.assert_array_equal(surf.faces.numpy(), np.asarray(want.faces))
    np.testing.assert_array_equal(surf.face_mask.numpy(), np.asarray(want.face_mask))
    np.testing.assert_array_equal(surf.vert_mask.numpy(), np.asarray(want.vert_mask))
    _close(surf.verts, want.verts, 1e-6, "verts")
    fm = surf.face_mask.numpy()
    assert 0 < fm.sum() < len(fm) and not surf.faces[~surf.face_mask].any()
    m = surf.vert_mask[:, None].float()
    feats = pdm.forward_features(tp, pc, surf.verts)
    ((surf.verts * torch.as_tensor(wv) * m).sum() + (feats * torch.as_tensor(wf) * m).sum()).backward()
    # jax flattens a dict's keys sorted, the port keeps insertion order
    want_leaves = jax.tree_util.tree_leaves(grads)
    got_leaves = [g for k in sorted(tp) for g in tree_leaves(tp[k])]
    assert len(want_leaves) == len(got_leaves)
    for i, (got, w) in enumerate(zip(got_leaves, want_leaves)):
        if np.abs(np.asarray(w)).max() == 0:  # sdf under fix_geometry
            assert got.grad is None or not got.grad.any(), i
            continue
        _close(got.grad, w, 1e-4, f"grad {i}")
    sdf_grad = tp["sdf"].grad
    assert (sdf_grad is None or not sdf_grad.any()) == fix_geometry


def test_registry_builds_tet_grid():
    c = find("tetrahedra-sdf-grid")({"isosurface_resolution": 4, "n_neurons": 8,
                                     "hashgrid": {"n_levels": 2, "log2_hashmap_size": 8}}, device="cpu")
    assert c.state["sdf"].shape == (125,) and c.cfg.hashgrid.n_levels == 2
    surf = c.isosurface()
    assert surf.faces.shape == (2 * 6 * 64, 3) and surf.face_mask.any()

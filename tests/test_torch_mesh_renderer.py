"""The port's mesh renderers and fixed-mesh geometry
(``models/renderers/mesh_rasterizer.py``, ``models/geometry/custom_mesh.py``)
against the JAX package's (CPU).

- ``MeshRasterizer.render_view`` of a marching-tets surface with its masked
  slots as (0, 0, 0) faces (binned by depth alone around vertex 0, as in
  JAX), shaded by ``custom-mesh``'s feature head, ``neural-radiance-material``
  and ``neural-environment-map-background`` from ``registry.find``: the
  face index equal on ≥ 99.9 % of the pixels (the inside test is
  discrete), the other outputs within 1e-5 on the pixels that agree, and
  the gradients of a weighted sum of them with respect to the vertices,
  the feature head, the material and the background within 1e-3 of each
  one's max; at a tile capacity below the masked faces' count and at the
  default;
- the batched ``__call__`` stacks the views;
- ``PatchRenderer`` with the JAX draw's patch offset carried: every output
  within 1e-5 and the same offset;
- ``custom-mesh``: the OBJ read and normalised equal, ``forward_features``
  within 1e-5.

The JAX references run under ``jax.jit`` with XLA's cheaper passes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import jit_fast as _jit

from dreammesh4d_tpu.models import background as jbg
from dreammesh4d_tpu.models import materials as jmat
from dreammesh4d_tpu.models.geometry import custom_mesh as jcm
from dreammesh4d_tpu.models.geometry import dmtet as jdm
from dreammesh4d_tpu.models.renderers import mesh_rasterizer as jmr
from dreammesh4d_tpu.ops import cameras as jcam
from dreammesh4d_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.export.mesh_io import MeshData, save_obj
from dreammesh4d_tpu_torch.models.geometry import custom_mesh as pcm
from dreammesh4d_tpu_torch.ops.cameras import GSCameraInfo
from dreammesh4d_tpu_torch.ops.mesh_raster import rasterize_mesh
from dreammesh4d_tpu_torch.registry import find
from dreammesh4d_tpu_torch.utils.tree import tree_leaves

HW = 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what, mask=None):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if mask is not None:
        got, want = got[mask], want[mask]
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    print(f"{what}: {err:.3g} (band {rel:g})")
    assert err <= rel, (what, err)


def _camera(elev, azim, dist):
    pos = jcam.camera_position_from_spherical(jnp.asarray(elev), jnp.asarray(azim), jnp.asarray(dist))
    cam = jcam.get_cam_info_gaussian(jcam.look_at_c2w(pos), 0.8, 0.8, 0.01, 100.0)
    return cam, np.asarray(pos), GSCameraInfo(*(torch.as_tensor(np.asarray(x)) for x in cam))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    rng = np.random.default_rng(12)
    # a marching-tets surface: real faces plus the masked slots at vertex 0
    grid = jdm.build_tet_grid(8)
    pos = jnp.asarray(grid.verts) * 1.6 - 0.8
    sdf = jnp.linalg.norm(pos, axis=-1) - 0.55 + jnp.asarray(rng.normal(scale=0.03, size=len(grid.verts)),
                                                             jnp.float32)
    surf = jax.device_get(_jit(lambda s, p: jdm.marching_tets(s, p, grid))(sdf, pos))
    faces = np.where(surf.face_mask[:, None], surf.faces, 0).astype(np.int32)
    # custom-mesh: the surface's real faces written as an OBJ and read back normalised
    path = str(tmp_path_factory.mktemp("mesh") / "surf.obj")
    save_obj(path, MeshData(v_pos=np.asarray(surf.verts), t_pos_idx=faces[surf.face_mask]))
    cm_cfg = jcm.CustomMeshConfig(shape_init="mesh:" + path, shape_init_params=0.7, n_feature_dims=8,
                                  n_neurons=16, hashgrid=JHashGridConfig(n_levels=2, log2_hashmap_size=8))
    cm_params = jax.tree.map(np.asarray, _jit(lambda k: jcm.init_custom_mesh(cm_cfg, k))(jax.random.PRNGKey(1)))
    cm_params["encoding"]["tables"] = rng.uniform(-1, 1, cm_params["encoding"]["tables"].shape).astype(np.float32)
    mat = jmat.NeuralRadianceMaterial(n_neurons=16)
    bg = jbg.NeuralEnvironmentMapBackground()
    return {"verts": np.asarray(surf.verts), "faces": faces, "fmask": np.asarray(surf.face_mask),
            "cm_cfg": cm_cfg, "cm_params": cm_params, "mat": mat, "bg": bg,
            "mat_params": jax.tree.map(np.asarray, _jit(mat.init_params)(jax.random.PRNGKey(3))),
            "bg_params": jax.tree.map(np.asarray, _jit(bg.init_params)(jax.random.PRNGKey(4))),
            "w": {k: rng.normal(size=(HW, HW, c)).astype(np.float32)
                  for k, c in (("comp_rgb", 3), ("comp_normal", 3), ("opacity", 1), ("depth", 1))}}


def _weighted(out, w):
    return sum((out[k] * w[k]).sum() for k in w)


@pytest.mark.parametrize("capacity", [64, 256])
def test_render_view_matches_jax(scene, capacity):
    jcamera, cam_pos, pcamera = _camera(20.0, 40.0, 2.2)
    raster = jmr.MeshRasterizer(tile_capacity=capacity)
    cm_cfg = scene["cm_cfg"]
    w = scene["w"]

    def j_loss(verts, cm_p, mat_p, bg_p):
        out = raster.render_view(
            verts, jnp.asarray(scene["faces"]), jcamera, jnp.asarray(cam_pos), HW, HW,
            feature_fn=lambda p: jcm.forward_features(cm_p, cm_cfg, p),
            material_fn=lambda f, **kw: scene["mat"](f, params=mat_p, **kw),
            background_fn=lambda d: scene["bg"](bg_p, d))
        return _weighted(out, w), out

    args = (scene["verts"], scene["cm_params"], scene["mat_params"], scene["bg_params"])
    (_, want), want_grads = _jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    want_face = np.asarray(_jit(lambda v, f: jmr.rasterize_mesh(v, f, jcamera, HW, HW, capacity, 64).face_idx)(
        scene["verts"], scene["faces"]))

    cm = find("custom-mesh")({"n_feature_dims": 8, "n_neurons": 16,
                              "hashgrid": {"n_levels": 2, "log2_hashmap_size": 8}}, device="cpu")
    mat = find("neural-radiance-material")({"n_neurons": 16}, device="cpu")
    bg = find("neural-environment-map-background")({}, device="cpu")
    pc = convert.geometry_config(cm_cfg)
    assert dataclasses.asdict(cm.cfg)["hashgrid"] == dataclasses.asdict(pc)["hashgrid"]
    trees = (torch.tensor(scene["verts"]), convert.geometry_params(scene["cm_params"], "cpu"),
             convert.component_params(scene["mat_params"], "cpu"), convert.component_params(scene["bg_params"], "cpu"))
    for leaf in tree_leaves(trees):
        leaf.requires_grad_(True)
    verts, cm_p, mat_p, bg_p = trees
    prast = find("nvdiff-rasterizer")({"tile_capacity": capacity}, device="cpu")
    out = prast.render_view(verts, torch.as_tensor(scene["faces"]), pcamera, torch.as_tensor(cam_pos), HW, HW,
                            feature_fn=lambda p: pcm.forward_features(cm_p, pc, p),
                            material_fn=lambda f, **kw: mat(f, params=mat_p, **kw),
                            background_fn=lambda d: bg(d, params=bg_p))
    face = rasterize_mesh(verts.detach(), torch.as_tensor(scene["faces"]), pcamera, HW, HW, capacity, 64).face_idx
    agree = face.numpy() == want_face
    print(f"face_idx agrees on {agree.mean():.5f}; hit pixels {(want_face >= 0).mean():.3f}")
    assert agree.mean() >= 0.999 and (want_face >= 0).mean() > 0.1
    for k in ("opacity", "comp_normal", "depth", "comp_rgb", "comp_rgb_bg"):
        _close(out[k], want[k], 1e-5, k, mask=agree)
    _weighted(out, {k: torch.as_tensor(v) for k, v in w.items()}).backward()
    got_leaves = [verts] + [g for tree in trees[1:] for g in _sorted_leaves(tree)]
    want_leaves = jax.tree_util.tree_leaves(want_grads)
    assert len(got_leaves) == len(want_leaves)
    for i, (got, wg) in enumerate(zip(got_leaves, want_leaves)):
        _close(got.grad, wg, 1e-3, f"grad {i}")
    assert torch.isfinite(verts.grad).all()


def _sorted_leaves(tree):
    """The leaves in jax's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [g for k in sorted(tree) for g in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [g for v in tree for g in _sorted_leaves(v)]
    return [tree]


def test_batched_call_stacks_views(scene):
    cams = [_camera(10.0, a, 2.4) for a in (0.0, 120.0)]
    prast = find("nvdiff-rasterizer")({}, device="cpu")
    verts, faces = torch.as_tensor(scene["verts"]), torch.as_tensor(scene["faces"])
    positions = torch.as_tensor(np.stack([c[1] for c in cams]))
    out = prast(verts, faces, [c[2] for c in cams], positions, 16, 16)
    assert out["comp_rgb"].shape == (2, 16, 16, 3) and out["opacity"].shape == (2, 16, 16, 1)
    one = prast.render_view(verts, faces, cams[1][2], positions[1], 16, 16)
    assert torch.equal(out["comp_normal"][1], one["comp_normal"])


def test_rasterize_mesh_keeps_float64(scene):
    """Float64 vertices are rasterized in float64 (the card-vs-CPU check of
    the mesh steps runs both sides so); the same decisions as float32's."""
    _, _, cam = _camera(20.0, 40.0, 2.2)
    verts, faces = torch.as_tensor(scene["verts"]), torch.as_tensor(scene["faces"])
    r32 = rasterize_mesh(verts, faces, cam, HW, HW)
    r64 = rasterize_mesh(verts.double(), faces, cam, HW, HW)
    assert r64.bary.dtype == r64.depth.dtype == torch.float64 and r32.bary.dtype == torch.float32
    agree = (r32.face_idx == r64.face_idx).numpy()
    assert agree.mean() >= 0.999 and (r64.face_idx >= 0).any()
    _close(r32.bary, r64.bary, 1e-5, "float32 barycentrics against float64's", agree)


def test_patch_renderer_matches_jax():
    rng = np.random.default_rng(8)
    rays_o = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    rays_d = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)

    def base(xp, sig):
        def render(o, d, scale=1.0):
            return {"comp_rgb": sig(o * d * scale), "opacity": (o ** 2).sum(-1, keepdims=True),
                    "scalar": (o * d).sum()}
        return render

    jpr = jmr.PatchRenderer(patch_size=8, global_downsample=2)
    key = jax.random.PRNGKey(5)
    want = _jit(lambda o, d: jpr(base(jnp, jax.nn.sigmoid), o, d, rng=key, scale=1.5))(rays_o, rays_d)
    ppr = find("patch-renderer")({"patch_size": 8, "global_downsample": 2}, device="cpu")
    got = ppr(base(torch, torch.sigmoid), torch.as_tensor(rays_o), torch.as_tensor(rays_d),
              patch_yx=torch.as_tensor(np.asarray(want["patch_yx"])), scale=1.5)
    np.testing.assert_array_equal(got["patch_yx"].numpy(), np.asarray(want["patch_yx"]))
    for k in ("comp_rgb", "opacity", "scalar"):
        _close(got[k], want[k], 1e-5, k)
    # not training: the base renderer alone
    full = ppr(base(torch, torch.sigmoid), torch.as_tensor(rays_o), torch.as_tensor(rays_d), training=False)
    assert full["comp_rgb"].shape == (2, 16, 16, 3)
    gen = torch.Generator().manual_seed(0)
    drawn = ppr(base(torch, torch.sigmoid), torch.as_tensor(rays_o), torch.as_tensor(rays_d), generator=gen)
    assert 0 <= int(drawn["patch_yx"].min()) and int(drawn["patch_yx"].max()) < 8


def test_custom_mesh_matches_jax(scene):
    cfg = scene["cm_cfg"]
    want = jcm.load_and_normalize(cfg)
    got = pcm.load_and_normalize(convert.geometry_config(cfg))
    np.testing.assert_array_equal(got.t_pos_idx, want.t_pos_idx)
    np.testing.assert_array_equal(got.v_pos, want.v_pos)
    assert abs(np.abs(got.v_pos).max() - 0.7) < 1e-6
    feats = _jit(lambda p, x: jcm.forward_features(p, cfg, x))(scene["cm_params"], want.v_pos)
    _close(pcm.forward_features(convert.geometry_params(scene["cm_params"], "cpu"), convert.geometry_config(cfg),
                                torch.as_tensor(got.v_pos)), feats, 1e-5, "features")

"""The registry's factory names of the port against the JAX package's (CPU):
``find(name)(cfg)`` of ``models/registry_names.py`` in both packages, from
the configs of ``tests/test_registry_parity.py``'s construction tests.

For each of the 13 older factory names: the constructed component's state has the
JAX component's tree structure and leaf shapes (the perceptual network's
against ``convert.perceptual_params`` of it, whose convolutions are OIHW),
its bound attributes exist, and one forward on the JAX parameters carried
across (copied into the port component's own state, which its bound
functions read) agrees within the band of that module's parity test:
- ``implicit-volume``, ``nerf-volume-renderer``: 2e-5 (+ rtol 1e-4;
  ``test_torch_nerf.py``);
- ``sugar``, ``dynamic-sugar``, ``gaussian-splatting``: 1e-5
  (``test_torch_geometry.py``, ``test_torch_gaussian_stage.py``);
- the three SuGaR rasterizer names: rgb/alpha 3e-3, depth 6e-3
  (``test_torch_raster.py``; the JAX ``xla`` blend takes 16-px tiles and no
  exit);
- ``perceptual-loss``: rtol 1e-4 (``test_torch_recovery.py``), its JAX
  structure from ``jax.eval_shape`` and both packages given the same seeded
  numpy parameters (an eager VGG16 init costs seconds);
- ``mesh-exporter``: equal meshes; ``gaussian-mesh-exporter`` and
  ``gaussian-splatting-io``: byte-equal files; ``dummy-exporter``: ``[]``.
The two materials construct from no arguments and shade within 1e-6.  The
five SDF and mesh factories (``implicit-sdf``, ``custom-mesh``,
``tetrahedra-sdf-grid``, ``volume-grid``, ``neus-volume-renderer``) build
the JAX component's config, state structure and leaf shapes and its bound
callables; their forwards are held in their modules' parity tests.
Every factory takes ``device=``, whose default is ``"cuda"``.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammesh4d_tpu as ds
import dreammesh4d_tpu.models.materials  # noqa: F401  (registers the two materials)
import dreammesh4d_tpu.models.registry_names  # noqa: F401  (binds the factory names)
from dreammesh4d_tpu.ops.cameras import camera_position_from_spherical, get_cam_info_gaussian, look_at_c2w
from dreammesh4d_tpu.utils import perceptual as jperc
from dreammesh4d_tpu_torch import convert, registry
from dreammesh4d_tpu_torch.ops.cameras import GSCameraInfo

FACTORIES = ("sugar", "dynamic-sugar", "gaussian-splatting", "implicit-volume",
             "diff-sugar-rasterizer-normal", "diff-sugar-rasterizer-temporal",
             "diff-sugar-rasterizer-shading", "nerf-volume-renderer", "mesh-exporter",
             "gaussian-mesh-exporter", "gaussian-splatting-io", "perceptual-loss", "dummy-exporter",
             "implicit-sdf", "custom-mesh", "tetrahedra-sdf-grid", "volume-grid", "neus-volume-renderer")
GRID = {"n_neurons": 8, "n_hidden_layers": 1, "hashgrid": {"n_levels": 2, "log2_hashmap_size": 8}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_mesh_dict():
    """``tests/test_registry_parity.py``'s regular tetrahedron with vertex colours."""
    v = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float32) * 0.5
    f = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32)
    c = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    return {"v_pos": v, "t_pos_idx": f, "v_rgb": c}


def _shapes(tree):
    """The tree's structure with each array leaf replaced by its shape
    (NamedTuples by their fields, dataclasses by theirs)."""
    if hasattr(tree, "_fields"):
        return {f: _shapes(getattr(tree, f)) for f in tree._fields}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _shapes(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return ("array", tuple(tree.shape))
    return tree


def _copy_into(dst, src):
    """Copy the carried tensors ``src`` into the port state ``dst`` in place
    (same structure), so that the component's bound functions see them."""
    if hasattr(dst, "_fields"):
        for f in dst._fields:
            _copy_into(getattr(dst, f), getattr(src, f))
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _copy_into(a, b)
    elif torch.is_tensor(dst):
        with torch.no_grad():
            dst.copy_(torch.as_tensor(np.asarray(src)).to(dst.dtype))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else np.asarray(got),
                               np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_inits():
    """The JAX factories' initialisers jitted: eager dispatch compiles each
    op on first use."""
    import dreammesh4d_tpu.models.geometry.deformation as jdef
    import dreammesh4d_tpu.models.geometry.gaussian as jgauss
    import dreammesh4d_tpu.models.geometry.implicit_volume as jiv

    with pytest.MonkeyPatch.context() as mp:
        for module, name in ((jdef, "init_deformation"), (jgauss, "init_random_sphere"),
                             (jiv, "init_implicit_volume")):
            real = getattr(module, name)
            mp.setattr(module, name, lambda cfg, key, real=real: jax.jit(lambda k: real(cfg, k))(key))
        yield


def _jax(name):
    """The JAX package's binding of ``name``, read from its registry without
    ``find``'s import of every builtin module (seconds of flax and
    transformers imports)."""
    return ds.__modules__[name]


def _build(name, cfg):
    return _jax(name)(cfg), registry.find(name)(cfg, device="cpu")


def test_every_factory_defaults_to_cuda():
    for name in FACTORIES:
        factory = registry.find(name)
        assert callable(factory) and not isinstance(factory, type), name
        assert inspect.signature(factory).parameters["device"].default == "cuda", name


def test_sugar_and_dynamic_sugar():
    mesh = _tiny_mesh_dict()
    cfg = {"mesh": mesh, "n_gaussians_per_surface_triangle": 3, "mesh_component_min_ratio": 0.0}
    jg, tg = _build("sugar", cfg)
    assert _shapes(tg.state) == _shapes(jg.state)
    _copy_into(tg.state[0], convert.sugar_params(_np(jg.state[0]), "cpu"))
    ja, ta = jax.jit(jg.gaussian_attributes)(), tg.gaussian_attributes()
    assert ta.means3d.shape == (4 * 3, 3)
    for f in ja._fields:
        _close(getattr(ta, f), getattr(ja, f), 1e-5)

    dcfg = {**cfg, "num_frames": 4, "n_dg_nodes": 4, "dg_node_connectivity": 2, "dist_mode": "eucdisc",
            "deformation": {"base_resolution": (4, 4, 4, 3), "multires": (1,), "hidden_dim": 8}}
    jd, td = _build("dynamic-sugar", dcfg)
    assert _shapes(td.state) == _shapes(jd.state)
    assert td.cfg.deformation.multires == (1,) and td.cfg.n_dg_nodes == 4
    jparams, jdeform, jstatic = _np(jd.state)
    _copy_into(td.state[1], convert.deformation_params(jdeform, "cpu"))
    _copy_into(td.state[2], convert.dynamic_static(jstatic, "cpu"))
    ts = np.float32([0.0, 0.5])
    (jgs, jvert), (tgs, tvert) = jax.jit(jd.timed_all)(jnp.asarray(ts)), td.timed_all(torch.tensor(ts))
    assert tgs.means3d.shape[0] == 2 and tvert.xyz.shape[:2] == (2, 4)
    for f in jgs._fields:
        _close(getattr(tgs, f), getattr(jgs, f), 1e-5)


def test_gaussian_splatting():
    jg, tg = _build("gaussian-splatting", {"capacity": 64, "init_num": 16})
    assert _shapes(tg.state) == _shapes(jg.state)
    _copy_into(tg.state, convert.gaussian_state_params(_np(jg.state), "cpu"))
    jr, tr = jg.renderable(), tg.renderable()
    assert tr[0].shape == (64, 3) and float(tr[3][16:].max()) == 0.0
    for a, b in zip(tr, jr):
        _close(a, b, 1e-5)


@pytest.fixture(scope="module")
def volume():
    jg, tg = _build("implicit-volume", GRID)
    assert _shapes(tg.state) == _shapes(jg.state)
    _copy_into(tg.state, convert.implicit_volume_params(_np(jg.state), "cpu"))
    return jg, tg


def test_implicit_volume(volume):
    jg, tg = volume
    pts = np.random.default_rng(0).uniform(-0.9, 0.9, (5, 3)).astype(np.float32)
    jd, (jd2, jf2) = jax.jit(lambda x: (jg.forward_density(x), jg.forward_field(x)))(jnp.asarray(pts))
    d = tg.forward_density(torch.tensor(pts))
    assert d.shape[0] == 5 and torch.isfinite(d).all()
    _close(d, jd, 2e-5, rtol=1e-4)
    d2, f2 = tg.forward_field(torch.tensor(pts))
    _close(d2, jd2, 2e-5, rtol=1e-4)
    _close(f2, jf2, 2e-5, rtol=1e-4)


def test_nerf_volume_renderer(volume):
    jgeo, tgeo = volume
    cfg = {"num_samples_coarse": 8, "num_samples_fine": 8, "ray_chunk_train": 0, "geometry": GRID}
    jr, tr = _build("nerf-volume-renderer", cfg)
    assert _shapes(tr.state) == _shapes(jr.state) and tr.cfg.num_samples_fine == 8
    rays_o = np.tile(np.float32([[0.0, 0.0, 3.0]]), (4, 1))
    rays_d = np.float32([[0.0, 0.0, -1.0], [0.05, 0.0, -1.0], [0.0, -0.05, -1.0], [0.03, 0.03, -1.0]])
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    out = tr.render_rays(tgeo.state, torch.tensor(rays_o), torch.tensor(rays_d), torch.tensor(rays_o),
                         torch.zeros(3))
    jout = jax.jit(jr.render_rays)(jgeo.state, jnp.asarray(rays_o), jnp.asarray(rays_d),
                                   jnp.asarray(rays_o), jnp.zeros(3))
    assert out["comp_rgb"].shape == (4, 3) and set(out) == set(jout)
    for k in ("comp_rgb", "opacity", "depth"):
        _close(out[k], jout[k], 2e-5, rtol=1e-4)


_JAX_RENDERS = {}  # the JAX render per config: the three names build the same one, compiled once


@pytest.mark.parametrize("name", ["diff-sugar-rasterizer-normal", "diff-sugar-rasterizer-temporal",
                                  "diff-sugar-rasterizer-shading"])
def test_sugar_rasterizer(name):
    cfg = {"width": 32, "height": 32, "tile_capacity": 64, "max_tiles_per_gaussian": 4, "backend": "xla",
           "fovy_deg": 40.0}
    jr, tr = _build(name, cfg)
    assert tr.cfg == convert.config(jr.cfg) and tr.cfg.tile_capacity == 64
    pos = camera_position_from_spherical(jnp.asarray(15.0), jnp.asarray(30.0), jnp.asarray(2.5))
    jcam = get_cam_info_gaussian(look_at_c2w(pos), 0.7, 0.7, 0.01, 100.0)
    rng = np.random.default_rng(2)
    n = 40
    q = rng.normal(size=(n, 4)).astype(np.float32)
    inputs = dict(means3d=(0.3 * rng.normal(size=(n, 3))).astype(np.float32),
                  quats=q / np.linalg.norm(q, axis=-1, keepdims=True),
                  scales=np.exp(-2.5 + 0.3 * rng.normal(size=(n, 3))).astype(np.float32),
                  opacities=rng.uniform(0.3, 0.95, n).astype(np.float32),
                  sh=rng.uniform(0, 1, (n, 3, 1)).astype(np.float32))
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    bg = np.float32([0.2, 0.3, 0.4])
    if jr.cfg not in _JAX_RENDERS:
        _JAX_RENDERS[jr.cfg] = jax.jit(lambda arrays, n, cam, b: jr.render_view(
            **arrays, sh_degree=0, gs_normals=n, camera=cam, bg_color=b))
    jout = _JAX_RENDERS[jr.cfg]({k: jnp.asarray(v) for k, v in inputs.items()}, jnp.asarray(normals), jcam,
                                jnp.asarray(bg))
    out = tr.render_view(**{k: torch.tensor(v) for k, v in inputs.items()}, sh_degree=0,
                         gs_normals=torch.tensor(normals), camera=GSCameraInfo(*(torch.tensor(np.asarray(x))
                                                                                 for x in jcam)),
                         bg_color=torch.tensor(bg))
    assert out["comp_rgb"].shape == (32, 32, 3) and set(out) == set(jout)
    assert float(out["comp_mask"].max()) > 0.5
    _close(out["comp_rgb"], jout["comp_rgb"], 3e-3, rtol=0)
    _close(out["comp_mask"], jout["comp_mask"], 3e-3, rtol=0)
    _close(out["comp_depth"], jout["comp_depth"], 6e-3, rtol=0)
    depth = tr.depth_to_normal(out["comp_depth"], torch.zeros(32, 32, 3), torch.ones(32, 32, 3),
                               out["comp_mask"])
    assert depth.shape == (32, 32, 3)


def test_mesh_exporters_and_io(tmp_path):
    jex, tex = _build("mesh-exporter", {})
    n = 16
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    density = np.maximum(0.6 - np.sqrt(x ** 2 + y ** 2 + z ** 2), 0.0) * 10
    jm, tm = jex(density), tex(density)
    assert len(tm.v_pos) > 0
    np.testing.assert_array_equal(tm.t_pos_idx, jm.t_pos_idx)
    np.testing.assert_allclose(tm.v_pos, jm.v_pos, rtol=0, atol=1e-6)

    jgx, tgx = _build("gaussian-mesh-exporter", {})
    m = _tiny_mesh_dict()
    jgx(tmp_path / "jax.obj", m["v_pos"], m["t_pos_idx"], v_rgb=m["v_rgb"])
    tgx(tmp_path / "port.obj", m["v_pos"], m["t_pos_idx"], v_rgb=m["v_rgb"])
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    assert callable(tgx.build_square_atlas) and callable(tgx.bake_texture)

    jio, tio = _build("gaussian-splatting-io", {})
    args = (np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32), np.zeros((4, 16, 3), np.float32),
            np.full((4,), 0.5, np.float32), np.full((4, 3), -2.0, np.float32),
            np.tile(np.array([1.0, 0, 0, 0], np.float32), (4, 1)))
    jio.save_ply(str(tmp_path / "jax.ply"), *args)
    tio.save_ply(str(tmp_path / "port.ply"), *args)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    data = tio.load_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(data["xyz"], args[0])

    jd, td = _build("dummy-exporter", {})
    assert td() == jd() == []


def test_perceptual_loss():
    shapes = jax.eval_shape(lambda: _jax("perceptual-loss")({}).state)
    rng = np.random.default_rng(4)
    jparams = jax.tree.map(lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32), shapes)
    jparams["lins"] = [np.abs(w) for w in jparams["lins"]]
    tp = registry.find("perceptual-loss")({}, device="cpu")
    carried = convert.perceptual_params(jparams, "cpu")
    assert _shapes(tp.state) == _shapes(carried)
    _copy_into(tp.state, carried)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jperc.perceptual_loss)(jparams, jnp.asarray(x), jnp.asarray(y)))
    got = tp(torch.tensor(x), torch.tensor(y)).numpy()
    assert got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_materials():
    for name in ("no-material", "diffuse-with-point-light-material"):
        assert registry.find(name).__name__ == _jax(name).__name__
    feats = np.random.default_rng(5).normal(size=(6, 5)).astype(np.float32)
    jm, tm = _jax("no-material")(), registry.find("no-material")()
    np.testing.assert_array_equal(tm(torch.tensor(feats)).numpy(), np.asarray(jm(jnp.asarray(feats))))
    jm, tm = _jax("diffuse-with-point-light-material")(), registry.find("diffuse-with-point-light-material")()
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    rng = np.random.default_rng(6)
    pos, nrm, light = (rng.normal(size=(6, 3)).astype(np.float32) for _ in range(3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    for ratio in (None, 0.3):
        got = tm(torch.tensor(feats), positions=torch.tensor(pos), shading_normal=torch.tensor(nrm),
                 light_positions=torch.tensor(light), ambient_ratio=ratio)
        want = jm(jnp.asarray(feats), positions=jnp.asarray(pos), shading_normal=jnp.asarray(nrm),
                  light_positions=jnp.asarray(light), ambient_ratio=ratio)
        _close(got, want, 1e-6)


def test_queued_names_raise_naming_their_roadmap_item():
    assert registry.QUEUED and not set(registry.QUEUED) & set(FACTORIES)
    for name, item in registry.QUEUED.items():
        with pytest.raises(KeyError, match=item):
            registry.find(name)


SDF_MESH_CFGS = {  # the SDF and mesh factories (their forwards: test_torch_sdf_neus.py, _dmtet.py, _mesh_renderer.py)
    "implicit-sdf": dict(GRID, radius=1.0),
    "custom-mesh": dict(GRID, n_feature_dims=8),
    "tetrahedra-sdf-grid": dict(GRID, isosurface_resolution=6),
    "volume-grid": {"grid_size": (4, 5, 6), "n_feature_dims": 2},
    "neus-volume-renderer": {"num_samples_coarse": 8, "geometry": dict(GRID)},
}


@pytest.mark.parametrize("name", sorted(SDF_MESH_CFGS))
def test_sdf_and_mesh_factories_match_jax_structure(name):
    jc, pc = _build(name, SDF_MESH_CFGS[name])
    assert dataclasses.asdict(pc.cfg) == dataclasses.asdict(jc.cfg)
    shapes = lambda tree: jax.tree.map(lambda v: tuple(np.shape(v)), tree)  # noqa: E731
    want = shapes(jax.tree.map(np.asarray, jc.state))
    assert shapes(jax.tree.map(lambda t: t.numpy(), pc.state, is_leaf=torch.is_tensor)) == want
    for attr in vars(jc):
        if attr not in ("cfg", "state", "_call") and getattr(jc, attr) is not None:
            assert callable(getattr(pc, attr)), (name, attr)

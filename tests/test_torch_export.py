"""The Gaussian stages' exports on the port against the JAX package (CPU):
the 3DGS PLY writer, the UV layouts (per-face squares and the chart unwrap),
the texture bake from fixed per-view images, and both experiments'
``export()`` built from their YAMLs at a tiny size with the JAX state
carried across.

Tolerances, with the numbers measured here:
- ``save_gaussians_ply``, ``build_square_atlas``, ``unwrap_uv`` (and
  ``grow_charts``): exact;
- ``bake_texture`` from the same images: texture ≤ 1e-5 (measured 0; the
  scatter-add order may differ), UVs exact;
- ``export()``: the static OBJ equal byte for byte, the Gaussians' attributes
  ≤ 1e-5 (measured ≤ 1.2e-7); the dynamic frames' faces and UVs equal,
  vertices ≤ 1e-5 (measured ≤ 1.0e-6, the OBJ's six decimals), the
  texture's mean |d| ≤ 2e-3 (measured 1.7e-5, at most 6 LSB on a texel: the
  two rasterizers composite the same Gaussians, the JAX ``xla`` backend on
  16-px tiles and the port's on the YAML's 32-px ones).

The JAX export's ``timed_all`` and ``rasterize`` run under ``jax.jit`` (the
same functions; eager dispatch costs ~20 s of per-op compiles here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import _cheap_xla  # noqa: F401

import dreammesh4d_tpu.models.geometry.deformation as jdef
import dreammesh4d_tpu.models.geometry.dynamic_sugar as jdyn
import dreammesh4d_tpu.ops.gs as jgs
from dreammesh4d_tpu.config import load_config as j_load_config
from dreammesh4d_tpu.export import gaussian_io as jgio
from dreammesh4d_tpu.export import texture_bake as jbake
from dreammesh4d_tpu.export import uv_unwrap as juv
from dreammesh4d_tpu.export.mesh_io import MeshData, load_obj, save_ply_mesh
from dreammesh4d_tpu.models.geometry.sugar import SuGaRParams as JSuGaRParams
from dreammesh4d_tpu.ops import cameras as jcam
from dreammesh4d_tpu.systems import assembly as jasm
from dreammesh4d_tpu.utils.procedural import make_icosphere
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.data.png import read_png, write_png
from dreammesh4d_tpu_torch.export import gaussian_io, texture_bake, uv_unwrap
from dreammesh4d_tpu_torch.ops import cameras as cam
from dreammesh4d_tpu_torch.systems import assembly

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATIC_YAML = os.path.join(REPO, "configs", "sugar_static_refine.yaml")
DYN_YAML = os.path.join(REPO, "configs", "sugar_dynamic_dg.yaml")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_save_gaussians_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    n = 37
    arrays = (rng.normal(size=(n, 3)), rng.normal(size=(n, 16, 3)), rng.normal(size=(n, 1)),
              rng.normal(size=(n, 3)), rng.normal(size=(n, 4)))
    arrays = [a.astype(np.float32) for a in arrays]
    jgio.save_gaussians_ply(str(tmp_path / "j.ply"), *arrays)
    gaussian_io.save_gaussians_ply(str(tmp_path / "t" / "g.ply"), *arrays)
    assert (tmp_path / "t" / "g.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back, jback = gaussian_io.load_gaussians_ply(str(tmp_path / "t" / "g.ply")), \
        jgio.load_gaussians_ply(str(tmp_path / "j.ply"))
    assert set(back) == set(jback)
    for k in back:
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
    np.testing.assert_array_equal(back["sh"], arrays[1])


def test_uv_layouts_match_jax():
    rng = np.random.default_rng(1)
    m = make_icosphere(2, radius=0.6)
    verts = (m.v_pos * (1 + 0.1 * rng.normal(size=(len(m.v_pos), 1)))).astype(np.float32)
    np.testing.assert_array_equal(uv_unwrap.grow_charts(verts, m.t_pos_idx, 40.0),
                                  juv.grow_charts(verts, m.t_pos_idx, 40.0))
    for got, want in zip(uv_unwrap.unwrap_uv(verts, m.t_pos_idx), juv.unwrap_uv(verts, m.t_pos_idx)):
        np.testing.assert_array_equal(got, want)
    for n_faces in (37, 320):
        for got, want in zip(texture_bake.build_square_atlas(n_faces, 64),
                             jbake.build_square_atlas(n_faces, 64)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("atlas", ["square", "charts"])
def test_bake_texture_matches_jax(atlas):
    """Three views of an icosphere(2) at 32², each 'rendered' as a fixed
    seeded image: the same texture from both packages."""
    m = make_icosphere(2, radius=0.6)
    rng = np.random.default_rng(2)
    images = rng.random((3, 32, 32, 3)).astype(np.float32)
    fov = np.radians(20.0)
    jcams = [jcam.get_cam_info_gaussian(jnp.asarray(jcam.make_c2w_numpy(el, az, 3.8)), fov, fov,
                                        0.01, 100.0) for el, az in ((5, 0), (20, 120), (-10, 240))]
    stacked = [np.stack([np.asarray(c[i]) for c in jcams]) for i in range(3)]

    def fixed(images_of):
        calls = []

        def render(camera):
            calls.append(camera)
            return images_of(len(calls) - 1)
        return render, calls

    jrender, jcalls = fixed(lambda i: jnp.asarray(images[i]))
    want = jbake.bake_texture(jnp.asarray(m.v_pos), jnp.asarray(m.t_pos_idx), *map(jnp.asarray, stacked),
                              jrender, 32, 32, tex_size=32, atlas=atlas)
    render, calls = fixed(lambda i: torch.as_tensor(images[i]))
    got = texture_bake.bake_texture(torch.as_tensor(m.v_pos), torch.as_tensor(m.t_pos_idx),
                                    *(torch.as_tensor(x) for x in stacked), render, 32, 32,
                                    tex_size=32, atlas=atlas)
    assert len(calls) == len(jcalls) == 3 and isinstance(calls[0], cam.GSCameraInfo)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape == (32, 32, 3)
    assert np.abs(got[0] - want[0]).max() <= 1e-5
    assert got[0].std() > 0.05  # more than the flood colour


# ---------------------------------------------------------------------------
# both experiments' export(), from their YAMLs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("export_assets")
    frames = d / "frames"
    frames.mkdir()
    for i in range(4):
        rgba = np.zeros((32, 32, 4), np.uint8)
        cx = 16 + int(4 * np.sin(2 * np.pi * i / 4))
        rgba[8:24, cx - 6:cx + 6] = [200, 80, 60, 255]
        write_png(str(frames / f"{i:03d}_rgba.png"), rgba)
    m = make_icosphere(1, radius=0.6)
    save_ply_mesh(str(d / "mesh.ply"), MeshData(v_pos=m.v_pos, t_pos_idx=m.t_pos_idx, v_rgb=m.v_rgb))
    return d, str(frames), str(d / "mesh.ply")


def _jitted_timed_all(real):
    """``timed_all`` under ``jax.jit``, the configuration and the static
    structures closed over (eager dispatch costs ~13 s of per-op compiles)."""
    def timed_all(params, deform_params, deform_cfg, static, ts, frame_indices=None):
        fn = jax.jit(lambda p, d, t, fi: real(p, d, deform_cfg, static, t, frame_indices=fi))
        return fn(params, deform_params, ts, frame_indices)
    return timed_all


def _jitted_rasterize(real):
    """``rasterize`` under ``jax.jit`` for the bake's keyword form, one
    compile per (config, SH degree)."""
    cache = {}

    def rasterize(means3d, opacities, camera, cfg, background, sh=None, sh_degree=0, scales=None,
                  quats=None):
        if (cfg, sh_degree) not in cache:
            cache[cfg, sh_degree] = jax.jit(lambda m, o, c, bg, s, sc, q: real(
                m, o, c, cfg, bg, sh=s, sh_degree=sh_degree, scales=sc, quats=q))
        return cache[cfg, sh_degree](means3d, opacities, camera, background, sh, scales, quats)
    return rasterize


def _both(yaml, dotlist, d):
    jexp = jasm.build_experiment(j_load_config(yaml, cli_args=dotlist + [f"exp_root_dir={d}/jax"]))
    exp = assembly.build_experiment(load_config(yaml, cli_args=dotlist + [f"exp_root_dir={d}/torch"]),
                                    device="cpu")
    return jexp, exp


def test_static_export_matches_jax(assets):
    d, frames, mesh = assets
    jexp, exp = _both(STATIC_YAML, [
        "system.guidance.pretrained_model_name_or_path=none", f"data.image_path={frames}/000_rgba.png",
        f"system.geometry.surface_mesh_to_bind_path={mesh}",
        "system.geometry.n_gaussians_per_surface_triangle=1",
        "data.height=32", "data.width=32", "data.random_camera.height=32", "data.random_camera.width=32",
        "system.renderer.backend=xla", "use_timestamp=false", "tag=st"], d)
    rng = np.random.default_rng(3)
    moved = {f: np.asarray(v) for f, v in _np(jexp.state.params)._asdict().items()}
    for f in moved:
        moved[f] = (moved[f] + 0.05 * rng.normal(size=moved[f].shape)).astype(np.float32)
    jexp.state = jexp.state._replace(params=JSuGaRParams(**{k: jnp.asarray(v) for k, v in moved.items()}))
    exp.load_state({"params": {k: torch.as_tensor(v) for k, v in moved.items()},
                    "opt_state": {"state": {}}, "step": 0})
    jexp.export()
    exp.export()
    jsave, save = jexp.saver.path(""), exp.saver.path("")
    assert sorted(os.listdir(save)) == sorted(os.listdir(jsave)) == ["gaussians.ply", "refined_mesh.obj"]
    with open(os.path.join(save, "refined_mesh.obj"), "rb") as f, \
            open(os.path.join(jsave, "refined_mesh.obj"), "rb") as g:
        assert f.read() == g.read()
    got = gaussian_io.load_gaussians_ply(os.path.join(save, "gaussians.ply"))
    want = jgio.load_gaussians_ply(os.path.join(jsave, "gaussians.ply"))
    assert got["xyz"].shape == (80, 3) and got["sh"].shape == want["sh"].shape
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_dynamic_export_matches_jax(assets, monkeypatch):
    d, frames, mesh = assets
    monkeypatch.setattr(jdyn, "timed_all", _jitted_timed_all(jdyn.timed_all))
    monkeypatch.setattr(jgs, "rasterize", _jitted_rasterize(jgs.rasterize))
    jexp, exp = _both(DYN_YAML, [
        "system.guidance.pretrained_model_name_or_path=none", f"data.video_frames_dir={frames}",
        f"system.geometry.surface_mesh_to_bind_path={mesh}",
        "system.geometry.n_gaussians_per_surface_triangle=1",
        "data.height=32", "data.width=32", "data.num_frames=2", "data.video_length=4",
        "data.random_camera.height=32", "data.random_camera.width=32", "data.random_camera.batch_size=2",
        "data.n_predict_views=4", "data.predict_height=32", "data.predict_width=32",
        "system.exporter.texture_size=32",
        "system.geometry.n_dg_nodes=16", "system.geometry.dist_mode=eucdisc",
        "system.geometry.deformation.base_resolution=[8,8,8,4]", "system.geometry.deformation.multires=[1,2]",
        "system.geometry.deformation.net_width=16", "system.geometry.deformation.grid_channels=8",
        "system.renderer.backend=xla", "system.renderer.tile_capacity=256",
        "use_timestamp=false", "tag=dyn"], d)
    filled = _np(jexp.state.deform_params)
    rng = np.random.default_rng(4)
    for name in ("head_dx", "head_dstrain", "head_drot"):
        for layer in ("res", "out"):
            for k in ("w", "b"):
                shape = filled[name][layer][k].shape
                filled[name][layer][k] = (0.05 * rng.normal(size=shape)).astype(np.float32)
    for planes in filled["grids"]:  # the time planes, so that the frames differ
        for i, (a, b) in enumerate(jdef._COMBS):
            if 3 in (a, b):
                planes[i] = (planes[i] + 0.3 * rng.normal(size=planes[i].shape)).astype(np.float32)
    jexp.state = jexp.state._replace(deform_params=jax.tree.map(jnp.asarray, filled))
    exp.load_state({"deform_params": convert.deformation_params(filled, "cpu"),
                    "opt_state": {"state": {}}, "step": 0})
    jexp.export()
    exp.export()
    jout, out = jexp.saver.path("4d_export"), exp.saver.path("4d_export")
    names = [f"frame_{i:03d}.obj" for i in range(4)] + ["material0.mtl", "material0.png"]
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout)) == names
    with open(os.path.join(out, "material0.mtl")) as f, open(os.path.join(jout, "material0.mtl")) as g:
        assert f.read() == g.read()
    tex, jtex = read_png(os.path.join(out, "material0.png")), read_png(os.path.join(jout, "material0.png"))
    assert tex.shape == jtex.shape == (32, 32, 3)
    assert np.abs(tex.astype(np.float32) - jtex).mean() / 255 <= 2e-3
    first = None
    for name in names[:4]:
        got, want = load_obj(os.path.join(out, name)), load_obj(os.path.join(jout, name))
        np.testing.assert_array_equal(got.t_pos_idx, want.t_pos_idx)
        np.testing.assert_array_equal(got.t_tex_idx, want.t_tex_idx)
        np.testing.assert_array_equal(got.v_tex, want.v_tex)
        np.testing.assert_allclose(got.v_pos, want.v_pos, rtol=0, atol=1e-5)
        first = got.v_pos if first is None else first
    assert np.abs(got.v_pos - first).max() > 1e-3  # the frames move

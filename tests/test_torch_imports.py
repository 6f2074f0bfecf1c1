"""The port stands alone and runs on the card by default.

- Every module of ``dreammesh4d_tpu_torch`` and ``chip_smoke.py`` imports
  without pulling in jax or anything of ``dreammesh4d_tpu`` (checked in a
  fresh interpreter).
- The entry points default to ``device="cuda"``: without a card they raise
  instead of quietly using the CPU; with one they land on it.
- ``chip_smoke.py`` fails, and prints no result, where there is no card.
- No port source names a path under the repository's ``native/``: the port
  builds its own copies of the host C++ sources.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, runpy, sys
import dreammesh4d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke_import_only")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "dreammesh4d_tpu",
                                    "yaml", "cv2", "imageio", "PIL", "transformers"))
print(len(names), " ".join(names), bad, sep="|")
"""

NEW_MODULES = ("systems.sugar_4dgen", "systems.zero123_system", "utils.schedule", "utils.tree",
               "ops.meshops", "ops.gs.resident_blend", "models.geometry.deformation", "convert",
               "ops.hashgrid", "ops.hashgrid_cell", "models.geometry.implicit_volume",
               "models.materials", "models.renderers.nerf_volume_renderer", "data.uncond",
               "ops.cameras", "ops.gs.table_blend", "ops.gs.binning", "systems.optim",
               "systems.sugar_static", "models.renderers.sugar_rasterizer", "utils.yaml_lite",
               "config", "registry", "data.png", "data.image", "data.temporal_image",
               "utils.checkpoint", "utils.saving", "utils.loggers", "trainer", "systems.assembly",
               "launch", "serving", "ops.mesh_raster", "utils.procedural", "utils.perceptual",
               "utils.metrics", "recovery", "export.mesh_io", "export.gaussian_io",
               "export.uv_unwrap", "export.texture_bake", "host_build", "export.isosurface",
               "export.decimate", "scripts.mesh_simplification", "scripts.full_pipeline",
               "ops.resize", "models.guidance.zero123.scheduler", "models.guidance.zero123.unet",
               "models.guidance.zero123.vae", "models.guidance.zero123.clip",
               "models.guidance.zero123.guidance", "models.guidance.zero123.checkpoint",
               "ops.knn", "models.geometry.gaussian", "ops.sugar_reg", "systems.gaussian_stage",
               "parallel", "parallel.mesh", "parallel.context", "parallel.sharding_rules", "dryrun",
               "scripts.render_4d", "models.guidance.stable_diffusion", "models.prompt_processors",
               "systems.threestudio_zoo", "systems.assembly_zoo", "systems.threestudio_zoo2",
               "models.guidance.vsd", "ops.shape_loss", "models.geometry.volume_grid",
               "models.registry_names", "utils.colormaps", "models.guidance.unified", "models.background",
               "systems.adan", "utils.misc", "models.geometry.implicit_sdf", "models.geometry.dmtet",
               "models.geometry.custom_mesh", "models.renderers.neus_volume_renderer",
               "models.renderers.mesh_rasterizer", "models.guidance.controlnet",
               "models.guidance.instructpix2pix", "models.guidance.deep_floyd", "utils.gan",
               "models.renderers.gan_volume_renderer", "systems.editing")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, names, bad = out.stdout.strip().splitlines()[-1].split("|")
    assert int(n_modules) >= 67
    for name in NEW_MODULES:
        assert f"dreammesh4d_tpu_torch.{name}" in names.split(" "), name
    assert bad == "[]", bad


def test_train_entry_points_default_to_cuda():
    from dreammesh4d_tpu_torch.systems.sugar_4dgen import (Sugar4DGenLosses, init_dyn_state,
                                                           make_dynamic_train_step)

    params, static, dparams, cfg, raster = _tiny_scene("cpu")
    arap_w = np.ones(tuple(static.sugar.ring_idx.shape), np.float32)
    args = (params, static, cfg.deformation, raster, Sugar4DGenLosses(), arap_w)
    if torch.cuda.is_available():
        assert init_dyn_state(dparams).deform_params["trunk"][0]["w"].device.type == "cuda"
        make_dynamic_train_step(*args)
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            init_dyn_state(dparams)
        with pytest.raises((RuntimeError, AssertionError)):
            make_dynamic_train_step(*args)
    state = init_dyn_state(dparams, device="cpu")
    leaf = state.deform_params["trunk"][0]["w"]
    assert leaf.requires_grad and leaf.is_leaf and state.step == 0
    assert callable(make_dynamic_train_step(*args, device="cpu"))


def test_stage1_entry_points_default_to_cuda():
    from dreammesh4d_tpu_torch.data.uncond import RandomCameraConfig, RandomCameraSampler
    from dreammesh4d_tpu_torch.models.geometry.implicit_volume import (ImplicitVolumeConfig,
                                                                        init_implicit_volume)
    from dreammesh4d_tpu_torch.models.renderers.nerf_volume_renderer import (
        NeRFRendererConfig, init_occgrid, make_occgrid_update)
    from dreammesh4d_tpu_torch.ops.hashgrid import HashGridConfig
    from dreammesh4d_tpu_torch.systems.zero123_system import Zero123Losses, make_zero123_train_step

    geo = ImplicitVolumeConfig(hashgrid=HashGridConfig(n_levels=2, log2_hashmap_size=6, layout="cell"),
                               n_neurons=4)
    rcfg = NeRFRendererConfig(grid_resolution=2)
    cam_cfg = RandomCameraConfig(height=4, width=4, batch_size=1)
    makers = (lambda **kw: init_implicit_volume(geo, **kw)["encoding"]["tables"],
                lambda **kw: init_occgrid(rcfg, **kw).binary,
                lambda **kw: RandomCameraSampler(cam_cfg, **kw).sample()["rays_o"])
    for build in makers:
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                build()
        assert build(device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            make_occgrid_update(geo, rcfg)
        with pytest.raises((RuntimeError, AssertionError)):
            make_zero123_train_step(geo, rcfg, Zero123Losses())
    assert callable(make_zero123_train_step(geo, rcfg, Zero123Losses(), device="cpu"))


def test_static_entry_points_default_to_cuda():
    from dreammesh4d_tpu_torch.systems.sugar_static import (SugarStaticLosses, init_static_state,
                                                            make_render_eval, make_static_train_step)

    params, static, _, _, raster = _tiny_scene("cpu")
    sugar_static = static.sugar
    raster = raster._replace(backend="pallas")
    if torch.cuda.is_available():
        assert init_static_state(params).params.points.device.type == "cuda"
        make_static_train_step(sugar_static, raster, SugarStaticLosses())
    else:
        for build in (lambda: init_static_state(params),
                      lambda: make_static_train_step(sugar_static, raster, SugarStaticLosses()),
                      lambda: make_render_eval(sugar_static, raster)):
            with pytest.raises((RuntimeError, AssertionError)):
                build()
    state = init_static_state(params, device="cpu")
    assert state.params.points.requires_grad and state.params.points.is_leaf and state.step == 0
    assert [g["name"] for g in state.opt_state.param_groups] == list(params._fields)
    assert all(g["betas"] == (0.9, 0.999) and g["eps"] == 1e-15 for g in state.opt_state.param_groups)
    assert callable(make_static_train_step(sugar_static, raster, SugarStaticLosses(), device="cpu"))


def _tiny_scene(device):
    from dreammesh4d_tpu_torch.models.geometry.deformation import DeformationConfig, init_deformation
    from dreammesh4d_tpu_torch.models.geometry.dynamic_sugar import DynamicSuGaRConfig, build_dynamic_static
    from dreammesh4d_tpu_torch.models.geometry.sugar import SuGaRConfig, create_sugar
    from dreammesh4d_tpu_torch.ops.gs.rasterize import RasterizerConfig
    from dreammesh4d_tpu_torch.utils.procedural import make_icosphere

    params, sst = create_sugar(SuGaRConfig(n_gaussians_per_surface_triangle=1), make_icosphere(0),
                               device=device)
    dcfg = DeformationConfig(net_width=8, grid_channels=2, base_resolution=(4, 4, 4, 3), multires=(1,))
    cfg = DynamicSuGaRConfig(n_dg_nodes=4, dist_mode="eucdisc", deformation=dcfg)
    static = build_dynamic_static(cfg, sst, params.points.cpu().numpy(), device=device)
    raster = RasterizerConfig(16, 16, 0.5, 0.5, backend="pallas_resident", tile_px=16)
    return params, static, init_deformation(dcfg, device=device), cfg, raster


def test_viewer_defaults_to_cuda():
    from dreammesh4d_tpu_torch.serving import Viewer4D

    params, static, dparams, cfg, raster = _tiny_scene("cpu")
    if torch.cuda.is_available():
        assert Viewer4D(params, static, dparams, cfg, raster, 16, 16, 40.0, 4).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            Viewer4D(params, static, dparams, cfg, raster, 16, 16, 40.0, 4)
    frame = Viewer4D(params, static, dparams, cfg, raster, 16, 16, 40.0, 4, device="cpu").render(
        distance=3.0)
    assert frame.shape == (16, 16, 3) and np.isfinite(frame).all()


def test_rasterize_defaults_to_cuda():
    from dreammesh4d_tpu_torch.ops.gs.rasterize import RasterizerConfig, rasterize

    rng = np.random.default_rng(0)
    n = 8
    cam = (np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32), np.zeros(3, np.float32))
    args = (rng.normal(size=(n, 3)).astype(np.float32), np.full(n, 0.5, np.float32), cam,
            RasterizerConfig(16, 16, 0.5, 0.5, backend="pallas_resident"), np.ones(3, np.float32))
    kw = dict(colors=rng.random((n, 3)).astype(np.float32), scales=np.full((n, 3), 0.1, np.float32),
              quats=np.tile(np.float32([1, 0, 0, 0]), (n, 1)))
    if torch.cuda.is_available():
        assert rasterize(*args, **kw).rgb.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            rasterize(*args, **kw)
    assert rasterize(*args, **kw, device="cpu").rgb.shape == (16, 16, 3)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            assert "ok" not in json.loads(line)


def test_launcher_defaults_to_cuda():
    from dreammesh4d_tpu_torch import launch

    args, extras = launch.parse_args(["--config", "configs/sugar_dynamic_dg.yaml", "--train", "a.b=1"])
    assert args.device == "cuda" and args.train and extras == ["a.b=1"]
    assert launch.make_args("x.yaml", "test").device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch.main(args, extras)


def test_zero123_experiment_and_full_pipeline_default_to_cuda(tmp_path):
    from dreammesh4d_tpu_torch.config import load_config
    from dreammesh4d_tpu_torch.scripts import full_pipeline
    from dreammesh4d_tpu_torch.systems.assembly import Zero123Experiment

    cfg = load_config(os.path.join(REPO, "configs", "stable-zero123.yaml"), makedirs=False,
                      cli_args=["data.image_path=/x/a_rgba.png", f"exp_root_dir={tmp_path}",
                                "system.guidance.pretrained_model_name_or_path=none",
                                "system.geometry.pos_encoding_config.n_levels=2",
                                "system.geometry.pos_encoding_config.log2_hashmap_size=6"])
    if torch.cuda.is_available():
        assert Zero123Experiment(cfg).state.geo_params["encoding"]["tables"].device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        Zero123Experiment(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        full_pipeline.run(str(tmp_path / "pipeline"), tiny=True)
    assert not (tmp_path / "pipeline").exists()
    assert Zero123Experiment(cfg, device="cpu").state.geo_params["encoding"]["tables"].device.type == "cpu"


def test_port_sources_name_no_path_under_the_repos_native():
    from dreammesh4d_tpu_torch import host_build

    pkg = os.path.join(REPO, "dreammesh4d_tpu_torch")
    assert host_build.SRC_DIR == host_build.PKG_DIR / "native"
    assert sorted(os.listdir(host_build.SRC_DIR)) == ["marching_tets.cpp", "qem_decimate.cpp"]
    sources = [os.path.join(d, f) for d, _, files in os.walk(pkg) for f in files
               if f.endswith((".py", ".cpp", ".cu", ".cuh")) and "_build" not in d]
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(sources) > 50
    for path in sources:
        with open(path) as f:
            text = f.read()
        for pattern in ("native/mc", "native/build", '"native", "mc"', "'native', 'mc'"):
            assert pattern not in text, (path, pattern)


def test_zoo_entry_points_default_to_cuda(tmp_path):
    from dreammesh4d_tpu_torch.config import load_config
    from dreammesh4d_tpu_torch.models.geometry.implicit_volume import ImplicitVolumeConfig
    from dreammesh4d_tpu_torch.models.guidance.stable_diffusion import (StableDiffusionGuidance,
                                                                       StableDiffusionPromptProcessor)
    from dreammesh4d_tpu_torch.models.renderers.nerf_volume_renderer import NeRFRendererConfig
    from dreammesh4d_tpu_torch.models.guidance.vsd import VSDGuidance
    from dreammesh4d_tpu_torch.ops.hashgrid import HashGridConfig
    from dreammesh4d_tpu_torch.ops.shape_loss import ShapeLoss
    from dreammesh4d_tpu_torch.systems import threestudio_zoo as zoo
    from dreammesh4d_tpu_torch.systems import threestudio_zoo2 as zoo2
    from dreammesh4d_tpu_torch.systems.assembly_zoo import ZooTextExperiment, ZooVSDExperiment
    from test_torch_shape_loss import write_guide_obj

    tiny = dict(model_channels=8, channel_mult=[1], num_res_blocks=1, num_heads=1, context_dim=8, vae_ch=8,
                vae_ch_mult=[1], latent_size=4, image_size=4)
    geo = ImplicitVolumeConfig(hashgrid=HashGridConfig(n_levels=2, log2_hashmap_size=6), n_neurons=4)
    rcfg = NeRFRendererConfig()
    cfg = load_config(os.path.join(REPO, "configs", "zoo", "dreamfusion-sd.yaml"), makedirs=False,
                      cli_args=[f"exp_root_dir={tmp_path}", "system.prompt_processor.prompt=x",
                                "system.guidance.pretrained_model_name_or_path=none",
                                "system.geometry.pos_encoding_config.n_levels=2",
                                "system.geometry.pos_encoding_config.log2_hashmap_size=6"])
    vsd_cfg = load_config(os.path.join(REPO, "configs", "zoo", "prolificdreamer.yaml"), makedirs=False,
                          cli_args=[f"exp_root_dir={tmp_path}", "system.prompt_processor.prompt=x",
                                    "system.guidance.pretrained_model_name_or_path=none",
                                    "system.geometry.pos_encoding_config.n_levels=2",
                                    "system.geometry.pos_encoding_config.log2_hashmap_size=6"])
    guide = write_guide_obj(tmp_path / "guide.obj")
    makers = (lambda **kw: StableDiffusionGuidance(tiny, **kw).modules.device,
              lambda **kw: StableDiffusionPromptProcessor({"context_dim": 8, "seq_len": 2}, **kw)().cond.device,
              lambda **kw: zoo.init_scene_state({"w": torch.zeros(2)}, **kw).geo_params["w"].device,
              lambda **kw: ZooTextExperiment(cfg, **kw).state.geo_params["encoding"]["tables"].device,
              lambda **kw: VSDGuidance(tiny, **kw).modules.device,
              lambda **kw: zoo.init_vsd_state({"w": torch.zeros(2)}, {"a": {"A": torch.zeros(2)}},
                                              **kw).lora_params["a"]["A"].device,
              lambda **kw: ShapeLoss(guide, grid_res=4, **kw).occ_grid.device,
              lambda **kw: ZooVSDExperiment(vsd_cfg, **kw).state.lora_params["unused"].device)
    for build in makers:
        if torch.cuda.is_available():
            assert build().type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                build()
        assert build(device="cpu").type == "cpu"
    if not torch.cuda.is_available():
        for build in (lambda: zoo.make_dreamfusion_train_step(geo, rcfg, zoo.DreamFusionLosses(), None),
                      lambda: zoo.make_magic123_train_step(geo, rcfg, zoo.Magic123Losses()),
                      lambda: zoo.make_prolificdreamer_train_step(geo, rcfg, zoo.ProlificDreamerLosses(), None),
                      lambda: zoo2.make_latentnerf_train_step(geo, rcfg, zoo2.LatentNeRFLosses(), None),
                      lambda: zoo2.make_sjc_train_step(geo, rcfg, zoo2.SJCLosses(), None)):
            with pytest.raises((RuntimeError, AssertionError)):
                build()
    assert callable(zoo.make_eff_dreamfusion_train_step(geo, rcfg, zoo.DreamFusionLosses(), None, 8,
                                                        device="cpu"))

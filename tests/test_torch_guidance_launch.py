"""Stages 1, 4 and 5 from their YAML with the Stable Zero123 guidance on, at
tiny widths (CPU; the guidance's own parity with the JAX package is
``test_torch_guidance.py``).

- Each experiment, built with ``pretrained_model_name_or_path=random:1`` and
  a tiny guidance by dotlist (``use_clip=false``), takes one step: the SDS
  term is in its metrics (``loss_sds``; ``loss_sds_zero123`` in stage 5) and
  reaches the gradients — the same step with the SDS weight at 0, from the
  same seed, gives other gradients.  Stage 1's bank holds the reference
  image, stage 5's every video frame; stage 5's random views reach the
  guidance at ``guidance_render_size``; ``freq.guidance_eval`` writes
  ``it1-guidance.png``.
- The launcher runs each YAML for one step with a checkpoint that exists: a
  tiny ``.ckpt`` in the LDM layout, with a text-tower key to skip.
- ``random[:seed]`` draws the same weights for the same seed, others for
  another.
"""

import csv
import os

import numpy as np
import pytest
import torch

from dreammesh4d_tpu_torch import launch
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.data.png import read_png, write_png
from dreammesh4d_tpu_torch.export.mesh_io import MeshData, save_ply_mesh
from dreammesh4d_tpu_torch.models.guidance.zero123.guidance import Zero123Modules
from dreammesh4d_tpu_torch.systems import assembly
from dreammesh4d_tpu_torch.utils.procedural import make_icosphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUIDANCE = ["system.guidance.model_channels=16", "system.guidance.channel_mult=[1,2]",
            "system.guidance.num_res_blocks=1", "system.guidance.num_heads=2",
            "system.guidance.context_dim=16", "system.guidance.vae_ch=8",
            "system.guidance.vae_ch_mult=[1,2]", "system.guidance.vae_num_res_blocks=1",
            "system.guidance.image_size=16", "system.guidance.latent_size=8",
            "system.guidance.use_clip=false", "system.guidance.dtype=float32"]
SDS_KEY = {"zero123": ("loss_sds", "lambda_sds"), "static": ("loss_sds", "lambda_sds"),
           "dynamic": ("loss_sds_zero123", "lambda_sds_zero123")}
YAMLS = {"zero123": "stable-zero123.yaml", "static": "sugar_static_refine.yaml",
         "dynamic": "sugar_dynamic_dg.yaml"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The stages' dotlists (guidance and output directory left out)."""
    d = tmp_path_factory.mktemp("guidance_assets")
    yy, xx = np.mgrid[0:48, 0:48]
    inside = (xx - 23.5) ** 2 + (yy - 23.5) ** 2 < 14.0 ** 2
    write_png(str(d / "ref_rgba.png"),
              np.stack([xx * 5, yy * 5, (xx + yy) * 2, inside * 255], -1).astype(np.uint8))
    frames = d / "frames"
    frames.mkdir()
    for i in range(8):
        rgba = np.zeros((48, 48, 4), np.uint8)
        cx = 24 + int(6 * np.sin(2 * np.pi * i / 8))
        rgba[16:32, cx - 8:cx + 8] = [200, 80, 60, 255]
        write_png(str(frames / f"{i:03d}_rgba.png"), rgba)
    m = make_icosphere(1, radius=0.6)
    save_ply_mesh(str(d / "mesh.ply"), MeshData(v_pos=m.v_pos, t_pos_idx=m.t_pos_idx, v_rgb=m.v_rgb))
    gs = ["system.geometry.n_gaussians_per_surface_triangle=1", "system.renderer.tile_capacity=256",
          f"system.geometry.surface_mesh_to_bind_path={d}/mesh.ply",
          "data.random_camera.height=32", "data.random_camera.width=32",
          "data.random_camera.batch_size=2", "data.height=32", "data.width=32"]
    return {
        "zero123": [
            f"data.image_path={d}/ref_rgba.png", "data.height=16", "data.width=16",
            "data.random_camera.height=8", "data.random_camera.width=8",
            "data.random_camera.batch_size=2", "data.random_camera.eval_height=16",
            "data.random_camera.eval_width=16",
            "system.geometry.pos_encoding_config.n_levels=2",
            "system.geometry.pos_encoding_config.log2_hashmap_size=8",
            "system.geometry.pos_encoding_config.base_resolution=4",
            "system.geometry.pos_encoding_config.per_level_scale=2.0",
            "system.renderer.grid_resolution=4", "system.renderer.occ_candidates=8",
            "system.renderer.occ_samples=4", "system.material.ambient_only_steps=0"],
        "static": gs + [f"data.image_path={d}/ref_rgba.png", "data.random_camera.n_test_views=4"],
        "dynamic": gs + [
            f"data.video_frames_dir={frames}", "data.num_frames=2", "data.video_length=8",
            "system.geometry.n_dg_nodes=16", "system.geometry.dist_mode=eucdisc",
            "system.geometry.deformation.base_resolution=[8,8,8,4]",
            "system.geometry.deformation.multires=[1,2]",
            "system.geometry.deformation.net_width=16", "system.geometry.deformation.grid_channels=8",
            "system.guidance.guidance_render_size=16"],
    }


def _experiment(stage, dotlist, out, extra=()):
    cfg = load_config(os.path.join(REPO, "configs", YAMLS[stage]),
                      cli_args=dotlist + GUIDANCE + [f"exp_root_dir={out}", "use_timestamp=false",
                                                     *extra])
    return assembly.build_experiment(cfg, device="cpu")


def _grads(exp):
    return [p.grad.clone() for g in exp.state.opt_state.param_groups for p in g["params"]
            if p.grad is not None]


@pytest.mark.parametrize("stage", ["zero123", "static", "dynamic"])
def test_each_stage_trains_with_the_guidance(stage, assets, tmp_path):
    key, weight = SDS_KEY[stage]
    guided = ["system.guidance.pretrained_model_name_or_path=random:1", "system.freq.guidance_eval=1"]
    exp = _experiment(stage, assets[stage], tmp_path / "a", guided)
    assert exp.guidance is not None and exp.guidance.modules.clip is None
    n_bank = 8 if stage == "dynamic" else 1
    assert tuple(exp.bank["c_concat"].shape) == (n_bank, 4, 8, 8)
    assert tuple(exp.bank["c_crossattn"].shape) == (n_bank, 16)
    seen = []
    real = exp.guidance.sds_loss

    def spy(bank, rgb, *args, **kwargs):
        seen.append((tuple(rgb.shape), args[3]))
        return real(bank, rgb, *args, **kwargs)

    exp.guidance.sds_loss = spy
    metrics = exp.train_step(0)
    assert key in metrics and float(metrics[key]) > 0 and np.isfinite(float(metrics["loss_total"]))
    grads = _grads(exp)
    if stage == "dynamic":  # the views at guidance_render_size; the frames' bank entries
        assert seen[0][0] == (2, 16, 16, 3) and seen[0][1] is not None
    else:
        assert seen[0][1] is None
    if stage != "static":  # freq.guidance_eval (the static stage has none, as in the JAX package)
        grid = read_png(os.path.join(exp.cfg.trial_dir, "save", "it1-guidance.png"))
        assert grid.shape[:2] == (16, 4 * 2 * 16 if stage == "dynamic" else 4 * 16)

    bare = _experiment(stage, assets[stage], tmp_path / "b",
                       ["system.guidance.pretrained_model_name_or_path=random:1",
                        f"system.loss.{weight}=0"])
    bare_metrics = bare.train_step(0)
    np.testing.assert_allclose(float(bare_metrics[key]), float(metrics[key]), rtol=1e-5)
    diff = max(float((a - b).abs().max()) for a, b in zip(grads, _grads(bare)))
    assert diff > 0, "the SDS term does not reach the gradients"


def test_launcher_runs_each_yaml_with_a_checkpoint(assets, tmp_path, monkeypatch):
    """One step of each YAML through ``launch.main`` with a tiny ``.ckpt``."""
    built = []

    def keep(cfg, device):
        built.append(assembly.build_experiment(cfg, device=device))
        return built[-1]

    monkeypatch.setattr(launch, "build_experiment", keep)
    cfg = load_config(os.path.join(REPO, "configs", YAMLS["static"]), makedirs=False,
                      cli_args=assets["static"] + GUIDANCE)
    mods = Zero123Modules(assembly.config_from_dict(dict(cfg.system.guidance)), device="cpu")
    mods.init_params(torch.Generator().manual_seed(5), zero_init=False)
    sd = dict(mods.state_dict())
    del sd["clip_proj"]
    sd["cond_stage_model.model.transformer.resblocks.0.ln_1.weight"] = torch.ones(4)
    ckpt = str(tmp_path / "tiny.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    for stage in ("zero123", "static", "dynamic"):
        extras = assets[stage] + GUIDANCE + [
            f"system.guidance.pretrained_model_name_or_path={ckpt}", "trainer.max_steps=1",
            "trainer.val_check_interval=100", f"exp_root_dir={tmp_path / 'out'}",
            "use_timestamp=false", f"tag={stage}"]
        launch.main(launch.make_args(os.path.join(REPO, "configs", YAMLS[stage]), "train",
                                     device="cpu"), extras)
        exp = built[-1]
        for k, v in sd.items():
            if k in exp.guidance.modules.state_dict():
                torch.testing.assert_close(exp.guidance.modules.state_dict()[k], v, rtol=0, atol=0)
        with open(os.path.join(exp.cfg.trial_dir, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        assert float(rows[-1][SDS_KEY[stage][0]]) > 0, stage


def test_random_seeds():
    gcfg = {"pretrained_model_name_or_path": "random:3", "model_channels": 16,
            "channel_mult": [1, 2], "num_res_blocks": 1, "num_heads": 2, "context_dim": 16,
            "vae_ch": 8, "vae_ch_mult": [1, 2], "vae_num_res_blocks": 1, "image_size": 16,
            "use_clip": False}
    a, b = (assembly.maybe_build_guidance({"guidance": gcfg}, device="cpu") for _ in range(2))
    c = assembly.maybe_build_guidance({"guidance": {**gcfg, "pretrained_model_name_or_path": "random"}},
                                      device="cpu")
    w = "model.diffusion_model.input_blocks.0.0.weight"
    sa, sb, sc = (g.modules.state_dict()[w] for g in (a, b, c))
    torch.testing.assert_close(sa, sb, rtol=0, atol=0)
    assert not torch.equal(sa, sc)
    assert type(a).__registered_name__ == "stable-zero123-guidance"
    t = assembly.maybe_build_guidance({"guidance": gcfg, "guidance_type": "temporal-stable-zero123-guidance"},
                                      device="cpu")
    assert type(t).__registered_name__ == "temporal-stable-zero123-guidance"

"""The Gaussian stage run from its YAML: ``configs/sugar_static_refine.yaml``
with ``system.stage=gaussian`` through both packages' config loaders and the
port's launcher (CPU).

Tiny size: a 48² RGBA reference read at 32², 2 random views at 32², the
``xla`` backend on 16-px tiles, capacity 256, the Gaussians initialised from
a vertex-coloured icosphere(2) OBJ through
``system.geometry.geometry_convert_from`` (162 points: no random draw on
either side), guidance off.

- ``build_experiment`` dispatches on ``system.stage`` to
  ``GaussianStageExperiment``, whose initial state equals the JAX
  experiment's: every slot's fields within 1e-6 (the scales come from the
  3-NN distances), ``alive`` exact, the YAML's geometry keys and ``freq``
  intervals, the neighbour table on the alive slots exact, the rasterizer
  config, Adam with zero moments (b2 0.999, eps 1e-15, each lr the YAML's
  at count 1).
- The launcher trains 4 steps with the intervals moved inside them
  (``densify_from=1``, ``densify=2``, ``opacity_reset=3``,
  ``reset_neighbors=2``, ``start_sugar_reg=0``): the densify at step 2
  changes ``n_alive`` (``gauss_num`` in that step's metrics), the neighbour
  table is rebuilt at steps 0 and 2, the opacity reset leaves every alive
  opacity ≤ 0.01 in the step-4 checkpoint.  ``load_state`` of that checkpoint
  restores every slot, the statistics, the step and each leaf's Adam count
  (4) and moments exactly; ``resume=LAST`` trains on to step 6.
- ``--export resume=LAST`` writes ``save/gaussians.ply`` of the alive slots,
  byte-equal to the JAX writer's file for the same state.
"""

import os

import jax
import numpy as np
import pytest
import torch

from dreammesh4d_tpu.config import load_config as j_load_config
from dreammesh4d_tpu.export.gaussian_io import save_gaussians_ply as j_save_gaussians_ply
from dreammesh4d_tpu.export.mesh_io import save_obj as j_save_obj
from dreammesh4d_tpu.systems import assembly as jasm
from dreammesh4d_tpu.utils.procedural import make_icosphere
from dreammesh4d_tpu_torch import convert, launch
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.data.png import write_png
from dreammesh4d_tpu_torch.models.geometry.gaussian import GaussianState
from dreammesh4d_tpu_torch.systems import assembly
from dreammesh4d_tpu_torch.utils.checkpoint import restore_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "sugar_static_refine.yaml")
FIELDS = ("xyz", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dotlist(tmp_path_factory):
    d = tmp_path_factory.mktemp("gaussian_assets")
    mesh = make_icosphere(2, radius=0.5)
    mesh.v_rgb = np.random.default_rng(0).random((mesh.n_verts, 3)).astype(np.float32)
    j_save_obj(str(d / "points.obj"), mesh)
    yy, xx = np.mgrid[0:48, 0:48]
    inside = (xx - 23.5) ** 2 + (yy - 23.5) ** 2 < 15.0 ** 2
    rgba = np.stack([xx * 5, yy * 5, (xx + yy) * 2, inside * 255], -1).astype(np.uint8)
    write_png(str(d / "ref_rgba.png"), rgba)
    return [
        "system.stage=gaussian", "system.guidance.pretrained_model_name_or_path=none",
        f"data.image_path={d}/ref_rgba.png", f"system.geometry.geometry_convert_from={d}/points.obj",
        "system.geometry.surface_mesh_to_bind_path=unused", "system.geometry.max_num=256",
        "data.height=32", "data.width=32", "data.random_camera.height=32", "data.random_camera.width=32",
        "data.random_camera.batch_size=2", "data.random_camera.n_test_views=4",
        "system.renderer.backend=xla", "system.renderer.tile_px=16", "system.renderer.tile_capacity=256",
        "system.renderer.max_tiles_per_gaussian=16", "system.renderer.bf16_matmuls=false",
        f"exp_root_dir={d}/out", "use_timestamp=false", "tag=gs",
    ]


def test_initial_state_matches_jax(dotlist):
    jexp = jasm.build_experiment(j_load_config(YAML, cli_args=dotlist))
    exp = assembly.build_experiment(load_config(YAML, cli_args=dotlist), device="cpu")
    assert isinstance(exp, assembly.GaussianStageExperiment)
    assert isinstance(jexp, jasm.GaussianStageExperiment)
    jg = jax.tree.map(np.asarray, jexp.state.gaussians)
    assert int(exp.state.gaussians.alive.sum()) == int(jg.alive.sum()) == 162
    np.testing.assert_array_equal(exp.state.gaussians.alive.numpy(), jg.alive)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(exp.state.gaussians, f).detach().numpy(), getattr(jg, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert exp.gcfg.__dict__ == jexp.gcfg.__dict__
    for k in ("densify_every", "densify_from", "densify_until", "opacity_reset_every",
              "reset_neighbors_every"):
        assert getattr(exp, k) == getattr(jexp, k), k
    alive = jg.alive
    np.testing.assert_array_equal(exp.reg_state.knn_idx.numpy()[alive],
                                  np.asarray(jexp.reg_state.knn_idx)[alive])
    assert exp.raster_cfg == convert.config(jexp.raster_cfg)
    assert exp.state.step == int(jexp.state.step) == 0 and exp.state.opt_state.state == {}
    groups = exp.state.opt_state.param_groups
    assert [g["name"] for g in groups] == list(FIELDS)
    assert all(g["betas"] == (0.9, 0.999) and g["eps"] == 1e-15 for g in groups)
    assert [g["lr"] for g in groups] == pytest.approx([0.00048, 0.001, 0.001 / 20, 0.005, 0.001, 0.02])


def test_launcher_densify_reset_resume_export(dotlist, tmp_path, monkeypatch):
    extras = dotlist + [
        f"exp_root_dir={tmp_path}", "trainer.max_steps=4", "checkpoint.every_n_train_steps=2",
        "trainer.val_check_interval=4", "trainer.log_every_n_steps=1",
        "system.freq.densify_from=1", "system.freq.densify=2", "system.freq.opacity_reset=3",
        "system.freq.reset_neighbors=2", "system.freq.start_sugar_reg=0",
        "system.geometry.densify_grad_threshold=1e-7"]
    seen, refreshed, resets = [], [], []
    real_step = assembly.GaussianStageExperiment.train_step
    real_reg, real_reset = assembly.make_reg_state, assembly.reset_state_opacity

    def train_step(exp, step):
        metrics = real_step(exp, step)
        seen.append((step, {k: float(v) for k, v in metrics.items()}, int(exp.state.gaussians.alive.sum())))
        return metrics

    monkeypatch.setattr(assembly.GaussianStageExperiment, "train_step", train_step)
    monkeypatch.setattr(assembly, "make_reg_state", lambda s: refreshed.append(s.step) or real_reg(s))
    monkeypatch.setattr(assembly, "reset_state_opacity", lambda s: resets.append(s.step) or real_reset(s))
    launch.main(launch.make_args(YAML, "train", device="cpu"), extras)

    assert [s for s, _, _ in seen] == [0, 1, 2, 3]
    assert refreshed == [0, 1, 3] and resets == [4]  # built at init; after steps 0 and 2; after step 3
    (_, m1, alive1), (_, m2, alive2) = seen[1], seen[2]
    assert "gauss_num" not in m1 and m2["gauss_num"] == alive2 != alive1 == 162
    assert all(np.isfinite(v) for _, m, _ in seen for v in m.values())
    assert m2["loss_sugar_density_reg"] > 0 and m2["loss_opacity_binary"] > 0
    trial = os.path.join(str(tmp_path), "sugar-refine", "gs")
    assert sorted(os.listdir(os.path.join(trial, "ckpts"))) == ["step_00000002", "step_00000004"]
    assert os.path.exists(os.path.join(trial, "save", "it4-gaussian.png"))
    saved = restore_checkpoint(os.path.join(trial, "ckpts", "step_00000004"))
    g = saved["gaussians"]
    assert int(g["alive"].sum()) == alive2 and saved["step"] == 4
    assert float(torch.sigmoid(g["opacity_logits"][g["alive"]]).max()) <= 0.01 + 1e-7

    exp = assembly.build_experiment(load_config(YAML, cli_args=extras), device="cpu")
    exp.load_state(saved)
    for f in GaussianState._fields:
        assert torch.equal(getattr(exp.state.gaussians, f).detach(), g[f]), f
    for k, v in saved["stats"].items():
        assert torch.equal(getattr(exp.state.stats, k), v), k
    opt = exp.state.opt_state
    for i, f in enumerate(FIELDS):
        st, want = opt.state[getattr(exp.state.gaussians, f)], saved["opt_state"]["state"][i]
        assert float(st["step"]) == 4 and torch.equal(st["exp_avg"], want["exp_avg"]), f
        assert torch.equal(st["exp_avg_sq"], want["exp_avg_sq"]) and want["exp_avg_sq"].any(), f
    assert exp.state.step == 4

    seen.clear()
    launch.main(launch.make_args(YAML, "train", device="cpu"),
                extras + ["resume=LAST", "trainer.max_steps=6"])
    assert [s for s, _, _ in seen] == [4, 5]
    resumed = restore_checkpoint(os.path.join(trial, "ckpts", "step_00000006"))
    assert resumed["step"] == 6 and float(resumed["opt_state"]["state"][0]["step"]) == 6

    launch.main(launch.make_args(YAML, "export", device="cpu"), extras + ["resume=LAST"])
    ply = os.path.join(trial, "save", "gaussians.ply")
    g = {k: v.numpy() for k, v in resumed["gaussians"].items()}
    alive = g["alive"]
    ref = str(tmp_path / "jax_gaussians.ply")
    j_save_gaussians_ply(ref, g["xyz"][alive], np.concatenate([g["sh_dc"], g["sh_rest"]], 1)[alive],
                         g["opacity_logits"][alive], g["log_scales"][alive], g["quats"][alive])
    with open(ply, "rb") as a, open(ref, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and f"element vertex {int(alive.sum())}".encode() in got

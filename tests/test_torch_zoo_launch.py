"""The zoo's ten YAMLs through the port's launcher (CPU, port only).

``configs/zoo/{zero123, dreamfusion-sd, magic3d-coarse-sd,
dreamfusion-sd-eff, magic123-coarse-sd, imagecondition, latentnerf,
sketchshape, sjc, prolificdreamer}.yaml`` (sketchshape with the 80-face
guide OBJ of ``test_torch_shape_loss.py``) at tiny
widths (2 hash levels of 2⁸ rows, 8² views — 32² for the efficient
variant's subgrid — 8² evaluation renders, a 16³ export grid) with the
guidance at ``random:0`` (SD UNet 16 × [1], VAE 8 × [1], latents 8²;
Stable Zero123 likewise, without CLIP) and with ``none``:

- ``random:0``: ``--train`` for 2 steps (a checkpoint every step), the SDS
  term nonzero in every row of ``metrics.csv`` (prolificdreamer's VSD and
  LoRA terms, with ``system.guidance.zero_init=false``: with the LDM's
  zero-initialised output convolution the UNet returns zeros and VSD is
  zero; latentnerf's LR follows its warm-up); ``--validate`` and
  ``--test`` write their image; ``--export resume=LAST`` writes
  ``save/model.obj``; ``--train resume=LAST`` to 3 steps starts at step 2;
- ``none``: ``--train`` for 2 steps, the SDS term zero (the zoo's systems
  keep it in the metrics, as in the JAX package) or absent (zero123-system);
- refusals: ``trainer.devices=2`` on a zoo system raises ``RuntimeError``
  naming ROADMAP A8 before any process starts; a system that no launcher
  builds (``fantasia3d-system``: in neither package's table) raises
  ``KeyError``; ``system.scheduler`` is no
  longer refused (it builds latentnerf's schedule), and an unknown
  scheduler name raises ``NotImplementedError``; a ``guide_shape`` that
  names no file drops the shape term.
"""

import csv
import glob
import os

import numpy as np
import pytest
import torch

from dreammesh4d_tpu_torch import launch
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.data.png import write_png
from dreammesh4d_tpu_torch.systems import assembly
from dreammesh4d_tpu_torch.systems.optim import scheduler_factor_fn
from dreammesh4d_tpu_torch.utils.checkpoint import restore_checkpoint
from test_torch_shape_loss import write_guide_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(key):
    return [f"{key}.model_channels=16", f"{key}.channel_mult=[1]", f"{key}.num_res_blocks=1",
            f"{key}.num_heads=2", f"{key}.context_dim=16", f"{key}.vae_ch=8", f"{key}.vae_ch_mult=[1]",
            f"{key}.vae_num_res_blocks=1", f"{key}.image_size=8", f"{key}.latent_size=8", f"{key}.use_clip=false"]


TEXT = ["system.prompt_processor.prompt=a test object", "system.prompt_processor.context_dim=16",
        "system.prompt_processor.seq_len=4", "data.eval_height=8", "data.eval_width=8"]
IMAGE = ["data.height=8", "data.width=8", "data.random_camera.height=8", "data.random_camera.width=8",
         "data.random_camera.eval_height=8", "data.random_camera.eval_width=8"]
YAMLS = {  # name: (extra dotlist, guidance keys, SDS metric)
    "zero123": (IMAGE, ["system.guidance"], "loss_sds"),
    "dreamfusion-sd": (TEXT + ["data.width=8", "data.height=8"], ["system.guidance"], "loss_sds"),
    "magic3d-coarse-sd": (TEXT + ["data.width=8", "data.height=8"], ["system.guidance"], "loss_sds"),
    "dreamfusion-sd-eff": (TEXT + ["data.width=32", "data.height=32"], ["system.guidance"], "loss_sds"),
    "magic123-coarse-sd": (TEXT + IMAGE, ["system.guidance", "system.guidance_3d"], "loss_sds_2d"),
    "imagecondition": (TEXT + IMAGE, ["system.guidance"], "loss_sds_2d"),
    "latentnerf": (TEXT + ["data.width=8", "data.height=8"], ["system.guidance"], "loss_sds"),
    "sketchshape": (TEXT + ["data.width=8", "data.height=8"], ["system.guidance"], "loss_sds"),
    "sjc": (TEXT + ["data.width=8", "data.height=8"], ["system.guidance"], "loss_sds"),
    "prolificdreamer": (TEXT + ["data.width=8", "data.height=8", "system.guidance.zero_init=false"],
                        ["system.guidance"], "loss_vsd"),
}


GRID8 = ["system.geometry.pos_encoding_config.n_levels=2", "system.geometry.pos_encoding_config.log2_hashmap_size=8"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_assets")
    yy, xx = np.mgrid[0:24, 0:24]
    inside = (xx - 11.5) ** 2 + (yy - 11.5) ** 2 < 7.0 ** 2
    write_png(str(d / "ref_rgba.png"), np.stack([xx * 10, yy * 10, (xx + yy) * 5, inside * 255], -1).astype(np.uint8))
    return str(d / "ref_rgba.png")


@pytest.fixture(scope="module")
def guide(tmp_path_factory):
    return write_guide_obj(tmp_path_factory.mktemp("zoo_guide") / "guide.obj")


def _dotlist(name, guidance, image, out, guide=None):
    extra, keys, _ = YAMLS[name]
    dl = list(extra) + ([f"system.guide_shape={guide}"] if name == "sketchshape" else []) + [
        f"data.image_path={image}", "system.geometry.pos_encoding_config.n_levels=2",
                        "system.geometry.pos_encoding_config.log2_hashmap_size=8",
                        "system.exporter.isosurface_resolution=16", "checkpoint.every_n_train_steps=1",
                        "trainer.max_steps=2", "trainer.val_check_interval=0", f"exp_root_dir={out}",
                        "use_timestamp=false", "tag=t"]
    for key in keys:
        dl.append(f"{key}.pretrained_model_name_or_path={guidance}")
        dl += _tiny(key) if guidance != "none" else []
    return dl


def _run(name, verb, dotlist):
    launch.main(launch.make_args(os.path.join(REPO, "configs", "zoo", f"{name}.yaml"), verb, device="cpu"),
                dotlist)


def _rows(trial):
    with open(os.path.join(trial, "metrics.csv")) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_yaml_runs_every_verb_with_the_guidance(name, image, guide, tmp_path):
    dl = _dotlist(name, "random:0", image, tmp_path, guide)
    exps = []
    build = launch.build_experiment
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch, "build_experiment", lambda *a, **k: exps.append(build(*a, **k)) or exps[-1])
        _run(name, "train", dl)
    (trial,) = glob.glob(str(tmp_path / "*" / "t"))
    sds = YAMLS[name][2]
    rows = _rows(trial)
    assert [int(r["step"]) for r in rows] == [0, 1]
    assert all(np.isfinite(float(r["loss_total"])) and float(r[sds]) > 0 for r in rows), rows
    if name == "magic123-coarse-sd":
        assert all(float(r["loss_sds_3d"]) > 0 for r in rows)
    if name == "sketchshape":
        assert all(float(r["loss_shape"]) > 0 for r in rows)
    if name == "prolificdreamer":
        assert all(float(r["loss_lora"]) > 0 for r in rows)
    if name == "latentnerf":  # the scene's lr after step 1: 0.01 times the warm-up's factor at 1
        factor = scheduler_factor_fn(exps[0].cfg.system.scheduler)
        assert exps[0].state.opt_state.param_groups[0]["lr"] == 0.01 * factor(1) and factor(1) > factor(0)
    saved = restore_checkpoint(os.path.join(trial, "ckpts", "step_00000002"), "cpu")
    keys = {"geo_params", "opt_state", "step"}
    if name == "prolificdreamer":
        keys |= {"lora_params", "lora_opt_state"}
    assert saved["step"] == 2 and set(saved) == keys
    _run(name, "validate", dl + ["resume=LAST"])
    _run(name, "export", dl + ["resume=LAST"])
    images = sorted(os.listdir(os.path.join(trial, "save")))
    stem = "nerf" if name == "zero123" else "val"
    assert f"it2-{stem}.png" in images and "model.obj" in images
    if name != "zero123":
        assert "it2-test.png" in images  # --train's test pass
    _run(name, "train", [x for x in dl if x != "trainer.max_steps=2"] + ["trainer.max_steps=3", "resume=LAST"])
    assert [int(r["step"]) for r in _rows(trial)][-1] == 2
    assert restore_checkpoint(os.path.join(trial, "ckpts", "step_00000003"), "cpu")["step"] == 3


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_yaml_trains_with_the_guidance_off(name, image, guide, tmp_path):
    _run(name, "train", _dotlist(name, "none", image, tmp_path, guide))
    (trial,) = glob.glob(str(tmp_path / "*" / "t"))
    rows = _rows(trial)
    assert len(rows) == 2 and all(np.isfinite(float(r["loss_total"])) for r in rows)
    sds = YAMLS[name][2]
    if name == "zero123":
        assert sds not in rows[0]
    else:
        assert all(float(r[sds]) == 0.0 for r in rows)


def test_refusals_name_a8(image, tmp_path):
    dl = _dotlist("dreamfusion-sd", "none", image, tmp_path)
    with pytest.raises(RuntimeError, match="A8"):
        _run("dreamfusion-sd", "train", dl + ["trainer.devices=2"])
    assert not os.path.exists(tmp_path / "dreamfusion-sd")
    cli = [f"exp_root_dir={tmp_path}", "system.prompt_processor.prompt=x",
           "system.guidance.pretrained_model_name_or_path=none"]
    path = os.path.join(REPO, "configs", "zoo", "latentnerf.yaml")
    cfg = load_config(path, makedirs=False, cli_args=cli + ["system_type=fantasia3d-system"])
    with pytest.raises(KeyError, match="fantasia3d-system"):
        assembly.build_experiment(cfg, device="cpu")
    # the scheduler builds; an unknown scheduler name raises
    exp = assembly.build_experiment(load_config(path, makedirs=False, cli_args=cli + GRID8), device="cpu")
    assert exp.state.opt_state.param_groups[0]["schedule"](0) == pytest.approx(0.001)
    cfg = load_config(path, makedirs=False, cli_args=cli + GRID8 + ["system.scheduler.name=OneCycleLR"])
    with pytest.raises(NotImplementedError, match="OneCycleLR"):
        assembly.build_experiment(cfg, device="cpu")
    # a guide_shape that names no file drops the shape term (as in the JAX package), with a warning
    cfg = load_config(os.path.join(REPO, "configs", "zoo", "sketchshape.yaml"), makedirs=False,
                      cli_args=cli + GRID8 + [f"system.guide_shape={tmp_path / 'missing.obj'}"])
    assert assembly.build_experiment(cfg, device="cpu").shape_loss is None

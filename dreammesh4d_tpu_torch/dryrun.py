"""Multi-device dry run of the port (counterpart of
``__graft_entry__.dryrun_multichip``): the experiments' training steps on a
``(data, model)`` grid THROUGH THE LAUNCH SURFACE, at tiny sizes.

``dryrun_multichip(n)`` runs ``configs/sugar_static_refine.yaml`` and
``configs/sugar_dynamic_dg.yaml`` (``stages`` may add ``gaussian``, the
Gaussian stage of the static YAML, and ``nerf``, ``configs/stable-zero123.yaml``)
through ``launch.main`` with ``trainer.devices=n`` and ``trainer.mesh=[2,
n/2]`` for an even n ≥ 4 (else ``[n, 1]``), with a random-weight tiny
guidance, on procedural assets: every rank spawned by the launcher, on the
CPU by ``gloo`` (``device="cpu"``) or on the cards where ``n`` of them are
visible.  It prints one "ok" line per stage with the last logged losses and
returns ``{stage: trial directory}``.

    python3 -m dreammesh4d_tpu_torch.dryrun 2 --device cpu

:func:`stage_dotlists` gives each stage's YAML and dotlist at that size, for
a single-device run of the same thing.
"""

from __future__ import annotations

import argparse
import csv
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .data.png import write_png
from .export.mesh_io import save_ply_mesh
from .utils.procedural import make_icosphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("static", "dynamic", "gaussian", "nerf")
EXP_NAMES = {"static": "sugar-refine", "dynamic": "sugar-dynamic", "gaussian": "sugar-refine",
             "nerf": "zero123-sai"}

# a random-weight Stable Zero123 at tiny widths: 4 heads, so tp ∈ {1, 2, 4};
# no zero-initialised output convolution, so that the attention and FF
# layers that tp splits reach the loss
TINY_GUIDANCE = [
    "system.guidance.pretrained_model_name_or_path=random:0", "system.guidance.zero_init=false",
    "system.guidance.model_channels=16", "system.guidance.channel_mult=[1,2]",
    "system.guidance.num_res_blocks=1", "system.guidance.num_heads=4",
    "system.guidance.context_dim=16", "system.guidance.vae_ch=8",
    "system.guidance.vae_ch_mult=[1,2]", "system.guidance.vae_num_res_blocks=1",
    "system.guidance.image_size=16", "system.guidance.use_clip=false",
    "system.guidance.guidance_render_size=0",
]


def write_assets(root: str) -> Dict[str, str]:
    """A 48² RGBA reference image, 8 RGBA frames of a moving square and an
    icosphere(1) bind mesh under ``root``."""
    os.makedirs(root, exist_ok=True)
    yy, xx = np.mgrid[0:48, 0:48]
    inside = (xx - 23.5) ** 2 + (yy - 23.5) ** 2 < 13.0 ** 2
    rgba = np.stack([xx * 5, yy * 5, (xx + yy) * 2, inside * 255], -1).astype(np.uint8)
    image = os.path.join(root, "obj_rgba.png")
    write_png(image, rgba)
    frames = os.path.join(root, "frames")
    os.makedirs(frames, exist_ok=True)
    for i in range(8):
        f = np.zeros((48, 48, 4), np.uint8)
        cx = 24 + int(6 * np.sin(2 * np.pi * i / 8))
        f[16:32, cx - 8:cx + 8] = [200, 80, 60, 255]
        write_png(os.path.join(frames, f"{i:03d}_rgba.png"), f)
    mesh = os.path.join(root, "mesh.ply")
    save_ply_mesh(mesh, make_icosphere(1, radius=0.6))
    return {"image": image, "frames": frames, "mesh": mesh}


def stage_dotlists(assets: Dict[str, str], out: str, tag: str,
                   batch: int = 2) -> Dict[str, Tuple[str, List[str]]]:
    """``{stage: (yaml, dotlist)}`` at the dry run's size: ``batch`` random
    views (stages 1 and 4, the Gaussian stage) or frames (stage 5) a step,
    2 steps (1 for stage 1, 4 for the Gaussian stage with a density control
    at step 2 and without the guidance), a metric row every step, no
    validation; the trial of stage
    ``s`` is ``<out>/<name>/<tag>_<s>`` (:func:`trial_dir`)."""
    common = ["trainer.val_check_interval=100", "trainer.log_every_n_steps=1",
              f"exp_root_dir={out}", "use_timestamp=false", *TINY_GUIDANCE]
    image = [f"data.image_path={assets['image']}", "data.height=32", "data.width=32",
             "data.random_camera.height=32", "data.random_camera.width=32",
             f"data.random_camera.batch_size={batch}"]
    static = [*image, f"system.geometry.surface_mesh_to_bind_path={assets['mesh']}",
              "system.geometry.n_gaussians_per_surface_triangle=1", "data.random_camera.n_test_views=4",
              "trainer.max_steps=2"]
    lists = {
        "static": ("configs/sugar_static_refine.yaml", static + common),
        "dynamic": ("configs/sugar_dynamic_dg.yaml", [
            f"data.video_frames_dir={assets['frames']}", "data.height=32", "data.width=32",
            f"data.num_frames={batch}", "data.video_length=8",
            "data.random_camera.height=32", "data.random_camera.width=32",
            "data.random_camera.eval_height=32", "data.random_camera.eval_width=32",
            f"system.geometry.surface_mesh_to_bind_path={assets['mesh']}",
            "system.geometry.n_gaussians_per_surface_triangle=1",
            "system.geometry.n_dg_nodes=16", "system.geometry.dist_mode=eucdisc",
            "system.geometry.deformation.base_resolution=[8,8,8,4]",
            "system.geometry.deformation.multires=[1,2]", "trainer.max_steps=2", *common]),
        "gaussian": ("configs/sugar_static_refine.yaml", [
            *image, "system.stage=gaussian", "system.geometry.max_num=512",
            "system.geometry.init_num_pts=64", "system.geometry.densify_grad_threshold=0.0000001",
            "system.freq.densify_from=1", "system.freq.densify=2", "system.freq.reset_neighbors=2",
            "trainer.max_steps=4", *common, "system.guidance.pretrained_model_name_or_path=none"]),
        "nerf": ("configs/stable-zero123.yaml", [
            f"data.image_path={assets['image']}", "data.height=16", "data.width=16",
            "data.random_camera.height=8", "data.random_camera.width=8",
            f"data.random_camera.batch_size={batch}", "data.random_camera.eval_height=16",
            "data.random_camera.eval_width=16",
            "system.geometry.pos_encoding_config.n_levels=2",
            "system.geometry.pos_encoding_config.log2_hashmap_size=8",
            "system.geometry.pos_encoding_config.base_resolution=4",
            "system.geometry.pos_encoding_config.per_level_scale=2.0",
            "system.renderer.grid_resolution=4", "system.renderer.occ_candidates=8",
            "system.renderer.occ_samples=4", "system.material.ambient_only_steps=0",
            "trainer.max_steps=1", *common]),
    }
    return {s: (yaml, extras + [f"tag={tag}_{s}"]) for s, (yaml, extras) in lists.items()}


def trial_dir(out: str, tag: str, stage: str) -> str:
    return os.path.join(out, EXP_NAMES[stage], f"{tag}_{stage}")


def grid_shape(n: int) -> Tuple[int, int]:
    """[2, n/2] for an even n ≥ 4, else [n, 1]."""
    return (2, n // 2) if n >= 4 and n % 2 == 0 else (n, 1)


def last_metrics(trial: str) -> Dict[str, float]:
    with open(os.path.join(trial, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    return {k: float(v) for k, v in rows[-1].items()}


def _run_stages(rank: int, jobs) -> None:
    from . import launch

    for yaml, extras, device in jobs:
        launch.main(launch.make_args(os.path.join(REPO, yaml), "train", device=device), extras)


def dryrun_multichip(n: int, device: str = "cpu", stages: Sequence[str] = ("static", "dynamic"),
                     out: Optional[str] = None) -> Dict[str, str]:
    """Each of ``stages`` trained on ``n`` ranks through the launcher (one
    spawn for all of them); returns their trial directories, under ``out``
    (a temporary directory, removed, when None: then the dict is empty)."""
    from . import launch

    dp, tp = grid_shape(n)
    multi = [f"trainer.devices={n}", f"trainer.mesh=[{dp},{tp}]"]
    with tempfile.TemporaryDirectory() as tmp:
        root = out or tmp
        assets = write_assets(root)
        lists = stage_dotlists(assets, os.path.join(root, "out"), "dryrun", batch=dp)
        jobs = [(lists[s][0], lists[s][1] + multi, device) for s in stages]
        launch.spawn(_run_stages, n, device, args=(jobs,))
        trials = {}
        for s in stages:
            trials[s] = trial_dir(os.path.join(root, "out"), "dryrun", s)
            m = last_metrics(trials[s])
            sds = m.get("loss_sds", m.get("loss_sds_zero123", float("nan")))
            print(f"dryrun_multichip({n}): {s} ok via launch.main — loss_total={m['loss_total']:.6f} "
                  f"sds={sds:.6f} (dp={dp}, tp={tp}, {device})", flush=True)
        return trials if out else {}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--stages", default="static,dynamic")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device, tuple(args.stages.split(",")))


if __name__ == "__main__":
    main()

"""The README's six-stage recipe chained end to end through the port's own
entry points, each stage reading the file the stage before it wrote
(counterpart of the repository's ``scripts/bench_full_pipeline.py``):

    python3 -m dreammesh4d_tpu_torch.scripts.full_pipeline [--tiny] [--out DIR] [--device cuda]
        [--guidance none|random[:seed]|<ckpt>]

1. static NeRF (``configs/stable-zero123.yaml --train``): 600 steps,
   reference 128/256/512², random views 8/4/2 at 64/128/256²;
2. the mesh export (``--export resume=LAST`` with the README's ``mc-cpu``
   dotlist): ``save/model.obj`` from the 256³ density grid;
3. mesh simplification (``scripts.mesh_simplification --method quadric
   --target_faces 5000``);
4. SuGaR static refine (``configs/sugar_static_refine.yaml --train``) bound
   to that mesh: 2000 steps at 512²;
5. the dynamic stage (``configs/sugar_dynamic_dg.yaml --train``) from the
   refine's last checkpoint: 2000 steps at 512², 32 frames;
6. the 4D export (``--export resume=LAST``): 32 frame OBJs sharing one
   1024² texture.

The guidance of stages 1, 4 and 5 is the reference's: Stable Zero123 at
random weights (``random:0``, ``system.guidance.use_clip=false``) at full
size, off under ``--tiny``; ``--guidance`` sets
``pretrained_model_name_or_path`` instead: ``none``, ``random[:seed]``
(with ``use_clip=false``, as the reference runs random weights) or a Stable
Zero123 checkpoint.  The inputs are procedural: the animated icosphere(4) of the
recovery benchmark rendered by the port's mesh rasterizer at the stages'
reference camera, 32 RGBA frames at 512², frame 0 the reference image.
``--tiny`` runs the chain at toy sizes and steps (a smoke check, no timing
value).  Writes ``<out>/pipeline.json``: seconds of every stage, ms per
train step (stage 1 per resolution milestone), total minutes, the card and
the guidance that ran.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEPS = {"static": 600, "refine": 2000, "dynamic": 2000}
# tests/test_full_pipeline.py's, stage 1 cut from 25 (the toy stage 1 costs ~1.5 s a step on a CPU)
TINY_STEPS = {"static": 6, "refine": 3, "dynamic": 10}
GUIDANCE = "random:0"  # at full size; off under --tiny (scripts/bench_full_pipeline.py:159-163)
MC_EXPORT = ["system.exporter_type=mesh-exporter", "system.exporter.fmt=obj",
             "system.geometry.isosurface_method=mc-cpu", "system.geometry.isosurface_resolution=256"]


def make_assets(root: str, L: int = 32, H: int = 512, device="cuda"):
    """The reference image and the L-frame RGBA video of the animated
    icosphere(4) (the rest pose at frame 0) under ``root/frames``."""
    from ..data.png import write_png
    from ..data.temporal_image import frame_timestamps
    from ..utils.procedural import deform_recovery, make_icosphere, render_vertex_color_view

    mesh = make_icosphere(4, radius=0.6)
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    for i, t in enumerate(frame_timestamps(L)):
        verts = deform_recovery(mesh.v_pos, (float(t) * (L + 1) - 1.0) / L)
        rgb, mask = render_vertex_color_view(verts, mesh.t_pos_idx, mesh.v_rgb, 5.0, 0.0, 3.8, 20.0,
                                             H, H, device=device)
        rgba = np.concatenate([rgb, mask], -1)
        write_png(os.path.join(frames_dir, f"{i:03d}_rgba.png"),
                  (np.clip(rgba, 0, 1) * 255).round().astype(np.uint8))
    return os.path.join(frames_dir, "000_rgba.png"), frames_dir


def card_line():
    """``name, power limit`` of the card as nvidia-smi gives them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


class StepTimes:
    """Times every ``train_step`` of the experiments (the card synchronised
    around each), with the random views' height at that step."""

    def __init__(self, classes, device):
        self.rows = {}
        self._undo = []
        sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
        for cls in classes:
            real = cls.train_step

            def timed(exp, step, real=real, name=cls.__name__):
                sync()
                t0 = time.perf_counter()
                metrics = real(exp, step)
                sync()
                hw = exp.data.random_sampler.height if exp.data.random_sampler is not None else 0
                self.rows.setdefault(name, []).append((step, (time.perf_counter() - t0) * 1e3, int(hw)))
                return metrics

            cls.train_step = timed
            self._undo.append((cls, real))

    def close(self):
        for cls, real in self._undo:
            cls.train_step = real

    def summary(self, name):
        """Median ms/step without each size's first step, per random-view size."""
        by_size = {}
        for _, ms, hw in self.rows.get(name, []):
            by_size.setdefault(hw, []).append(ms)
        return {f"{hw}px": {"steps": len(ms), "median_ms": statistics.median(ms[1:] or ms)}
                for hw, ms in by_size.items()}


def guidance_dotlist(guidance: str) -> list:
    """The dotlist of ``--guidance``: random weights without the CLIP tower,
    as the reference's recipe runs them; a checkpoint as it is."""
    dotlist = [f"system.guidance.pretrained_model_name_or_path={guidance}"]
    if guidance == "random" or guidance.startswith("random:"):
        dotlist.append("system.guidance.use_clip=false")
    return dotlist


def run(out_root: str, tiny: bool = False, device: str = "cuda", guidance=None) -> dict:
    """The six stages under ``out_root``; returns the result dict (also
    written as ``out_root/pipeline.json``).  ``guidance``: the
    ``pretrained_model_name_or_path`` of stages 1, 4 and 5 (default
    ``random:0``, ``none`` with ``tiny``)."""
    from .. import launch
    from ..systems import assembly
    from . import mesh_simplification

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the recipe runs on the card; pass --device cpu to run "
                           "the plain PyTorch versions on the CPU")
    steps = TINY_STEPS if tiny else STEPS
    guidance = guidance or ("none" if tiny else GUIDANCE)
    L, H = (8, 48) if tiny else (32, 512)
    os.makedirs(out_root, exist_ok=True)
    trials = os.path.join(out_root, "outputs")
    stages = {}

    def timed(name, fn, n_steps=0):
        t0 = time.perf_counter()
        fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        stages[name] = {"seconds": time.perf_counter() - t0}
        if n_steps:
            stages[name]["steps"] = n_steps
        print(f"[pipeline] {name}: {stages[name]['seconds']:.1f} s", flush=True)

    def launch_main(config, verb, extras):
        launch.main(launch.make_args(os.path.join(REPO, "configs", config), verb, device=device),
                    extras)

    paths = {}
    timed("assets", lambda: paths.update(zip(("image", "frames"), make_assets(out_root, L, H, device))))
    common = guidance_dotlist(guidance) + [f"exp_root_dir={trials}", "use_timestamp=false",
                             "trainer.val_check_interval=100000"]
    # --tiny: the sizes of tests/test_full_pipeline.py
    gauss_tiny = ["data.height=32", "data.width=32", "data.random_camera.height=32",
                  "data.random_camera.width=32", "data.random_camera.batch_size=2",
                  "data.random_camera.n_test_views=4", "system.renderer.backend=xla",
                  "system.renderer.tile_capacity=256"] if tiny else []

    # 1-2. static NeRF and its mesh export
    nerf = common + [f"data.image_path={paths['image']}", f"trainer.max_steps={steps['static']}",
                     "tag=nerf"]
    if tiny:
        nerf += ["data.height=48", "data.width=48", "data.random_camera.height=32",
                 "data.random_camera.width=32", "data.random_camera.batch_size=2",
                 "data.random_camera.eval_height=48", "data.random_camera.eval_width=48",
                 "data.random_camera.n_test_views=4", "system.geometry.pos_encoding_config.n_levels=6",
                 "system.geometry.pos_encoding_config.log2_hashmap_size=14",
                 "system.exporter.isosurface_resolution=48", "system.renderer.occ_candidates=64",
                 "system.renderer.occ_samples=16"]
    times = StepTimes([assembly.Zero123Experiment, assembly.SugarStaticExperiment,
                       assembly.Sugar4DGenExperiment], device)
    try:
        timed("static_nerf", lambda: launch_main("stable-zero123.yaml", "train", nerf), steps["static"])
        timed("mc_export", lambda: launch_main("stable-zero123.yaml", "export",
                                               nerf + MC_EXPORT + ["resume=LAST"]))
        nerf_obj = os.path.join(trials, "zero123-sai", "nerf", "save", "model.obj")
        if not os.path.exists(nerf_obj):
            raise RuntimeError(f"stage 2 wrote no {nerf_obj}")

        # 3. simplification (QEM to 5000 faces; the README's default binds it)
        target = "500" if tiny else "5000"
        timed("simplify_qem", lambda: paths.update(bind=mesh_simplification.main(
            ["--mesh_path", nerf_obj, "--method", "quadric", "--target_faces", target])))

        # 4. SuGaR static refine bound to the simplified mesh
        refine = common + gauss_tiny + [
            f"data.image_path={paths['image']}", f"system.geometry.surface_mesh_to_bind_path={paths['bind']}",
            f"trainer.max_steps={steps['refine']}", "tag=refine"]
        timed("sugar_refine", lambda: launch_main("sugar_static_refine.yaml", "train", refine),
              steps["refine"])
        refine_ckpt = os.path.join(trials, "sugar-refine", "refine", "ckpts", f"step_{steps['refine']:08d}")
        if not os.path.isdir(refine_ckpt):
            raise RuntimeError(f"stage 4 wrote no {refine_ckpt}")

        # 5-6. the dynamic stage from the refine's weights, and the 4D export
        dyn = common + gauss_tiny + [
            f"data.video_frames_dir={paths['frames']}", f"data.video_length={L}",
            f"system.geometry.num_frames={L}", f"system.geometry.surface_mesh_to_bind_path={paths['bind']}",
            f"system.weights={refine_ckpt}", f"trainer.max_steps={steps['dynamic']}", "tag=dyn"]
        if tiny:
            dyn += ["data.num_frames=2", "system.geometry.n_dg_nodes=32",
                    "system.geometry.dg_node_connectivity=4", "system.geometry.dist_mode=eucdisc",
                    "system.geometry.deformation.base_resolution=[8,8,8,4]",
                    "system.geometry.deformation.multires=[1,2]", "data.predict_height=64",
                    "data.predict_width=64", "data.n_predict_views=4", "system.exporter.texture_size=64"]
        timed("dynamic", lambda: launch_main("sugar_dynamic_dg.yaml", "train", dyn), steps["dynamic"])
        timed("export_4d", lambda: launch_main("sugar_dynamic_dg.yaml", "export", dyn + ["resume=LAST"]))
    finally:
        times.close()
    export_dir = os.path.join(trials, "sugar-dynamic", "dyn", "save", "4d_export")
    objs = sorted(glob.glob(os.path.join(export_dir, "frame_*.obj")))
    if len(objs) != L:
        raise RuntimeError(f"stage 6 wrote {len(objs)} frame OBJs, not {L}")

    for name, cls in (("static_nerf", "Zero123Experiment"), ("sugar_refine", "SugarStaticExperiment"),
                      ("dynamic", "Sugar4DGenExperiment")):
        stages[name]["ms_per_step"] = times.summary(cls)
    total = sum(s["seconds"] for s in stages.values())
    result = {
        "pipeline": f"static{steps['static']} -> mc-export -> qem{target} -> refine{steps['refine']}"
                    f"@{H} -> dynamic{steps['dynamic']}@{H}x{L}f -> 4D export",
        "tiny": tiny, "device": str(device),
        "card": card_line() if torch.device(device).type == "cuda" else None,
        "guidance": guidance, "stages": stages, "total_seconds": total, "total_minutes": total / 60,
        "files": {"model_obj": nerf_obj, "bind_mesh": paths["bind"], "refine_ckpt": refine_ckpt,
                  "frames": objs},
        "notes": "wall clock of each stage; a train stage includes its setup and its test pass; "
                 "validation off (val_check_interval > max_steps); ms/step per random-view size, "
                 "the card synchronised around each step",
    }
    with open(os.path.join(out_root, "pipeline.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tiny", action="store_true", help="toy sizes and steps (a smoke check)")
    parser.add_argument("--out", help="output directory (default: a new temporary directory)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    parser.add_argument("--guidance", help="pretrained_model_name_or_path of stages 1, 4 and 5: none, "
                        "random[:seed] or a checkpoint (default random:0, none with --tiny)")
    args = parser.parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="pipeline_")
    result = run(out, tiny=args.tiny, device=args.device, guidance=args.guidance)
    print(json.dumps({k: v for k, v in result.items() if k != "files"}, indent=2))
    return result


if __name__ == "__main__":
    main()

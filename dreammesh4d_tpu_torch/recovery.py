"""The recovery benchmark on the port: a procedurally animated vertex-coloured
mesh, its ground-truth video rendered by the port's mesh rasterizer, the
static refine and dynamic stages trained on it through the port's launcher
(guidance off), and PSNR / SSIM / LPIPS at trained and held-out (view, time)
against ground truth (counterpart of ``tests/test_recovery_benchmark.py``
``make_gt_assets`` / ``run_recovery`` and ``scripts/bench_recovery.py``).

    python3 -m dreammesh4d_tpu_torch.recovery --device cuda --backend pallas_resident
    python3 -m dreammesh4d_tpu_torch.recovery --device cuda --backend xla

The recipe is the reference's: icosphere(3) of radius 0.6, 64², 16 frames,
1000 static + 600 dynamic steps, with the same dotlists plus
``system.renderer.tile_px=16`` (the reference's ``xla`` backend bins on fixed
16-px tiles, which keeps the capacity of 512 pairs a tile clear of the
front surface; the port's backends bin on ``tile_px``).  ``main`` prints the
result as JSON and asserts ``assert_recovery_gate(res, tier="cpu")``, which
it imports from ``tests/test_recovery_benchmark.py`` so that the floors have
one definition.  It never writes ``RECOVERY.json``.

Differences from the reference, by design: the runs draw from
``torch.Generator`` streams, not ``jax.random``, so the columns clear the
same floors without equalling the reference's numbers; the LPIPS features
are random from a seeded ``torch.Generator`` (the reference's are random
from ``jax.random``); the CLIP columns come from the reference's tiny random
tower (64 wide, 4 layers, 4 heads, patch 8 at 64²; ``CLIP_TOWER``), whose
weights are drawn from a ``torch.Generator``; the gate does not read them.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELEV, AZIM, DIST, FOVY = 5.0, 0.0, 3.8, 20.0  # the stage configs' reference camera
# the reference's CPU-tier tower (tests/test_recovery_benchmark.py): fast, random, relative only
CLIP_TOWER = dict(image_size=64, patch_size=8, width=64, layers=4, heads=4, mlp=128, output_dim=768)


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float32) - np.asarray(b, np.float32)) ** 2))
    return -10.0 * np.log10(mse + 1e-10)


def make_gt_assets(tmp_path, L: int = 16, H: int = 64, W: int = 64, device="cuda"):
    """(frames_dir, mesh_path, gt_fn, ts): the ground-truth video as RGBA PNGs
    and the rest mesh as a PLY under ``tmp_path``; ``gt_fn(t, azimuth)``
    renders ground truth at any time and azimuth (the animation is
    continuous)."""
    from .data.png import write_png
    from .data.temporal_image import frame_timestamps
    from .export.mesh_io import MeshData, save_ply_mesh
    from .utils.procedural import deform_recovery, make_icosphere, render_vertex_color_view

    mesh = make_icosphere(3, radius=0.6)
    rest, faces, colors = mesh.v_pos, mesh.t_pos_idx, mesh.v_rgb

    def gt(t, azimuth=AZIM, h=H, w=W):
        # the data pipeline's timestamps (i+1)/(L+1) map to a phase that is 0
        # at frame 0: the static stage fits frame 0 against the rest mesh
        phase = (float(t) * (L + 1) - 1.0) / L
        return render_vertex_color_view(deform_recovery(rest, phase), faces, colors, ELEV, azimuth,
                                        DIST, FOVY, h, w, device=device)

    frames_dir = os.path.join(str(tmp_path), "frames")
    os.makedirs(frames_dir)
    ts = frame_timestamps(L)
    for i, t in enumerate(ts):
        rgb, mask = gt(t)
        rgba = np.concatenate([rgb, mask], -1)
        write_png(os.path.join(frames_dir, f"{i:03d}_rgba.png"),
                  (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
    mesh_path = os.path.join(str(tmp_path), "rest_mesh.ply")
    save_ply_mesh(mesh_path, MeshData(v_pos=rest, t_pos_idx=faces))
    return frames_dir, mesh_path, gt, ts


class _FirstTileCount:
    """Records the largest per-tile pair count of the next render's binning
    (one host sync), then steps aside."""

    def __init__(self):
        rast = importlib.import_module(f"{__package__}.ops.gs.rasterize")
        self.rast, self.real, self.value = rast, rast.bin_gaussians_pairs, None

    def __enter__(self):
        def first(*a, **kw):
            pa = self.real(*a, **kw)
            self.value = int(pa.counts.max())
            self.rast.bin_gaussians_pairs = self.real
            return pa

        self.rast.bin_gaussians_pairs = first
        return self

    def __exit__(self, *exc):
        self.rast.bin_gaussians_pairs = self.real


def run_recovery(tmp_path, H: int = 64, W: int = 64, L: int = 16, static_steps: int = 1000,
                 dynamic_steps: int = 600, num_frames: int = 4, device="cuda",
                 backend: str = "pallas_resident", stats=None) -> dict:
    """Ground-truth video → static refine → dynamic stage → the dict of
    columns at trained and held-out (view, time), under the reference's keys.  ``stats``, a dict, receives seconds per part,
    ms per step of each stage and the largest tile count of each stage's
    first render against the capacity."""
    from . import launch
    from .serving import Viewer4D
    from .utils.metrics import CLIPSimilarityMetric, LPIPSMetric, ssim

    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    frames_dir, mesh_path, gt, ts = make_gt_assets(tmp_path, L=L, H=H, W=W, device=device)
    stats["gt_assets_s"] = time.perf_counter() - t0
    out_root = os.path.join(str(tmp_path), "out")
    raster = [f"system.renderer.backend={backend}", "system.renderer.tile_capacity=512",
              "system.renderer.tile_px=16"]
    stats["tile_capacity"] = 512

    t0 = time.perf_counter()
    with _FirstTileCount() as first:
        launch.main(launch.make_args(os.path.join(REPO, "configs/sugar_static_refine.yaml"), "train",
                                     device=device), [
            "system.guidance.pretrained_model_name_or_path=none",
            f"data.image_path={frames_dir}/000_rgba.png",
            f"data.height={H}", f"data.width={W}",
            f"data.random_camera.height={H}", f"data.random_camera.width={W}",
            "data.random_camera.batch_size=2",
            f"system.geometry.surface_mesh_to_bind_path={mesh_path}",
            *raster,
            f"trainer.max_steps={static_steps}", "trainer.val_check_interval=10000",
            f"exp_root_dir={out_root}", "use_timestamp=false", "tag=recov",
        ])
    stats["static_s"], stats["static_max_tile_count"] = time.perf_counter() - t0, first.value
    static_trial = os.path.join(out_root, "sugar-refine", "recov")
    static_ckpt = os.path.join(static_trial, "ckpts", f"step_{static_steps:08d}")
    if not os.path.isdir(static_ckpt):
        raise RuntimeError(f"the static stage wrote no checkpoint {static_ckpt}")

    t0 = time.perf_counter()
    with _FirstTileCount() as first:
        launch.main(launch.make_args(os.path.join(REPO, "configs/sugar_dynamic_dg.yaml"), "train",
                                     device=device), [
            "system.guidance.pretrained_model_name_or_path=none",
            f"data.video_frames_dir={frames_dir}",
            f"data.height={H}", f"data.width={W}", f"data.num_frames={num_frames}",
            f"data.random_camera.height={H}", f"data.random_camera.width={W}",
            f"data.random_camera.batch_size={num_frames}",
            f"data.video_length={L}", f"system.geometry.num_frames={L}",
            f"system.geometry.surface_mesh_to_bind_path={mesh_path}",
            f"system.weights={static_ckpt}",
            "system.geometry.n_dg_nodes=64", "system.geometry.dg_node_connectivity=6",
            "system.geometry.dist_mode=eucdisc",
            *raster,
            f"trainer.max_steps={dynamic_steps}", "trainer.val_check_interval=10000",
            f"exp_root_dir={out_root}", "use_timestamp=false", "tag=recov",
        ])
    stats["dynamic_s"], stats["dynamic_max_tile_count"] = time.perf_counter() - t0, first.value
    trial = os.path.join(out_root, "sugar-dynamic", "recov")
    for label, t in (("static", static_trial), ("dynamic", trial)):
        with open(os.path.join(t, "train_summary.json")) as f:
            summary = json.load(f)
        stats[f"{label}_ms_per_step"] = 1e3 * summary["wall_s"] / summary["steps"]

    t0 = time.perf_counter()
    viewer = Viewer4D.from_trial(trial, height=H, width=W, device=device)

    def render(t, azimuth=AZIM):
        return viewer.render(elevation_deg=ELEV, azimuth_deg=azimuth, distance=DIST, t=float(t))

    def as_t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    res = {}
    rest_img = gt(ts[0])[0]  # frame 0's pose is the rest pose: the no-motion predictor

    # the trained timestamps of largest deformation, training view
    deformed = (2, L // 4, 5 * L // 8, 3 * L // 4)
    renders = np.stack([np.asarray(render(ts[i]), np.float32) for i in deformed])
    gts = np.stack([np.asarray(gt(ts[i])[0], np.float32) for i in deformed])
    rests = np.broadcast_to(np.asarray(rest_img, np.float32), gts.shape)
    res["psnr_trained_t"] = float(np.mean([_psnr(r, g) for r, g in zip(renders, gts)]))
    res["psnr_no_motion_baseline"] = float(np.mean([_psnr(rest_img, g) for g in gts]))
    # held-out timestamps: midpoints near the largest deformation
    mids = [(ts[i] + ts[i + 1]) / 2 for i in (L // 4 - 1, 3 * L // 4 - 1)]
    res["psnr_heldout_t"] = float(np.mean([_psnr(render(t), gt(t)[0]) for t in mids]))
    # held-out views at phase 0.25, each beside the rest pose at the same azimuth
    t_hv = ts[L // 4]
    for az in (5.0, 15.0, 30.0, 60.0):
        hv_r = np.asarray(render(t_hv, azimuth=az), np.float32)
        hv_g = np.asarray(gt(t_hv, azimuth=az)[0], np.float32)
        hv_b = np.asarray(gt(ts[0], azimuth=az)[0], np.float32)
        suffix = "" if az == 15.0 else f"_az{int(az)}"
        res[f"psnr_heldout_view{suffix}"] = _psnr(hv_r, hv_g)
        res[f"psnr_heldout_view_baseline{suffix}"] = _psnr(hv_b, hv_g)
    hv_render = np.asarray(render(t_hv, azimuth=15.0), np.float32)
    hv_gt = np.asarray(gt(t_hv, azimuth=15.0)[0], np.float32)
    hv_rest = np.asarray(gt(ts[0], azimuth=15.0)[0], np.float32)

    lpips = LPIPSMetric(device=device)
    clip = CLIPSimilarityMetric(config=CLIP_TOWER, device=device)
    res["lpips_converted"] = lpips.converted
    res["clip_converted"] = clip.converted
    res["ssim_trained_t"] = float(ssim(as_t(renders), as_t(gts)).mean())
    res["ssim_no_motion_baseline"] = float(ssim(as_t(rests), as_t(gts)).mean())
    res["ssim_heldout_view"] = float(ssim(as_t(hv_render), as_t(hv_gt))[0])
    res["lpips_trained_t"] = float(lpips(renders, gts).mean())
    res["lpips_no_motion_baseline"] = float(lpips(rests, gts).mean())
    res["lpips_heldout_view"] = float(lpips(hv_render, hv_gt)[0])
    res["lpips_heldout_view_baseline"] = float(lpips(hv_rest, hv_gt)[0])
    res["clip_trained_t"] = float(clip(renders, gts).mean())
    res["clip_no_motion_baseline"] = float(clip(rests, gts).mean())
    res["clip_heldout_view"] = float(clip(hv_render, hv_gt)[0])
    stats["eval_s"] = time.perf_counter() - t0
    return res


def assert_gate(res: dict, tier: str = "cpu") -> None:
    """``assert_recovery_gate`` of ``tests/test_recovery_benchmark.py``."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from test_recovery_benchmark import assert_recovery_gate

    assert_recovery_gate(res, tier=tier)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="the recovery gate on the PyTorch port")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    parser.add_argument("--backend", default="pallas_resident", choices=("pallas_resident", "xla"))
    parser.add_argument("--out", default=None,
                        help="directory for the assets and trials (default: a temporary one, removed)")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the recovery gate runs on the card; pass --device cpu to "
                           "run the plain PyTorch versions on the CPU")
    stats: dict = {}
    t0 = time.perf_counter()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        res = run_recovery(args.out, device=args.device, backend=args.backend, stats=stats)
    else:
        with tempfile.TemporaryDirectory(prefix="recovery_") as tmp:
            res = run_recovery(tmp, device=args.device, backend=args.backend, stats=stats)
    stats["total_s"] = time.perf_counter() - t0
    report = {**res, "resolution": 64, "static_steps": 1000, "dynamic_steps": 600,
              "backend": args.backend, "device": args.device,
              "feature_provenance": "deterministic-random features: LPIPS and CLIP valid for "
                                    "RELATIVE margins only",
              "stats": stats}
    if torch.device(args.device).type == "cuda":
        report["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(report))
    assert_gate(res, tier="cpu")
    print("recovery gate (tier cpu): passed")
    return report


if __name__ == "__main__":
    main()

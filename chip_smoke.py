#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``dreammesh4d_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs a CUDA card and exits nonzero, printing no result, without one.
Phases, each of which fails the run on a failed check:

1. the card's name and power limit, torch and CUDA versions;
2. build every hand-written kernel from ``dreammesh4d_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, plus adversarial cases;
4. the main path — ``Viewer4D.render / orbit / play`` — at the full width of
   ``configs/sugar_dynamic_dg.yaml`` (icosphere(4) SuGaR mesh: 30,720
   Gaussians, SH 3; 1000-node geodesic graph, hybrid skinning; HexPlane
   64-wide, 32 channels, [64,64,64,25] × [1,2,4,8]; 512², tile 32, capacity
   2048, 6 tiles per Gaussian; fovy 20°, distance 3.8, elevation 5°), with
   random weights from a seed and the deformation heads perturbed; launch
   counts are zeroed just before and read just after;
5. CUDA-event times (median of 30 after warm-up);
6. a ``{"kernels": [...]}`` line, the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
KERNELS = ["resident_fwd"]
N_TIMED = 30
H100_F32_FLOPS = 67e12  # non-tensor float32 peak, H100 SXM data sheet, 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n=N_TIMED, warmup=3):
    """Median milliseconds of ``fn`` between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def full_width_scene(torch, device):
    """The sugar_dynamic_dg.yaml scene at full width, weights from seed 0."""
    from dreammesh4d_tpu_torch.models.geometry.deformation import DeformationConfig, init_deformation
    from dreammesh4d_tpu_torch.models.geometry.dynamic_sugar import DynamicSuGaRConfig, build_dynamic_static
    from dreammesh4d_tpu_torch.models.geometry.sugar import SuGaRConfig, create_sugar
    from dreammesh4d_tpu_torch.ops.gs.rasterize import RasterizerConfig
    from dreammesh4d_tpu_torch.utils.procedural import make_icosphere

    params, sugar_static = create_sugar(SuGaRConfig(n_gaussians_per_surface_triangle=6, sh_degree=3),
                                        make_icosphere(4, radius=0.6), device=device)
    dcfg = DeformationConfig(net_width=64, defor_depth=1, grid_channels=32,
                             base_resolution=(64, 64, 64, 25), multires=(1, 2, 4, 8), bounds=1.0)
    dyn_cfg = DynamicSuGaRConfig(num_frames=32, dynamic_mode="deformation", use_deform_graph=True,
                                 n_dg_nodes=1000, dg_node_connectivity=4, dist_mode="geodisc",
                                 skinning_method="hybrid", d_scale=True, deformation=dcfg)
    t0 = time.perf_counter()
    static = build_dynamic_static(dyn_cfg, sugar_static, params.points.cpu().numpy(), seed=0,
                                  device=device)
    graph_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(0)
    dparams = init_deformation(dcfg, gen, device=device)
    # a fresh field deforms by nothing and ignores time: fill the zero-init
    # heads at 1e-2 and move the time planes off 1
    for name in ("head_dx", "head_dstrain", "head_drot", "head_dopacity"):
        for layer in dparams[name].values():
            for k, v in layer.items():
                layer[k] = 1e-2 * torch.randn(v.shape, generator=gen, device=device)
    for planes in dparams["grids"]:
        for i in (2, 4, 5):  # (x,t), (y,t), (z,t)
            planes[i] = planes[i] + 0.5 * torch.randn(planes[i].shape, generator=gen, device=device)
    t = math.tan(math.radians(20.0) / 2)
    raster_cfg = RasterizerConfig(512, 512, t, t, tile_capacity=2048, max_tiles_per_gaussian=6,
                                  chunk=32, backend="pallas_resident", bf16_matmuls=True,
                                  binning="pairs", stream_rows=False, tile_px=32)
    return params, static, dparams, dyn_cfg, raster_cfg, graph_s


def view_blend_inputs(torch, viewer, params, static, dparams, dyn_cfg, raster_cfg, t):
    """The compositing inputs of one served view (elevation 5°, distance 3.8)."""
    from dreammesh4d_tpu_torch.models.geometry.dynamic_sugar import timed_all
    from dreammesh4d_tpu_torch.models.geometry.sugar import gaussian_attributes
    from dreammesh4d_tpu_torch.ops.gs.binning import bin_gaussians_pairs
    from dreammesh4d_tpu_torch.ops.gs.projection import project_gaussians_sq
    from dreammesh4d_tpu_torch.ops.gs.rasterize import _auto_group
    from dreammesh4d_tpu_torch.ops.gs.resident_blend import _pack_rows
    from dreammesh4d_tpu_torch.ops.meshops import face_normals
    from dreammesh4d_tpu_torch.ops.sh import sh_to_rgb

    cams = viewer._cameras(5.0, 0.0, 3.8)
    ts = torch.tensor([t], device=params.points.device)
    gs, vert = timed_all(params, dparams, dyn_cfg.deformation, static, ts)
    attrs0 = gaussian_attributes(params, static.sugar)
    normals = torch.repeat_interleave(face_normals(vert.xyz, static.sugar.faces), 6, dim=-2)[0]
    m = gs.means3d[0]
    dirs = m - cams.camera_center[0][None]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8)
    colors = torch.cat([sh_to_rgb(3, attrs0.sh, dirs), normals], -1)
    proj = project_gaussians_sq(m, gs.scales[0], gs.quats[0], cams.world_view[0], cams.full_proj[0],
                                raster_cfg.tan_fovx, raster_cfg.tan_fovy, raster_cfg.width,
                                raster_cfg.height, raster_cfg.near)
    cfg = raster_cfg
    pa = bin_gaussians_pairs(proj.means2d, proj.radii, proj.depths, proj.mask, cfg.width,
                             cfg.height, cfg.max_tiles_per_gaussian, conics=proj.conics,
                             opacities=attrs0.opacities, tile=cfg.tile_px)
    colors = torch.cat([colors, proj.depths[:, None]], -1)  # + depth: C = 7
    rows = _pack_rows(proj.means2d, proj.conics, colors, attrs0.opacities)
    return (rows, pa.sorted_gauss, pa.starts, pa.counts, cfg.width // cfg.tile_px, cfg.tile_px,
            cfg.tile_capacity, _auto_group(cfg, m.shape[0]), colors.shape[-1])


def synthetic_blend_inputs(torch, case, device):
    """Adversarial segments at 512², tile 32, cap 2048, C = 7."""
    from dreammesh4d_tpu_torch.ops.gs.binning import bin_gaussians_pairs
    from dreammesh4d_tpu_torch.ops.gs.resident_blend import _pack_rows

    gen = torch.Generator(device=device).manual_seed(1)
    rnd = lambda *s: torch.rand(s, generator=gen, device=device)  # noqa: E731
    if case == "saturated":  # 3000 faint splats on one tile: count > cap
        n, lo, hi, op, spread = 3000, 200.0, 220.0, 0.005, 0.02
    else:  # "empty_tiles": a small cluster, most tiles hold nothing
        n, lo, hi, op, spread = 200, 40.0, 80.0, 0.6, 0.3
    means = lo + (hi - lo) * rnd(n, 2)
    conics = torch.stack([torch.full((n,), spread, device=device), 0.002 * (rnd(n) - 0.5),
                          torch.full((n,), spread, device=device)], -1)
    opac = torch.full((n,), op, device=device)
    depths = 1.0 + 2.0 * rnd(n)
    radii = torch.ceil(3.0 / torch.sqrt(conics[:, 0])).int()
    pa = bin_gaussians_pairs(means, radii, depths, torch.ones(n, dtype=torch.bool, device=device),
                             512, 512, 6, conics=conics, opacities=opac, tile=32)
    rows = _pack_rows(means, conics, torch.cat([rnd(n, 6), depths[:, None]], -1), opac)
    return (rows, pa.sorted_gauss, pa.starts, pa.counts, 16, 32, 2048, 128, 7)


def profile_render(torch, viewer, card, top=12):
    """Where one render's time goes: torch.profiler over one warm
    ``Viewer4D.render``; device time by kernel and host time by operator."""
    from torch.profiler import ProfilerActivity, profile

    viewer.render(5.0, 0.0, 3.8, t=0.25)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        viewer.render(5.0, 0.0, 3.8, t=0.25)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    # device-side records (kernels, copies) only: operator records repeat
    # their kernels' time
    device = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(dev_us(e) for e in device) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"[{card}] profile of one render: wall {wall_ms:.3f} ms (profiled), device busy "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f} %), {launches} kernel launches")
    for e in sorted(device, key=dev_us, reverse=True)[:top]:
        print(f"  [{card}] device {dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]:
        print(f"  [{card}] host   {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    import numpy as np

    sys.path.insert(0, REPO)
    try:
        from dreammesh4d_tpu_torch import cuda_build
        from dreammesh4d_tpu_torch.ops.gs import resident_blend as rb
        from dreammesh4d_tpu_torch.serving import Viewer4D
    except ImportError as e:
        fail(f"the port is not importable next to chip_smoke.py: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = DEVICE

    # 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    secs = cuda_build.build(KERNELS)
    print(f"[{card}] build: {time.perf_counter() - t0:.2f} s wall " + json.dumps(secs))
    for name, (_, log) in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    # 3. B1 against its plain version, at the main path's shapes
    params, static, dparams, dyn_cfg, raster_cfg, graph_s = full_width_scene(torch, dev)
    print(f"scene: {params.log_scales.shape[0]} gaussians, {static.sugar.faces.shape[0]} faces, "
          f"{static.node_xyz.shape[0]} nodes (graph build on the host: {graph_s:.2f} s)")
    viewer = Viewer4D(params, static, dparams, dyn_cfg, raster_cfg, 512, 512, 20.0, 32, device=dev)
    cases = {"main_view": view_blend_inputs(torch, viewer, params, static, dparams, dyn_cfg,
                                            raster_cfg, 0.0)}
    cases["saturated"] = synthetic_blend_inputs(torch, "saturated", dev)
    cases["empty_tiles"] = synthetic_blend_inputs(torch, "empty_tiles", dev)
    b1_err = 0.0
    main_stats = {}
    for name, args in cases.items():
        stats = {}
        out_k = rb.blend_pairs_cuda(*args)
        out_p = rb.blend_pairs_plain(*args, stats=stats)
        torch.cuda.synchronize()
        C = args[-1]
        depth_scale = max(float(args[0][:, 5 + C - 1].abs().max()), 1.0)
        err_col = float((out_k[:, :C - 1] - out_p[:, :C - 1]).abs().max())
        err_t = float((out_k[:, C] - out_p[:, C]).abs().max())
        err_d = float((out_k[:, C - 1] - out_p[:, C - 1]).abs().max())
        counts = args[3]
        print(f"B1 {name}: tiles {counts.shape[0]}, pairs {int(counts.sum())}, "
              f"saturated tiles (count > cap) {int((counts > args[6]).sum())}, "
              f"empty tiles {int((counts == 0).sum())}, pairs read {stats['pairs_read']}, "
              f"max|d| colors {err_col:.3g} transmittance {err_t:.3g} depth {err_d:.3g} "
              f"(depth scale {depth_scale:.3g})")
        check(torch.isfinite(out_k).all(), f"B1 {name}: non-finite kernel output")
        check(err_col <= 1e-4 and err_t <= 1e-4, f"B1 {name}: kernel vs plain > 1e-4")
        check(err_d <= 1e-4 * depth_scale, f"B1 {name}: depth kernel vs plain > 1e-4 x depth scale")
        b1_err = max(b1_err, err_col, err_t, err_d / depth_scale)
        if name == "main_view":
            main_stats = stats
    check(int((cases["saturated"][3] > 2048).sum()) >= 1, "saturated case has no saturated tile")
    check(int((cases["empty_tiles"][3] == 0).sum()) >= 1, "empty-tile case has no empty tile")

    # 4. the main path, through the entry points a user calls
    rb.reset_launch_counts()
    frame0 = viewer.render(5.0, 0.0, 3.8, t=0.0)
    frame_half = viewer.render(5.0, 0.0, 3.8, t=0.5)
    orbit = viewer.orbit(n_views=8, elevation_deg=5.0, distance=3.8, t=0.0)
    play = viewer.play(elevation_deg=5.0, azimuth_deg=0.0, distance=3.8, n_frames=32)
    torch.cuda.synchronize()
    launches = dict(rb.launch_counts)
    print(f"main path launches: {json.dumps(launches)} (render x2 + orbit 8 + play 32 views)")
    check(launches["resident_fwd"] >= 1, "the main path never launched resident_fwd")
    frames = [frame0, frame_half] + orbit + play
    check(all(np.isfinite(f).all() and f.shape == (512, 512, 3) for f in frames),
          "non-finite or misshapen frames")
    cover = float((np.abs(frame0 - 1.0).max(-1) > 1e-3).mean())
    moved = float(np.abs(frame0 - frame_half).max())
    print(f"coverage {cover:.4f} of pixels; max|frame(t=0) - frame(t=0.5)| {moved:.4g}; "
          f"orbit views differ by {float(np.abs(orbit[0] - orbit[4]).max()):.4g}")
    check(cover > 0.05, "alpha coverage <= 5 %")
    check(moved > 1e-3, "frames at t=0 and t=0.5 do not differ")
    plain_viewer = Viewer4D(params, static, dparams, dyn_cfg, raster_cfg._replace(backend="xla"),
                            512, 512, 20.0, 32, device=dev)
    plain_frame = plain_viewer.render(5.0, 0.0, 3.8, t=0.0)
    render_err = float(np.abs(plain_frame - frame0).max())
    print(f"render through the kernel vs through the plain blend: max|d| {render_err:.3g}")
    check(render_err <= 1e-4, "kernel render and plain render differ by more than 1e-4")

    # 5. times (CUDA events, median of 30 after warm-up)
    args = cases["main_view"]
    b1_ms = time_ms(torch, lambda: rb.blend_pairs_cuda(*args))
    plain_ms = time_ms(torch, lambda: rb.blend_pairs_plain(*args))
    render_ms = time_ms(torch, lambda: viewer.render(5.0, 0.0, 3.8, t=0.25))
    play_ms = time_ms(torch, lambda: viewer.play(5.0, 0.0, 3.8, n_frames=32))
    rows, pairs, starts, counts = args[:4]
    C, P = args[-1], args[5] ** 2
    n_bytes = 4 * (rows.numel() + pairs.numel() + starts.numel() + counts.numel()
                   + starts.numel() * (C + 1) * P)
    # per evaluated (pair, pixel): 19 FP32 ops of geometry, exp, clamp and
    # tests; per composited one: 3 + 2C more (weight, C FMAs, transmittance)
    n_ops = main_stats["pairs_read"] * P * 19 + main_stats["live_pixels"] * (3 + 2 * C)
    bound_ms = max(n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOPS) * 1e3
    bound_by = "bytes" if n_bytes / H100_BYTES_PER_S > n_ops / H100_F32_FLOPS else "operations"
    print(f"[{card}] B1 resident_fwd: {b1_ms:.4f} ms (plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"by {bound_by}: {n_bytes} B, {n_ops} ops)")
    print(f"[{card}] Viewer4D.render 512x512: {render_ms:.3f} ms; play(32): {play_ms:.2f} ms "
          f"= {32e3 / play_ms:.1f} frames/s")
    profile_render(torch, viewer, card)

    # 6. result lines
    print(json.dumps({"kernels": [{
        "name": "resident_fwd", "id": "B1", "route": "cuda",
        "source": "dreammesh4d_tpu_torch/csrc/resident_fwd.cu",
        "replaces": "dreammesh4d_tpu/ops/gs/pallas_resident.py:121",
        "tpu": "ops/gs/pallas_resident.py::_fwd_kernel",
        "launches": launches["resident_fwd"], "max_abs_err": b1_err, "max_abs_diff": b1_err,
        "ms": b1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
   the main paths give it, plus adversarial cases: the forward compositing
   (B1, ``resident_fwd``) and the replay backward in both forms (B2
   ``resident_bwd_accum``, B3 ``resident_bwd_pairs``) at C = 7 and C = 4;
4. the serving main path — ``Viewer4D.render / orbit / play`` — at the full
   width of ``configs/sugar_dynamic_dg.yaml`` (icosphere(4) SuGaR mesh:
   30,720 Gaussians, SH 3; 1000-node geodesic graph, hybrid skinning;
   HexPlane 64-wide, 32 channels, [64,64,64,25] × [1,2,4,8]; 512², tile 32,
   capacity 2048, 6 tiles per Gaussian; fovy 20°, distance 3.8, elevation
   5°), with random weights from a seed and the deformation heads perturbed;
   launch counts are zeroed just before and read just after;
5. the training main path — ``make_dynamic_train_step`` → ``train_step`` on
   the same scene with the YAML's loss weights, 4 of 32 frames per step of a
   target video rendered once from a second, differently seeded deformation,
   4 random + 4 reference views at 512², 10 inter-frame timestamps, Adam
   (lr 1.6e-3, betas 0.9/0.99) — with its own launch counts, then one step
   with ``bwd_accum=False`` from the same state.  The guidance model is not
   ported yet; a stand-in ``guidance_fn`` (mean squared distance of the
   random-view render from mid-grey) takes its place in the loss, so that
   the random views' gradients go through the backward kernel as they will
   with the real guidance.  With ``guidance_fn=None`` and the YAML's zero TV
   weights the random views do not reach the loss at all and autograd skips
   their backward; a few such steps are driven and counted too;
6. CUDA-event times (median of 30 after warm-up), ms per train step and
   profiles of one render and one train step;
7. a ``{"kernels": [...]}`` line, the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
KERNELS = ["resident_fwd", "resident_bwd"]  # sources; resident_bwd holds B2 and B3
N_TIMED = 30
RES = 512  # image side of every render
MESH_LEVEL = 4  # icosphere subdivisions: 5120 faces x 6 = 30,720 Gaussians
N_NODES = 1000
VIDEO_LEN = 32
FRAMES_PER_STEP = 4
N_INTER = 10
N_TRAIN_STEPS = 10
GRAD_TOL = 1e-4  # B2/B3 vs plain, of each column group's max |value| (see check_backward)
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


def moving_deformation(torch, dcfg, seed, device):
    """A deformation field that moves: a fresh one deforms by nothing and
    ignores time, so fill the zero-init heads at 1e-2 and move the time
    planes off 1."""
    from dreammesh4d_tpu_torch.models.geometry.deformation import init_deformation

    gen = torch.Generator(device=device).manual_seed(seed)
    dparams = init_deformation(dcfg, gen, device=device)
    for name in ("head_dx", "head_dstrain", "head_drot", "head_dopacity"):
        for layer in dparams[name].values():
            for k, v in layer.items():
                layer[k] = 1e-2 * torch.randn(v.shape, generator=gen, device=device)
    for planes in dparams["grids"]:
        for i in (2, 4, 5):  # (x,t), (y,t), (z,t)
            planes[i] = planes[i] + 0.5 * torch.randn(planes[i].shape, generator=gen, device=device)
    return dparams


def full_width_scene(torch, device):
    """The sugar_dynamic_dg.yaml scene at full width, weights from seed 0."""
    from dreammesh4d_tpu_torch.models.geometry.deformation import DeformationConfig
    from dreammesh4d_tpu_torch.models.geometry.dynamic_sugar import DynamicSuGaRConfig, build_dynamic_static
    from dreammesh4d_tpu_torch.models.geometry.sugar import SuGaRConfig, create_sugar
    from dreammesh4d_tpu_torch.ops.gs.rasterize import RasterizerConfig
    from dreammesh4d_tpu_torch.utils.procedural import make_icosphere

    params, sugar_static = create_sugar(SuGaRConfig(n_gaussians_per_surface_triangle=6, sh_degree=3),
                                        make_icosphere(MESH_LEVEL, radius=0.6), device=device)
    dcfg = DeformationConfig(net_width=64, defor_depth=1, grid_channels=32,
                             base_resolution=(64, 64, 64, 25), multires=(1, 2, 4, 8), bounds=1.0)
    dyn_cfg = DynamicSuGaRConfig(num_frames=VIDEO_LEN, dynamic_mode="deformation", use_deform_graph=True,
                                 n_dg_nodes=N_NODES, dg_node_connectivity=4, dist_mode="geodisc",
                                 skinning_method="hybrid", d_scale=True, deformation=dcfg)
    t0 = time.perf_counter()
    static = build_dynamic_static(dyn_cfg, sugar_static, params.points.cpu().numpy(), seed=0,
                                  device=device)
    graph_s = time.perf_counter() - t0
    dparams = moving_deformation(torch, dcfg, 0, device)
    t = math.tan(math.radians(20.0) / 2)
    raster_cfg = RasterizerConfig(RES, RES, t, t, tile_capacity=2048, max_tiles_per_gaussian=6,
                                  chunk=32, backend="pallas_resident", bf16_matmuls=True,
                                  binning="pairs", stream_rows=False, tile_px=32)
    return params, static, dparams, dyn_cfg, raster_cfg, graph_s


def view_blend_inputs(torch, viewer, params, static, dparams, dyn_cfg, raster_cfg, t,
                       with_normals=True):
    """The compositing inputs of one view (elevation 5°, distance 3.8): rgb ⊕
    normals ⊕ depth, C = 7, as the serving path blends them, or rgb ⊕ depth,
    C = 4, as the train step does."""
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
    m = gs.means3d[0]
    dirs = m - cams.camera_center[0][None]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8)
    colors = sh_to_rgb(3, attrs0.sh, dirs)
    if with_normals:
        normals = torch.repeat_interleave(face_normals(vert.xyz, static.sugar.faces), 6, dim=-2)[0]
        colors = torch.cat([colors, normals], -1)
    proj = project_gaussians_sq(m, gs.scales[0], gs.quats[0], cams.world_view[0], cams.full_proj[0],
                                raster_cfg.tan_fovx, raster_cfg.tan_fovy, raster_cfg.width,
                                raster_cfg.height, raster_cfg.near)
    cfg = raster_cfg
    pa = bin_gaussians_pairs(proj.means2d, proj.radii, proj.depths, proj.mask, cfg.width,
                             cfg.height, cfg.max_tiles_per_gaussian, conics=proj.conics,
                             opacities=attrs0.opacities, tile=cfg.tile_px)
    colors = torch.cat([colors, proj.depths[:, None]], -1)  # + depth
    rows = _pack_rows(proj.means2d, proj.conics, colors, attrs0.opacities)
    return (rows, pa.sorted_gauss, pa.starts, pa.counts, cfg.width // cfg.tile_px, cfg.tile_px,
            cfg.tile_capacity, _auto_group(cfg, m.shape[0]), colors.shape[-1])


def synthetic_blend_inputs(torch, case, device, n_channels=7):
    """Adversarial segments at 512², tile 32, cap 2048."""
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
    colors = torch.cat([rnd(n, 6)[:, :n_channels - 1], depths[:, None]], -1)
    rows = _pack_rows(means, conics, colors, opac)
    return (rows, pa.sorted_gauss, pa.starts, pa.counts, 16, 32, 2048, 128, n_channels)


def check_forward(torch, rb, cases):
    """B1 against its plain version; returns (max error, work of main_view)."""
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
    return b1_err, main_stats


def check_backward(torch, rb, cases):
    """B2 and B3 against the plain backward on a seeded random cotangent.

    Per column group (means, conic, colours, opacity) the limit is GRAD_TOL =
    1e-4 of the group's max |value| in the plain result: a Gaussian's
    gradient is a float32 sum over up to 6 tiles x 1024 pixels, taken by the
    kernels with atomics and shuffles in an order that changes from run to
    run and by the plain version with ``index_add_`` and ``cumsum``, so
    agreement is to rounding (~1e-5 of the max measured), never bitwise.
    Returns {kernel: (max relative error, max absolute error)} and the work
    of each case."""
    groups = lambda C: (("means", slice(0, 2)), ("conic", slice(2, 5)),  # noqa: E731
                        ("colours", slice(5, 5 + C)), ("opacity", slice(rb.OP_COL, rb.OP_COL + 1)))
    worst = {"resident_bwd_accum": [0.0, 0.0], "resident_bwd_pairs": [0.0, 0.0]}
    work = {}
    for name, args in cases.items():
        seg, shape, C = args[:4], args[4:], args[-1]
        out = rb.blend_pairs_cuda(*args)
        gen = torch.Generator(device=out.device).manual_seed(5)
        cot = torch.randn(out.shape, generator=gen, device=out.device)
        stats = {}
        plain = rb.blend_pairs_bwd_plain(*seg, out, cot, *shape, stats=stats)
        accum = rb.blend_pairs_bwd_cuda(*seg, out, cot, *shape)
        per_pair = rb.blend_pairs_bwd_cuda(*seg, out, cot, *shape, per_pair=True)
        reduced = rb.reduce_pair_grads(per_pair, *seg[1:], seg[0].shape[0])
        torch.cuda.synchronize()
        work[name] = stats
        check(torch.isfinite(accum).all() and torch.isfinite(per_pair).all(),
              f"backward {name}: non-finite kernel output")
        check(float(accum[-1].abs().max()) == 0.0, f"backward {name}: the sentinel row got a gradient")
        line = []
        for gname, sl in groups(C):
            scale = float(plain[:, sl].abs().max())
            errs = {}
            for kernel, got in (("resident_bwd_accum", accum), ("resident_bwd_pairs", reduced)):
                err = float((got[:, sl] - plain[:, sl]).abs().max())
                errs[kernel] = err / max(scale, 1e-30)
                worst[kernel][0] = max(worst[kernel][0], errs[kernel])
                worst[kernel][1] = max(worst[kernel][1], err)
                check(err <= GRAD_TOL * scale,
                      f"{kernel} {name} C={C} {gname}: |d| {err:.3g} > {GRAD_TOL} x {scale:.3g}")
            b3_b2 = float((reduced[:, sl] - accum[:, sl]).abs().max()) / max(scale, 1e-30)
            check(b3_b2 <= GRAD_TOL, f"B3 + index_add_ vs B2 {name} C={C} {gname}: {b3_b2:.3g}")
            line.append(f"{gname} max {scale:.3g}: B2 {errs['resident_bwd_accum']:.2g} "
                        f"B3 {errs['resident_bwd_pairs']:.2g} B3-B2 {b3_b2:.2g}")
        print(f"B2/B3 {name} C={C} (|d| / group max, limit {GRAD_TOL}): " + "; ".join(line))
    return {k: tuple(v) for k, v in worst.items()}, work


def profile_call(torch, label, fn, card, top=12):
    """Where one call's time goes: torch.profiler over one warm ``fn()``;
    device time by kernel and host time by operator."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    print(f"[{card}] profile of one {label}: wall {wall_ms:.3f} ms (profiled), device busy "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f} %), {launches} kernel launches")
    for e in sorted(device, key=dev_us, reverse=True)[:top]:
        print(f"  [{card}] device {dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]:
        print(f"  [{card}] host   {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")


def training_setup(torch, np, viewer, params, static, dparams, dyn_cfg, raster_cfg, device):
    """The dynamic stage of sugar_dynamic_dg.yaml on the full-width scene:
    returns (make_step, target video, batch sampler).  The target video is
    the same mesh under a second deformation (seed 1), rendered once from the
    reference camera and kept on the device."""
    from dreammesh4d_tpu_torch.data.temporal_image import frame_timestamps
    from dreammesh4d_tpu_torch.data.uncond import assemble_camera_batch
    from dreammesh4d_tpu_torch.ops.meshops import build_one_ring, cotangent_weights
    from dreammesh4d_tpu_torch.systems.sugar_4dgen import (Sugar4DGenLosses, make_dynamic_render_eval,
                                                           make_dynamic_train_step)

    dcfg = dyn_cfg.deformation
    target = moving_deformation(torch, dcfg, 1, device)
    ts_all = torch.as_tensor(frame_timestamps(VIDEO_LEN), device=device)
    ref_cam = viewer._cameras(5.0, 0.0, 3.8)
    ref_cam = type(ref_cam)(*(x.expand(VIDEO_LEN, *x.shape[1:]) for x in ref_cam))
    with torch.no_grad():
        render = make_dynamic_render_eval(params, static, dcfg, raster_cfg)
        frames = render(target, ref_cam, ts_all, torch.arange(VIDEO_LEN, device=device))
    video = (frames["comp_rgb"], (frames["comp_mask"] > 0.5).float())
    del frames

    faces = static.sugar.faces.cpu().numpy()
    points = params.points.cpu().numpy()
    arap_w = cotangent_weights(points, faces, build_one_ring(faces, len(points)))
    losses = Sugar4DGenLosses(  # configs/sugar_dynamic_dg.yaml:110-125 + the dataclass defaults
        lambda_sds_zero123=0.1, lambda_rgb=5000.0, lambda_mask=[200, 500.0, 5000.0, 1000],
        lambda_depth=0.0, lambda_depth_rel=0.0, lambda_normal=0.0, lambda_normal_consistency=100.0,
        lambda_laplacian_smoothing=0.0, lambda_arap_reg_key_frame=10.0,
        lambda_arap_reg_inter_frame=10.0, lambda_ref_xyz=0, lambda_rgb_tv=0.0, lambda_depth_tv=0.0,
        lambda_normal_tv=0.0, lambda_obj_centric=0.0, lambda_plane_tv=0.0001,
        lambda_time_smoothness=0.01)

    def guidance_stand_in(guidance_state, generator, rgb, batch):
        return ((rgb - 0.5) ** 2).mean()

    def make_step(bwd_accum, guidance=True):
        return make_dynamic_train_step(
            params, static, dcfg, raster_cfg._replace(bwd_accum=bwd_accum), losses, arap_w,
            guidance_fn=guidance_stand_in if guidance else None, invert_bg_prob=1.0,
            video_frames=video, device=device)

    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)

    def sample_batch():
        fi = np.sort(rng.choice(VIDEO_LEN, FRAMES_PER_STEP, replace=False))
        el = np.radians(rng.uniform(-10.0, 80.0, FRAMES_PER_STEP))
        az = np.radians(rng.uniform(-180.0, 180.0, FRAMES_PER_STEP))
        pos = 3.8 * np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
        pos = torch.as_tensor(pos, **f32)
        up = torch.tensor([0.0, 0.0, 1.0], **f32).expand(pos.shape)
        fovy = torch.full((FRAMES_PER_STEP,), math.radians(20.0), **f32)
        start = rng.uniform(0.0, 0.8)
        return {
            "timestamps": ts_all[torch.as_tensor(fi, device=device)],
            "frame_indices": torch.as_tensor(fi, device=device),
            "ref_cameras": type(ref_cam)(*(x[:FRAMES_PER_STEP] for x in ref_cam)),
            "rand_cameras": assemble_camera_batch(pos, torch.zeros_like(pos), up, fovy, 0.01, 100.0),
            "inter_timestamps": torch.linspace(start, start + 0.2, N_INTER, **f32),
        }

    return make_step, video, sample_batch


def drive_training(torch, np, rb, card, make_step, sample_batch, dparams, device):
    """The training main path: N_TRAIN_STEPS steps through ``train_step``
    with the launch counts zeroed just before and read just after, then one
    step with ``bwd_accum=False`` and one with ``bwd_accum=True`` from the
    same state.  Returns (launch counts, the bwd_accum=False step's counts,
    ms per step, a callable that takes one more step)."""
    from dreammesh4d_tpu_torch.systems.sugar_4dgen import init_dyn_state
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves, tree_map

    views = 2 * FRAMES_PER_STEP
    train_step = make_step(True)
    state = init_dyn_state(dparams, lr=1.6e-3, betas=(0.9, 0.99), device=device)
    before = [p.detach().clone() for p in tree_leaves(state.deform_params)]
    gen = torch.Generator().manual_seed(0)
    rb.reset_launch_counts()
    step_ms, history = [], []
    for _ in range(N_TRAIN_STEPS):
        batch = sample_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
    launches = dict(rb.launch_counts)
    print(f"training main path launches: {json.dumps(launches)} ({N_TRAIN_STEPS} steps x {views} views)")
    check(launches["resident_fwd"] == views * N_TRAIN_STEPS,
          f"resident_fwd launches {launches['resident_fwd']} != {views * N_TRAIN_STEPS}")
    check(launches["resident_bwd_accum"] == views * N_TRAIN_STEPS,
          f"resident_bwd_accum launches {launches['resident_bwd_accum']} != {views * N_TRAIN_STEPS}")
    check(launches["resident_bwd_pairs"] == 0, "bwd_accum=True launched resident_bwd_pairs")
    check(state.step == N_TRAIN_STEPS, "the step counter did not advance")
    check(all(math.isfinite(v) for m in history for v in m.values()), "non-finite metric")
    after = tree_leaves(state.deform_params)
    check(all(bool(torch.isfinite(p).all()) for p in after), "non-finite parameter after training")
    moved = [float((a.detach() - b).abs().max()) for a, b in zip(after, before)]
    n_grids = sum(len(planes) for planes in state.deform_params["grids"])
    print(f"parameters moved (max |delta|): grids {max(moved[:n_grids]):.3g} "
          f"({sum(m > 0 for m in moved[:n_grids])}/{n_grids} planes), "
          f"trunk w {moved[n_grids]:.3g} b {moved[n_grids + 1]:.3g}")
    check(max(moved[:n_grids]) > 0, "no HexPlane grid changed")
    check(moved[n_grids] > 0, "the trunk weights did not change")
    keys = sorted(history[0])
    print("metrics: " + ", ".join(keys))
    for i in (0, len(history) - 1):
        print(f"  step {i}: loss_rgb + loss_mask = {history[i]['loss_rgb'] + history[i]['loss_mask']:.6g}, "
              f"loss_total = {history[i]['loss_total']:.6g}, psnr = {history[i]['psnr']:.4g}")
    ms = statistics.median(step_ms[1:])
    print(f"[{card}] train step ({FRAMES_PER_STEP} + {FRAMES_PER_STEP} views at {RES}x{RES}, "
          f"{N_INTER} inter-frame timestamps): {ms:.2f} ms/step (median of steps 2..{N_TRAIN_STEPS}; "
          f"all: {', '.join(f'{x:.1f}' for x in step_ms)})")

    # one further step per backward kernel from the same state and batch
    snapshot = tree_map(lambda p: p.detach().clone(), state.deform_params)
    batch = sample_batch()
    results = {}
    for accum in (False, True):
        s = init_dyn_state(snapshot, lr=1.6e-3, betas=(0.9, 0.99), step=state.step, device=device)
        rb.reset_launch_counts()
        _, m = make_step(accum)(s, batch, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        results[accum] = (dict(rb.launch_counts), float(m["loss_total"]),
                          [p.grad.clone() for p in tree_leaves(s.deform_params)])
    pair_counts, loss_pairs, grads_pairs = results[False]
    _, loss_accum, grads_accum = results[True]
    print(f"bwd_accum=False step launches: {json.dumps(pair_counts)}; loss_total {loss_pairs:.8g} "
          f"vs bwd_accum=True {loss_accum:.8g}")
    check(pair_counts["resident_bwd_pairs"] == views and pair_counts["resident_bwd_accum"] == 0
          and pair_counts["resident_fwd"] == views, "bwd_accum=False did not launch resident_bwd_pairs 8x")
    # the two steps share the forward, so the losses agree to float32 rounding
    # of the host-side sum; the gradients differ by the order of the sums
    check(abs(loss_pairs - loss_accum) <= 1e-6 * abs(loss_accum),
          "loss_total differs between bwd_accum=False and True from the same state")
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(grads_pairs, grads_accum))
    print(f"parameter gradients, bwd_accum=False vs True: max |d| / leaf max = {rel:.3g} (limit 1e-3)")
    check(rel <= 1e-3, "parameter gradients differ between the two backward kernels")

    # without a guidance_fn (and with the YAML's zero TV weights) the random
    # views are rendered but never reach the loss: no backward for them
    bare_step = make_step(True, guidance=False)
    s = init_dyn_state(snapshot, lr=1.6e-3, betas=(0.9, 0.99), step=state.step, device=device)
    rb.reset_launch_counts()
    bare_ms = []
    for _ in range(3):
        batch = sample_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, m = bare_step(s, batch, gen)
        torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    bare = dict(rb.launch_counts)
    print(f"[{card}] guidance_fn=None: 3 steps launch {json.dumps(bare)}; "
          f"{statistics.median(bare_ms[1:]):.2f} ms/step; metrics: {', '.join(sorted(m))}")
    check(bare["resident_fwd"] == 3 * views and bare["resident_bwd_accum"] == 3 * FRAMES_PER_STEP,
          "guidance_fn=None: expected 8 forward and 4 backward launches per step")
    check("loss_sds_zero123" not in m and all(math.isfinite(float(v)) for v in m.values()),
          "guidance_fn=None: unexpected metrics")
    return launches, pair_counts, ms, lambda: train_step(state, sample_batch(), gen)


def kernel_bounds(args, stats, table_rows, per_pair):
    """The least time the card could take for one backward launch on these
    inputs: bytes (rows, pairs, starts, counts, out and cotangent read once,
    the gradient table written once) over 3.35 TB/s, and FP32 operations
    over 67 TFLOP/s.  Per evaluated (pair, pixel) the replay does the
    forward's 19 operations (offsets, conic quadratic, exp, opacity, clamp,
    three tests); per composited one 24 + 4C more: weight 1, the two C-wide
    dots 4C, prefix 2, 1 - alpha and its floor 2, d_alpha 4, clamp select and
    d_power 2, the shared products 2, six sums 9, transmittance 2."""
    rows, pairs, starts, counts = args[:4]
    tile, cap, C = args[5], args[6], args[-1]
    P, T = tile * tile, starts.numel()
    table = T * cap * 16 if per_pair else table_rows * 16
    n_bytes = 4 * (rows.numel() + pairs.numel() + starts.numel() + counts.numel()
                   + 2 * T * (C + 1) * P + table)
    n_ops = stats["pairs_read"] * P * 19 + stats["live_pixels"] * (24 + 4 * C)
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations", n_bytes, n_ops


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
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = len(re.findall(r"[1-9]\d* bytes spill stores", log))
        if regs:
            print(f"  {name}: registers per thread {min(regs)}..{max(regs)} over {len(regs)} kernels, "
                  f"{spills} with spills")

    # 3. the kernels against their plain versions, at the main paths' shapes
    params, static, dparams, dyn_cfg, raster_cfg, graph_s = full_width_scene(torch, dev)
    print(f"scene: {params.log_scales.shape[0]} gaussians, {static.sugar.faces.shape[0]} faces, "
          f"{static.node_xyz.shape[0]} nodes (graph build on the host: {graph_s:.2f} s)")
    viewer = Viewer4D(params, static, dparams, dyn_cfg, raster_cfg, RES, RES, 20.0, VIDEO_LEN, device=dev)
    cases = {}
    for C in (7, 4):
        cases[C] = {
            "main_view": view_blend_inputs(torch, viewer, params, static, dparams, dyn_cfg,
                                           raster_cfg, 0.0, with_normals=C == 7),
            "saturated": synthetic_blend_inputs(torch, "saturated", dev, C),
            "empty_tiles": synthetic_blend_inputs(torch, "empty_tiles", dev, C)}
    b1_err, main_stats = check_forward(torch, rb, cases[7])
    check(int((cases[7]["saturated"][3] > 2048).sum()) >= 1, "saturated case has no saturated tile")
    check(int((cases[7]["empty_tiles"][3] == 0).sum()) >= 1, "empty-tile case has no empty tile")
    bwd_err, bwd_work = {}, {}
    for C in (7, 4):
        errs, bwd_work[C] = check_backward(torch, rb, cases[C])
        for k, (rel, absolute) in errs.items():
            old = bwd_err.get(k, (0.0, 0.0))
            bwd_err[k] = (max(old[0], rel), max(old[1], absolute))

    # 4. the serving main path, through the entry points a user calls
    rb.reset_launch_counts()
    frame0 = viewer.render(5.0, 0.0, 3.8, t=0.0)
    frame_half = viewer.render(5.0, 0.0, 3.8, t=0.5)
    orbit = viewer.orbit(n_views=8, elevation_deg=5.0, distance=3.8, t=0.0)
    play = viewer.play(elevation_deg=5.0, azimuth_deg=0.0, distance=3.8, n_frames=VIDEO_LEN)
    torch.cuda.synchronize()
    launches = dict(rb.launch_counts)
    print(f"main path launches: {json.dumps(launches)} (render x2 + orbit 8 + play {VIDEO_LEN} views)")
    check(launches["resident_fwd"] >= 1, "the main path never launched resident_fwd")
    check(launches["resident_bwd_accum"] == 0 and launches["resident_bwd_pairs"] == 0,
          "the serving path launched a backward kernel")
    frames = [frame0, frame_half] + orbit + play
    check(all(np.isfinite(f).all() and f.shape == (RES, RES, 3) for f in frames),
          "non-finite or misshapen frames")
    cover = float((np.abs(frame0 - 1.0).max(-1) > 1e-3).mean())
    moved = float(np.abs(frame0 - frame_half).max())
    print(f"coverage {cover:.4f} of pixels; max|frame(t=0) - frame(t=0.5)| {moved:.4g}; "
          f"orbit views differ by {float(np.abs(orbit[0] - orbit[4]).max()):.4g}")
    check(cover > 0.05, "alpha coverage <= 5 %")
    check(moved > 1e-3, "frames at t=0 and t=0.5 do not differ")
    plain_viewer = Viewer4D(params, static, dparams, dyn_cfg, raster_cfg._replace(backend="xla"),
                            RES, RES, 20.0, VIDEO_LEN, device=dev)
    plain_frame = plain_viewer.render(5.0, 0.0, 3.8, t=0.0)
    render_err = float(np.abs(plain_frame - frame0).max())
    print(f"render through the kernel vs through the plain blend: max|d| {render_err:.3g}")
    check(render_err <= 1e-4, "kernel render and plain render differ by more than 1e-4")

    # 5. the training main path
    make_step, video, sample_batch = training_setup(torch, np, viewer, params, static, dparams,
                                                    dyn_cfg, raster_cfg, dev)
    print(f"target video: {tuple(video[0].shape)} on {video[0].device}, "
          f"mask coverage {float(video[1].mean()):.4f}")
    check(float(video[1].mean()) > 0.05, "the target video is empty")
    train_launches, pair_launches, step_ms, one_step = drive_training(
        torch, np, rb, card, make_step, sample_batch, dparams, dev)

    # 6. times (CUDA events, median of 30 after warm-up)
    args = cases[7]["main_view"]
    b1_ms = time_ms(torch, lambda: rb.blend_pairs_cuda(*args))
    plain_ms = time_ms(torch, lambda: rb.blend_pairs_plain(*args))
    render_ms = time_ms(torch, lambda: viewer.render(5.0, 0.0, 3.8, t=0.25))
    play_ms = time_ms(torch, lambda: viewer.play(5.0, 0.0, 3.8, n_frames=VIDEO_LEN))
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
    bwd = {}
    for C in (4, 7):  # the train step blends C = 4, serving C = 7
        a = cases[C]["main_view"]
        seg, shape = a[:4], a[4:]
        out = rb.blend_pairs_cuda(*a)
        cot = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        plain_bwd_ms = time_ms(torch, lambda: rb.blend_pairs_bwd_plain(*seg, out, cot, *shape), n=10)
        for kernel, per_pair in (("resident_bwd_accum", False), ("resident_bwd_pairs", True)):
            ms = time_ms(torch, lambda: rb.blend_pairs_bwd_cuda(*seg, out, cot, *shape, per_pair=per_pair))
            b_ms, b_by, nb, no = kernel_bounds(a, bwd_work[C]["main_view"], a[0].shape[0], per_pair)
            bwd[kernel, C] = (ms, plain_bwd_ms, b_ms, b_by)
            print(f"[{card}] {'B3' if per_pair else 'B2'} {kernel} C={C}: {ms:.4f} ms (plain backward "
                  f"{plain_bwd_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}: {nb} B, {no} ops)")
        pp = rb.blend_pairs_bwd_cuda(*seg, out, cot, *shape, per_pair=True)
        red_ms = time_ms(torch, lambda: rb.reduce_pair_grads(pp, *seg[1:], seg[0].shape[0]))
        print(f"[{card}] B3's reduction outside the kernel (index_add_ of {pp.shape[0] * pp.shape[1]} "
              f"rows) C={C}: {red_ms:.4f} ms")
    print(f"[{card}] Viewer4D.render {RES}x{RES}: {render_ms:.3f} ms; play({VIDEO_LEN}): {play_ms:.2f} ms "
          f"= {VIDEO_LEN * 1e3 / play_ms:.1f} frames/s")
    print(f"[{card}] train step: {step_ms:.2f} ms/step")
    profile_call(torch, "render", lambda: viewer.render(5.0, 0.0, 3.8, t=0.25), card)
    profile_call(torch, "train step", one_step, card)

    # 7. result lines
    def entry(name, kid, source, replaces, tpu, n_launches, err, ms, plain, b_ms, b_by, **extra):
        return {"name": name, "id": kid, "route": "cuda", "source": source, "replaces": replaces,
                "tpu": tpu, "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **extra}

    bwd_src = "dreammesh4d_tpu_torch/csrc/resident_bwd.cu"
    b2, b3 = bwd["resident_bwd_accum", 4], bwd["resident_bwd_pairs", 4]
    print(json.dumps({"kernels": [
        entry("resident_fwd", "B1", "dreammesh4d_tpu_torch/csrc/resident_fwd.cu",
              "dreammesh4d_tpu/ops/gs/pallas_resident.py:121", "ops/gs/pallas_resident.py::_fwd_kernel",
              launches["resident_fwd"] + train_launches["resident_fwd"], b1_err, b1_ms, plain_ms,
              bound_ms, bound_by, max_abs_diff=b1_err, launches_serving=launches["resident_fwd"],
              launches_training=train_launches["resident_fwd"]),
        entry("resident_bwd_accum", "B2", bwd_src, "dreammesh4d_tpu/ops/gs/pallas_resident.py:248",
              "ops/gs/pallas_resident.py::_bwd_kernel_accum", train_launches["resident_bwd_accum"],
              bwd_err["resident_bwd_accum"][1], *b2, max_rel_err=bwd_err["resident_bwd_accum"][0],
              n_channels=4, ms_c7=bwd["resident_bwd_accum", 7][0]),
        entry("resident_bwd_pairs", "B3", bwd_src, "dreammesh4d_tpu/ops/gs/pallas_resident.py:173",
              "ops/gs/pallas_resident.py::_bwd_kernel", pair_launches["resident_bwd_pairs"],
              bwd_err["resident_bwd_pairs"][1], *b3, max_rel_err=bwd_err["resident_bwd_pairs"][0],
              n_channels=4, ms_c7=bwd["resident_bwd_pairs", 7][0]),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
   ``resident_bwd_accum``, B3 ``resident_bwd_pairs``) at C = 7 and C = 4; the
   cell hash-grid encode (B4, ``hashgrid_cell_fwd``) and its table-gradient
   backward (B5, ``hashgrid_cell_bwd``) at 524,288 points sampled along
   rays, 16 levels of 2^16 rows, and at odd sizes, one shared cell, points on
   cell faces, a level mask, single cotangents and a 2^8-row table; the
   (T, K)-table compositing (B6, ``table_fwd``) and its replay backward (B7,
   ``table_bwd``; B1's and B2's bodies over the table read as segments, one
   CTA per 16-px tile) on the inputs the static refine scene's
   renders hand B6 (recorded during one evaluation render, C = 7, and one
   rgb-only ``render_batch``, C = 4: 512², T = 1024, K = 2048), and at a tile
   at and one over capacity, empty tiles, tiles that exit in their first
   group, one Gaussian over the whole image, a row count that is no multiple
   of the group, a block of tiles all over K (``saturated``) and an opaque
   wall over the whole image that stops every tile after its first group
   (``opaque_wall``); B6/B7 write each tile's walked entries, held to the
   plain versions' ``walked_per_tile`` (and as many composited rows: they do
   not cull), and the main view's walked distribution is printed.  B1-B3 also write
   the pair slots each quadrant CTA walked, which must equal the plain
   version's count for every tile, on every case, including an opaque wall
   over one quadrant of several tiles (``quadrant_wall``: the tile-wide exit
   vote must keep them going) and thin rotated Gaussians whose -4.5 contour
   ends at a quadrant edge (``cull_edges``: the per-quadrant row cull); and
   the rows each quadrant CTA's cull kept, which must equal
   ``quadrant_kept_plain``'s count; B1-B3 also at the recovery recipe's
   tiles (64², 16-px tiles, one CTA each, capacity 512: the recipe's scene
   from its reference camera, and one saturated tile);
4. the serving main path — ``Viewer4D.render / orbit / play`` — at the full
   width of ``configs/sugar_dynamic_dg.yaml`` (icosphere(4) SuGaR mesh:
   30,720 Gaussians, SH 3; 1000-node geodesic graph, hybrid skinning;
   HexPlane 64-wide, 32 channels, [64,64,64,25] × [1,2,4,8]; 512², tile 32,
   capacity 2048, 6 tiles per Gaussian; fovy 20°, distance 3.8, elevation
   5°), with random weights from a seed and the deformation heads perturbed;
   launch counts are zeroed just before and read just after; then one
   ``Viewer4D.render`` with ``backend: pallas`` (16-px tiles, 16 tiles per
   Gaussian: one B6 launch) against the ``pallas_resident`` frame;
5. the dynamic-stage training main path — ``make_dynamic_train_step`` →
   ``train_step`` on the same scene with the YAML's loss weights, 4 of 32
   frames per step of a target video rendered once from a second,
   differently seeded deformation, 4 random + 4 reference views at 512², 10
   inter-frame timestamps, Adam (lr 1.6e-3, betas 0.9/0.99) — with its own
   launch counts, then one step with ``bwd_accum=False`` from the same state.
   The guidance model is not ported yet; a stand-in ``guidance_fn`` (mean
   squared distance of the random-view render from mid-grey) takes its place
   in the loss, so that the random views' gradients go through the backward
   kernel as they will with the real guidance.  With ``guidance_fn=None`` and
   the YAML's zero TV weights the random views do not reach the loss at all
   and autograd skips their backward; a few such steps are driven and
   counted too;
6. the stage-1 training main path — ``make_zero123_train_step`` →
   ``train_step`` at the full width of ``configs/stable-zero123.yaml`` (16
   levels × 2 features, cell layout, 2^16 rows, base 16; radius 2,
   ``blob_magic3d``, softplus, analytic normals, MLPs 64 × 2; occupancy-grid
   estimator, 32³ grid, 192 candidates, 64 samples, update every 16 steps;
   ``DiffuseWithPointLightMaterial`` at ambient ratio 1; the YAML's loss
   weights; Adam 0.01 / (0.9, 0.99) / 1e-8; cameras from
   ``RandomCameraSampler`` with the YAML's ranges).  The loop around the step
   — level mask, ambient ratio, the occupancy update every 16 steps, the
   resolution milestones — is written out here by hand as
   ``Zero123Experiment.train_step`` of the JAX package does it (the
   experiment class itself is not ported yet).  The reference image is
   synthetic: a shaded sphere seen from the reference camera.  Steps 0..17 at
   the first milestone's shapes (reference 128², 8 views at 64²), then a few
   steps at the last milestone's (reference 512², 2 views at 256²) from the
   same state, with the stand-in guidance, and a few with
   ``guidance_fn=None``; B4/B5 launch counts are held to what the code path
   predicts;
7. the export pass — ``export_density_grid`` at 256³ through B4;
8. the static SuGaR refine main path — ``make_static_train_step`` →
   ``train_step`` at the full width of ``configs/sugar_static_refine.yaml``
   (the icosphere(4) mesh with 6 Gaussians per face, SH 3, the YAML's
   geometry, loss weights and learning rates through ``sugar_optimizer``,
   ``invert_bg_prob`` 1, no guidance; 1 reference + 4 random views at 512²,
   fovy 20°, distance 3.8; the reference image rendered once from a perturbed
   copy of the parameters), driven from the same start on the YAML's
   ``pallas_resident`` (B1/B2) and on ``backend: pallas`` with 16 tiles per
   Gaussian (B6/B7), with the launches of each held to 5 + 5 per step;
9. the launcher main path — ``dreammesh4d_tpu_torch.launch.main`` as a user
   calls it, guidance off, at the YAMLs' full width: assets in a temporary
   directory (the icosphere(4, 0.6) bind mesh as an OBJ; phase 5's target
   video, 32 frames at 512², as RGBA PNGs from the port's encoder, frame 0
   the reference image); ``configs/sugar_static_refine.yaml --train`` for 4
   steps (a checkpoint every 2, one validation, the 120-view test), then
   ``configs/sugar_dynamic_dg.yaml --train`` with ``system.weights`` of its
   last checkpoint for 4 steps, then ``resume=LAST`` to 6; launch counts
   zeroed before and read after.  Checks the checkpoint layout, the resumed
   start step, the B1/B2 launches of every step against the YAMLs' batches
   (static 5 + 5; dynamic 8 + 4: with the guidance off and the YAML's zero
   TV weights the random views reach no loss); then the static YAML again
   with ``system.renderer.backend=pallas max_tiles_per_gaussian=16`` for 4
   steps, held to 5 B6 + 5 B7 launches a step; and one ``Viewer4D.from_trial``
   frame (one B1 launch) against the experiment's own render of the same
   state; prints ms/step beside the direct steps of phases 5 and 8, the
   seconds of setup (mesh, graph, frame decode), checkpoint save and load
   and the test pass, peak memory, and which of yaml, PIL, imageio and cv2
   the machine has;
10. CUDA-event times (median of 30 after warm-up; a kernel's ``ms`` as the
    earlier versions of this script took it: B1-B3 one launch per event
    pair, B4-B7 ten, and B1-B3 also ``ms_r10``), every kernel's device time
    from ``torch.profiler`` (``device_ms``), ms per train step, peak memory
    and profiles of one render and one train step of each stage; B6's main
    views also through B1/B2's entries, which cull their rows
    (``quadrant_kept_plain``); with ``--parent DIR`` (an unpacked parent
    tree) B6/B7 on every table case and B1/B2 on the main views, launched
    through that tree's wrappers and this one's in a process each, in the
    order parent, this, this, parent (``compare_trees``);
11. the recovery benchmark and the Gaussian stages' exports
    (``drive_recovery_and_export``): the ground truth of the recovery scene
    (``render_vertex_color_view``, the mesh rasterizer) on the card against
    the CPU at 64² and its ms per view at 64² and 1024²; the recovery recipe
    (``dreammesh4d_tpu_torch.recovery.run_recovery``, icosphere(3), 64², 16
    frames) on ``pallas_resident`` with its 1000 + 600 steps cut to 50 + 30,
    every column finite (not gated here: the full gate is ``python3 -m
    dreammesh4d_tpu_torch.recovery``); ``--export resume=LAST`` of phase 9's
    trials: ``refined_mesh.obj`` and ``gaussians.ply``, then the 4D export
    at the YAML's full width (120 predict views at 1024², one B1 launch
    each, texture 1024), each frame OBJ held to ``timed_all``; seconds of
    the bake, the OBJ writes and the PNG, peak memory;
12. a ``{"kernels": [...]}`` line, the card's name and power limit, and as the
    last line ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
# sources: resident_fwd holds B1 and B6, resident_bwd B2, B3 and B7, hashgrid_cell B4 and B5
KERNELS = ["resident_fwd", "resident_bwd", "hashgrid_cell"]
N_TIMED = 30
RES = 512  # image side of every render
MESH_LEVEL = 4  # icosphere subdivisions: 5120 faces x 6 = 30,720 Gaussians
N_NODES = 1000
VIDEO_LEN = 32
FRAMES_PER_STEP = 4
N_INTER = 10
N_TRAIN_STEPS = 10
GRAD_TOL = 1e-4  # B2/B3 vs plain, of each column group's max |value| (see check_backward)
# stage 1 (configs/stable-zero123.yaml)
S1_CHUNK_RAYS = 8192  # ray_chunk_train
S1_SAMPLES = 64  # occ_samples: one chunk encodes 8192 x 64 = 524,288 points
S1_REF_HW = (128, 512)  # the reference view at the first and the last milestone
S1_FIRST_STEPS = 18  # steps 0..17: the occupancy update runs at steps 0 and 16
S1_LAST_STEPS = 3
S1_BARE_STEPS = 2  # steps with guidance_fn=None at each milestone
EXPORT_RES = 256
# stage 4 (configs/sugar_static_refine.yaml)
STATIC_STEPS = 10
STATIC_RAND_VIEWS = 4  # data.random_camera.batch_size
STATIC_M = 16  # max_tiles_per_gaussian with backend: pallas (the YAML's 6 counts 32-px tiles)
TABLE_FWD_TOL = 1e-5  # B6 vs plain, max |d| over every channel
FEAT_TOL = 1e-6  # B4 feats vs plain, of each level's max |feats|
DFEAT_TOL = 1e-5  # B4 dfeats vs plain, of each level's max |dfeats| (they carry the resolution)
# the launcher (dreammesh4d_tpu_torch.launch) on both Gaussian YAMLs
LAUNCH_STEPS = 4  # trainer.max_steps of each stage's first run
LAUNCH_RESUMED_STEPS = 6  # the dynamic stage resumed from LAST
LAUNCH_CKPT_EVERY = 2  # checkpoint.every_n_train_steps
# the recovery recipe (dreammesh4d_tpu_torch.recovery) and the exports
RECOVERY_STEPS = (50, 30)  # static, dynamic: the recipe's 1000 + 600 cut
GT_TIMES = 4  # ground-truth views compared card against CPU
GT_FACE_SHARE = 0.999  # face_idx equal on at least this share of pixels
GT_RGB_TOL = 1e-5  # rgb elsewhere
GT_SIZES = (64, 1024)  # the recipe's size and the bake's
EXPORT_VERT_TOL = 1e-5  # a frame OBJ's vertices against timed_all's (six decimals written)
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


def time_ms(torch, fn, n=N_TIMED, warmup=3, reps=1):
    """Median milliseconds of ``fn`` between two CUDA events; with ``reps``
    the events enclose that many calls and the time is per call, so that a
    short kernel is not timed by the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(torch, fn, key, n=N_TIMED, required=True):
    """Device milliseconds per launch of the kernels whose name holds
    ``key`` over ``n`` calls of ``fn``, from ``torch.profiler``: no host
    time in it.  The profiler may drop a few records; the mean is over those
    it kept, and a trace that kept none of them is taken again (twice at
    most); no record, or more than ``n``, fails the run, or, where not
    ``required``, gives None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if key in e.key]
        total = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) for e in events)
        count = sum(e.count for e in events)
        if count:
            break
        print(f"device time of {key}: the trace kept no record of {n} calls, taken again")
    if not required and not 0 < count <= n:
        return None
    check(0 < count <= n, f"device time of {key}: {count} kernel records for {n} calls")
    return total / 1e3 / count


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


def recovery_blend_inputs(torch, case, device, n_channels=7):
    """The recovery recipe's tiles: 64², 16-px tiles (one CTA per tile),
    capacity 512.

    - ``recovery_view``: the recipe's scene at the start of its static stage
      — icosphere(3) of radius 0.6, 6 Gaussians per face (7,680), the
      YAML's init — from the reference camera (elevation 5°, distance 3.8,
      fovy 20°): rgb from its SH (⊕ its face normals at C = 7) ⊕ depth; 12 of
      its 16 tiles hold more pairs than the capacity;
    - ``saturated16``: 3000 faint splats on one 16-px tile, count > cap."""
    from dreammesh4d_tpu_torch.models.geometry.sugar import create_sugar, gaussian_attributes
    from dreammesh4d_tpu_torch.ops import cameras as cam_ops
    from dreammesh4d_tpu_torch.ops.gs.binning import bin_gaussians_pairs
    from dreammesh4d_tpu_torch.ops.gs.projection import project_gaussians_sq
    from dreammesh4d_tpu_torch.ops.gs.resident_blend import _pack_rows
    from dreammesh4d_tpu_torch.ops.meshops import face_normals
    from dreammesh4d_tpu_torch.ops.sh import sh_to_rgb
    from dreammesh4d_tpu_torch.utils.procedural import make_icosphere

    hw, tile, cap = 64, 16, 512
    if case == "recovery_view":
        params, static = create_sugar(static_configs()[0], make_icosphere(3, radius=0.6), device=device)
        attrs = gaussian_attributes(params, static)
        fov = math.radians(20.0)
        cam = cam_ops.get_cam_info_gaussian(
            torch.as_tensor(cam_ops.make_c2w_numpy(5.0, 0.0, 3.8), device=device), fov, fov, 0.01, 100.0)
        t = math.tan(fov / 2)
        proj = project_gaussians_sq(attrs.means3d, attrs.scales, attrs.quats, cam.world_view_transform,
                                    cam.full_proj_transform, t, t, hw, hw, 0.2)
        dirs = attrs.means3d - cam.camera_center[None]
        colors = sh_to_rgb(static.sh_degree, attrs.sh, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True))
        if n_channels == 7:
            normals = torch.repeat_interleave(face_normals(params.points, static.faces), 6, dim=-2)
            colors = torch.cat([colors, normals], -1)
        means, conics, opac, depths = proj.means2d, proj.conics, attrs.opacities, proj.depths
        radii, mask, n_tiles = proj.radii, proj.mask, 6
    else:
        gen = torch.Generator(device=device).manual_seed(2)
        n = 3000
        means = 20.0 + 8.0 * torch.rand((n, 2), generator=gen, device=device)
        conics = torch.tensor([0.02, 0.0, 0.02], device=device).expand(n, 3)
        opac = torch.full((n,), 0.005, device=device)
        depths = 1.0 + 2.0 * torch.rand(n, generator=gen, device=device)
        radii = torch.full((n,), 22, dtype=torch.int32, device=device)
        mask, n_tiles = torch.ones(n, dtype=torch.bool, device=device), 16
        colors = torch.rand((n, n_channels - 1), generator=gen, device=device)
    pa = bin_gaussians_pairs(means, radii, depths, mask, hw, hw, n_tiles, conics=conics, opacities=opac,
                             tile=tile)
    colors = torch.cat([colors, depths[:, None]], -1)
    rows = _pack_rows(means, conics, colors, opac).detach()
    return (rows, pa.sorted_gauss, pa.starts, pa.counts, hw // tile, tile, cap, 32, n_channels)


def synthetic_blend_inputs(torch, case, device, n_channels=7):
    """Adversarial segments at 512², tile 32, cap 2048, group 128.

    - ``saturated``: 3000 faint splats on one tile, count > cap;
    - ``empty_tiles``: a small cluster, most tiles hold nothing;
    - ``quadrant_wall``: in each of 6 tiles an opaque wall over one quadrant
      (a different one from tile to tile), five sharp disks (op 50: alpha =
      0.99 out to power -3.9, nothing past -4.5) in front of ~400 faint
      splats per tile: the quadrant's transmittance falls under 1e-4 in the
      first group while the other quadrants composite on, so the tiles must
      walk their whole segments (a vote per quadrant would stop early);
    - ``cull_edges``: 1500 thin, rotated, anisotropic Gaussians over 16
      tiles whose power = -4.5 box ends within a pixel of a quadrant edge."""
    from dreammesh4d_tpu_torch.ops.gs.binning import bin_gaussians_pairs
    from dreammesh4d_tpu_torch.ops.gs.resident_blend import _pack_rows

    gen = torch.Generator(device=device).manual_seed(1)
    rnd = lambda *s: torch.rand(s, generator=gen, device=device)  # noqa: E731
    full = lambda n, v: torch.full((n,), v, device=device)  # noqa: E731
    if case in ("saturated", "empty_tiles"):
        if case == "saturated":
            n, lo, hi, op, spread = 3000, 200.0, 220.0, 0.005, 0.02
        else:
            n, lo, hi, op, spread = 200, 40.0, 80.0, 0.6, 0.3
        means = lo + (hi - lo) * rnd(n, 2)
        conics = torch.stack([full(n, spread), 0.002 * (rnd(n) - 0.5), full(n, spread)], -1)
        opac = full(n, op)
        depths = 1.0 + 2.0 * rnd(n)
        radii = torch.ceil(3.0 / torch.sqrt(conics[:, 0])).int()
    elif case == "quadrant_wall":  # tiles (4..9, 6)
        q = torch.arange(6, device=device) % 4  # the wall's quadrant, x-major
        centre = torch.stack([(4 + torch.arange(6, device=device)) * 32 + (q & 1) * 16 + 7.5,
                              6 * 32 + (q >> 1) * 16 + 7.5], -1).float()
        n_wall, n_faint = 30, 2400
        means = torch.cat([centre.repeat_interleave(5, 0),
                           torch.stack([128.0 + 192.0 * rnd(n_faint), 192.0 + 32.0 * rnd(n_faint)], -1)])
        n = n_wall + n_faint
        spread = torch.cat([full(n_wall, 0.0685), full(n_faint, 0.3)])
        conics = torch.stack([spread, torch.zeros_like(spread), spread], -1)
        opac = torch.cat([full(n_wall, 50.0), full(n_faint, 0.05)])
        depths = torch.cat([0.5 + 0.1 * rnd(n_wall), 1.0 + 2.0 * rnd(n_faint)])
        radii = torch.cat([full(n_wall, 12.0), full(n_faint, 6.0)]).int()
    else:  # "cull_edges": tiles (2..5, 2..5)
        n = 1500
        theta = math.pi * rnd(n)
        sa = 3.0 + 9.0 * rnd(n)
        sb = sa / (3.0 + 27.0 * rnd(n))
        c, s = torch.cos(theta), torch.sin(theta)
        ia, ib = 1.0 / sa ** 2, 1.0 / sb ** 2
        conics = torch.stack([c * c * ia + s * s * ib, c * s * (ia - ib), s * s * ia + c * c * ib], -1)
        half = torch.stack([3.0 * torch.sqrt(c * c * sa ** 2 + s * s * sb ** 2),
                            3.0 * torch.sqrt(s * s * sa ** 2 + c * c * sb ** 2)], -1)
        # the box's end (mean +- half-width) at a quadrant edge 16k - 0.5, +- one pixel
        edge = 64.0 + 16.0 * torch.floor(9.0 * rnd(n, 2)) - 0.5 + (2.0 * rnd(n, 2) - 1.0)
        side = torch.where(rnd(n, 2) < 0.5, -1.0, 1.0)
        means = torch.where(rnd(n, 1) < 0.5,
                            torch.stack([edge[:, 0] + side[:, 0] * half[:, 0], 64.0 + 128.0 * rnd(n)], -1),
                            torch.stack([64.0 + 128.0 * rnd(n), edge[:, 1] + side[:, 1] * half[:, 1]], -1))
        opac = 0.3 + 0.6 * rnd(n)
        depths = 1.0 + 2.0 * rnd(n)
        radii = torch.ceil(3.0 * sa).int()
    pa = bin_gaussians_pairs(means, radii, depths, torch.ones(n, dtype=torch.bool, device=device),
                             512, 512, 6, conics=conics, opacities=opac, tile=32)
    colors = torch.cat([rnd(n, 6)[:, :n_channels - 1], depths[:, None]], -1)
    rows = _pack_rows(means, conics, colors, opac)
    return (rows, pa.sorted_gauss, pa.starts, pa.counts, 16, 32, 2048, 128, n_channels)


def new_walked(torch, args):
    """A (2, T, 4) int32 buffer for the kernels' per-quadrant counts (walked
    pair slots, rows the cull kept), filled with -1 so that a column no CTA
    wrote shows."""
    return torch.full((2, args[2].numel(), 4), -1, dtype=torch.int32, device=args[0].device)


def same_work(a, b):
    """Two plain versions' ``stats`` are the same work (the walked counts
    per tile included)."""
    return a.keys() == b.keys() and all(
        bool((a[k] == b[k]).all()) if hasattr(a[k], "shape") else a[k] == b[k] for k in a)


def check_walked(torch, rb, kernel, name, walked, stats, args):
    """Every quadrant CTA of every tile walked the plain version's pair
    slots and its cull kept as many of their rows as ``quadrant_kept_plain``
    (column 0 only where a tile is one CTA).  Returns the kept share of the
    (walked pair, quadrant) evaluations, as the kernel counted it: what it
    evaluates of the work ``kernel_bounds`` counts."""
    ref = stats["walked_per_tile"].to(walked.device)
    nq = 4 if args[5] > 16 else 1
    cols = walked[:, :, :nq].long()
    bad = int((cols[0] != ref[:, None]).any(-1).sum())
    check(bad == 0, f"{kernel} {name}: the walked pair slots of {bad} tiles differ from the plain version's")
    kept = rb.quadrant_kept_plain(args[0], args[1], args[2], ref, args[4], args[5]).to(walked.device)
    bad = int((cols[1] != kept).any(-1).sum())
    check(bad == 0, f"{kernel} {name}: the rows the cull kept in {bad} tiles differ from quadrant_kept_plain")
    return float(cols[1].sum()) / max(float(cols[0].sum()), 1.0)


def check_quadrant_wall(torch, rb, args):
    """The quadrant_wall case is what it claims (through the plain version):
    each wall tile holds several groups and walks all of them, its wall
    quadrant is opaque and another quadrant is not."""
    stats = {}
    out = rb.blend_pairs_plain(*args, stats=stats)
    tiles = 6 * 16 + 4 + torch.arange(6, device=out.device)
    segment = torch.clamp(args[3][tiles].long(), max=args[6])
    trans = out[tiles, args[-1]].reshape(6, 32, 32)
    quads = [((i % 4 >> 1) * 16, (i % 4 & 1) * 16) for i in range(6)]  # the wall's (y, x) offset
    wall_max = [float(trans[i, y:y + 16, x:x + 16].max()) for i, (y, x) in enumerate(quads)]
    print(f"quadrant_wall: pairs per wall tile {segment.tolist()}, walked {stats['walked_per_tile'][tiles].tolist()}; "
          f"max transmittance in the wall quadrant {max(wall_max):.3g}, in the tile "
          f"{[round(float(t.max()), 3) for t in trans]}")
    check(int(segment.min()) > 2 * args[7], "quadrant_wall: a wall tile holds fewer than three groups")
    check(bool((stats["walked_per_tile"][tiles].to(segment.device) == segment).all()),
          "quadrant_wall: a wall tile stopped before the end of its segment")
    check(max(wall_max) <= rb.T_EPS and float(trans.amax(dim=(1, 2)).min()) > 0.1,
          "quadrant_wall: a wall quadrant is not opaque, or a whole tile is")


def check_forward(torch, rb, cases):
    """B1 against its plain version, its walked counts against the plain
    version's; returns (max error, work of main_view)."""
    b1_err = 0.0
    main_stats, main_kept = {}, 0.0
    for name, args in cases.items():
        stats = {}
        walked = new_walked(torch, args)
        out_k = rb.blend_pairs_cuda(*args, walked=walked)
        out_p = rb.blend_pairs_plain(*args, stats=stats)
        torch.cuda.synchronize()
        C = args[-1]
        depth_scale = max(float(args[0][:, 5 + C - 1].abs().max()), 1.0)
        err_col = float((out_k[:, :C - 1] - out_p[:, :C - 1]).abs().max())
        err_t = float((out_k[:, C] - out_p[:, C]).abs().max())
        err_d = float((out_k[:, C - 1] - out_p[:, C - 1]).abs().max())
        counts = args[3]
        kept = check_walked(torch, rb, "B1", name, walked, stats, args)
        print(f"B1 {name}: tiles {counts.shape[0]}, pairs {int(counts.sum())}, "
              f"saturated tiles (count > cap) {int((counts > args[6]).sum())}, "
              f"empty tiles {int((counts == 0).sum())}, pairs read {stats['pairs_read']}, "
              f"the kernel's cull kept {kept:.4f} of (pair, quadrant) (= quadrant_kept_plain per tile); "
              f"max|d| colors {err_col:.3g} transmittance {err_t:.3g} depth {err_d:.3g} "
              f"(depth scale {depth_scale:.3g})")
        check(torch.isfinite(out_k).all(), f"B1 {name}: non-finite kernel output")
        check(err_col <= 1e-4 and err_t <= 1e-4, f"B1 {name}: kernel vs plain > 1e-4")
        check(err_d <= 1e-4 * depth_scale, f"B1 {name}: depth kernel vs plain > 1e-4 x depth scale")
        b1_err = max(b1_err, err_col, err_t, err_d / depth_scale)
        if name == "main_view":
            main_stats, main_kept = stats, kept
    return b1_err, main_stats, main_kept


def check_backward(torch, rb, cases):
    """B2 and B3 against the plain backward on a seeded random cotangent.

    Per column group (means, conic, colours, opacity) the limit is GRAD_TOL =
    1e-4 of the group's max |value| in the plain result: a Gaussian's
    gradient is a float32 sum over up to 6 tiles x 1024 pixels, taken by the
    kernels with atomics and shuffles in an order that changes from run to
    run and by the plain version with ``index_add_`` and ``cumsum``, so
    agreement is to rounding (~1e-5 of the max measured), never bitwise.
    Returns {kernel: (max relative error, max absolute error)}, the work of
    each case and the share B2's cull kept in each case."""
    groups = lambda C: (("means", slice(0, 2)), ("conic", slice(2, 5)),  # noqa: E731
                        ("colours", slice(5, 5 + C)), ("opacity", slice(rb.OP_COL, rb.OP_COL + 1)))
    worst = {"resident_bwd_accum": [0.0, 0.0], "resident_bwd_pairs": [0.0, 0.0]}
    work, kept = {}, {}
    for name, args in cases.items():
        seg, shape, C = args[:4], args[4:], args[-1]
        walked = {k: new_walked(torch, args) for k in ("B1", "B2", "B3")}
        out = rb.blend_pairs_cuda(*args, walked=walked["B1"])
        gen = torch.Generator(device=out.device).manual_seed(5)
        cot = torch.randn(out.shape, generator=gen, device=out.device)
        stats = {}
        plain = rb.blend_pairs_bwd_plain(*seg, out, cot, *shape, stats=stats)
        accum = rb.blend_pairs_bwd_cuda(*seg, out, cot, *shape, walked=walked["B2"])
        per_pair = rb.blend_pairs_bwd_cuda(*seg, out, cot, *shape, per_pair=True, walked=walked["B3"])
        reduced = rb.reduce_pair_grads(per_pair, *seg[1:], seg[0].shape[0])
        torch.cuda.synchronize()
        work[name] = stats
        for kernel, w in walked.items():
            kept[kernel, name] = check_walked(torch, rb, kernel, f"{name} C={C}", w, stats, args)
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
        print(f"B2/B3 {name} C={C} (|d| / group max, limit {GRAD_TOL}; walked pairs and kept rows of B1, "
              f"B2, B3 = the plain versions' in every quadrant, B2 kept {kept['B2', name]:.4f}): "
              + "; ".join(line))
    return {k: tuple(v) for k, v in worst.items()}, work, {n: kept["B2", n] for n in cases}


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
    busy_ms = sum(dev_us(e) for e in device) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    # B1-B3's cluster launches and PyTorch's GEMMs go through cudaLaunchKernelExC
    launches_ex = sum(e.count for e in events if e.key == "cudaLaunchKernelExC")
    print(f"[{card}] profile of one {label}: wall {wall_ms:.3f} ms (profiled), device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), {launches} kernel launches "
          f"(cudaLaunchKernel) + {launches_ex} cudaLaunchKernelExC")
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
    same state, then steps with ``guidance_fn=None``.  Returns (launch
    counts, the bwd_accum=False step's counts, ms per step, ms per step with
    ``guidance_fn=None``, a callable that takes one more step)."""
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
    return (launches, pair_counts, ms, statistics.median(bare_ms[1:]),
            lambda: train_step(state, sample_batch(), gen))


def stage1_configs():
    """configs/stable-zero123.yaml at full width: geometry, renderer, losses,
    material and the random camera sampler's settings."""
    from dreammesh4d_tpu_torch.data.uncond import RandomCameraConfig
    from dreammesh4d_tpu_torch.models.geometry.implicit_volume import ImplicitVolumeConfig
    from dreammesh4d_tpu_torch.models.materials import DiffuseWithPointLightMaterial
    from dreammesh4d_tpu_torch.models.renderers.nerf_volume_renderer import NeRFRendererConfig
    from dreammesh4d_tpu_torch.ops.hashgrid import HashGridConfig
    from dreammesh4d_tpu_torch.systems.zero123_system import Zero123Losses

    hg = HashGridConfig(n_levels=16, n_features_per_level=2, log2_hashmap_size=16,
                        base_resolution=16, per_level_scale=1.447269237440378, layout="cell")
    geo = ImplicitVolumeConfig(radius=2.0, normal_type="analytic", density_bias="blob_magic3d",
                               density_activation="softplus", density_blob_scale=10.0,
                               density_blob_std=0.5, hashgrid=hg, n_neurons=64, n_hidden_layers=2)
    rcfg = NeRFRendererConfig(radius=2.0, estimator="occgrid", grid_resolution=32,
                              occ_candidates=192, occ_samples=S1_SAMPLES, occ_thre=0.01,
                              grid_update_every=16, ray_chunk_train=S1_CHUNK_RAYS)
    losses = Zero123Losses(lambda_sds=0.1, lambda_rgb=[100, 500.0, 1000.0, 400], lambda_mask=50.0,
                           lambda_depth=0.0, lambda_depth_rel=0.0, lambda_normal=0.0,
                           lambda_normal_smooth=[100, 7.0, 5.0, 150, 10.0, 200],
                           lambda_3d_normal_smooth=[100, 7.0, 5.0, 150, 10.0, 200],
                           lambda_orient=1.0, lambda_sparsity=0.5, lambda_opaque=0.5)
    cams = RandomCameraConfig(height=[64, 128, 256], width=[64, 128, 256], batch_size=[8, 4, 2],
                              resolution_milestones=(200, 300), eval_height=512, eval_width=512,
                              elevation_range=(-10.0, 80.0), azimuth_range=(-180.0, 180.0),
                              camera_distance_range=(3.8, 3.8), fovy_range=(20.0, 20.0),
                              light_position_perturb=1.0, light_distance_range=(7.5, 10.0))
    return geo, rcfg, losses, DiffuseWithPointLightMaterial(), cams


def ray_sample_points(torch, cams, n_rays, n_samples, radius, device):
    """Contracted points in [0, 1]³ sampled along camera rays as the renderer
    samples them: jittered, in order along each ray inside the box."""
    from dreammesh4d_tpu_torch.data.uncond import RandomCameraSampler
    from dreammesh4d_tpu_torch.models.renderers.nerf_volume_renderer import ray_bbox_intersect

    batch = RandomCameraSampler(cams, seed=3, device=device).sample()
    ro = batch["rays_o"].reshape(-1, 3)[:n_rays]
    rd = batch["rays_d"].reshape(-1, 3)[:n_rays]
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    check(ro.shape[0] == n_rays, f"the sampler gave {ro.shape[0]} rays, {n_rays} needed")
    t_near, t_far = ray_bbox_intersect(ro, rd, radius, 0.05)
    gen = torch.Generator(device=device).manual_seed(4)
    u = (torch.arange(n_samples, device=device) + torch.rand((n_rays, n_samples), generator=gen,
                                                             device=device)) / n_samples
    t = t_near[:, None] + (t_far - t_near)[:, None] * u
    pts = ro[:, None] + t[..., None] * rd[:, None]
    return ((pts + radius) / (2 * radius)).clamp(0.0, 1.0).reshape(-1, 3).contiguous()


def hashgrid_cases(torch, cams, device):
    """name -> (config, tables, x, cotangents wanted): the main path's shape
    and the adversarial ones."""
    from dreammesh4d_tpu_torch.ops.hashgrid import HashGridConfig

    geo = stage1_configs()[0]
    hg = geo.hashgrid
    gen = torch.Generator(device=device).manual_seed(2)
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=device)  # noqa: E731
    # the 1e-4 init scaled up, so that rounding differences would show
    tables = 0.2 * rnd(hg.n_levels, 1 << hg.log2_hashmap_size, 16) - 0.1
    main = ray_sample_points(torch, cams, S1_CHUNK_RAYS, S1_SAMPLES, geo.radius, device)
    faces = torch.cat([torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.5]], device=device),
                       torch.randint(0, 17, (2045, 3), generator=gen, device=device) / 16.0,
                       torch.randint(0, 4096, (2048, 3), generator=gen, device=device) / 4095.0])
    small = HashGridConfig(n_levels=16, n_features_per_level=2, log2_hashmap_size=8,
                           base_resolution=4, per_level_scale=1.447269237440378, layout="cell")
    cases = {"main_chunk": (hg, tables, main, "both")}
    for n in (1, 257, 1000):
        cases[f"n={n}"] = (hg, tables, rnd(n, 3), "both")
    cases["one_cell"] = (hg, tables, 0.3 + 1e-5 * rnd(4096, 3), "both")
    cases["cell_faces"] = (hg, tables, faces, "both")
    cases["only_g_feats"] = (hg, tables, main[:65536], "feats")
    cases["only_g_dfeats"] = (hg, tables, main[:65536], "dfeats")
    cases["table_2^8"] = (small, 0.2 * rnd(16, 256, 16) - 0.1, rnd(20000, 3), "both")
    return cases


def check_hashgrid(torch, hc, cases):
    """B4 and B5 against their plain versions.

    Forward, per level: |feats| within FEAT_TOL = 1e-6 and |dfeats| within
    DFEAT_TOL = 1e-5 of the level's largest value in the plain result — the
    kernel sums the eight corners in another order and with fused
    multiply-adds; cell and fraction are the plain version's bit for bit
    (dfeats carry the level's resolution, up to 4095).  Backward, per level:
    within GRAD_TOL = 1e-4 of the level's largest gradient — float32 sums over
    all points of a cell, by atomics in a run-dependent order against
    ``index_add_``.  Returns the worst errors and the gradient's norm of the
    main case."""
    worst = {"feats_rel": 0.0, "dfeats_rel": 0.0, "fwd_abs": 0.0, "bwd_rel": 0.0, "bwd_abs": 0.0}
    for name, (cfg, tables, x, which) in cases.items():
        L = cfg.n_levels
        f_k, d_k = hc.encode_cell_fwd_cuda(tables, x, cfg)
        f_only, none = hc.encode_cell_fwd_cuda(tables, x, cfg, with_dfeats=False)
        f_p, d_p = hc.encode_cell_fwd_plain(tables, x, cfg)
        torch.cuda.synchronize()
        check(none is None and torch.isfinite(f_k).all() and torch.isfinite(d_k).all(),
              f"B4 {name}: non-finite kernel output")
        N = x.shape[0]
        fk, fo, fp = (t.reshape(N, L, 2) for t in (f_k, f_only, f_p))
        dk, dp = d_k.reshape(N, L, 6), d_p.reshape(N, L, 6)
        f_scale = fp.abs().amax(dim=(0, 2)).clamp_min(1e-30)
        d_scale = dp.abs().amax(dim=(0, 2)).clamp_min(1e-30)
        f_rel = float(((fk - fp).abs().amax(dim=(0, 2)) / f_scale).max())
        fo_rel = float(((fo - fp).abs().amax(dim=(0, 2)) / f_scale).max())
        d_rel = float(((dk - dp).abs().amax(dim=(0, 2)) / d_scale).max())
        check(f_rel <= FEAT_TOL and fo_rel <= FEAT_TOL,
              f"B4 {name}: feats {max(f_rel, fo_rel):.3g} > {FEAT_TOL} of a level's max")
        check(d_rel <= DFEAT_TOL, f"B4 {name}: dfeats {d_rel:.3g} > {DFEAT_TOL} of a level's max")
        worst["feats_rel"] = max(worst["feats_rel"], f_rel, fo_rel)
        worst["dfeats_rel"] = max(worst["dfeats_rel"], d_rel)
        worst["fwd_abs"] = max(worst["fwd_abs"], float((f_k - f_p).abs().max()),
                               float((d_k - d_p).abs().max()))

        gen = torch.Generator(device=x.device).manual_seed(5)
        g_f = torch.randn(f_k.shape, generator=gen, device=x.device) if which != "dfeats" else None
        g_d = torch.randn(d_k.shape, generator=gen, device=x.device) if which != "feats" else None
        t_k = hc.encode_cell_bwd_cuda(x, cfg, g_f, g_d)
        t_p = hc.encode_cell_bwd_plain(x, cfg, g_f, g_d)
        torch.cuda.synchronize()
        check(torch.isfinite(t_k).all(), f"B5 {name}: non-finite kernel output")
        g_scale = t_p.abs().amax(dim=(1, 2)).clamp_min(1e-30)
        g_abs = (t_k - t_p).abs().amax(dim=(1, 2))
        g_rel = float((g_abs / g_scale).max())
        check(g_rel <= GRAD_TOL, f"B5 {name}: table gradient {g_rel:.3g} > {GRAD_TOL} of a level's max")
        worst["bwd_rel"] = max(worst["bwd_rel"], g_rel)
        worst["bwd_abs"] = max(worst["bwd_abs"], float(g_abs.max()))
        rows = int((t_p.abs().amax(-1) > 0).sum())
        print(f"B4/B5 {name}: N {N}, L {L}, T {tables.shape[1]}, cotangents {which}: |d| / level max "
              f"feats {max(f_rel, fo_rel):.2g} (limit {FEAT_TOL}) dfeats {d_rel:.2g} (limit "
              f"{DFEAT_TOL}) table gradient {g_rel:.2g} (limit {GRAD_TOL}); rows with a gradient "
              f"{rows}, largest |gradient| {float(t_p.abs().max()):.4g}")

    # a level mask with zeros, through the differentiable entry: the kernels
    # against the plain versions inside the same autograd.Function
    cfg, tables, x, _ = cases["n=1000"]
    mask = torch.ones(cfg.n_levels, device=x.device)
    mask[3::4] = 0.0
    got = {}
    for plain in (False, True):
        t = tables.clone().requires_grad_(True)
        feats, dfeats = hc.encode_cell_with_grad({"tables": t}, cfg, x, level_mask=mask, plain=plain)
        (feats.sin().sum() + 1e-3 * dfeats.cos().sum()).backward()
        got[plain] = (feats.detach(), dfeats.detach(), t.grad)
    torch.cuda.synchronize()
    check(float(got[False][0][:, 6:8].abs().max()) == 0.0 and float(got[False][1][:, 6:8].abs().max()) == 0.0
          and float(got[False][2][3].abs().max()) == 0.0, "level mask: a masked level is not zero")
    mask_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(got[False], got[True]))
    print(f"B4/B5 level mask with zeros (autograd through both kernels vs the plain versions): "
          f"max |d| / max {mask_rel:.2g} (limit {GRAD_TOL})")
    check(mask_rel <= GRAD_TOL, "level mask: kernels and plain versions disagree")
    return worst


def hashgrid_bounds(torch, cfg, x):
    """The least time the card could take for one B4 or B5 launch on these
    points: the bytes each must move over 3.35 TB/s — the points, the table
    rows that the points touch (each once: unique rows x 64 B; B5 writes the
    whole zeroed table instead) and the (N, 2L) + (N, 2L, 3) outputs or
    cotangents — and its FP32 operations over 67 TFLOP/s: per (point, level)
    15 for cell and fraction, 35 for the eight weight chains and 128 (B4) or
    176 (B5) for the eight-corner sums."""
    from dreammesh4d_tpu_torch.ops.hashgrid import cell_indices

    N, L, T = x.shape[0], cfg.n_levels, 1 << cfg.log2_hashmap_size
    idx = cell_indices(cfg, x)
    unique_rows = sum(int(torch.unique(idx[l]).numel()) for l in range(L))
    io = 4 * N * (3 + 2 * L * 4)
    out = {}
    for kernel, table_bytes, ops in (("hashgrid_cell_fwd", 64 * unique_rows, 15 + 35 + 128),
                                     ("hashgrid_cell_bwd", 64 * L * T, 15 + 35 + 176)):
        n_bytes, n_ops = io + table_bytes, N * L * ops
        t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOPS
        out[kernel] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
                       n_bytes, n_ops)
    return out, unique_rows


def sphere_reference(torch, c2w, hw, fovy_deg, device):
    """Rays of the reference camera and a synthetic reference image: the
    analytic silhouette of a sphere of radius 0.5 at the origin, coloured by
    its surface normal (a smooth colour), on white."""
    from dreammesh4d_tpu_torch.ops.cameras import get_ray_directions, get_rays

    focal = 0.5 * hw / math.tan(0.5 * math.radians(fovy_deg))
    ro, rd = get_rays(get_ray_directions(hw, hw, focal, device=device), c2w)
    b = (ro * rd).sum(-1)
    disc = b * b - ((ro * ro).sum(-1) - 0.25)
    mask = (disc > 0).float()[:, None]
    hit = ro + (-b - torch.sqrt(disc.clamp_min(0.0)))[:, None] * rd
    rgb = (0.5 + hit) * mask + (1.0 - mask)  # |hit| = 0.5 on the sphere
    return {"ref_rays_o": ro, "ref_rays_d": rd, "ref_rgb": rgb, "ref_mask": mask,
            "ref_light": torch.tensor([0.0, 0.0, 3.0], device=device)}


def drive_stage1(torch, np, hc, card, device):
    """The stage-1 training main path and the export pass.  Returns the
    launch counts of the main path, ms per step, the peak memory, the
    geometry config, the trained parameters and a callable that takes one
    more first-milestone step (for the profile)."""
    from dreammesh4d_tpu_torch.data.uncond import RandomCameraSampler
    from dreammesh4d_tpu_torch.models.geometry.implicit_volume import init_implicit_volume
    from dreammesh4d_tpu_torch.models.renderers.nerf_volume_renderer import (init_occgrid,
                                                                             make_occgrid_update)
    from dreammesh4d_tpu_torch.ops.cameras import make_c2w_numpy
    from dreammesh4d_tpu_torch.ops.hashgrid import progressive_level_mask
    from dreammesh4d_tpu_torch.systems.zero123_system import init_nerf_state, make_zero123_train_step
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves, tree_map

    geo, rcfg, losses, material, cams = stage1_configs()
    ambient_only_steps = 100000  # system.material.ambient_only_steps

    def guidance_stand_in(guidance_state, generator, rgb, batch):
        return ((rgb - 0.5) ** 2).mean()

    steps = {g: make_zero123_train_step(geo, rcfg, losses, material,
                                        guidance_fn=guidance_stand_in if g else None, device=device)
             for g in (True, False)}
    occ_update = make_occgrid_update(geo, rcfg, device=device)
    c2w = torch.as_tensor(make_c2w_numpy(5.0, 0.0, 3.8), device=device)
    refs = {hw: sphere_reference(torch, c2w, hw, 20.0, device) for hw in S1_REF_HW}
    for hw, ref in refs.items():
        cover = float(ref["ref_mask"].mean())
        print(f"stage 1 reference {hw}x{hw}: silhouette covers {cover:.4f} of the pixels")
        check(0.05 < cover < 0.9, "the synthetic reference silhouette is degenerate")
    sampler = RandomCameraSampler(cams, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    state = init_nerf_state(
        init_implicit_volume(geo, torch.Generator(device=device).manual_seed(0), device=device),
        lr=0.01, betas=(0.9, 0.99), eps=1e-8, device=device)
    before = [p.detach().clone() for p in tree_leaves(state.geo_params)]
    occ = [init_occgrid(rcfg, device=device)]
    occ_share = []

    def one_step(state, step, ref_hw, sampler_step, guidance=True):
        """``Zero123Experiment.train_step`` written out: milestone shapes,
        level mask, ambient ratio, the occupancy update, then the step."""
        sampler.update(sampler_step)
        rand = sampler.sample()
        batch = {**refs[ref_hw], "rand_rays_o": rand["rays_o"], "rand_rays_d": rand["rays_d"],
                 "light_positions": rand["light_positions"], "elevation": rand["elevation"],
                 "azimuth": rand["azimuth"], "camera_distances": rand["camera_distances"]}
        lm = progressive_level_mask(geo.hashgrid, step)
        ambient = 1.0 if step < ambient_only_steps else 0.1 + 0.9 * float(np.random.rand())
        updated = step % rcfg.grid_update_every == 0
        if updated:
            occ[0] = occ_update(occ[0], state.geo_params, gen, torch.as_tensor(lm, device=device))
            occ_share.append(float(occ[0].binary.mean()))
        n_rays = batch["ref_rays_o"].shape[0], rand["rays_o"][..., 0].numel()
        return steps[guidance](state, batch, gen, lm, ambient, None, occ[0]), n_rays, updated

    def predicted(n_rays, updated):
        """B4 / B5 launches of one step: an encode per 8192-ray chunk of the
        reference view, two per chunk of the random views (the samples and
        the perturbed samples of the 3D normal smoothness); each encode runs
        once in the forward and once more when its chunk is rematerialised,
        and has one backward; the occupancy update adds one forward."""
        fwd = bwd = 0
        for n, per_chunk in zip(n_rays, (1, 2)):
            encodes = -(-n // S1_CHUNK_RAYS) * per_chunk
            fwd += encodes * (2 if n > S1_CHUNK_RAYS else 1)
            bwd += encodes
        return fwd + int(updated), bwd

    def run(label, n_steps, first_step, ref_hw, sampler_step, guidance, state):
        hc.reset_launch_counts()
        want = [0, 0]
        ms, history = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (state, metrics), n_rays, updated = one_step(state, first_step + i, ref_hw,
                                                         sampler_step, guidance)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            history.append({k: float(v) for k, v in metrics.items()})
            fwd, bwd = predicted(n_rays, updated)
            want[0] += fwd
            want[1] += bwd
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts, plain = dict(hc.launch_counts), dict(hc.plain_counts)
        per_step = predicted(n_rays, False)
        print(f"[{card}] stage 1 {label}: {n_steps} steps, reference {n_rays[0]} rays + random "
              f"{n_rays[1]} rays; launches {json.dumps(counts)}, predicted B4 {want[0]} B5 {want[1]} "
              f"({per_step[0]} + {per_step[1]} per step, + 1 B4 per occupancy update); plain "
              f"versions {json.dumps(plain)}; {statistics.median(ms[1:] or ms):.2f} ms/step (median "
              f"after the first; all: {', '.join(f'{x:.0f}' for x in ms)}); peak memory {peak:.2f} GiB")
        check(counts["hashgrid_cell_fwd"] == want[0], f"{label}: B4 launches != predicted")
        check(counts["hashgrid_cell_bwd"] == want[1], f"{label}: B5 launches != predicted")
        check(sum(plain.values()) == 0, f"{label}: the plain version ran on the card")
        check(all(math.isfinite(v) for m in history for v in m.values()), f"{label}: non-finite metric")
        check(("loss_sds" in history[0]) == guidance, f"{label}: unexpected metrics")
        return state, history, counts, statistics.median(ms[1:] or ms), peak

    results = {}
    state, hist, counts_first, results["first_ms"], results["first_peak"] = run(
        "first milestone", S1_FIRST_STEPS, 0, S1_REF_HW[0], 0, True, state)
    pair = [h["loss_rgb"] + h["loss_mask"] for h in hist]
    print("metrics: " + ", ".join(sorted(hist[0])))
    print(f"  loss_rgb + loss_mask: step 0 {pair[0]:.6g} -> step {len(pair) - 1} {pair[-1]:.6g}; "
          f"psnr {hist[0]['psnr']:.4g} -> {hist[-1]['psnr']:.4g}; occupied share of the grid after "
          f"each update: {', '.join(f'{x:.4f}' for x in occ_share)}")
    check(pair[-1] < pair[0], "loss_rgb + loss_mask did not fall over the first-milestone steps")
    check(len(occ_share) >= 2 and occ_share[1] < 1.0, "the second occupancy update pruned nothing")
    check(state.step == S1_FIRST_STEPS, "the step counter did not advance")
    after = tree_leaves(state.geo_params)
    check(all(bool(torch.isfinite(p).all()) for p in after), "non-finite parameter after training")
    moved = [float((a.detach() - b).abs().max()) for a, b in zip(after, before)]
    print(f"parameters moved (max |delta|): tables {moved[0]:.3g}, MLP leaves "
          f"{min(moved[1:]):.3g}..{max(moved[1:]):.3g}")
    check(min(moved) > 0, "a parameter leaf did not change")

    # the last milestone's shapes from the same state (steps numbered on,
    # so that no occupancy update falls into the timed steps)
    last_step = rcfg.grid_update_every * (S1_FIRST_STEPS // rcfg.grid_update_every + 1) + 1
    milestone = cams.resolution_milestones[-1]
    state, hist_last, counts_last, results["last_ms"], results["last_peak"] = run(
        "last milestone", S1_LAST_STEPS, last_step, S1_REF_HW[1], milestone, True, state)
    snapshot = tree_map(lambda p: p.detach().clone(), state.geo_params)

    def fresh():
        return init_nerf_state(snapshot, lr=0.01, betas=(0.9, 0.99), eps=1e-8, step=last_step + 8,
                               device=device)

    _, _, _, results["first_bare_ms"], _ = run("first milestone, guidance_fn=None", S1_BARE_STEPS,
                                               last_step + 8, S1_REF_HW[0], 0, False, fresh())
    _, _, _, results["last_bare_ms"], _ = run("last milestone, guidance_fn=None", S1_BARE_STEPS,
                                              last_step + 8, S1_REF_HW[1], milestone, False, fresh())
    # all rays at once (no chunks, no rematerialisation) at the first
    # milestone: what the chunking saves
    steps["whole"] = make_zero123_train_step(geo, dataclasses.replace(rcfg, ray_chunk_train=0), losses,
                                             material, guidance_fn=guidance_stand_in, device=device)
    s = fresh()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):  # the first step of this shape also grows the allocator's pool
        hc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (s, _), n_rays, _ = one_step(s, last_step + 8, S1_REF_HW[0], 0, "whole")
        torch.cuda.synchronize()
        results["whole_ms"] = (time.perf_counter() - t0) * 1e3
    results["whole_peak"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] stage 1 first milestone, all {sum(n_rays)} rays at once (ray_chunk_train=0): "
          f"launches per step {json.dumps(hc.launch_counts)}, {results['whole_ms']:.2f} ms (the second "
          f"of two steps), peak memory {results['whole_peak']:.2f} GiB")
    check(hc.launch_counts["hashgrid_cell_fwd"] == 3 and hc.launch_counts["hashgrid_cell_bwd"] == 3,
          "ray_chunk_train=0: expected 3 encodes, each with one backward")

    launches = {k: counts_first[k] + counts_last[k] for k in counts_first}
    profile_state = [fresh()]

    def profiled_step():
        (profile_state[0], _), _, _ = one_step(profile_state[0], last_step + 8, S1_REF_HW[0], 0, True)

    return launches, results, geo, state.geo_params, profiled_step


def drive_export(torch, np, hc, card, geo, params):
    """The export pass: the dense density grid of the isosurface export,
    through B4 (features only), checked at random cells against the plain
    version."""
    from dreammesh4d_tpu_torch.models.geometry import implicit_volume as iv
    from dreammesh4d_tpu_torch.ops.hashgrid import hashgrid_encode_cell

    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = iv.export_density_grid(params, geo, EXPORT_RES)
    seconds = time.perf_counter() - t0
    counts = dict(hc.launch_counts)
    n_chunks = -(-EXPORT_RES ** 3 // 65536)
    check(grid.shape == (EXPORT_RES,) * 3 and np.isfinite(grid).all(), "export: bad density grid")
    check(counts["hashgrid_cell_fwd"] == n_chunks and counts["hashgrid_cell_bwd"] == 0
          and sum(hc.plain_counts.values()) == 0, f"export: launches {counts}, expected {n_chunks} B4")
    rng = np.random.default_rng(0)
    ijk = rng.integers(0, EXPORT_RES, (4096, 3))
    lin = np.linspace(-geo.radius, geo.radius, EXPORT_RES, dtype=np.float32)
    pts = torch.as_tensor(lin[ijk], device=params["density_mlp"][0]["w"].device)
    with torch.no_grad():
        enc = hashgrid_encode_cell(params["encoding"], geo.hashgrid, iv._contract(geo, pts))
        ref = iv._activate_density(geo, iv._mlp_apply(params["density_mlp"], enc)
                                   + iv.density_bias(geo, pts))[:, 0].cpu().numpy()
    got = grid[ijk[:, 0], ijk[:, 1], ijk[:, 2]]
    err = float(np.abs(got - ref).max())
    print(f"[{card}] export_density_grid {EXPORT_RES}^3: {seconds:.2f} s, {counts['hashgrid_cell_fwd']} "
          f"B4 launches (features only), 0 B5; density in [{grid.min():.4g}, {grid.max():.4g}], "
          f"{float((grid > 1.0).mean()):.4f} of the cells above 1; 4096 cells vs the plain version: "
          f"max |d| {err:.3g} (limit 1e-4 x {max(float(np.abs(ref).max()), 1.0):.3g})")
    check(err <= 1e-4 * max(float(np.abs(ref).max()), 1.0), "export: density differs from the plain version")
    check(float((grid > 1.0).mean()) > 0, "export: the grid holds no density")
    return counts["hashgrid_cell_fwd"], seconds


def static_configs():
    """configs/sugar_static_refine.yaml at full width: the geometry, the
    YAML's rasterizer config (``pallas_resident``, 32-px tiles) and the same
    with ``backend: pallas`` and 16 tiles per Gaussian, the loss weights and
    the optimizer's learning rates."""
    from dreammesh4d_tpu_torch.models.geometry.sugar import SuGaRConfig
    from dreammesh4d_tpu_torch.ops.gs.rasterize import RasterizerConfig
    from dreammesh4d_tpu_torch.systems.sugar_static import SugarStaticLosses

    geo = SuGaRConfig(n_gaussians_per_surface_triangle=6, sh_degree=3, init_gs_opacity=0.9,
                      init_gs_scales_s=1.3, spatial_extent=3.8)
    t = math.tan(math.radians(20.0) / 2)
    resident = RasterizerConfig(RES, RES, t, t, tile_capacity=2048, max_tiles_per_gaussian=6,
                                chunk=32, backend="pallas_resident", bf16_matmuls=True,
                                binning="pairs", stream_rows=True, tile_px=32)
    table = resident._replace(backend="pallas", max_tiles_per_gaussian=STATIC_M)
    losses = SugarStaticLosses(
        lambda_sds=0.01, lambda_rgb=1000.0, lambda_mask=100.0, lambda_normal_consistency=10.0,
        lambda_laplacian_smoothing=1.0, lambda_opacity_max=0.0, lambda_rgb_tv=1.0,
        lambda_normal_tv=1.0, lambda_depth_tv=1.0, lambda_depth=0.0, lambda_depth_rel=0.0,
        lambda_normal=0.0, lambda_normal_depth_consistency=0.0)
    optimizer = dict(position_lr=0.00048, scaling_lr=0.005, feature_lr=0.001, opacity_lr=0.02,
                     rotation_lr=0.001, spatial_lr_scale=1.0)
    return geo, resident, table, losses, optimizer


def static_scene(torch, np, device):
    """The refine stage's scene: the icosphere(4) mesh of ``full_width_scene``
    turned by a seeded rotation (no mirror plane of the mesh then holds a
    camera axis, so no two overlapping Gaussians tie in depth) and coloured
    by a smooth seeded field; returns (params, static, target params) — the
    target is the same mesh 2 % larger under a second colour field."""
    from dreammesh4d_tpu_torch.models.geometry.sugar import create_sugar, gaussian_centers
    from dreammesh4d_tpu_torch.ops.sh import rgb_to_sh_dc
    from dreammesh4d_tpu_torch.utils.procedural import make_icosphere

    rng = np.random.default_rng(0)
    mesh = make_icosphere(MESH_LEVEL, radius=0.6)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    mesh.v_pos = (mesh.v_pos @ rot.T).astype(np.float32)
    freq, phase = rng.uniform(2.0, 5.0, (2, 3)), rng.uniform(0.0, 2 * np.pi, (2, 3))
    colour = lambda i: (0.5 + 0.4 * np.sin(freq[i] * mesh.v_pos + phase[i])).astype(np.float32)  # noqa: E731
    mesh.v_rgb = colour(0)
    params, static = create_sugar(static_configs()[0], mesh, device=device)
    pts = gaussian_centers(params.points, static).cpu().numpy()
    rgb = (0.5 + 0.4 * np.sin(freq[1] * pts + phase[1])).astype(np.float32)
    target = params._replace(points=params.points * 1.02,
                             sh_dc=rgb_to_sh_dc(torch.as_tensor(rgb, device=device))[:, None, :])
    return params, static, target


def random_views(torch, np, rng, n, device):
    """``n`` random cameras with the YAML's ranges: elevation [-10, 80]°,
    azimuth [-180, 180]°, distance 3.8, fovy 20°."""
    from dreammesh4d_tpu_torch.data.uncond import assemble_camera_batch

    f32 = dict(dtype=torch.float32, device=device)
    el = np.radians(rng.uniform(-10.0, 80.0, n))
    az = np.radians(rng.uniform(-180.0, 180.0, n))
    pos = torch.as_tensor(3.8 * np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                                          np.sin(el)], -1), **f32)
    up = torch.tensor([0.0, 0.0, 1.0], **f32).expand(pos.shape)
    fovy = torch.full((n,), math.radians(20.0), **f32)
    return assemble_camera_batch(pos, torch.zeros_like(pos), up, fovy, 0.01, 100.0)


def reference_view(torch, device):
    """The refine stage's reference camera: elevation 5°, azimuth 0°, distance 3.8."""
    from dreammesh4d_tpu_torch.data.uncond import assemble_camera_batch

    f32 = dict(dtype=torch.float32, device=device)
    el = math.radians(5.0)
    pos = torch.tensor([[3.8 * math.cos(el), 0.0, 3.8 * math.sin(el)]], **f32)
    up = torch.tensor([[0.0, 0.0, 1.0]], **f32)
    return assemble_camera_batch(pos, torch.zeros_like(pos), up,
                                 torch.full((1,), math.radians(20.0), **f32), 0.01, 100.0)


def captured_table_inputs(torch, tb, render):
    """B6's inputs as the main path hands them over: runs ``render()`` once
    under ``no_grad`` with recorders on ``table_blend.blend_table_cuda`` and
    on the rasterizer's ``bin_gaussians``, and returns the first view's
    (rows, tile_gauss, counts, tiles_x, group, C) and its tile report: the
    largest tile count against K, and the Gaussians whose tile span exceeds
    ``max_tiles_per_gaussian`` at 16 px and the YAML's 6 tiles of 32 px."""
    # the module, not the function the package exports under its name
    rz = importlib.import_module("dreammesh4d_tpu_torch.ops.gs.rasterize")

    blends, binnings = [], []
    real_blend, real_bin = tb.blend_table_cuda, rz.bin_gaussians

    def record_blend(*args):
        blends.append(args)
        return real_blend(*args)

    def record_bin(*args, **kw):
        out = real_bin(*args, **kw)
        binnings.append((args, out))
        return out

    tb.blend_table_cuda, rz.bin_gaussians = record_blend, record_bin
    try:
        with torch.no_grad():
            render()
    finally:
        tb.blend_table_cuda, rz.bin_gaussians = real_blend, real_bin
    check(len(blends) >= 1 and len(binnings) == len(blends), "the render did not reach B6 through the table")
    (means2d, radii, _, mask, _, _, K, M), assign = binnings[0]

    def spans(tile):
        r = radii.float()
        lo = lambda c: torch.floor((c - r) / tile)  # noqa: E731
        hi = lambda c: torch.floor((c + r) / tile) + 1  # noqa: E731
        n = (hi(means2d[:, 0]) - lo(means2d[:, 0])) * (hi(means2d[:, 1]) - lo(means2d[:, 1]))
        return torch.where(mask & (radii > 0), n, torch.zeros_like(n))

    report = {"max_tile_count": int(assign.tile_counts.max()), "K": K,
              "over_M16_at_16px": int((spans(16) > M).sum()),
              "over_M6_at_32px": int((spans(32) > 6).sum()), "visible": int(mask.sum())}
    return blends[0], report


def synthetic_table_inputs(torch, case, device, n_channels):
    """Adversarial (T, K) tables at RES², K = 2048, group 128."""
    from dreammesh4d_tpu_torch.ops.gs.binning import bin_gaussians
    from dreammesh4d_tpu_torch.ops.gs.resident_blend import _pack_rows

    gen = torch.Generator(device=device).manual_seed(2)
    rnd = lambda *s: torch.rand(s, generator=gen, device=device)  # noqa: E731
    full = lambda n, v: torch.full((n,), v, device=device)  # noqa: E731
    tiles, M = RES // 16, 16
    depths = None
    if case == "capacity":  # 2048 faint splats inside one tile (at K), 3000 inside another (over)
        n = 5048
        corner = torch.tensor([[16.0, 16.0]] * 2048 + [[16.0 * (tiles - 3), 16.0 * (tiles // 2)]] * 3000,
                              device=device)
        means = corner + 5.0 + 6.0 * rnd(n, 2)  # radius 5: no pair leaves the tile
        spread, op = full(n, 0.5), full(n, 0.005)
    elif case == "saturated":  # 3000 faint splats inside each tile of a 2x2 block: all four over K, walked to K
        n = 12000
        quad = torch.arange(n, device=device) % 4
        corner = 16.0 * torch.stack([8 + (quad & 1), 8 + (quad >> 1)], -1).float()
        means = corner + 5.0 + 6.0 * rnd(n, 2)
        spread, op = full(n, 0.5), full(n, 0.005)
    elif case == "empty_tiles":  # a small cluster: most tiles hold nothing
        n = 200
        means = 0.1 * RES + 0.1 * RES * rnd(n, 2)
        spread, op = full(n, 0.3), 0.2 + 0.7 * rnd(n)
    elif case == "first_group_exit":  # an opaque wall: the tiles it covers stop after one group
        n = 600
        means = 0.4 * RES + 0.2 * RES * rnd(n, 2)
        spread, op = full(n, 0.002), full(n, 0.99)
        M = tiles * tiles  # every tile the wall reaches holds all of it
    elif case == "opaque_wall":  # every tile stops after its first group
        # in front a grid of sharp wide disks every 16 px (sigma 16 px, op 50:
        # alpha = 0.99 out to 45 px, ~24 of them over each pixel); behind,
        # 60,000 splats, so that every tile (the corners too) holds more than
        # one group
        g = 8.0 + 16.0 * torch.arange(tiles, device=device, dtype=torch.float32)
        wall = torch.stack(torch.meshgrid(g, g, indexing="xy"), -1).reshape(-1, 2)
        n_wall, n_back = wall.shape[0], 60000
        n = n_wall + n_back
        means = torch.cat([wall, RES * rnd(n_back, 2)])
        spread = torch.cat([full(n_wall, 1.0 / 256.0), full(n_back, 0.05)])
        op = torch.cat([full(n_wall, 50.0), 0.2 + 0.7 * rnd(n_back)])
        depths = torch.cat([0.5 + 0.1 * rnd(n_wall), 1.0 + 2.0 * rnd(n_back)])
        M = 64
    elif case == "whole_image":  # one Gaussian reaching every pixel, over small splats
        n = 501
        means = torch.cat([full(1, RES / 2.0)[:, None].expand(1, 2), RES * rnd(n - 1, 2)])
        spread = torch.cat([full(1, 12.0 / RES ** 2), full(n - 1, 0.05)])
        op = torch.cat([full(1, 0.5), 0.2 + 0.7 * rnd(n - 1)])
        M = tiles * tiles
    else:  # "rows_1001": N + 1 = 1001 rows, no multiple of the group
        n = 1000
        means = RES * rnd(n, 2)
        spread, op = 0.01 + 0.05 * rnd(n), 0.2 + 0.7 * rnd(n)
    conics = torch.stack([spread, 0.1 * spread * (rnd(n) - 0.5), spread], -1)
    if depths is None:
        depths = 1.0 + 2.0 * rnd(n)
    radii = torch.ceil(3.0 / torch.sqrt(spread)).int()
    assign = bin_gaussians(means, radii, depths, torch.ones(n, dtype=torch.bool, device=device),
                           RES, RES, 2048, M, conics=conics, opacities=op)
    colors = torch.cat([rnd(n, 6)[:, :n_channels - 1], depths[:, None]], -1)
    rows = _pack_rows(means, conics, colors, op)
    # the raw counts: the kernels cut them at K themselves
    return (rows, assign.tile_gauss, assign.tile_counts, tiles, 128, n_channels)


def table_segment_args(tb, args):
    """B6's inputs as pair segments, the reading B6/B7 and their plain
    versions share (``table_blend._segments``: tile t's segment at t * K):
    (rows, pairs, starts, counts, tiles_x, 16, K, group, C), as B1's wrapper
    and ``check_walked`` take them."""
    rows, tile_gauss, counts, tiles_x, group, C = args
    pairs, starts, _ = tb._segments(tile_gauss, counts)
    return (rows, pairs, starts.int(), counts, tiles_x, 16, tile_gauss.shape[1], group, C)


def grad_group_errors(tb, g_k, g_p, C):
    """B7's error against its plain version per column group (means, conic,
    colours, opacity): [(group, max |d|, the group's max |plain|)]."""
    groups = (("means", slice(0, 2)), ("conic", slice(2, 5)), ("colours", slice(5, 5 + C)),
              ("opacity", slice(tb.OP_COL, tb.OP_COL + 1)))
    return [(name, float((g_k[:, sl] - g_p[:, sl]).abs().max()), float(g_p[:, sl].abs().max()))
            for name, sl in groups]


def check_table(torch, tb, cases):
    """B6 and B7 against their plain versions.  Forward: every channel within
    TABLE_FWD_TOL = 1e-5 — the live tests decide on bit-equal conic
    quadratics and exponentials, and only the accumulation order differs.
    Backward, on a seeded random cotangent: per column group (means, conic,
    colours, opacity) within GRAD_TOL = 1e-4 of the group's max |value| in
    the plain result, as for B2 (atomics in a run-dependent order against
    ``index_add_``).  Both kernels' walked entries per tile must equal the
    plain versions', and so must the rows they composited of those (they do
    not cull).  Returns the worst errors and the work of each case."""
    worst = {"fwd_abs": 0.0, "bwd_rel": 0.0, "bwd_abs": 0.0}
    work = {}
    for name, args in cases.items():
        rows, tile_gauss, counts, tiles_x, group, C = args
        stats_f, stats_b = {}, {}
        walked = {k: new_walked(torch, args) for k in ("B6", "B7")}
        out_k = tb.blend_table_cuda(*args, walked=walked["B6"])
        out_p = tb.blend_table_plain(*args, stats=stats_f)
        torch.cuda.synchronize()
        check(torch.isfinite(out_k).all(), f"B6 {name}: non-finite kernel output")
        err = float((out_k - out_p).abs().max())
        gen = torch.Generator(device=rows.device).manual_seed(5)
        cot = torch.randn(out_p.shape, generator=gen, device=rows.device)
        g_k = tb.blend_table_bwd_cuda(rows, tile_gauss, counts, out_p, cot, tiles_x, group, C,
                                      walked=walked["B7"])
        g_p = tb.blend_table_bwd_plain(rows, tile_gauss, counts, out_p, cot, tiles_x, group, C,
                                       stats=stats_b)
        torch.cuda.synchronize()
        check(torch.isfinite(g_k).all(), f"B7 {name}: non-finite kernel output")
        check(float(g_k[-1].abs().max()) == 0.0, f"B7 {name}: the sentinel row got a gradient")
        check(same_work(stats_f, stats_b), f"B6/B7 {name}: the replay walked other entries than the forward")
        ref = stats_f["walked_per_tile"].to(rows.device)
        for kernel, w in walked.items():
            bad = int((w[:, :, 0].long() != ref).any(0).sum())
            check(bad == 0, f"{kernel} {name} C={C}: the walked or composited entries of {bad} tiles differ "
                  f"from the plain version's walked_per_tile")
        line = []
        for gname, g_err, scale in grad_group_errors(tb, g_k, g_p, C):
            check(g_err <= GRAD_TOL * scale,
                  f"B7 {name} C={C} {gname}: |d| {g_err:.3g} > {GRAD_TOL} x {scale:.3g}")
            worst["bwd_rel"] = max(worst["bwd_rel"], g_err / max(scale, 1e-30))
            worst["bwd_abs"] = max(worst["bwd_abs"], g_err)
            line.append(f"{gname} {g_err / max(scale, 1e-30):.2g}")
        raw = counts.long()
        K = tile_gauss.shape[1]
        print(f"B6/B7 {name} C={C}: tiles {raw.numel()}, entries {int(torch.clamp(raw, max=K).sum())}, "
              f"largest count {int(raw.max())} (K {K}; at K {int((raw == K).sum())}, over "
              f"{int((raw > K).sum())}), empty tiles {int((raw == 0).sum())}, entries walked "
              f"{stats_f['pairs_read']} (B6's and B7's = the plain versions' per tile); B6 max|d| {err:.3g} (limit "
              f"{TABLE_FWD_TOL}); B7 |d| / group max (limit {GRAD_TOL}): " + "; ".join(line))
        check(err <= TABLE_FWD_TOL, f"B6 {name} C={C}: kernel vs plain {err:.3g} > {TABLE_FWD_TOL}")
        worst["fwd_abs"] = max(worst["fwd_abs"], err)
        work[name] = stats_f
    return worst, work


def walked_distribution(stats):
    """The entries each tile walked, summarised: max, mean, 99th percentile
    and the densest tile's share of all walked entries."""
    w = stats["walked_per_tile"].double()
    return {"max": int(w.max()), "mean": float(w.mean()), "p99": float(w.quantile(0.99)),
            "densest_share": float(w.max() / w.sum().clamp(min=1.0))}


def table_bounds(args, stats, backward):
    """The least time the card could take for one B6 or B7 launch on these
    inputs: bytes (the rows and the counts, the index entries the tiles walk,
    the output — or the output, its cotangent and the written gradient
    table — once) over 3.35 TB/s, and FP32 operations over 67 TFLOP/s: 19
    per evaluated (entry, pixel), and per composited one 3 + 2C (B6) or
    24 + 4C (B7), as ``kernel_bounds`` counts them."""
    rows, tile_gauss, counts, _, _, C = args
    T, P = tile_gauss.shape[0], 256
    blocks = (2 if backward else 1) * T * (C + 1) * P
    n_bytes = 4 * (rows.numel() * (2 if backward else 1) + counts.numel() + stats["pairs_read"]
                   + blocks)
    n_ops = stats["pairs_read"] * P * 19 + stats["live_pixels"] * ((24 + 4 * C) if backward
                                                                   else (3 + 2 * C))
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations", n_bytes, n_ops


def drive_static(torch, np, rb, tb, card, scene, device):
    """The static refine main path on both backends from the same start and
    the same batches; ``scene`` is (params, static, target params, reference
    camera).  Returns the results of each backend (metrics, ms/step, peak
    memory, launches) and, for the profiles, a callable per backend that
    takes one more step."""
    from dreammesh4d_tpu_torch.systems.sugar_static import (init_static_state, make_render_eval,
                                                            make_static_train_step)

    _, resident, table, losses, optimizer = static_configs()
    params, static, target, ref_cams = scene
    with torch.no_grad():
        ref = make_render_eval(static, resident, device=device)(target, ref_cams)
    ref_batch = {"ref_cameras": ref_cams, "ref_rgb": ref["comp_rgb"],
                 "ref_mask": (ref["comp_mask"] > 0.5).float()}
    cover = float(ref_batch["ref_mask"].mean())
    print(f"static scene: {params.log_scales.shape[0]} gaussians, reference mask covers {cover:.4f}")
    check(cover > 0.05, "the static reference image is empty")
    rng = np.random.default_rng(1)
    batches = [{**ref_batch, "rand_cameras": random_views(torch, np, rng, STATIC_RAND_VIEWS, device)}
               for _ in range(STATIC_STEPS)]
    views = 1 + STATIC_RAND_VIEWS
    expected = {"pallas_resident": {"resident_fwd": views, "resident_bwd_accum": views},
                "pallas": {"table_fwd": views, "table_bwd": views}}
    results, profiled = {}, {}
    for label, cfg in (("pallas_resident", resident), ("pallas", table)):
        train_step = make_static_train_step(static, cfg, losses, guidance_fn=None, invert_bg_prob=1.0,
                                            device=device)
        state = init_static_state(params, optimizer, device=device)
        before = [p.detach().clone() for p in state.params]
        gen = torch.Generator().manual_seed(0)
        rb.reset_launch_counts()
        tb.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        ms, history = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            history.append({k: float(v) for k, v in metrics.items()})
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {**rb.launch_counts, **tb.launch_counts}
        want = {k: STATIC_STEPS * expected[label].get(k, 0) for k in counts}
        print(f"[{card}] static refine on {label}: {STATIC_STEPS} steps x {views} views, launches "
              f"{json.dumps(counts)}; {statistics.median(ms[1:]):.2f} ms/step (median of steps "
              f"2..{STATIC_STEPS}; all: {', '.join(f'{x:.1f}' for x in ms)}); peak memory {peak:.2f} GiB")
        check(counts == want, f"static refine on {label}: launches {counts} != predicted {want}")
        check(all(math.isfinite(v) for m in history for v in m.values()), f"{label}: non-finite metric")
        check(state.step == STATIC_STEPS, f"{label}: the step counter did not advance")
        moved = [float((a.detach() - b).abs().max()) for a, b in zip(state.params, before)]
        print(f"  metrics: {', '.join(sorted(history[0]))}; loss_rgb step 0 {history[0]['loss_rgb']:.6g} "
              f"-> step {STATIC_STEPS - 1} {history[-1]['loss_rgb']:.6g}, loss_total "
              f"{history[0]['loss_total']:.6g} -> {history[-1]['loss_total']:.6g}; parameters moved "
              f"(max |delta|): " + ", ".join(f"{f} {m:.3g}" for f, m in zip(params._fields, moved)))
        check(history[-1]["loss_rgb"] < history[0]["loss_rgb"], f"{label}: loss_rgb did not fall")
        check(min(moved[:2] + moved[3:4]) > 0, f"{label}: points, scales or colours did not move")
        results[label] = dict(history=history, ms=statistics.median(ms[1:]), peak=peak,
                              launches=counts)
        profiled[label] = one_more_step(train_step, state, batches[0], gen)
    # the two backends' first steps: the same losses on 16-px and 32-px tiles
    first = {label: r["history"][0] for label, r in results.items()}
    worst = 0.0
    for k, ref_v in first["pallas_resident"].items():
        d = abs(first["pallas"][k] - ref_v)
        worst = max(worst, d / max(abs(ref_v), 1e-12))
        check(d <= 3e-3 * abs(ref_v) + 1e-7,
              f"first-step {k}: pallas {first['pallas'][k]:.8g} vs pallas_resident {ref_v:.8g}")
    print(f"first-step metrics, pallas vs pallas_resident: max relative |d| {worst:.3g} (limit 3e-3)")
    return results, profiled


def one_more_step(train_step, state, batch, gen):
    """A callable that advances ``state`` by one step of ``train_step``."""
    box = [state]

    def run():
        box[0] = train_step(box[0], batch, gen)[0]

    return run


def write_obj(path, mesh):
    """``mesh`` as a vertex-coloured OBJ (float32 written exactly)."""
    with open(path, "w") as f:
        for v, c in zip(mesh.v_pos, mesh.v_rgb):
            f.write("v %.9g %.9g %.9g %.9g %.9g %.9g\n" % (*v, *c))
        for t in mesh.t_pos_idx:
            f.write("f %d %d %d\n" % tuple(int(i) + 1 for i in t))


class Spans:
    """Wraps functions and methods in place to time their calls (the card
    synchronised around each) and, for ``train_step``, to record the kernel
    launches of each step; ``close`` puts the originals back."""

    def __init__(self, torch, counts):
        self.torch, self.counts = torch, counts
        self.seconds = {}
        self.steps = []  # (label, step, state.step at entry, ms, launches, metrics)
        self.results = {}
        self._undo = []

    def _patch(self, owner, name, make):
        fn = getattr(owner, name)
        setattr(owner, name, make(fn))
        self._undo.append((owner, name, fn))

    def time(self, owner, name, label, keep=False):
        def make(fn):
            def timed(*a, **kw):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.torch.cuda.synchronize()
                self.seconds.setdefault(label, []).append(time.perf_counter() - t0)
                if keep:
                    self.results.setdefault(label, []).append(out)
                return out
            return timed
        self._patch(owner, name, make)

    def train_steps(self, cls, label):
        def make(fn):
            def timed(exp, step):
                before, at_entry = self.counts(), exp.state.step
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = fn(exp, step)
                self.torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                after = self.counts()
                self.steps.append((label, step, at_entry, ms, {k: after[k] - before[k] for k in after},
                                   {k: float(v) for k, v in metrics.items()}))
                return metrics
            return timed
        self._patch(cls, "train_step", make)

    def close(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)


def drive_launcher(torch, np, rb, tb, card, video, device, tmp):
    """The launcher main path: ``dreammesh4d_tpu_torch.launch.main`` as a
    user calls it, at the YAMLs' full width with the guidance off.  Assets in
    a temporary directory: the icosphere(4, 0.6) bind mesh as an OBJ, and the
    target video of phase 5 (32 frames at 512², moving) as RGBA PNGs written
    by the port's encoder, frame 0 the static stage's reference image.  Runs
    configs/sugar_static_refine.yaml --train (LAUNCH_STEPS steps, a
    checkpoint every LAUNCH_CKPT_EVERY, one validation, then the 120-view
    test), configs/sugar_dynamic_dg.yaml --train with system.weights of its
    last checkpoint, then resume=LAST to LAUNCH_RESUMED_STEPS; then one
    ``Viewer4D.from_trial`` frame against the experiment's own render of the
    same state.  Writes under ``tmp``; returns the numbers of the phase, the
    trials and their dotlists (phase 11 exports them)."""
    import importlib.util

    from dreammesh4d_tpu_torch import launch, trainer
    from dreammesh4d_tpu_torch.data.png import write_png
    from dreammesh4d_tpu_torch.data.temporal_image import TemporalImageDataModule
    from dreammesh4d_tpu_torch.serving import Viewer4D
    from dreammesh4d_tpu_torch.systems import assembly
    from dreammesh4d_tpu_torch.utils.procedural import make_icosphere
    from dreammesh4d_tpu_torch.utils.schedule import C_max

    def counts():
        return {**rb.launch_counts, **tb.launch_counts}

    static_yaml = os.path.join(REPO, "configs", "sugar_static_refine.yaml")
    dyn_yaml = os.path.join(REPO, "configs", "sugar_dynamic_dg.yaml")
    res = {"modules": {m: importlib.util.find_spec(m) is not None
                       for m in ("yaml", "PIL", "imageio", "cv2")}}
    print(f"on this machine: {json.dumps(res['modules'])} (importable; the port needs none of them)")
    mesh_path = os.path.join(tmp, "mesh.obj")
    write_obj(mesh_path, make_icosphere(MESH_LEVEL, radius=0.6))
    frames_dir = os.path.join(tmp, "frames")
    os.makedirs(frames_dir)
    rgba = (torch.cat(video, -1).clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()
    t0 = time.perf_counter()
    for i, frame in enumerate(rgba):
        write_png(os.path.join(frames_dir, f"{i:03d}_rgba.png"), frame)
    res["encode_s"] = time.perf_counter() - t0
    out = os.path.join(tmp, "out")
    common = ["system.guidance.pretrained_model_name_or_path=none",
              f"system.geometry.surface_mesh_to_bind_path={mesh_path}", f"exp_root_dir={out}",
              "use_timestamp=false", f"checkpoint.every_n_train_steps={LAUNCH_CKPT_EVERY}"]
    static_trial = os.path.join(out, "sugar-refine", "static")
    dyn_trial = os.path.join(out, "sugar-dynamic", "dynamic")
    static_ckpt = os.path.join(static_trial, "ckpts", f"step_{LAUNCH_STEPS:08d}")
    dyn = common + [f"data.video_frames_dir={frames_dir}", f"system.weights={static_ckpt}",
                    "tag=dynamic"]
    static = common + [f"data.image_path={frames_dir}/000_rgba.png", f"trainer.max_steps={LAUNCH_STEPS}",
                       f"trainer.val_check_interval={LAUNCH_STEPS}", "tag=static"]
    res["trials"] = {"static": (static_yaml, static_trial, static),
                     "dynamic": (dyn_yaml, dyn_trial, dyn + [f"trainer.max_steps={LAUNCH_RESUMED_STEPS}"])}
    spans = Spans(torch, counts)
    spans.time(launch, "build_experiment", "setup", keep=True)
    for owner, name, label in (
            (assembly, "load_mesh", "mesh load"),
            (assembly.SugarStaticExperiment, "train_batch", "static batch"),
            (assembly.Sugar4DGenExperiment, "train_batch", "dynamic batch"),
            (assembly, "create_sugar", "create_sugar"), (assembly, "build_dynamic_static", "graph"),
            (TemporalImageDataModule, "frames_at", "frame decode"),
            (trainer, "save_checkpoint", "checkpoint save"),
            (trainer, "restore_checkpoint", "checkpoint load (resume)"),
            (assembly, "restore_checkpoint", "checkpoint load (system.weights)"),
            (trainer.Trainer, "fit", "fit"), (trainer.Trainer, "test", "test")):
        spans.time(owner, name, label)
    spans.train_steps(assembly.SugarStaticExperiment, "static")
    spans.train_steps(assembly.Sugar4DGenExperiment, "dynamic")
    rb.reset_launch_counts()
    tb.reset_launch_counts()
    try:
        torch.cuda.reset_peak_memory_stats()
        launch.main(launch.make_args(static_yaml, "train"), static)
        res["static_peak"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        launch.main(launch.make_args(dyn_yaml, "train"), dyn + [f"trainer.max_steps={LAUNCH_STEPS}"])
        launch.main(launch.make_args(dyn_yaml, "train"),
                    dyn + [f"trainer.max_steps={LAUNCH_RESUMED_STEPS}", "resume=LAST"])
        res["dyn_peak"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        spans.close()
    torch.cuda.synchronize()
    res["launches"] = launches = counts()
    print(f"launcher main path launches: {json.dumps(launches)}")
    check(launches["resident_fwd"] > 0 and launches["resident_bwd_accum"] > 0,
          "the launcher path did not launch B1 and B2")
    check(launches["table_fwd"] == launches["table_bwd"] == launches["resident_bwd_pairs"] == 0,
          "the launcher path (backend pallas_resident, bwd_accum) launched another kernel")

    # the checkpoint layout of both trials
    want = {static_trial: [LAUNCH_CKPT_EVERY, LAUNCH_STEPS],
            dyn_trial: list(range(LAUNCH_CKPT_EVERY, LAUNCH_RESUMED_STEPS + 1, LAUNCH_CKPT_EVERY))}
    for trial, steps in want.items():
        got = sorted(os.listdir(os.path.join(trial, "ckpts")))
        check(got == [f"step_{k:08d}" for k in steps], f"{trial}: checkpoints {got}")
        check(all(os.listdir(os.path.join(trial, "ckpts", d)) == ["state.pt"] for d in got),
              f"{trial}: a checkpoint directory holds more than state.pt")
        for name in ("configs/parsed.yaml", "cmd.txt", "metrics.csv", "train_summary.json"):
            check(os.path.exists(os.path.join(trial, name)), f"{trial}: no {name}")

    print(f"checkpoints: {json.dumps({os.path.basename(t): sorted(os.listdir(os.path.join(t, 'ckpts'))) for t in want})}")

    # steps: the resumed run starts where the checkpoint ends; launches per step
    static_exp, dyn_exp = spans.results["setup"][0], spans.results["setup"][-1]
    n_test = static_exp.data.cfg.random_camera.n_test_views
    check(len(os.listdir(os.path.join(static_trial, "save", f"it{LAUNCH_STEPS}-test"))) == n_test,
          f"the static test pass did not write {n_test} views")
    views = {"static": 1 + static_exp.data.cfg.random_camera.batch_size}
    frames = dyn_exp.data.cfg.num_frames
    lw = dyn_exp.losses
    rand_in_loss = any(C_max(w) > 0 for w in (lw.lambda_rgb_tv, lw.lambda_normal_tv, lw.lambda_depth_tv))
    predicted = {"static": {"resident_fwd": views["static"], "resident_bwd_accum": views["static"]},
                 "dynamic": {"resident_fwd": 2 * frames,
                             "resident_bwd_accum": frames * (2 if rand_in_loss else 1)}}
    steps = {label: [s for s in spans.steps if s[0] == label] for label in predicted}
    check([s[1] for s in steps["static"]] == list(range(LAUNCH_STEPS)), "static: steps taken")
    check([s[1] for s in steps["dynamic"]] == list(range(LAUNCH_STEPS)) + list(
        range(LAUNCH_STEPS, LAUNCH_RESUMED_STEPS)), "dynamic: steps taken")
    resumed = steps["dynamic"][LAUNCH_STEPS]
    print(f"resumed run: first step {resumed[1]}, the restored state's step {resumed[2]}")
    check(resumed[1] == resumed[2] == LAUNCH_STEPS, "the resumed run did not start at the saved step")
    for label, rows in steps.items():
        for _, step, _, _, launched, metrics in rows:
            got = {k: v for k, v in launched.items() if v}
            check(got == predicted[label], f"{label} step {step}: launches {got} != {predicted[label]}")
            check(all(math.isfinite(v) for v in metrics.values()), f"{label} step {step}: non-finite metric")
        ms = [r[3] for r in rows]
        batch_ms = [1e3 * x for x in spans.seconds[f"{label} batch"]]
        res[f"{label}_ms"] = statistics.median(ms[1:LAUNCH_STEPS] + ms[LAUNCH_STEPS + 1:])
        res[f"{label}_batch_ms"] = statistics.median(batch_ms[1:LAUNCH_STEPS] + batch_ms[LAUNCH_STEPS + 1:])
        print(f"[{card}] launcher {label} train_step ({json.dumps(predicted[label])} per step): "
              f"{res[f'{label}_ms']:.2f} ms/step (median without each run's first step; all: "
              f"{', '.join(f'{x:.1f}' for x in ms)}), of it the data module's batch "
              f"{res[f'{label}_batch_ms']:.2f} ms (all: {', '.join(f'{x:.1f}' for x in batch_ms)}); "
              f"loss_total step 0 {rows[0][5]['loss_total']:.6g} "
              f"-> step {rows[-1][1]} {rows[-1][5]['loss_total']:.6g}")
    check(dyn_exp.state.step == LAUNCH_RESUMED_STEPS, "the last experiment is not at the last step")

    # the static YAML again on backend: pallas (B6/B7; 16 tiles a Gaussian at 16 px)
    table_run = [x for x in static if not x.startswith("tag=")] + [
        "tag=static_pallas", "system.renderer.backend=pallas",
        f"system.renderer.max_tiles_per_gaussian={STATIC_M}"]
    table_spans = Spans(torch, counts)
    table_spans.train_steps(assembly.SugarStaticExperiment, "static_pallas")
    rb.reset_launch_counts()
    tb.reset_launch_counts()
    try:
        launch.main(launch.make_args(static_yaml, "train"), table_run)
    finally:
        table_spans.close()
    torch.cuda.synchronize()
    res["table_launches"] = {k: v for k, v in counts().items() if v}
    want = {"table_fwd": views["static"], "table_bwd": views["static"]}
    rows = table_spans.steps
    check([s[1] for s in rows] == list(range(LAUNCH_STEPS)), "static on pallas: steps taken")
    for _, step, _, _, launched, metrics in rows:
        got = {k: v for k, v in launched.items() if v}
        check(got == want, f"static on pallas, step {step}: launches {got} != {want}")
        check(all(math.isfinite(v) for v in metrics.values()), f"static on pallas, step {step}: non-finite metric")
    check(not any(k.startswith("resident") for k in res["table_launches"]),
          "the launcher run on backend pallas launched a resident kernel")
    ms = [r[3] for r in rows]
    res["static_pallas_ms"] = statistics.median(ms[1:])
    print(f"[{card}] launcher static train_step on backend pallas ({json.dumps(want)} per step): "
          f"{res['static_pallas_ms']:.2f} ms/step (median without the first step; all: "
          f"{', '.join(f'{x:.1f}' for x in ms)}) beside {res['static_ms']:.2f} on pallas_resident; the run's "
          f"launches (steps, validation, test) {json.dumps(res['table_launches'])}; loss_total step 0 "
          f"{rows[0][5]['loss_total']:.6g} -> step {rows[-1][1]} {rows[-1][5]['loss_total']:.6g}")

    # Viewer4D.from_trial against the experiment's own render of that state
    viewer = Viewer4D.from_trial(dyn_trial, device=device)
    rb.reset_launch_counts()
    tb.reset_launch_counts()
    frame = viewer.render(5.0, 30.0, 3.8, t=0.37)
    torch.cuda.synchronize()
    view_launches = {k: v for k, v in counts().items() if v}
    ts = torch.tensor([0.37], device=device)
    ref = dyn_exp.render(viewer._cameras(5.0, 30.0, 3.8), ts, viewer._frame_indices(ts))["comp_rgb"][0]
    res["from_trial_err"] = float(np.abs(frame - ref).max())
    res["view_launches"] = view_launches
    cover = float((np.abs(frame - 1.0).max(-1) > 1e-3).mean())
    print(f"Viewer4D.from_trial frame: launches {json.dumps(view_launches)}, coverage {cover:.4f}, "
          f"max|d| against the experiment's render {res['from_trial_err']:.3g} (limit 1e-6)")
    check(view_launches == {"resident_fwd": 1}, "from_trial: expected one B1 launch per view")
    check(frame.shape == (RES, RES, 3) and np.isfinite(frame).all() and cover > 0.05,
          "from_trial: empty, non-finite or misshapen frame")
    check(res["from_trial_err"] <= 1e-6, "from_trial renders another state than the experiment")

    sec = spans.seconds
    res["seconds"] = sec
    print(f"[{card}] launcher seconds: setup (build_experiment) static {sec['setup'][0]:.3f}, dynamic "
          f"{fmt_s(sec['setup'][1:])}; of it mesh load {fmt_s(sec['mesh load'])}, create_sugar "
          f"{fmt_s(sec['create_sugar'])}, graph {fmt_s(sec['graph'])}, frame decode ({VIDEO_LEN} frames at {RES}²) "
          f"{fmt_s(x for x in sec['frame decode'] if x > 1e-3)}; checkpoint save {fmt_s(sec['checkpoint save'])}, load "
          f"{fmt_s(sec['checkpoint load (resume)'] + sec['checkpoint load (system.weights)'])}; test "
          f"{fmt_s(sec['test'])}; fit {fmt_s(sec['fit'])}; the smoke's own PNG encode of {VIDEO_LEN} frames "
          f"{res['encode_s']:.3f}")
    print(f"[{card}] launcher peak memory: static {res['static_peak']:.2f} GiB, dynamic "
          f"{res['dyn_peak']:.2f} GiB")
    return res


def drive_recovery_and_export(torch, np, rb, tb, card, launcher, device):
    """(a) The recovery benchmark's ground truth (``render_vertex_color_view``
    of the animated icosphere(3) at 64²) on the card against the same call on
    the CPU at GT_TIMES timestamps, and its ms per view at 64² and 1024²;
    (b) ``recovery.run_recovery`` on ``pallas_resident`` with the steps cut to
    RECOVERY_STEPS (ms/step of both stages at 64², the largest tile count
    against the capacity, every column finite; the full gate is
    ``python3 -m dreammesh4d_tpu_torch.recovery``); (c) ``--export
    resume=LAST`` of phase 9's static and dynamic trials at the YAMLs' full
    width (120 predict views at 1024², texture 1024): the file sets, each
    frame OBJ's vertex and face counts and its vertices against
    ``timed_all``'s, the texture's filled-texel share, the bake's seconds, B1
    launches and peak memory, and the seconds of the OBJ writes and the PNG.
    Launch counts are zeroed before (b) and before (c) and read after each."""
    import tempfile

    from dreammesh4d_tpu_torch import launch, recovery
    from dreammesh4d_tpu_torch.data import png
    from dreammesh4d_tpu_torch.data.temporal_image import frame_timestamps
    from dreammesh4d_tpu_torch.export import texture_bake
    from dreammesh4d_tpu_torch.export.gaussian_io import load_gaussians_ply
    from dreammesh4d_tpu_torch.export.mesh_io import load_obj
    from dreammesh4d_tpu_torch.models.geometry.dynamic_sugar import timed_all
    from dreammesh4d_tpu_torch.ops import cameras as cam_ops
    from dreammesh4d_tpu_torch.ops.mesh_raster import rasterize_mesh
    from dreammesh4d_tpu_torch.systems import assembly
    from dreammesh4d_tpu_torch.utils.procedural import (deform_recovery, make_icosphere,
                                                        render_vertex_color_view)

    def counts():
        return {**rb.launch_counts, **tb.launch_counts}

    res = {}
    # (a) the ground truth, card against CPU
    mesh = make_icosphere(3, radius=0.6)
    L = 16
    worst_share, worst_rgb = 1.0, 0.0
    fov = math.radians(recovery.FOVY)
    for t in frame_timestamps(L)[::L // GT_TIMES][:GT_TIMES]:
        verts = deform_recovery(mesh.v_pos, (float(t) * (L + 1) - 1.0) / L)
        out = {}
        for dev in (device, "cpu"):
            c2w = torch.as_tensor(cam_ops.make_c2w_numpy(recovery.ELEV, recovery.AZIM, recovery.DIST),
                                  device=dev)
            raster = rasterize_mesh(torch.as_tensor(verts, device=dev),
                                    torch.as_tensor(mesh.t_pos_idx, device=dev),
                                    cam_ops.get_cam_info_gaussian(c2w, fov, fov, 0.01, 100.0), 64, 64)
            rgb, mask = render_vertex_color_view(verts, mesh.t_pos_idx, mesh.v_rgb, recovery.ELEV,
                                                 recovery.AZIM, recovery.DIST, recovery.FOVY, 64, 64,
                                                 device=dev)
            out[dev] = (raster.face_idx.cpu().numpy(), rgb, mask)
        same = out[device][0] == out["cpu"][0]
        worst_share = min(worst_share, float(same.mean()))
        worst_rgb = max(worst_rgb, float(np.abs(out[device][1] - out["cpu"][1])[same].max()))
        check(float(out[device][2].mean()) > 0.2, "the ground-truth view is nearly empty")
    res["gt_face_share"], res["gt_rgb_err"] = worst_share, worst_rgb
    print(f"ground truth on the card vs the CPU ({GT_TIMES} timestamps at 64²): face_idx equal on "
          f"{worst_share:.6f} of pixels at worst (limit {GT_FACE_SHARE}), rgb max|d| elsewhere "
          f"{worst_rgb:.3g} (limit {GT_RGB_TOL})")
    check(worst_share >= GT_FACE_SHARE, "ground truth: face_idx differs between the card and the CPU")
    check(worst_rgb <= GT_RGB_TOL, "ground truth: rgb differs between the card and the CPU")
    for hw in GT_SIZES:
        torch.cuda.reset_peak_memory_stats()
        res[f"gt_ms_{hw}"] = time_ms(torch, lambda: render_vertex_color_view(
            mesh.v_pos, mesh.t_pos_idx, mesh.v_rgb, recovery.ELEV, 30.0, recovery.DIST, recovery.FOVY,
            hw, hw, device=device), n=5, warmup=1)
        res[f"gt_peak_{hw}"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{card}] ground-truth view (render_vertex_color_view) at {hw}²: {res[f'gt_ms_{hw}']:.2f} ms, "
              f"peak {res[f'gt_peak_{hw}']:.2f} GiB")

    # (b) the recovery recipe, steps cut
    stats = {}
    rb.reset_launch_counts()
    tb.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        cols = recovery.run_recovery(tmp, static_steps=RECOVERY_STEPS[0], dynamic_steps=RECOVERY_STEPS[1],
                                     device=device, backend="pallas_resident", stats=stats)
    torch.cuda.synchronize()
    res["recovery_launches"] = {k: v for k, v in counts().items() if v}
    res["recovery_stats"], res["recovery"] = stats, cols
    print(f"recovery recipe (pallas_resident, {RECOVERY_STEPS[0]} + {RECOVERY_STEPS[1]} steps) launches: "
          f"{json.dumps(res['recovery_launches'])}")
    print(f"[{card}] recovery recipe at 64²: static {stats['static_ms_per_step']:.2f} ms/step, dynamic "
          f"{stats['dynamic_ms_per_step']:.2f} ms/step; largest tile count of each stage's first render "
          f"{stats['static_max_tile_count']} / {stats['dynamic_max_tile_count']} against capacity "
          f"{stats['tile_capacity']}; seconds: ground truth {stats['gt_assets_s']:.2f}, static "
          f"{stats['static_s']:.2f}, dynamic {stats['dynamic_s']:.2f}, evaluation {stats['eval_s']:.2f}")
    print(f"recovery columns (cut run, not gated; CLIP {recovery.CLIP_NOTE}): {json.dumps(cols)}")
    check(all(math.isfinite(float(v)) for v in cols.values()), "recovery: a non-finite column")
    check(res["recovery_launches"].get("resident_fwd", 0) > 0
          and res["recovery_launches"].get("resident_bwd_accum", 0) > 0,
          "recovery: the recipe did not launch B1 and B2")

    # (c) --export of phase 9's trials
    spans = Spans(torch, counts)
    spans.time(launch, "build_experiment", "setup", keep=True)
    for owner, name, label in ((assembly.SugarStaticExperiment, "export", "static export"),
                               (assembly, "bake_texture", "bake"),
                               (assembly, "export_textured_mesh", "frame OBJ"),
                               (png, "write_png", "texture PNG")):
        spans.time(owner, name, label)
    filled = []
    real_bake_view = texture_bake.bake_view

    def bake_view(tex_acc, tex_w, *a, **kw):
        filled[:] = [tex_w]
        return real_bake_view(tex_acc, tex_w, *a, **kw)

    texture_bake.bake_view = bake_view
    try:
        yaml_path, static_trial, static = launcher["trials"]["static"]
        launch.main(launch.make_args(yaml_path, "export"), static + ["resume=LAST"])
        save = os.path.join(static_trial, "save")
        check(os.path.getsize(os.path.join(save, "refined_mesh.obj")) > 0, "static export: no refined_mesh.obj")
        g = load_gaussians_ply(os.path.join(save, "gaussians.ply"))
        check(g["xyz"].shape == (6 * 20 * 4 ** MESH_LEVEL, 3) and np.isfinite(g["xyz"]).all(),
              f"static export: gaussians.ply holds {g['xyz'].shape}")
        yaml_path, dyn_trial, dyn = launcher["trials"]["dynamic"]
        rb.reset_launch_counts()
        tb.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        launch.main(launch.make_args(yaml_path, "export"), dyn + ["resume=LAST"])
        torch.cuda.synchronize()
        res["export_peak"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        texture_bake.bake_view = real_bake_view
        spans.close()
    res["export_launches"] = launches = {k: v for k, v in counts().items() if v}
    exp = spans.results["setup"][-1]
    n_views = exp.data.cfg.n_predict_views
    print(f"dynamic export launches: {json.dumps(launches)} ({n_views} predict views at "
          f"{exp.data.cfg.predict_height}²)")
    check(launches == {"resident_fwd": n_views}, f"dynamic export: expected {n_views} B1 launches")
    out_dir = os.path.join(dyn_trial, "save", "4d_export")
    L = exp.data.video_length
    names = [f"frame_{i:03d}.obj" for i in range(L)]
    check(sorted(os.listdir(out_dir)) == names + ["material0.mtl", "material0.png"],
          f"dynamic export: files {sorted(os.listdir(out_dir))}")
    with torch.no_grad():
        _, vert = timed_all(exp.sugar_params, exp.state.deform_params, exp.dyn_cfg.deformation, exp.static,
                            torch.as_tensor(frame_timestamps(L), device=device),
                            frame_indices=torch.arange(L, device=device))
    xyz = vert.xyz.cpu().numpy()
    faces = exp.static.sugar.faces.cpu().numpy()
    worst = 0.0
    for i, name in enumerate(names):
        m = load_obj(os.path.join(out_dir, name))
        check(m.v_pos.shape == xyz[i].shape and (m.t_pos_idx == faces).all(),
              f"{name}: {m.v_pos.shape[0]} vertices / {m.t_pos_idx.shape[0]} faces, not the mesh's")
        worst = max(worst, float(np.abs(m.v_pos - xyz[i]).max()))
    res["export_vert_err"] = worst
    tex = png.read_png(os.path.join(out_dir, "material0.png"))
    res["filled_share"] = float((filled[0] > 0).float().mean())
    moved = float(np.abs(xyz[-1] - xyz[0]).max())
    print(f"4D export: {L} frame OBJs of {xyz.shape[1]} vertices / {faces.shape[0]} faces, vertices against "
          f"timed_all max|d| {worst:.3g} (limit {EXPORT_VERT_TOL}); first to last frame moved {moved:.4g}; "
          f"texture {tex.shape}, filled-texel share {res['filled_share']:.4f}")
    check(worst <= EXPORT_VERT_TOL, "4D export: frame vertices differ from timed_all")
    check(tex.shape == (1024, 1024, 3) and res["filled_share"] > 0.05, "4D export: texture empty or misshapen")
    sec = res["export_seconds"] = spans.seconds
    print(f"[{card}] export seconds: static {sec['static export'][0]:.3f}; dynamic bake ({n_views} views at "
          f"{exp.data.cfg.predict_height}², B1 + mesh rasterizer + index_add_) {sec['bake'][0]:.3f}, "
          f"{len(sec['frame OBJ'])} OBJ writes {sum(sec['frame OBJ']):.3f} (of it the texture PNG "
          f"{sum(sec['texture PNG']):.3f}); setup (build_experiment) {fmt_s(sec['setup'])}; peak memory "
          f"{res['export_peak']:.2f} GiB")
    return res


def fmt_s(xs):
    return ", ".join(f"{x:.3f}" for x in xs)


def time_kernels(torch, rb, tb, path):
    """``--time-kernels TREE FILE``, which ``compare_trees`` runs in a
    process of its own: device time (``device_ms``; None where the profiler
    kept no record) and CUDA-event time (ten launches a pair) of B6/B7 on
    every table case in FILE (C = 7 and 4) and of B1 (C = 7) and B2 (C = 4
    and 7) on its pair main views, launched through the wrappers of TREE's
    package with the arguments every tree's wrappers take.  B6 and B7 are
    held to that package's plain versions first, as in ``check_table``.
    Prints {"kernel C=.. case": [device ms, ms]} as its last line."""
    saved = torch.load(path)
    res = {}

    def timed(kernel, C, case, run):
        res[f"{kernel} C={C} {case}"] = [device_ms(torch, run, f"{kernel}_kernel", required=False),
                                         time_ms(torch, run, reps=10)]

    for C, cases in saved["tables"].items():
        for case, a in cases.items():
            rows, tile_gauss, counts, tiles_x, group, _ = a
            out = tb.blend_table_plain(*a)
            err = float((tb.blend_table_cuda(*a) - out).abs().max())
            check(err <= TABLE_FWD_TOL, f"B6 {case} C={C}: kernel vs plain {err:.3g} > {TABLE_FWD_TOL}")
            cot = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(5),
                              device=out.device)
            bwd = lambda: tb.blend_table_bwd_cuda(rows, tile_gauss, counts, out, cot, tiles_x, group, C)  # noqa: E731
            g_p = tb.blend_table_bwd_plain(rows, tile_gauss, counts, out, cot, tiles_x, group, C)
            for gname, g_err, scale in grad_group_errors(tb, bwd(), g_p, C):
                check(g_err <= GRAD_TOL * scale, f"B7 {case} C={C} {gname}: |d| {g_err:.3g} > {GRAD_TOL} x {scale:.3g}")
            timed("table_fwd", C, case, lambda: tb.blend_table_cuda(*a))
            timed("table_bwd", C, case, bwd)
    for C, a in saved["pairs"].items():
        out = rb.blend_pairs_cuda(*a)
        cot = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(5), device=out.device)
        if C == 7:  # B1 serves C = 7
            timed("resident_fwd", C, "main_view", lambda: rb.blend_pairs_cuda(*a))
        timed("resident_bwd", C, "main_view", lambda: rb.blend_pairs_bwd_cuda(*a[:4], out, cot, *a[4:]))
    print(json.dumps(res))


def compare_trees(torch, table_cases, pair_views, parent, card):
    """``--parent DIR``: the kernels of an unpacked parent tree (``git
    archive``) against this tree's on the same inputs, each tree's through
    its own wrappers in a process of its own (``time_kernels``), in the
    order parent, this, this, parent.  Prints every kernel's readings and
    returns {"kernel C=.. case": {"parent": [[device ms, ms], ..], "this":
    ..}}."""
    parent = os.path.abspath(parent)
    check(os.path.isfile(os.path.join(parent, "dreammesh4d_tpu_torch", "ops", "gs", "table_blend.py")),
          f"--parent {parent}: no port there")
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "cases.pt")
    torch.save({"tables": table_cases, "pairs": pair_views}, path)
    results = {}
    for label, tree in (("parent", parent), ("this", REPO), ("this", REPO), ("parent", parent)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-kernels", tree, path],
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"--time-kernels {tree} exited {proc.returncode}:\n"
              f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        for key, reading in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            results.setdefault(key, {}).setdefault(label, []).append(reading)
        print(f"[{card}] kernels of {label} ({tree}) timed in {time.perf_counter() - t0:.1f} s")
    tmp.cleanup()
    fmt = lambda xs: ", ".join("not measured" if x is None else f"{x:.4f}" for x in xs)  # noqa: E731
    for key, r in results.items():
        print(f"[{card}] {key}: " + "; ".join(
            f"{label} device {fmt([x[0] for x in xs])} ms, events {fmt([x[1] for x in xs])} ms"
            for label, xs in r.items()))
    print("tree comparison: " + json.dumps(results))
    return results


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
    import argparse

    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port.")
    parser.add_argument("--parent", metavar="DIR", help="an unpacked parent tree: time its B1/B2/B6/B7 "
                        "against this tree's in phase 10 (compare_trees)")
    parser.add_argument("--time-kernels", nargs=2, metavar=("TREE", "FILE"),
                        help="only time TREE's kernels on the inputs in FILE (time_kernels)")
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    import numpy as np

    sys.path.insert(0, opts.time_kernels[0] if opts.time_kernels else REPO)
    if opts.time_kernels:
        from dreammesh4d_tpu_torch.ops.gs import resident_blend as rb
        from dreammesh4d_tpu_torch.ops.gs import table_blend as tb

        time_kernels(torch, rb, tb, opts.time_kernels[1])
        return
    try:
        from dreammesh4d_tpu_torch import cuda_build
        from dreammesh4d_tpu_torch.ops import hashgrid_cell as hc
        from dreammesh4d_tpu_torch.ops.gs import resident_blend as rb
        from dreammesh4d_tpu_torch.ops.gs import table_blend as tb
        from dreammesh4d_tpu_torch.models.geometry.sugar import gaussian_attributes
        from dreammesh4d_tpu_torch.models.renderers.sugar_rasterizer import render_batch
        from dreammesh4d_tpu_torch.serving import Viewer4D
        from dreammesh4d_tpu_torch.systems.sugar_static import make_render_eval
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
            **{case: synthetic_blend_inputs(torch, case, dev, C)
               for case in ("saturated", "empty_tiles", "quadrant_wall", "cull_edges")},
            **{case: recovery_blend_inputs(torch, case, dev, C)
               for case in ("recovery_view", "saturated16")}}
    b1_err, main_stats, b1_kept = check_forward(torch, rb, cases[7])
    check(int((cases[7]["saturated"][3] > 2048).sum()) >= 1, "saturated case has no saturated tile")
    check(int((cases[7]["empty_tiles"][3] == 0).sum()) >= 1, "empty-tile case has no empty tile")
    for case in ("recovery_view", "saturated16"):
        check(int((cases[7][case][3] > 512).sum()) >= 1, f"{case}: no tile over the capacity of 512")
    check_quadrant_wall(torch, rb, cases[7]["quadrant_wall"])
    bwd_err, bwd_work, bwd_kept = {}, {}, {}
    for C in (7, 4):
        errs, bwd_work[C], bwd_kept[C] = check_backward(torch, rb, cases[C])
        for k, (rel, absolute) in errs.items():
            old = bwd_err.get(k, (0.0, 0.0))
            bwd_err[k] = (max(old[0], rel), max(old[1], absolute))

    hg_cases = hashgrid_cases(torch, stage1_configs()[4], dev)
    hg_err = check_hashgrid(torch, hc, hg_cases)

    # B6/B7 at the static refine scene's reference view, and adversarial tables
    static_params, static_sugar, static_target = static_scene(torch, np, dev)
    ref_cams = reference_view(torch, dev)
    table_cfg = static_configs()[2]
    # C = 7: the static step's blend (rgb, face normals, depth) through its
    # evaluation render; C = 4: the rgb-only blend of ``render_batch``
    render_eval = make_render_eval(static_sugar, table_cfg, device=dev)
    attrs = gaussian_attributes(static_params, static_sugar)
    white = torch.ones(3, device=dev)
    main_views = {
        7: captured_table_inputs(torch, tb, lambda: render_eval(static_params, ref_cams)),
        4: captured_table_inputs(torch, tb, lambda: render_batch(
            attrs.means3d, attrs.quats, attrs.scales, attrs.opacities, attrs.sh, static_sugar.sh_degree,
            None, ref_cams, white, table_cfg))}
    report = main_views[7][1]
    table_cases = {}
    for C in (7, 4):
        table_cases[C] = {"main_view": main_views[C][0]}
        check(main_views[C][0][-1] == C, f"the captured main-view blend has {main_views[C][0][-1]} channels, not {C}")
        for case in ("capacity", "saturated", "empty_tiles", "first_group_exit", "opaque_wall", "whole_image",
                     "rows_1001"):
            table_cases[C][case] = synthetic_table_inputs(torch, case, dev, C)
    print(f"static scene, reference view, backend pallas: {json.dumps(report)} (largest tile count "
          f"against K; Gaussians whose tile span exceeds 16 tiles of 16 px, and 6 of 32 px)")
    table_err, table_work = {"fwd_abs": 0.0, "bwd_rel": 0.0, "bwd_abs": 0.0}, {}
    for C in (7, 4):
        worst, table_work[C] = check_table(torch, tb, table_cases[C])
        table_err = {k: max(v, worst[k]) for k, v in table_err.items()}
    cap_counts = table_cases[7]["capacity"][2]
    check(int((cap_counts == 2048).sum()) >= 1 and int((cap_counts > 2048).sum()) >= 1,
          "the capacity case has no tile at K and none over it")
    sat_over = table_cases[7]["saturated"][2] > 2048
    check(int(sat_over.sum()) >= 4 and bool((table_work[7]["saturated"]["walked_per_tile"][sat_over] == 2048).all()),
          "the saturated case has fewer than 4 tiles over K, or one stopped before K")
    wall_counts, wall_walked = table_cases[7]["opaque_wall"][2], table_work[7]["opaque_wall"]["walked_per_tile"]
    check(bool((wall_counts > 128).all()) and bool((wall_walked == 128).all()),
          "opaque_wall: a tile holds one group or less, or did not stop after its first group")
    walked_dist = {C: walked_distribution(table_work[C]["main_view"]) for C in (7, 4)}
    print(f"B6/B7 main view, entries walked per tile (T {table_cases[7]['main_view'][1].shape[0]}): "
          f"C=7 {json.dumps(walked_dist[7])}, C=4 {json.dumps(walked_dist[4])}")
    check(int((table_cases[7]["empty_tiles"][2] == 0).sum()) >= 1, "the empty-tile case has no empty tile")
    wall = table_cases[7]["first_group_exit"]
    check(table_work[7]["first_group_exit"]["pairs_read"] < int(torch.clamp(wall[2], max=2048).sum()),
          "the opaque wall did not stop any tile early")
    check(int((table_cases[7]["whole_image"][2] > 0).sum()) == table_cases[7]["whole_image"][2].numel(),
          "the whole-image Gaussian does not reach every tile")

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
    # the same frame with backend: pallas (16-px tiles, the (T, K) table, B6)
    table_viewer = Viewer4D(params, static, dparams, dyn_cfg,
                            raster_cfg._replace(backend="pallas", max_tiles_per_gaussian=STATIC_M),
                            RES, RES, 20.0, VIDEO_LEN, device=dev)
    rb.reset_launch_counts()
    tb.reset_launch_counts()
    table_frame = table_viewer.render(5.0, 0.0, 3.8, t=0.0)
    torch.cuda.synchronize()
    serving_table = {**rb.launch_counts, **tb.launch_counts}
    table_render_err = float(np.abs(table_frame - frame0).max())
    print(f"render with backend pallas: launches {json.dumps(serving_table)}; vs the pallas_resident "
          f"frame max|d| {table_render_err:.3g} (limit 7e-4)")
    check(serving_table == {"resident_fwd": 0, "resident_bwd_accum": 0, "resident_bwd_pairs": 0,
                            "table_fwd": 1, "table_bwd": 0}, "backend pallas: expected one B6 launch")
    check(table_render_err <= 7e-4, "backend pallas and pallas_resident frames differ by more than 7e-4")

    # 5. the training main path
    make_step, video, sample_batch = training_setup(torch, np, viewer, params, static, dparams,
                                                    dyn_cfg, raster_cfg, dev)
    print(f"target video: {tuple(video[0].shape)} on {video[0].device}, "
          f"mask coverage {float(video[1].mean()):.4f}")
    check(float(video[1].mean()) > 0.05, "the target video is empty")
    train_launches, pair_launches, step_ms, bare_step_ms, one_step = drive_training(
        torch, np, rb, card, make_step, sample_batch, dparams, dev)

    # 6. the stage-1 training main path, 7. the export pass
    s1_launches, s1, s1_geo, s1_params, s1_step = drive_stage1(torch, np, hc, card, dev)
    export_launches, export_s = drive_export(torch, np, hc, card, s1_geo, s1_params)

    # 8. the static refine main path on both backends
    static_res, static_steps = drive_static(torch, np, rb, tb, card,
                                            (static_params, static_sugar, static_target, ref_cams), dev)

    # 9. the launcher main path: both Gaussian YAMLs through dreammesh4d_tpu_torch.launch.main
    launch_tmp = tempfile.TemporaryDirectory()  # phase 11 exports the trials
    launcher = drive_launcher(torch, np, rb, tb, card, video, dev, launch_tmp.name)
    print(f"[{card}] launcher ms/step: static {launcher['static_ms']:.2f} (direct make_static_train_step "
          f"on pallas_resident, phase 8: {static_res['pallas_resident']['ms']:.2f}); static on pallas "
          f"{launcher['static_pallas_ms']:.2f} (direct, phase 8: {static_res['pallas']['ms']:.2f}); dynamic "
          f"{launcher['dynamic_ms']:.2f} (direct make_dynamic_train_step with guidance_fn=None, phase 5: "
          f"{bare_step_ms:.2f})")
    del video

    # 10. times (CUDA events, median of 30 after warm-up)
    args = cases[7]["main_view"]
    b1_ms = time_ms(torch, lambda: rb.blend_pairs_cuda(*args))
    b1_more = {"ms_r10": time_ms(torch, lambda: rb.blend_pairs_cuda(*args), reps=10),
               "device_ms": device_ms(torch, lambda: rb.blend_pairs_cuda(*args), "resident_fwd_kernel")}
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
    # the kernels' own counts of the rows their cull kept (phase 3)
    kept = {"resident_fwd": b1_kept, "resident_bwd": bwd_kept[4]["main_view"]}
    print(f"[{card}] B1 resident_fwd: {b1_ms:.4f} ms one launch per event pair, {b1_more['ms_r10']:.4f} ms "
          f"per launch of ten, {b1_more['device_ms']:.4f} ms device time (plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by}: {n_bytes} B, {n_ops} ops; the cull kept {kept['resident_fwd']:.4f} "
          f"of the (pair, quadrant) evaluations)")
    bwd, bwd_more = {}, {}
    for C in (4, 7):  # the train step blends C = 4, serving C = 7
        a = cases[C]["main_view"]
        seg, shape = a[:4], a[4:]
        out = rb.blend_pairs_cuda(*a)
        cot = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        plain_bwd_ms = time_ms(torch, lambda: rb.blend_pairs_bwd_plain(*seg, out, cot, *shape), n=10)
        for kernel, per_pair in (("resident_bwd_accum", False), ("resident_bwd_pairs", True)):
            run = lambda: rb.blend_pairs_bwd_cuda(*seg, out, cot, *shape, per_pair=per_pair)  # noqa: E731
            ms = time_ms(torch, run)
            more = bwd_more[kernel, C] = {"ms_r10": time_ms(torch, run, reps=10),
                                          "device_ms": device_ms(torch, run, "resident_bwd_kernel")}
            b_ms, b_by, nb, no = kernel_bounds(a, bwd_work[C]["main_view"], a[0].shape[0], per_pair)
            bwd[kernel, C] = (ms, plain_bwd_ms, b_ms, b_by)
            print(f"[{card}] {'B3' if per_pair else 'B2'} {kernel} C={C}: {ms:.4f} ms one launch per event "
                  f"pair, {more['ms_r10']:.4f} ms per launch of ten, {more['device_ms']:.4f} ms device time "
                  f"(plain backward {plain_bwd_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}: {nb} B, {no} ops)")
        pp = rb.blend_pairs_bwd_cuda(*seg, out, cot, *shape, per_pair=True)
        red_ms = time_ms(torch, lambda: rb.reduce_pair_grads(pp, *seg[1:], seg[0].shape[0]))
        print(f"[{card}] B3's reduction outside the kernel (index_add_ of {pp.shape[0] * pp.shape[1]} "
              f"rows) C={C}: {red_ms:.4f} ms")
    hg_cfg, hg_tables, hg_x, _ = hg_cases["main_chunk"]
    hg_bound, hg_rows = hashgrid_bounds(torch, hg_cfg, hg_x)
    gen5 = torch.Generator(device=dev).manual_seed(5)
    g_f = torch.randn((hg_x.shape[0], hg_cfg.out_dim), generator=gen5, device=dev)
    g_d = torch.randn((hg_x.shape[0], hg_cfg.out_dim, 3), generator=gen5, device=dev)
    hg_ms = {
        "hashgrid_cell_fwd": (time_ms(torch, lambda: hc.encode_cell_fwd_cuda(hg_tables, hg_x, hg_cfg), reps=10),
                              time_ms(torch, lambda: hc.encode_cell_fwd_plain(hg_tables, hg_x, hg_cfg), n=5)),
        "hashgrid_cell_bwd": (time_ms(torch, lambda: hc.encode_cell_bwd_cuda(hg_x, hg_cfg, g_f, g_d), reps=10),
                              time_ms(torch, lambda: hc.encode_cell_bwd_plain(hg_x, hg_cfg, g_f, g_d), n=5)),
    }
    hg_dev = {"hashgrid_cell_fwd": device_ms(torch, lambda: hc.encode_cell_fwd_cuda(hg_tables, hg_x, hg_cfg),
                                             "hashgrid_cell_fwd_kernel"),
              "hashgrid_cell_bwd": device_ms(torch, lambda: hc.encode_cell_bwd_cuda(hg_x, hg_cfg, g_f, g_d),
                                             "hashgrid_cell_bwd_kernel")}
    feats_only_ms = time_ms(
        torch, lambda: hc.encode_cell_fwd_cuda(hg_tables, hg_x, hg_cfg, with_dfeats=False), reps=10)
    bwd_feats_only_ms = time_ms(torch, lambda: hc.encode_cell_bwd_cuda(hg_x, hg_cfg, g_f, None), reps=10)
    gathered = 64 * hg_x.shape[0] * hg_cfg.n_levels
    for kernel, kid in (("hashgrid_cell_fwd", "B4"), ("hashgrid_cell_bwd", "B5")):
        b_ms, b_by, nb, no = hg_bound[kernel]
        print(f"[{card}] {kid} {kernel} at {hg_x.shape[0]} points x {hg_cfg.n_levels} levels: "
              f"{hg_ms[kernel][0]:.4f} ms, {hg_dev[kernel]:.4f} ms device time (plain {hg_ms[kernel][1]:.4f} ms; "
              f"bound {b_ms:.4f} ms by {b_by}: "
              f"{nb} B with the {hg_rows} rows touched read once, {no} ops; {gathered} B of rows are "
              f"gathered)")
    print(f"[{card}] B4 features only (with_dfeats=False): {feats_only_ms:.4f} ms; B5 from g_feats only: "
          f"{bwd_feats_only_ms:.4f} ms")
    print(f"[{card}] Viewer4D.render {RES}x{RES}: {render_ms:.3f} ms; play({VIDEO_LEN}): {play_ms:.2f} ms "
          f"= {VIDEO_LEN * 1e3 / play_ms:.1f} frames/s")
    print(f"[{card}] train step: {step_ms:.2f} ms/step")
    profile_call(torch, "render", lambda: viewer.render(5.0, 0.0, 3.8, t=0.25), card)
    profile_call(torch, "train step", one_step, card)
    print(f"[{card}] stage-1 train step: first milestone {s1['first_ms']:.2f} ms/step "
          f"({s1['first_bare_ms']:.2f} with guidance_fn=None; {s1['whole_ms']:.2f} unchunked), peak "
          f"{s1['first_peak']:.2f} GiB (unchunked {s1['whole_peak']:.2f} GiB); last milestone "
          f"{s1['last_ms']:.2f} ms/step ({s1['last_bare_ms']:.2f} with guidance_fn=None), peak "
          f"{s1['last_peak']:.2f} GiB; export {EXPORT_RES}^3: {export_s:.2f} s")
    profile_call(torch, "stage-1 train step (first milestone)", s1_step, card)
    table_ms, table_dev = {}, {}
    for C in (7, 4):
        a = table_cases[C]["main_view"]
        rows, tile_gauss, counts, tiles_x, group, _ = a
        out = tb.blend_table_cuda(*a)
        cot = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        for kernel, kid, run, plain, backward in (
                ("table_fwd", "B6", lambda: tb.blend_table_cuda(*a), lambda: tb.blend_table_plain(*a), False),
                ("table_bwd", "B7", lambda: tb.blend_table_bwd_cuda(rows, tile_gauss, counts, out, cot,
                                                                    tiles_x, group, C),
                 lambda: tb.blend_table_bwd_plain(rows, tile_gauss, counts, out, cot, tiles_x, group, C),
                 True)):
            ms = time_ms(torch, run, reps=10)
            table_dev[kernel, C] = device_ms(torch, run, f"{kernel}_kernel")
            p_ms = time_ms(torch, plain, n=5)
            b_ms, b_by, nb, no = table_bounds(a, table_work[C]["main_view"], backward)
            table_ms[kernel, C] = (ms, p_ms, b_ms, b_by)
            print(f"[{card}] {kid} {kernel} C={C} (T {tile_gauss.shape[0]}, K {tile_gauss.shape[1]}, "
                  f"{table_work[C]['main_view']['pairs_read']} entries walked): {ms:.4f} ms, "
                  f"{table_dev[kernel, C]:.4f} ms device time (plain "
                  f"{p_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}: {nb} B, {no} ops)")
    # the cull, measured: B6's main views through B1's and B2's entries, the
    # same bodies with the box cull on (and the compiler's unroll)
    for C in (7, 4):
        a = table_cases[C]["main_view"]
        seg = table_segment_args(tb, a)
        walked = new_walked(torch, seg)
        out = rb.blend_pairs_cuda(*seg, walked=walked)
        err = float((out - tb.blend_table_plain(*a)).abs().max())
        check(err <= TABLE_FWD_TOL, f"B1 over B6's main view C={C}: kernel vs plain {err:.3g} > {TABLE_FWD_TOL}")
        box_kept = check_walked(torch, rb, "B1", f"over B6's main view C={C}", walked,
                                table_work[C]["main_view"], seg)
        cot = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        culled = {"B1": device_ms(torch, lambda: rb.blend_pairs_cuda(*seg), "resident_fwd_kernel"),
                  "B2": device_ms(torch, lambda: rb.blend_pairs_bwd_cuda(*seg[:4], out, cot, *seg[4:]),
                                  "resident_bwd_kernel")}
        print(f"[{card}] B6's main view C={C} through B1/B2 (box cull on; kept {box_kept:.4f} of the walked "
              f"entries, = quadrant_kept_plain per tile): device time B1 {culled['B1']:.4f} ms, B2 "
              f"{culled['B2']:.4f} ms, beside B6 {table_dev['table_fwd', C]:.4f} ms, B7 "
              f"{table_dev['table_bwd', C]:.4f} ms without the cull")
    if opts.parent:
        compare_trees(torch, table_cases, {C: cases[C]["main_view"] for C in (7, 4)}, opts.parent, card)
    for label, r in static_res.items():
        print(f"[{card}] static refine step on {label} (1 + {STATIC_RAND_VIEWS} views at {RES}x{RES}): "
              f"{r['ms']:.2f} ms/step, peak memory {r['peak']:.2f} GiB")
        profile_call(torch, f"static refine step ({label})", static_steps[label], card)

    # 11. the recovery recipe and the exports of phase 9's trials
    recov = drive_recovery_and_export(torch, np, rb, tb, card, launcher, dev)
    launch_tmp.cleanup()

    # 12. result lines
    def entry(name, kid, source, replaces, tpu, n_launches, err, ms, plain, b_ms, b_by, **extra):
        return {"name": name, "id": kid, "route": "cuda", "source": source, "replaces": replaces,
                "tpu": tpu, "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **extra}

    bwd_src = "dreammesh4d_tpu_torch/csrc/resident_bwd.cu"
    hg_src = "dreammesh4d_tpu_torch/csrc/hashgrid_cell.cu"
    static_table = static_res["pallas"]["launches"]
    table_launcher = launcher["table_launches"]
    static_resident = static_res["pallas_resident"]["launches"]
    b2, b3 = bwd["resident_bwd_accum", 4], bwd["resident_bwd_pairs", 4]
    print(json.dumps({"kernels": [
        entry("resident_fwd", "B1", "dreammesh4d_tpu_torch/csrc/resident_fwd.cu",
              "dreammesh4d_tpu/ops/gs/pallas_resident.py:121", "ops/gs/pallas_resident.py::_fwd_kernel",
              launches["resident_fwd"] + train_launches["resident_fwd"] + launcher["launches"]["resident_fwd"]
              + recov["recovery_launches"]["resident_fwd"] + recov["export_launches"]["resident_fwd"],
              b1_err, b1_ms, plain_ms, bound_ms, bound_by, max_abs_diff=b1_err,
              launches_serving=launches["resident_fwd"], launches_training=train_launches["resident_fwd"],
              launches_static=static_resident["resident_fwd"],
              launches_launcher=launcher["launches"]["resident_fwd"],
              launches_recovery=recov["recovery_launches"]["resident_fwd"],
              launches_export=recov["export_launches"]["resident_fwd"], cull_kept=kept["resident_fwd"],
              **b1_more),
        entry("resident_bwd_accum", "B2", bwd_src, "dreammesh4d_tpu/ops/gs/pallas_resident.py:248",
              "ops/gs/pallas_resident.py::_bwd_kernel_accum",
              train_launches["resident_bwd_accum"] + launcher["launches"]["resident_bwd_accum"]
              + recov["recovery_launches"]["resident_bwd_accum"],
              bwd_err["resident_bwd_accum"][1], *b2, max_rel_err=bwd_err["resident_bwd_accum"][0],
              n_channels=4, ms_c7=bwd["resident_bwd_accum", 7][0],
              launches_static=static_resident["resident_bwd_accum"],
              launches_launcher=launcher["launches"]["resident_bwd_accum"],
              launches_recovery=recov["recovery_launches"]["resident_bwd_accum"], cull_kept=kept["resident_bwd"],
              **bwd_more["resident_bwd_accum", 4],
              device_ms_c7=bwd_more["resident_bwd_accum", 7]["device_ms"]),
        entry("resident_bwd_pairs", "B3", bwd_src, "dreammesh4d_tpu/ops/gs/pallas_resident.py:173",
              "ops/gs/pallas_resident.py::_bwd_kernel", pair_launches["resident_bwd_pairs"],
              bwd_err["resident_bwd_pairs"][1], *b3, max_rel_err=bwd_err["resident_bwd_pairs"][0],
              n_channels=4, ms_c7=bwd["resident_bwd_pairs", 7][0], cull_kept=kept["resident_bwd"],
              **bwd_more["resident_bwd_pairs", 4],
              device_ms_c7=bwd_more["resident_bwd_pairs", 7]["device_ms"]),
        entry("hashgrid_cell_fwd", "B4", hg_src, "dreammesh4d_tpu/ops/hashgrid_pallas.py:224",
              "ops/hashgrid_pallas.py::_fwd_kernel", s1_launches["hashgrid_cell_fwd"],
              hg_err["fwd_abs"], *hg_ms["hashgrid_cell_fwd"], *hg_bound["hashgrid_cell_fwd"][:2],
              max_rel_err=hg_err["dfeats_rel"], max_rel_err_feats=hg_err["feats_rel"],
              launches_export=export_launches, ms_features_only=feats_only_ms,
              device_ms=hg_dev["hashgrid_cell_fwd"]),
        entry("hashgrid_cell_bwd", "B5", hg_src, "dreammesh4d_tpu/ops/hashgrid_pallas.py:251",
              "ops/hashgrid_pallas.py::_bwd_kernel", s1_launches["hashgrid_cell_bwd"],
              hg_err["bwd_abs"], *hg_ms["hashgrid_cell_bwd"], *hg_bound["hashgrid_cell_bwd"][:2],
              max_rel_err=hg_err["bwd_rel"], ms_g_feats_only=bwd_feats_only_ms,
              device_ms=hg_dev["hashgrid_cell_bwd"]),
        entry("table_fwd", "B6", "dreammesh4d_tpu_torch/csrc/resident_fwd.cu",
              "dreammesh4d_tpu/ops/gs/pallas_blend.py:286", "ops/gs/pallas_blend.py::_fwd_kernel",
              static_table["table_fwd"] + serving_table["table_fwd"],
              table_err["fwd_abs"], *table_ms["table_fwd", 7], n_channels=7,
              launches_static=static_table["table_fwd"], launches_serving=serving_table["table_fwd"],
              launches_launcher=table_launcher.get("table_fwd", 0),
              ms_c4=table_ms["table_fwd", 4][0], device_ms=table_dev["table_fwd", 7],
              device_ms_c4=table_dev["table_fwd", 4], walked_per_tile=walked_dist[7]),
        entry("table_bwd", "B7", "dreammesh4d_tpu_torch/csrc/resident_bwd.cu",
              "dreammesh4d_tpu/ops/gs/pallas_blend.py:316", "ops/gs/pallas_blend.py::_bwd_kernel",
              static_table["table_bwd"], table_err["bwd_abs"],
              *table_ms["table_bwd", 7], max_rel_err=table_err["bwd_rel"], n_channels=7,
              launches_static=static_table["table_bwd"], launches_launcher=table_launcher.get("table_bwd", 0),
              ms_c4=table_ms["table_bwd", 4][0], device_ms=table_dev["table_bwd", 7],
              device_ms_c4=table_dev["table_bwd", 4]),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

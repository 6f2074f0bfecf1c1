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
   The guidance is the real one (``sds_guidance_fn``, temporal): Stable
   Zero123 at ``random:0`` with the YAML's widths (UNet 320 × [1,2,4,4], VAE
   128, ViT-L/14) in bfloat16, its bank built from the 32 target frames; the
   random views (at 512², resized to 256² inside SDS) reach the loss through
   it and go through the backward kernel.  With ``guidance_fn=None`` and the
   YAML's zero TV weights the random views do not reach the loss at all and
   autograd skips their backward; a few such steps are driven and counted
   too;
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
   ``Zero123Experiment.train_step`` does it (phase 12 drives the
   experiment itself, through the launcher).  The reference image is
   synthetic: a shaded sphere seen from the reference camera.  Steps 0..17 at
   the first milestone's shapes (reference 128², 8 views at 64²), then a few
   steps at the last milestone's (reference 512², 2 views at 256²) from the
   same state, with the real guidance (the same modules under the stage-1
   YAML's settings, its bank from the 128² reference), and a few with
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
    from ``torch.profiler`` (``device_ms``; CUDA events over 30 launches in
    a row where no trace kept half of the records), ms per train step, peak memory
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
12. the README's six-stage recipe chained at full width (``drive_recipe``),
    guidance off, each stage reading the file the stage before it wrote:
    ``configs/stable-zero123.yaml --train`` at the YAML's widths for 6 steps
    with the resolution milestones moved to steps 2 and 4 (all three sizes
    run; phase 9's frame 0 the reference image), ``--test`` and ``--export
    resume=LAST`` with the README's ``mc-cpu`` dotlist at 256³; the
    simplification tool (``python3 -m
    dreammesh4d_tpu_torch.scripts.mesh_simplification``), QEM to 5000 faces
    and clustering at scale 30; ``configs/sugar_static_refine.yaml --train``
    bound to the QEM mesh and ``configs/sugar_dynamic_dg.yaml --train`` from
    its last checkpoint with phase 9's 32 frames, 4 steps each; the 4D
    export.  Checks the B4/B5 launches of every stage-1 step against phase
    6's prediction, 256 + 1 B4 launches for the export's grid and vertex
    colours, the grid against the plain version at 4096 cells, the mesh
    (closed inside the box, colours in [0, 1]), ≤ 5000 QEM faces and 6
    Gaussians a face, 5 + 5 and 8 + 4 launches a Gaussian step, 120 B1 for
    the 4D export and each frame OBJ against ``timed_all``, no plain
    version called; prints the seconds of every stage and sub-step (density
    grid, extraction, component removal, vertex colours, OBJ write, QEM,
    clustering, bind), stage-1 ms/step per milestone beside phase 6's, the
    mesh's V/F before and after simplification and each stage's peak
    memory;
13. the Stable Zero123 guidance at the YAMLs' full widths
    (``drive_guidance``): (a) one float32 ``sds_loss`` (B = 1) on the card
    and on the CPU with the same random weights (the zero-initialised
    convolutions drawn too) and draws — the bank, the loss, ``grad_norm``
    and d loss/d rgb within SDS_CPU_TOL / SDS_CPU_GRAD_TOL — then bfloat16
    against float32 on the card within SDS_BF16_TOL / SDS_BF16_GRAD_TOL (the
    gradient's relative L2 error); the
    UNet's ms per call (CUDA events) and one SDS forward + backward; (b)
    those weights written as an LDM-layout ``.ckpt`` with the schedule
    buffers and text-tower keys, loaded through the dynamic YAML's guidance
    path: zero unmapped keys, equal weights, a bit-equal ``sds_loss`` and
    its gradient within SDS_CKPT_GRAD_TOL; (c)
    ``configs/stable-zero123.yaml``, ``sugar_static_refine.yaml`` and
    ``sugar_dynamic_dg.yaml`` through the launcher with
    ``pretrained_model_name_or_path=random:0``, GUIDED_STEPS steps each on
    phase 9's assets: the SDS term in every step's metrics, B4/B5 launches
    of every stage-1 step as phase 6 predicts, 5 + 5 and 8 + 8 B1/B2 a
    Gaussian step (the dynamic random views reach SDS at
    ``guidance_render_size``); ms/step beside the guidance-off steps of
    phases 9 and 12, the guidance's share, the banks' seconds, peak memory;
14. the Gaussian stage (``drive_gaussian_stage``): configs/sugar_static_refine.yaml
    with ``system.stage=gaussian`` through the launcher at the YAML's 512²
    and 1 + 4 views, capacity 200,000; (a) the YAML's random ball of 5,000
    with ``system.freq`` moved so that a densify and prune (step 2), the
    opacity reset (after step 3) and the neighbour refresh (every 2 steps)
    fall inside 4 steps, ``resume=LAST`` to 6, ``--export resume=LAST``
    (``gaussians.ply`` of the alive slots), and 2 steps with the guidance at
    ``random:0``; (b) ``init_num_pts=100000``, 2 steps, B1 and B2 on one view
    of it held to their plain versions and timed.  Checks 5 + 5 B1/B2 launches
    a step, ``n_alive`` changing at the densify, the SDS term with the
    guidance, the resumed start and Adam count, the file's rows, no pair of a
    dead slot in any tile; prints ms/step, the seconds of ``refresh_knn`` and
    ``densify_and_prune``, peak memory and the fullest tile against the
    capacity;
16. more than one device (``drive_multidevice``, run after 14, before the
    lines of 15): the launcher's refusal of more devices than cards; two
    ranks spawned by the phase on the one card in a ``gloo`` group
    (``launch.spawn``), configs/sugar_dynamic_dg.yaml at full width at mesh
    [2,1] and [1,2] and sugar_static_refine.yaml at [2,1], MULTI_STEPS steps
    with the guidance at ``random:0`` (MULTI_DTYPE, output convolutions
    drawn, cuDNN TF32 off) against one process: the first step's losses and
    gradient within MULTI_RTOL, the later step's losses within
    MULTI_RTOL_LATER; each rank's B1/B2 launches its share of the views,
    the Gaussian stage at [2,1] across a densify (MULTI_GS_STEPS steps)
    with ``n_alive`` equal on both ranks, ms/step and
    peak memory per rank, the UNet's bytes per rank at tp=2 and 1; and
    ``scripts/render_4d`` frame (byte-equal to ``write_png`` of
    ``Viewer4D.render``), orbit and play on phase 9's dynamic trial;
17. the zoo's NeRF systems (``drive_zoo``, run after 16, before the lines
    of 15): (a) the Stable Diffusion guidance at full width (UNet 320 ×
    [1,2,4,4], VAE 128 at 512², latents 64²) in float32, one ``sds_loss``
    on the card against the CPU with the same weights and draws, within
    SDS_CPU_TOL / SDS_CPU_GRAD_TOL, and its ms per SDS forward + backward;
    (b) ``configs/zoo/{zero123, dreamfusion-sd, magic3d-coarse-sd,
    dreamfusion-sd-eff, magic123-coarse-sd, imagecondition}.yaml`` through
    the launcher at their full widths (16 × 2 × 2^19 corner rows, 64 + 64
    samples a ray, SD 1.5 and Stable Zero123 in float32) with every
    guidance at ``random:0``, ZOO_STEPS steps each; phase 9's frame 0 the
    image.  Checks the SDS terms in every step, finite losses, parameters
    that moved, no hand-written kernel launched, ``--validate`` and
    ``--export`` (``model.obj``) of two trials; prints ms/step, the
    guidance's and the corner grid's shares (each timed alone at the step's
    shapes), peak memory, and the profile of one dreamfusion step;
18. the zoo's last four YAMLs (``drive_zoo_latent``, run after 17, before
    the lines of 15): (a) VSD (``models/guidance/vsd.py``) in float32, one
    ``vsd_loss`` on the card against the CPU with the same weights (every
    layer drawn), LoRA (B drawn non-zero) and draws, at SD 1.5's layout
    with the UNet and VAE narrowed to VSD_CHECK's widths, within
    VSD_CPU_TOL / VSD_CPU_GRAD_TOL, and the ms of one full-width VSD forward
    + backward; (b) ``configs/zoo/{latentnerf, sketchshape, sjc,
    prolificdreamer}.yaml`` through the launcher at their full widths with
    the guidance at ``random:0`` (prolificdreamer's with
    ``system.guidance.zero_init=false``, every layer drawn: with the LDM's
    zero-initialised output convolution the UNet returns zeros, and VSD and
    the LoRA's gradient with it), LATENT_STEPS steps
    each, sketchshape guided by phase 12's stage-1 ``model.obj``.  Checks
    the SDS / VSD terms in every step, finite losses, parameters that
    moved, latentnerf's Adam lr at 0.01 · factor(k) in step k (the warm-up
    rising), the shape term, the LoRA moved, prolificdreamer resumed from
    LAST at step LATENT_STEPS with both Adams' counts restored,
    ``--validate`` / ``--export`` of latentnerf, no hand-written kernel
    launched; prints ms/step, peak memory, the guide's bake and its faces,
    and the guidance's share (timed alone at the step's shapes);
19. ``binning: rank`` (``drive_rank``, run after 18, before the lines of
    15): the served view of phase 4's scene through
    ``find("diff-sugar-rasterizer-temporal")`` built from
    configs/sugar_dynamic_dg.yaml's renderer block with ``binning: rank``
    (``bin_gaussians_ranks``: the pairs are depth ranks into a row table in
    depth order, un-permuted by ``inv_rank`` in the backward); B1 and B2 on
    its captured inputs (C = 7 and 4) against their plain versions through
    ``check_forward`` / ``check_backward`` and timed; the same view in pairs
    mode against it within RANK_RGB_TOL / RANK_DEPTH_TOL (tiles where pairs
    mode holds two pairs of one quantized depth printed, and left out only
    if every failing pixel lies in one); ``launch.main(*launch.parse_args(
    ["--config", configs/sugar_dynamic_dg.yaml, "--train", "--gpu", "0",
    "--verbose", ..., "system.renderer.binning=rank"]))`` for RANK_STEPS
    steps on phase 9's assets beside the same run in pairs mode (B1/B2
    every step, the first step's loss within 1e-3, first and last losses
    printed); the 13 factory names of ``models/registry_names.py`` built on
    the card with a forward each; an image grid with a ``jet`` depth layer
    equal to the port's table;
20. the unified guidance, the materials and backgrounds and Adan
    (``drive_components``, run after 19, before the lines of 15): each
    built through ``registry.find(name)(cfg)`` (Adan from Python):
    ``stable-diffusion-unified-guidance`` at SD 1.5's widths (float32,
    every weight drawn), Perp-Neg SDS on 3 renders at 512² (one in each
    branch: front-side, side-back, overhead) and the ``vsd`` dispatch with a
    rank-8 LoRA; ``zero123-unified-guidance`` at Stable Zero123's widths,
    ``sds`` and ``vsd`` (phi scale 1.5, the camera token, one view's camera
    dropped); each card against CPU on the same weights and draws within
    UNIFIED_TOL / UNIFIED_GRAD_TOL and timed (CUDA events); the 8 material
    and background names on COMP_POINTS points, forward + backward, card
    against the CPU's float64 within COMP_TOL or COMP_ROUNDING × the CPU's
    own float32 rounding, timed; Adan over
    configs/zoo/dreamfusion-sd.yaml's implicit-volume parameters (corner
    grid 16 × 2 × 2^19), ADAN_STEPS steps with seeded gradients, card
    against CPU within ADAN_TOL, ms/step; no hand-written kernel launched;
21. the SDF and mesh geometries (``drive_zoo_mesh``, run after 20, before
    the lines of 15), built through ``registry.find``: the fantasia3d
    geometry and texture steps and the magic3d refine step on
    ``tetrahedra-sdf-grid`` at resolution 64 (3,145,728 face slots) and
    ``nvdiff-rasterizer``, 4 views at ZMESH_HW² (512² is refused by the
    binning's int32 key, as in the JAX package), and the textmesh step on
    ``implicit-sdf`` with ``neus-volume-renderer`` (64 + 64 samples) at the
    largest of ZMESH_TEXTMESH_HW the card holds, SD 1.5 at ``random:0`` in
    float32, ZMESH_STEPS steps each: ms/step, the SDS term alone, peak
    memory; one view's rasterization with every slot against the real faces
    alone; one step of each card against CPU at ZMESH_CHECK's widths, both
    in float64, within ZMESH_TOL / ZMESH_GRAD_TOL and face maps apart on at
    most ZMESH_FLIP_SHARE of their pixels (the CPU's side in the thread of
    phase 20's);
    ``export_mesh`` and ``export_sdf_grid`` at ZMESH_EXPORT_RES³ with
    mc-cpu, timed; no hand-written kernel launched;
22. the guidance zoo and the editing systems (``drive_editing``, run after
    21, before the lines of 15), built through ``registry.find``, float32,
    every guidance at ``random:0`` with its zero-initialised layers drawn:
    ControlNet (SD 1.5's UNet and the ControlNet copy, VAE 128 at 512²) SDS
    with a normal and a canny hint, InstructPix2Pix ``edit_loss`` and one
    ``ip2p_edit_images`` at its defaults, DeepFloyd at its defaults, each on
    EDIT_VIEWS renders at 512², forward + backward, CUDA events;
    instructnerf2nerf over configs/stable-zero123.yaml's geometry and
    renderer (the cell grid: B4/B5 every step, held to ``in2n_predicted``)
    on one 512² view, L1 + the perceptual net, IN2N_STEPS steps with a fresh
    edit every IN2N_EDIT_EVERY; control4d, the GAN renderer at its defaults
    (512² over a 128² base of the same grid, 11 feature channels) with the
    PatchGAN and two Adams at ``generator_level`` 0, 1 and 2, the
    discriminator's gradient held to its own term's; one call of each
    guidance and one step of each system at EDIT_CHECK's widths card against
    CPU in float64 within EDIT_TOL / EDIT_GRAD_TOL (the CPU's side in the
    thread of phase 20's);
15. a ``{"kernels": [...]}`` line (every kernel's ``launches_gaussian``,
    ``launches_multidevice``, ``launches_zoo``, ``launches_zoo_latent``,
    ``launches_rank``, ``launches_components``, ``launches_zoo_mesh`` and
    ``launches_editing`` too;
    B1/B2 also their rank-mode device times), the
    card's name and power limit, and as the last line
    ``{"ok": true, "device": {...}}``.
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
import threading
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
# the README recipe chained (phase 12): stage 1 at the YAML's widths, its three
# resolution milestones moved to steps 2 and 4, then stages 2-6
RECIPE_S1_STEPS = 6
RECIPE_MILESTONES = (2, 4)
RECIPE_QEM_FACES = 5000
RECIPE_CLUSTER_SCALE = 30
RECIPE_GS_STEPS = 4  # the static refine and the dynamic stage, each
MC_EXPORT = ["system.exporter_type=mesh-exporter", "system.exporter.fmt=obj",
             "system.geometry.isosurface_method=mc-cpu", "system.geometry.isosurface_resolution=256"]
# the guidance (phases 5, 6 and 13): random:0 at the YAMLs' widths
GUIDED_STEPS = 3  # each stage through the launcher with the guidance on (phase 13)
SDS_CPU_TOL = 1e-4  # float32 card vs CPU: loss_sds and grad_norm, relative
SDS_CPU_GRAD_TOL = 1e-3  # float32 card vs CPU: d loss / d rgb and the bank, of their max |value|
SDS_CKPT_GRAD_TOL = 1e-5  # the checkpoint's d loss / d rgb vs its source modules', of its max |value|
SDS_BF16_TOL = 5e-2  # bfloat16 vs float32 on the card: loss_sds and grad_norm, relative
SDS_BF16_GRAD_TOL = 1e-1  # bfloat16 vs float32 on the card: d loss / d rgb, ||d|| / ||float32||
# the Gaussian stage (phase 14): configs/sugar_static_refine.yaml with system.stage=gaussian
GS_STEPS = 4  # run (a): a densify + prune at step 2, the opacity reset after step 3
GS_RESUMED_STEPS = 6  # run (a) resumed from LAST: another densify at step 4
GS_GUIDED_STEPS = 2  # run (a) again with the guidance at random:0
GS_FREQ = ["system.freq.densify_from=2", "system.freq.densify=2", "system.freq.densify_until=100",
           "system.freq.opacity_reset=3", "system.freq.reset_neighbors=2", "system.freq.start_sugar_reg=1"]
GS_BIG_INIT = 100_000  # run (b): init_num_pts, B1/B2 at ~100k alive
GS_BIG_STEPS = 2
H100_F32_FLOPS = 67e12  # non-tensor float32 peak, H100 SXM data sheet, 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bfloat16 tensor-core peak, H100 SXM data sheet, 700 W


class PhaseClock:
    """Wall seconds from each ``mark`` to the next, under the name of the
    phase that ran between them (the first phase runs from construction)."""

    def __init__(self):
        self.seconds, self._name, self._t = {}, "1", time.perf_counter()

    def mark(self, name):
        now = time.perf_counter()
        self.seconds[self._name] = round(now - self._t, 1)
        self._name, self._t = name, now


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
    time in it.  The profiler drops records: one or two of 30 in most
    traces, and all or most of them in some (phase 19's first, while the
    CPU references' thread runs).  The mean is over the records a trace
    kept; a trace that kept fewer than half of ``n`` is taken again (three
    traces at most).  More records than calls fails the run.  Where no
    trace kept half, the time is the CUDA events' over ``n`` launches in a
    row, per launch (the host enqueues ahead of the card), and a line says
    so; where not ``required``, None (not measured)."""
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
        check(count <= n, f"device time of {key}: {count} kernel records for {n} calls")
        if 2 * count >= n:
            return total / 1e3 / count
        print(f"device time of {key}: the trace kept {count} records of {n} calls, taken again")
    if not required:
        return None
    ms = time_ms(torch, fn, n=1, warmup=1, reps=n)
    print(f"device time of {key}: no trace kept half of {n} records; CUDA events over {n} launches in a "
          f"row instead: {ms:.4f} ms per launch")
    return ms


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


def training_setup(torch, np, viewer, params, static, dparams, dyn_cfg, raster_cfg, guidance, device):
    """The dynamic stage of sugar_dynamic_dg.yaml on the full-width scene:
    returns (make_step, target video, batch sampler, the guidance's bank).
    The target video is the same mesh under a second deformation (seed 1),
    rendered once from the reference camera and kept on the device; the
    guidance's bank holds its 32 frames."""
    from dreammesh4d_tpu_torch.systems.assembly import sds_guidance_fn
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

    bank_s, bank_peak, bank = bank_build(torch, guidance, video[0])

    def make_step(bwd_accum, guidance_on=True):
        step = make_dynamic_train_step(
            params, static, dcfg, raster_cfg._replace(bwd_accum=bwd_accum), losses, arap_w,
            guidance_fn=sds_guidance_fn(guidance, temporal=True) if guidance_on else None,
            invert_bg_prob=1.0, video_frames=video, device=device)
        return lambda state, batch, gen: step(state, batch, gen, bank)

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
            "elevation": torch.as_tensor(np.degrees(el), **f32),
            "azimuth": torch.as_tensor(np.degrees(az), **f32),
            "camera_distances": torch.full((FRAMES_PER_STEP,), 3.8, **f32),
            "timestamps": ts_all[torch.as_tensor(fi, device=device)],
            "frame_indices": torch.as_tensor(fi, device=device),
            "ref_cameras": type(ref_cam)(*(x[:FRAMES_PER_STEP] for x in ref_cam)),
            "rand_cameras": assemble_camera_batch(pos, torch.zeros_like(pos), up, fovy, 0.01, 100.0),
            "inter_timestamps": torch.linspace(start, start + 0.2, N_INTER, **f32),
        }

    return make_step, video, sample_batch, (bank_s, bank_peak)


def bank_build(torch, guidance, frames):
    """(seconds, peak GiB, bank): ``prepare_embeddings`` of ``frames``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bank = guidance.prepare_embeddings(frames)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 2**30, bank


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
    bare_step = make_step(True, guidance_on=False)
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


def stage1_predicted(n_rays, updated):
    """B4 / B5 launches of one stage-1 step with (reference, random) rays
    ``n_rays``: an encode per 8192-ray chunk of the reference view, two per
    chunk of the random views (the samples and the perturbed samples of the
    3D normal smoothness); each encode runs once in the forward and once more
    when its chunk is rematerialised, and has one backward; the occupancy
    update adds one forward."""
    fwd = bwd = 0
    for n, per_chunk in zip(n_rays, (1, 2)):
        encodes = -(-n // S1_CHUNK_RAYS) * per_chunk
        fwd += encodes * (2 if n > S1_CHUNK_RAYS else 1)
        bwd += encodes
    return fwd + int(updated), bwd


def drive_stage1(torch, np, hc, card, guidance, device):
    """The stage-1 training main path and the export pass.  Returns the
    launch counts of the main path, ms per step, the peak memory, the
    geometry config, the trained parameters and a callable that takes one
    more first-milestone step (for the profile)."""
    from dreammesh4d_tpu_torch.systems.assembly import sds_guidance_fn
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

    sds = sds_guidance_fn(guidance)
    steps = {g: make_zero123_train_step(geo, rcfg, losses, material,
                                        guidance_fn=sds if g else None, device=device)
             for g in (True, False)}
    occ_update = make_occgrid_update(geo, rcfg, device=device)
    c2w = torch.as_tensor(make_c2w_numpy(5.0, 0.0, 3.8), device=device)
    refs = {hw: sphere_reference(torch, c2w, hw, 20.0, device) for hw in S1_REF_HW}
    # the bank from the reference image at the first milestone's size, as the experiment builds it
    bank_s, bank_peak, bank = bank_build(torch, guidance, refs[S1_REF_HW[0]]["ref_rgb"].reshape(
        1, S1_REF_HW[0], S1_REF_HW[0], 3))
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
        return steps[guidance](state, batch, gen, lm, ambient, bank, occ[0]), n_rays, updated

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
            fwd, bwd = stage1_predicted(n_rays, updated)
            want[0] += fwd
            want[1] += bwd
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts, plain = dict(hc.launch_counts), dict(hc.plain_counts)
        per_step = stage1_predicted(n_rays, False)
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

    results = {"bank_s": bank_s, "bank_peak": bank_peak}
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
                                             material, guidance_fn=sds, device=device)
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

    hc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = iv.export_density_grid(params, geo, EXPORT_RES)
    seconds = time.perf_counter() - t0
    counts = dict(hc.launch_counts)
    n_chunks = -(-EXPORT_RES ** 3 // 65536)
    check(counts["hashgrid_cell_fwd"] == n_chunks and counts["hashgrid_cell_bwd"] == 0
          and sum(hc.plain_counts.values()) == 0, f"export: launches {counts}, expected {n_chunks} B4")
    err, limit = check_density_grid(torch, np, geo, params, grid, "export")
    print(f"[{card}] export_density_grid {EXPORT_RES}^3: {seconds:.2f} s, {counts['hashgrid_cell_fwd']} "
          f"B4 launches (features only), 0 B5; density in [{grid.min():.4g}, {grid.max():.4g}], "
          f"{float((grid > 1.0).mean()):.4f} of the cells above 1; 4096 cells vs the plain version: "
          f"max |d| {err:.3g} (limit {limit:.3g})")
    return counts["hashgrid_cell_fwd"], seconds


def check_density_grid(torch, np, geo, params, grid, label):
    """The density grid at 4096 random cells against the plain version (the
    plain hash-grid encode, the MLP and the bias), within 1e-4 of
    max(1, max |density|) there; the grid finite and holding density.
    Returns the error and its limit."""
    from dreammesh4d_tpu_torch.models.geometry import implicit_volume as iv
    from dreammesh4d_tpu_torch.ops.hashgrid import hashgrid_encode_cell

    res = grid.shape[0]
    check(grid.shape == (res,) * 3 and np.isfinite(grid).all(), f"{label}: bad density grid")
    rng = np.random.default_rng(0)
    ijk = rng.integers(0, res, (4096, 3))
    lin = np.linspace(-geo.radius, geo.radius, res, dtype=np.float32)
    pts = torch.as_tensor(lin[ijk], device=params["density_mlp"][0]["w"].device)
    with torch.no_grad():
        enc = hashgrid_encode_cell(params["encoding"], geo.hashgrid, iv._contract(geo, pts))
        ref = iv._activate_density(geo, iv._mlp_apply(params["density_mlp"], enc)
                                   + iv.density_bias(geo, pts))[:, 0].cpu().numpy()
    err = float(np.abs(grid[ijk[:, 0], ijk[:, 1], ijk[:, 2]] - ref).max())
    limit = 1e-4 * max(float(np.abs(ref).max()), 1.0)
    check(err <= limit, f"{label}: density differs from the plain version ({err:.3g} > {limit:.3g})")
    check(float((grid > 1.0).mean()) > 0, f"{label}: the grid holds no density")
    return err, limit


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
    res["frames_dir"] = frames_dir
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


def check_frame_objs(torch, np, exp, out_dir, device, label):
    """The 4D export's file set in ``out_dir`` (one OBJ per timestamp, one
    material), each frame OBJ on the bind mesh's faces with its vertices
    within EXPORT_VERT_TOL of ``timed_all``'s.  Returns the worst error, the
    vertices of every frame and the faces."""
    from dreammesh4d_tpu_torch.data.temporal_image import frame_timestamps
    from dreammesh4d_tpu_torch.export.mesh_io import load_obj
    from dreammesh4d_tpu_torch.models.geometry.dynamic_sugar import timed_all

    L = exp.data.video_length
    names = [f"frame_{i:03d}.obj" for i in range(L)]
    check(sorted(os.listdir(out_dir)) == names + ["material0.mtl", "material0.png"],
          f"{label}: files {sorted(os.listdir(out_dir))}")
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
              f"{label} {name}: {m.v_pos.shape[0]} vertices / {m.t_pos_idx.shape[0]} faces, not the mesh's")
        worst = max(worst, float(np.abs(m.v_pos - xyz[i]).max()))
    check(worst <= EXPORT_VERT_TOL, f"{label}: frame vertices differ from timed_all ({worst:.3g})")
    return worst, xyz, faces


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
    print(f"recovery columns (cut run, not gated; CLIP on a random tower, relative only): {json.dumps(cols)}")
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
    worst, xyz, faces = check_frame_objs(torch, np, exp, out_dir, device, "dynamic export")
    L = exp.data.video_length
    res["export_vert_err"] = worst
    tex = png.read_png(os.path.join(out_dir, "material0.png"))
    res["filled_share"] = float((filled[0] > 0).float().mean())
    moved = float(np.abs(xyz[-1] - xyz[0]).max())
    print(f"4D export: {L} frame OBJs of {xyz.shape[1]} vertices / {faces.shape[0]} faces, vertices against "
          f"timed_all max|d| {worst:.3g} (limit {EXPORT_VERT_TOL}); first to last frame moved {moved:.4g}; "
          f"texture {tex.shape}, filled-texel share {res['filled_share']:.4f}")
    check(tex.shape == (1024, 1024, 3) and res["filled_share"] > 0.05, "4D export: texture empty or misshapen")
    sec = res["export_seconds"] = spans.seconds
    print(f"[{card}] export seconds: static {sec['static export'][0]:.3f}; dynamic bake ({n_views} views at "
          f"{exp.data.cfg.predict_height}², B1 + mesh rasterizer + index_add_) {sec['bake'][0]:.3f}, "
          f"{len(sec['frame OBJ'])} OBJ writes {sum(sec['frame OBJ']):.3f} (of it the texture PNG "
          f"{sum(sec['texture PNG']):.3f}); setup (build_experiment) {fmt_s(sec['setup'])}; peak memory "
          f"{res['export_peak']:.2f} GiB")
    return res


def open_edges(np, mesh, radius):
    """(edges used by other than two faces, those of them not on the box's
    faces): a surface of marching tetrahedra is closed except where it meets
    the grid's boundary."""
    f = mesh.t_pos_idx
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    uniq, n = np.unique(edges, axis=0, return_counts=True)
    bad = uniq[n != 2]
    on_box = (np.abs(mesh.v_pos[bad]) >= radius - 1e-3).any(-1).all(-1)
    return int(len(bad)), int((~on_box).sum())


def drive_recipe(torch, np, rb, tb, hc, card, launcher, s1, device, tmp):
    """The README's six-stage recipe chained at full width through the entry
    points a user calls, guidance off, each stage reading the file the stage
    before it wrote: ``configs/stable-zero123.yaml --train`` (the YAML's
    widths, RECIPE_S1_STEPS steps with the resolution milestones moved to
    RECIPE_MILESTONES, so that all three sizes run; the reference image is
    phase 9's frame 0), ``--test`` and ``--export resume=LAST`` with the
    README's ``mc-cpu`` dotlist at 256³; the simplification tool, QEM to
    RECIPE_QEM_FACES faces (the mesh stage 4 binds) and clustering at
    ``--scale`` RECIPE_CLUSTER_SCALE; ``configs/sugar_static_refine.yaml
    --train`` bound to the QEM mesh and ``configs/sugar_dynamic_dg.yaml
    --train`` from its last checkpoint with phase 9's 32 frames, each
    RECIPE_GS_STEPS steps; the 4D export.  Launch counts are zeroed before
    each stage and read after it; every plain version is watched."""
    from dreammesh4d_tpu_torch import launch, trainer
    from dreammesh4d_tpu_torch.export import decimate, isosurface
    from dreammesh4d_tpu_torch.export.mesh_io import load_mesh, load_obj
    from dreammesh4d_tpu_torch.scripts import mesh_simplification as simplify
    from dreammesh4d_tpu_torch.systems import assembly
    from dreammesh4d_tpu_torch.utils.schedule import C_max

    def counts():
        return {**rb.launch_counts, **tb.launch_counts, **hc.launch_counts}

    frames_dir = launcher["frames_dir"]
    out = os.path.join(tmp, "recipe")
    cfg_dir = os.path.join(REPO, "configs")
    nerf_yaml, static_yaml, dyn_yaml = (os.path.join(cfg_dir, n) for n in (
        "stable-zero123.yaml", "sugar_static_refine.yaml", "sugar_dynamic_dg.yaml"))
    common = ["system.guidance.pretrained_model_name_or_path=none", f"exp_root_dir={out}",
              "use_timestamp=false", "trainer.val_check_interval=100000"]
    milestones = "[" + ",".join(str(m) for m in RECIPE_MILESTONES) + "]"
    nerf = common + [f"data.image_path={frames_dir}/000_rgba.png", "tag=nerf",
                     f"data.resolution_milestones={milestones}",
                     f"data.random_camera.resolution_milestones={milestones}",
                     f"trainer.max_steps={RECIPE_S1_STEPS}"]
    nerf_trial = os.path.join(out, "zero123-sai", "nerf")
    model_obj = os.path.join(nerf_trial, "save", "model.obj")

    spans = Spans(torch, counts)
    spans.time(launch, "build_experiment", "setup", keep=True)
    spans.time(assembly, "export_density_grid", "density grid", keep=True)
    for owner, name, label in (
            (isosurface, "marching_cubes", "extraction"),
            (isosurface, "remove_small_components", "component removal"),
            (assembly, "forward_field", "vertex colours"), (assembly, "save_obj", "OBJ write"),
            (simplify, "load_mesh", "mesh load"), (decimate, "quadric_decimate", "QEM"),
            (simplify, "simplify_vertex_clustering", "clustering"), (simplify, "save_ply_mesh", "PLY write"),
            (assembly, "create_sugar", "bind"), (assembly, "build_dynamic_static", "graph"),
            (trainer.Trainer, "fit", "fit"), (trainer.Trainer, "test", "test"),
            (assembly, "bake_texture", "bake"), (assembly, "export_textured_mesh", "frame OBJ")):
        spans.time(owner, name, label)
    for cls, label in ((assembly.Zero123Experiment, "nerf"), (assembly.SugarStaticExperiment, "refine"),
                       (assembly.Sugar4DGenExperiment, "dynamic")):
        spans.train_steps(cls, label)
    plain_calls = {}

    def watch(fn, name=None):
        def counted(*a, **kw):
            plain_calls[name] = plain_calls.get(name, 0) + 1
            return fn(*a, **kw)
        return counted

    for owner, name in ((rb, "blend_pairs_plain"), (rb, "blend_pairs_bwd_plain"), (tb, "blend_table_plain"),
                        (tb, "blend_table_bwd_plain"), (hc, "encode_cell_fwd_plain"),
                        (hc, "encode_cell_bwd_plain")):
        spans._patch(owner, name, lambda fn, name=name: watch(fn, name))

    res = {"seconds": {}, "launches": {}, "peak": {}}

    def stage(label, fn):
        for m in (rb, tb, hc):
            m.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        res["seconds"][label] = time.perf_counter() - t0
        res["peak"][label] = torch.cuda.max_memory_allocated() / 2**30
        res["launches"][label] = {k: v for k, v in counts().items() if v}
        print(f"[{card}] recipe {label}: {res['seconds'][label]:.3f} s, launches "
              f"{json.dumps(res['launches'][label])}, peak memory {res['peak'][label]:.2f} GiB", flush=True)
        return value

    try:
        stage("stage 1 --train", lambda: launch.main(launch.make_args(nerf_yaml, "train"), nerf))
        stage("stage 1 --test", lambda: launch.main(launch.make_args(nerf_yaml, "test"), nerf + ["resume=LAST"]))
        stage("stage 2 --export", lambda: launch.main(launch.make_args(nerf_yaml, "export"),
                                                      nerf + MC_EXPORT + ["resume=LAST"]))
        qem_path = stage("stage 3 QEM", lambda: simplify.main(
            ["--mesh_path", model_obj, "--method", "quadric", "--target_faces", str(RECIPE_QEM_FACES)]))
        cluster_path = stage("stage 3 clustering", lambda: simplify.main(
            ["--mesh_path", model_obj, "--scale", str(RECIPE_CLUSTER_SCALE)]))
        refine = common + [f"data.image_path={frames_dir}/000_rgba.png", "tag=refine",
                           f"system.geometry.surface_mesh_to_bind_path={qem_path}",
                           f"trainer.max_steps={RECIPE_GS_STEPS}"]
        stage("stage 4 --train", lambda: launch.main(launch.make_args(static_yaml, "train"), refine))
        refine_ckpt = os.path.join(out, "sugar-refine", "refine", "ckpts", f"step_{RECIPE_GS_STEPS:08d}")
        dyn = common + [f"data.video_frames_dir={frames_dir}", f"system.weights={refine_ckpt}", "tag=dyn",
                        f"system.geometry.surface_mesh_to_bind_path={qem_path}",
                        f"trainer.max_steps={RECIPE_GS_STEPS}"]
        stage("stage 5 --train", lambda: launch.main(launch.make_args(dyn_yaml, "train"), dyn))
        stage("stage 6 --export", lambda: launch.main(launch.make_args(dyn_yaml, "export"), dyn + ["resume=LAST"]))
    finally:
        spans.close()
    sec, launches = spans.seconds, res["launches"]
    check(not plain_calls, f"recipe: a plain version ran on the card: {plain_calls}")

    # stage 1: B4/B5 launches of every step against phase 6's prediction
    exp1 = spans.results["setup"][0]
    dcfg, rc = exp1.data.cfg, exp1.data.cfg.random_camera
    rows = [r for r in spans.steps if r[0] == "nerf"]
    check([r[1] for r in rows] == list(range(RECIPE_S1_STEPS)), "stage 1: steps taken")
    by_milestone = {}
    for _, step, _, ms, launched, metrics in rows:
        i = sum(step >= m for m in rc.resolution_milestones)
        n_rays = (int(dcfg.height[i]) * int(dcfg.width[i]),
                  int(rc.batch_size[i]) * int(rc.height[i]) * int(rc.width[i]))
        fwd, bwd = stage1_predicted(n_rays, step % exp1.rcfg.grid_update_every == 0)
        got = {k: v for k, v in launched.items() if v}
        check(got == {"hashgrid_cell_fwd": fwd, "hashgrid_cell_bwd": bwd},
              f"stage 1 step {step}: launches {got}, predicted B4 {fwd} B5 {bwd}")
        check(all(math.isfinite(v) for v in metrics.values()), f"stage 1 step {step}: non-finite metric")
        by_milestone.setdefault(i, []).append((ms, n_rays, fwd, bwd))
    res["s1_ms"] = {i: [r[0] for r in v] for i, v in by_milestone.items()}
    for i, v in sorted(by_milestone.items()):
        print(f"[{card}] recipe stage 1 milestone {i} (reference {v[0][1][0]} rays + random {v[0][1][1]}): "
              f"{', '.join(f'{r[0]:.1f}' for r in v)} ms/step, B4 {v[-1][2]} + B5 {v[-1][3]} a step"
              + (" (step 0: + 1 B4 for the occupancy update)" if i == 0 else ""))
    print(f"[{card}] recipe stage 1 beside phase 6's direct step with guidance_fn=None: first milestone "
          f"{s1['first_bare_ms']:.2f}, last {s1['last_bare_ms']:.2f} ms/step")
    check(os.path.exists(os.path.join(nerf_trial, "save", f"it{RECIPE_S1_STEPS}-nerf.png")),
          "stage 1: the test pass wrote no it*-nerf.png")

    # stage 2: 256 B4 launches for the grid, one for the vertex colours
    exp2 = spans.results["setup"][2]
    grid = spans.results["density grid"][0]
    n_chunks = -(-grid.size // 65536)
    want = {"hashgrid_cell_fwd": n_chunks + 1}
    check(launches["stage 2 --export"] == want,
          f"stage 2: launches {launches['stage 2 --export']}, expected {want}")
    err, limit = check_density_grid(torch, np, exp2.geo_cfg, exp2.state.geo_params, grid, "stage 2")
    mesh = load_obj(model_obj)
    n_open, n_open_inside = open_edges(np, mesh, exp2.geo_cfg.radius)
    res["mesh"], res["model_obj"] = (mesh.n_verts, mesh.n_faces), model_obj
    print(f"recipe stage 2: grid {grid.shape} vs the plain version at 4096 cells max|d| {err:.3g} (limit "
          f"{limit:.3g}); model.obj {mesh.n_verts} V / {mesh.n_faces} F, {n_open} open edges, {n_open_inside} "
          f"of them off the box; v_rgb in [{mesh.v_rgb.min():.4f}, {mesh.v_rgb.max():.4f}]")
    check(mesh.n_faces > 0 and mesh.v_rgb is not None and mesh.v_rgb.shape == mesh.v_pos.shape,
          "stage 2: empty mesh or no vertex colours")
    check(n_open_inside == 0, "stage 2: the mesh is open inside the box")
    check(float(mesh.v_rgb.min()) >= 0.0 and float(mesh.v_rgb.max()) <= 1.0, "stage 2: v_rgb outside [0, 1]")

    # stage 3: the QEM mesh (bound by stage 4) and the clustered one
    qem, cluster = load_mesh(qem_path), load_mesh(cluster_path)
    res["qem"], res["cluster"] = (qem.n_verts, qem.n_faces), (cluster.n_verts, cluster.n_faces)
    print(f"recipe stage 3: {mesh.n_verts} V / {mesh.n_faces} F -> QEM {qem.n_verts} V / {qem.n_faces} F "
          f"({os.path.basename(qem_path)}), clustering at scale {RECIPE_CLUSTER_SCALE} {cluster.n_verts} V / "
          f"{cluster.n_faces} F ({os.path.basename(cluster_path)})")
    check(0 < qem.n_faces <= RECIPE_QEM_FACES, f"stage 3: QEM left {qem.n_faces} faces")

    # stages 4 and 5: launches of every step
    exp4, exp5 = spans.results["setup"][3], spans.results["setup"][4]
    # create_sugar binds to the mesh's non-degenerate faces (as in the JAX package)
    n_gauss, n_bound = int(exp4.state.params.log_scales.shape[0]), int(exp4.static.faces.shape[0])
    check(0 < n_bound <= qem.n_faces and n_gauss == 6 * n_bound,
          f"stage 4: {n_gauss} Gaussians on {n_bound} faces, QEM mesh {qem.n_faces}")
    frames = exp5.data.cfg.num_frames
    views = 1 + exp4.data.cfg.random_camera.batch_size
    lw = exp5.losses  # with the guidance off the random views reach a loss only through TV
    rand_in_loss = any(C_max(w) > 0 for w in (lw.lambda_rgb_tv, lw.lambda_normal_tv, lw.lambda_depth_tv))
    predicted = {"refine": {"resident_fwd": views, "resident_bwd_accum": views},
                 "dynamic": {"resident_fwd": 2 * frames,
                             "resident_bwd_accum": frames * (2 if rand_in_loss else 1)}}
    for label, want in predicted.items():
        rows = [r for r in spans.steps if r[0] == label]
        check([r[1] for r in rows] == list(range(RECIPE_GS_STEPS)), f"{label}: steps taken")
        for _, step, _, _, launched, metrics in rows:
            got = {k: v for k, v in launched.items() if v}
            check(got == want, f"{label} step {step}: launches {got} != {want}")
            check(all(math.isfinite(v) for v in metrics.values()), f"{label} step {step}: non-finite metric")
        ms = [r[3] for r in rows]
        res[f"{label}_ms"] = statistics.median(ms[1:])
        print(f"[{card}] recipe {label} train_step ({json.dumps(want)} per step): {res[f'{label}_ms']:.2f} "
              f"ms/step (median without the first; all: {', '.join(f'{x:.1f}' for x in ms)})")
    print(f"recipe stage 4: {n_gauss} Gaussians = 6 x {n_bound} faces bound of the QEM mesh's {qem.n_faces} "
          f"({qem.n_faces - n_bound} degenerate ones pruned)")

    # stage 6: 120 B1 launches, the frame OBJs against timed_all
    exp6 = spans.results["setup"][-1]
    n_views = exp6.data.cfg.n_predict_views
    check(launches["stage 6 --export"] == {"resident_fwd": n_views},
          f"stage 6: launches {launches['stage 6 --export']}, expected {n_views} B1")
    worst, _, _ = check_frame_objs(torch, np, exp6, os.path.join(out, "sugar-dynamic", "dyn", "save", "4d_export"),
                                   device, "stage 6")
    print(f"recipe stage 6: {exp6.data.video_length} frame OBJs of {exp6.static.sugar.faces.shape[0]} faces, "
          f"against timed_all max|d| {worst:.3g} (limit {EXPORT_VERT_TOL})")
    res["sub_seconds"] = {k: sum(v) for k, v in sec.items()}
    print(f"[{card}] recipe seconds: " + "; ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items()))
    print(f"[{card}] recipe sub-steps (seconds, summed over calls): " + "; ".join(
        f"{k} {fmt_s(sec[k])}" for k in ("setup", "fit", "test", "density grid", "extraction",
                                          "component removal", "vertex colours", "OBJ write", "mesh load",
                                          "QEM", "clustering", "PLY write", "bind", "graph", "bake",
                                          "frame OBJ") if k in sec))
    total = {}
    for per_stage in launches.values():
        for k, v in per_stage.items():
            total[k] = total.get(k, 0) + v
    res["total_launches"] = total
    print(f"recipe launches in all: {json.dumps(total)}")
    return res


def yaml_guidance(name, **over):
    """``system.guidance_type`` and ``system.guidance`` of configs/<name>
    through the port's config loader, the guidance's keys updated by
    ``over``: the ``system`` dict ``maybe_build_guidance`` reads."""
    from dreammesh4d_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", name), makedirs=False,
                      cli_args=["data.image_path=/nonexistent/ref_rgba.png",
                                "data.video_frames_dir=/nonexistent"])
    return {"guidance_type": cfg.system.get("guidance_type"),
            "guidance": {**dict(cfg.system.guidance), **over}}


def rel_err(a, b):
    """max |a − b| over max |b|, as a float."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def smooth_images(torch, n, hw, seed):
    """``n`` smooth colour images (n, hw, hw, 3) in [0, 1] on the CPU."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, hw), torch.linspace(0, 1, hw), indexing="ij")
    f = 1 + 4 * torch.rand((n, 1, 1, 3, 2), generator=g)
    ph = 6.3 * torch.rand((n, 1, 1, 3), generator=g)
    return 0.5 + 0.4 * torch.sin(f[..., 0] * 6.3 * yy[None, ..., None] + f[..., 1] * 6.3
                                 * xx[None, ..., None] + ph)


def drive_guidance(torch, np, rb, tb, hc, card, launcher, recipe, direct, device, tmp):
    """Phase 13, the Stable Zero123 guidance at the YAMLs' full widths
    (UNet 320 × [1,2,4,4], VAE 128, ViT-L/14): (a) one float32 ``sds_loss``
    (B = 1) on the card and on the CPU with the same weights (random, the
    zero-initialised convolutions drawn too, so that the UNet's output is not
    zero) and draws, then bfloat16 on the card against float32 on the card;
    (b) those weights written as an LDM-layout ``.ckpt`` (the real key
    prefixes, the schedule buffers and text-tower keys to skip) and loaded
    through the dynamic YAML's guidance path: zero unmapped keys, the same
    weights, the same ``sds_loss`` (its gradient within SDS_CKPT_GRAD_TOL:
    cuDNN's backward is not bit-reproducible); (c) stages 1, 4 and 5 through
    ``launch.main`` with ``pretrained_model_name_or_path=random:0``,
    GUIDED_STEPS steps each, on phase 9's assets: the SDS term in every
    step's metrics and each step's launches as the code path predicts.
    ``direct``: phase 5's and 6's numbers.  Returns the phase's numbers."""
    from dreammesh4d_tpu_torch import launch
    from dreammesh4d_tpu_torch.models.guidance.zero123 import guidance as zg
    from dreammesh4d_tpu_torch.models.guidance.zero123.checkpoint import load_ldm_state_dict
    from dreammesh4d_tpu_torch.systems import assembly

    res = {}
    dyn_guidance = yaml_guidance("sugar_dynamic_dg.yaml")

    # (a) float32, card against CPU
    t0 = time.perf_counter()
    cfg32 = zg.config_from_dict({**dyn_guidance["guidance"], "dtype": "float32"})
    card32 = zg.StableZero123Guidance(cfg32, device=device)
    card32.modules.init_params(torch.Generator(device=device).manual_seed(0), zero_init=False)
    cpu32 = zg.StableZero123Guidance(cfg32, device="cpu")
    cpu32.modules.load_state_dict(card32.modules.state_dict())
    n_params = {part: sum(p.numel() for p in getattr(card32.modules, part).parameters())
                for part in ("unet", "vae", "clip")}
    print(f"[{card}] guidance at full width: parameters {json.dumps(n_params)}; built on the card and "
          f"copied to the CPU in {time.perf_counter() - t0:.2f} s")
    S, L = cfg32.image_size, cfg32.latent_size
    frames = smooth_images(torch, 2, 2 * S, 13)
    rgb = smooth_images(torch, 1, S, 14)
    draws = {"u": torch.tensor([0.37]),
             "noise": torch.randn((1, 4, L, L), generator=torch.Generator().manual_seed(15))}
    pose = [torch.tensor([20.0]), torch.tensor([40.0]), torch.tensor([3.8]), torch.tensor([1])]

    def run_sds(guidance, dev, bank=None):
        if bank is None:
            bank = guidance.prepare_embeddings(frames.to(dev))
        x = rgb.to(dev, copy=True).requires_grad_(True)
        out = guidance.sds_loss(bank, x, *(p.to(dev) for p in pose), 0, **draws)
        out["loss_sds"].backward()
        return bank, {k: v.detach().cpu() for k, v in out.items()}, x.grad.cpu().clone()

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    bank_cpu, out_cpu, grad_cpu = run_sds(cpu32, "cpu")
    res["cpu_sds_s"] = time.perf_counter() - t0
    bank32, out32, grad32 = run_sds(card32, device)
    errs = {k: rel_err(bank32[k].cpu(), bank_cpu[k]) for k in bank32}
    for k in ("loss_sds", "grad_norm"):
        errs[k] = abs(float(out32[k]) - float(out_cpu[k])) / abs(float(out_cpu[k]))
    errs["d_rgb"] = rel_err(grad32, grad_cpu)
    res["card_vs_cpu"] = errs
    print(f"[{card}] sds_loss float32, card vs CPU (B = 1, t {int(out32['t'][0])} vs {int(out_cpu['t'][0])}): "
          f"loss {float(out32['loss_sds']):.8g} vs {float(out_cpu['loss_sds']):.8g}; relative errors "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} (limits: loss and grad_norm "
          f"{SDS_CPU_TOL}, the bank and d loss/d rgb {SDS_CPU_GRAD_TOL} of their max); the CPU's bank and "
          f"step {res['cpu_sds_s']:.2f} s")
    check(torch.equal(out32["t"], out_cpu["t"]), "the card and the CPU drew other timesteps")
    check(float(out32["loss_sds"]) > 0 and float(grad32.abs().max()) > 0, "sds_loss or its gradient is zero")
    check(errs["loss_sds"] <= SDS_CPU_TOL and errs["grad_norm"] <= SDS_CPU_TOL,
          "float32 sds_loss: card and CPU disagree")
    check(max(errs["c_crossattn"], errs["c_concat"], errs["d_rgb"]) <= SDS_CPU_GRAD_TOL,
          "float32 bank or d loss/d rgb: card and CPU disagree")
    del cpu32, bank_cpu

    cfg16 = zg.config_from_dict(dyn_guidance["guidance"])
    check(cfg16.dtype == torch.bfloat16, "the dynamic YAML's guidance does not run in bfloat16")
    card16 = zg.StableZero123Guidance(cfg16, device=device)
    card16.modules.load_state_dict(card32.modules.state_dict())
    _, out16, grad16 = run_sds(card16, device)
    bf = {k: abs(float(out16[k]) - float(out32[k])) / abs(float(out32[k])) for k in ("loss_sds", "grad_norm")}
    bf["d_rgb"] = float((grad16 - grad32).norm() / grad32.norm())
    cos = float((grad16 * grad32).sum() / (grad16.norm() * grad32.norm()))
    res["bf16_vs_f32"] = {**bf, "d_rgb_cosine": cos, "d_rgb_of_max": rel_err(grad16, grad32)}
    print(f"[{card}] sds_loss bfloat16 vs float32 on the card: loss {float(out16['loss_sds']):.8g} vs "
          f"{float(out32['loss_sds']):.8g}; relative errors {json.dumps({k: float(f'{v:.3g}') for k, v in bf.items()})}, "
          f"d loss/d rgb cosine {cos:.6f}, max |d| / max {res['bf16_vs_f32']['d_rgb_of_max']:.3g} (limits: "
          f"loss and grad_norm {SDS_BF16_TOL}, d loss/d rgb {SDS_BF16_GRAD_TOL} in L2 norm)")
    check(bf["loss_sds"] <= SDS_BF16_TOL and bf["grad_norm"] <= SDS_BF16_TOL,
          "bfloat16 sds_loss outside its band of float32")
    check(bf["d_rgb"] <= SDS_BF16_GRAD_TOL, "bfloat16 d loss/d rgb outside its band of float32")

    # the UNet per call (CUDA events) at the dynamic step's CFG batch, and one
    # SDS forward + backward at its 4 views of 256²
    x = torch.randn((8, 8, L, L), generator=torch.Generator(device=device).manual_seed(3), device=device)
    tt = torch.full((8,), 500, device=device)
    ctx = torch.randn((8, 1, cfg32.context_dim), generator=torch.Generator(device=device).manual_seed(4),
                      device=device)
    views = smooth_images(torch, 4, S, 16).to(device)
    bank16 = card16.prepare_embeddings(frames.to(device))
    fi = torch.tensor([0, 1, 0, 1], device=device)
    el, az, dist = (torch.full((4,), v, device=device) for v in (20.0, 40.0, 3.8))
    gen = torch.Generator(device=device).manual_seed(5)

    def sds_step(g, bank):
        v = views.clone().requires_grad_(True)
        g.sds_loss(bank, v, el, az, dist, fi, 0, gen)["loss_sds"].backward()

    with torch.no_grad():
        res["unet_ms"] = {"bf16": time_ms(torch, lambda: card16.modules.unet(x, tt, ctx), n=10),
                          "f32": time_ms(torch, lambda: card32.modules.unet(x, tt, ctx), n=10)}
        res["vae_encode_ms"] = time_ms(torch, lambda: card16.modules.encode_images(views), n=10)
    res["sds_ms"] = {"bf16": time_ms(torch, lambda: sds_step(card16, bank16), n=10),
                     "f32": time_ms(torch, lambda: sds_step(card32, bank32), n=10)}
    unet_flops = unet_macs(card16.modules.unet, x, tt, ctx) * 2
    res["unet_bound_ms"] = unet_flops / H100_BF16_FLOPS * 1e3
    print(f"[{card}] UNet per call (batch 8 = CFG 2 x 4 views, 8 x {L} x {L}): bfloat16 "
          f"{res['unet_ms']['bf16']:.3f} ms, float32 {res['unet_ms']['f32']:.3f} ms ({unet_flops / 1e9:.1f} "
          f"GFLOP; at the bfloat16 peak {res['unet_bound_ms']:.3f} ms); VAE encode of 4 x {S}² (bfloat16) "
          f"{res['vae_encode_ms']:.3f} ms; sds_loss forward + backward of 4 views at {S}²: bfloat16 "
          f"{res['sds_ms']['bf16']:.3f} ms, float32 {res['sds_ms']['f32']:.3f} ms")
    del card16, bank16

    # (b) a full-width checkpoint in the LDM layout, through the YAML's guidance path
    sd = {k: v.cpu() for k, v in card32.modules.state_dict().items() if k != "clip_proj"}
    sched = card32.modules.schedule
    extra = {"betas": sched.betas.cpu(), "alphas_cumprod": sched.alphas_cumprod.cpu(),
             "alphas_cumprod_prev": sched.alphas_cumprod.cpu(), "sqrt_alphas_cumprod": sched.alphas_cumprod.cpu(),
             "posterior_variance": sched.betas.cpu(), "logvar": torch.zeros(1000),
             "model_ema.decay": torch.tensor(0.9999),
             "cond_stage_model.model.transformer.resblocks.0.ln_1.weight": torch.ones(1024),
             "cond_stage_model.model.logit_scale": torch.tensor(4.6)}
    path = os.path.join(tmp, "stable_zero123_random.ckpt")
    t0 = time.perf_counter()
    torch.save({"state_dict": {**sd, **extra}, "global_step": 0}, path)
    res["ckpt_write_s"] = time.perf_counter() - t0
    res["ckpt_gb"] = os.path.getsize(path) / 1e9
    t0 = time.perf_counter()
    loaded = assembly.maybe_build_guidance(
        yaml_guidance("sugar_dynamic_dg.yaml", pretrained_model_name_or_path=path, dtype="float32"),
        device=device)
    res["ckpt_load_s"] = time.perf_counter() - t0
    os.remove(path)
    same = all(torch.equal(v, sd[k].to(device)) for k, v in loaded.modules.state_dict().items() if k in sd)
    report = load_ldm_state_dict(loaded.modules, {**sd, **extra}, strict=True)
    _, out_ck, grad_ck = run_sds(loaded, device, bank32)
    ck_err = abs(float(out_ck["loss_sds"]) - float(out32["loss_sds"]))
    print(f"[{card}] full-width checkpoint: {res['ckpt_gb']:.2f} GB written in {res['ckpt_write_s']:.2f} s, "
          f"built through the YAML's guidance path in {res['ckpt_load_s']:.2f} s; keys consumed "
          f"{len(report['consumed'])}, skipped {len(report['skipped'])}, unmapped {len(report['unmapped'])}; "
          f"weights equal: {same}; sds_loss {float(out_ck['loss_sds']):.8g} vs the modules it was written from "
          f"{float(out32['loss_sds']):.8g} (|d| {ck_err:.3g}), d loss/d rgb max |d| / max "
          f"{rel_err(grad_ck, grad32):.3g} (limit {SDS_CKPT_GRAD_TOL})")
    check(type(loaded).__registered_name__ == "temporal-stable-zero123-guidance",
          "the dynamic YAML's guidance_type did not resolve to the temporal guidance")
    check(report["unmapped"] == [] and set(report["skipped"]) == set(extra) and same,
          "the full-width checkpoint did not load key for key")
    # the loss is bit-equal; cuDNN's backward is not bit-reproducible from run to run
    check(ck_err == 0 and rel_err(grad_ck, grad32) <= SDS_CKPT_GRAD_TOL,
          "the loaded checkpoint's sds_loss or its gradient differs")
    del card32, loaded, bank32, sd
    torch.cuda.empty_cache()

    # (c) stages 1, 4 and 5 through the launcher, guidance random:0
    def counts():
        return {**rb.launch_counts, **tb.launch_counts, **hc.launch_counts}

    frames_dir = launcher["frames_dir"]
    out = os.path.join(tmp, "guided")
    drop = ("tag=", "trainer.max_steps=", "trainer.val_check_interval=", "exp_root_dir=",
            "system.guidance.pretrained_model_name_or_path=", "checkpoint.")
    common = ["system.guidance.pretrained_model_name_or_path=random:0", f"exp_root_dir={out}",
              f"trainer.max_steps={GUIDED_STEPS}", "trainer.val_check_interval=100000"]
    runs = {"nerf": (os.path.join(REPO, "configs", "stable-zero123.yaml"),
                     ["use_timestamp=false", f"data.image_path={frames_dir}/000_rgba.png"]),
            "static": (launcher["trials"]["static"][0],
                       [x for x in launcher["trials"]["static"][2] if not x.startswith(drop)]),
            "dynamic": (launcher["trials"]["dynamic"][0],
                        [x for x in launcher["trials"]["dynamic"][2] if not x.startswith(drop)])}
    spans = Spans(torch, counts)
    spans.time(launch, "build_experiment", "setup", keep=True)
    spans.time(zg.StableZero123Guidance, "prepare_embeddings", "bank")
    rendered = []
    real_sds = zg.StableZero123Guidance.sds_loss
    spans._patch(zg.StableZero123Guidance, "sds_loss",
                 lambda fn: lambda g, bank, rgb, *a, **k: (rendered.append(tuple(rgb.shape)), fn(g, bank, rgb, *a, **k))[1])
    for cls, label in ((assembly.Zero123Experiment, "nerf"), (assembly.SugarStaticExperiment, "static"),
                       (assembly.Sugar4DGenExperiment, "dynamic")):
        spans.train_steps(cls, label)
    res["peak"], res["shapes"] = {}, {}
    try:
        for label, (yaml, dotlist) in runs.items():
            rendered.clear()
            torch.cuda.reset_peak_memory_stats()
            launch.main(launch.make_args(yaml, "train"), dotlist + common + [f"tag={label}_sds"])
            res["peak"][label] = torch.cuda.max_memory_allocated() / 2**30
            res["shapes"][label] = sorted(set(rendered))
    finally:
        spans.close()
    check(zg.StableZero123Guidance.sds_loss is real_sds, "sds_loss was not restored")
    exps = dict(zip(runs, spans.results["setup"]))
    sds_key = {"nerf": "loss_sds", "static": "loss_sds", "dynamic": "loss_sds_zero123"}
    static_views = 1 + exps["static"].data.cfg.random_camera.batch_size
    frames_n = exps["dynamic"].data.cfg.num_frames
    grs = int(dict(exps["dynamic"].cfg.system.guidance).get("guidance_render_size", 0))
    predicted = {"static": {"resident_fwd": static_views, "resident_bwd_accum": static_views},
                 "dynamic": {"resident_fwd": 2 * frames_n, "resident_bwd_accum": 2 * frames_n}}
    exp1 = exps["nerf"]
    dcfg, rc = exp1.data.cfg, exp1.data.cfg.random_camera

    def first(v):  # a milestone list's first entry
        return int(v[0] if isinstance(v, (list, tuple)) else v)

    res["ms"], res["launches"] = {}, {}
    for label in runs:
        rows = [r for r in spans.steps if r[0] == label]
        check([r[1] for r in rows] == list(range(GUIDED_STEPS)), f"guided {label}: steps taken")
        for _, step, _, ms, launched, metrics in rows:
            want = predicted.get(label)
            if label == "nerf":
                n_rays = (first(dcfg.height) * first(dcfg.width),
                          first(rc.batch_size) * first(rc.height) * first(rc.width))
                fwd, bwd = stage1_predicted(n_rays, step % exp1.rcfg.grid_update_every == 0)
                want = {"hashgrid_cell_fwd": fwd, "hashgrid_cell_bwd": bwd}
            got = {k: v for k, v in launched.items() if v}
            check(got == want, f"guided {label} step {step}: launches {got} != {want}")
            check(sds_key[label] in metrics and metrics[sds_key[label]] > 0,
                  f"guided {label} step {step}: no {sds_key[label]} in the metrics")
            check(all(math.isfinite(v) for v in metrics.values()), f"guided {label} step {step}: non-finite metric")
            for k, v in launched.items():
                res["launches"][k] = res["launches"].get(k, 0) + v
        res["ms"][label] = statistics.median([r[3] for r in rows[1:]])
        print(f"[{card}] launcher {label} with the guidance (random:0): {json.dumps(want)} launches a step; "
              f"{', '.join(f'{r[3]:.1f}' for r in rows)} ms/step; {sds_key[label]} "
              f"{', '.join(f'{r[5][sds_key[label]]:.5g}' for r in rows)}; renders into SDS {res['shapes'][label]}; "
              f"peak memory {res['peak'][label]:.2f} GiB")
    check(res["shapes"]["dynamic"] == [(frames_n, grs, grs, 3)],
          f"the dynamic stage's random views did not reach SDS at guidance_render_size {grs}")
    check(exps["dynamic"].bank["c_concat"].shape[0] == exps["dynamic"].data.video_length,
          "the dynamic bank does not hold every frame")
    off = {"nerf": recipe["s1_ms"][0][-1], "static": launcher["static_ms"], "dynamic": launcher["dynamic_ms"]}
    res["off_ms"] = off
    res["bank_s"] = spans.seconds["bank"]
    print(f"[{card}] ms/step with the guidance (random:0, bfloat16) vs without it: " + "; ".join(
        f"{label} {res['ms'][label]:.2f} vs {off[label]:.2f} (the guidance's share "
        f"{1 - off[label] / res['ms'][label]:.3f})" for label in runs)
          + f"; without it = phase 12's stage-1 step at the first milestone and phase 9's launcher steps")
    print(f"[{card}] banks through the launcher: {fmt_s(res['bank_s'])} (stage 1, 4, 5); phase 5's bank of "
          f"{VIDEO_LEN} frames at {RES}²: {direct['bank_s']:.3f} s, {direct['bank_peak']:.2f} GiB above the "
          f"resident set; phase 6's of the 128² reference: {direct['s1_bank_s']:.3f} s")
    return res


def unet_macs(unet, x, t, ctx):
    """Multiply-accumulates of one UNet call: its convolutions, dense layers
    and attention products, counted from the shapes (forward hooks)."""
    import torch

    total = [0]

    def conv_hook(m, inp, out):
        total[0] += out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1] // m.groups

    def dense_hook(m, inp, out):
        total[0] += out.numel() * m.in_features

    from dreammesh4d_tpu_torch.models.guidance.zero123 import unet as zu

    hooks = []
    for m in unet.modules():
        if isinstance(m, zu.Conv2d):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, zu.Linear):
            hooks.append(m.register_forward_hook(dense_hook))
        elif isinstance(m, zu.CrossAttention):
            def attn_hook(m, inp, out):
                q = inp[0]
                k = inp[1] if len(inp) > 1 and inp[1] is not None else q
                total[0] += 2 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]
            hooks.append(m.register_forward_hook(attn_hook))
    try:
        with torch.no_grad():
            unet(x, t, ctx)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def resident_fwd_bound(args, stats):
    """The least time the card could take for one B1 launch on these inputs:
    rows, pairs, starts, counts read once and the (T, C + 1, tile²) blocks
    written once, over 3.35 TB/s; per evaluated (pair, pixel) 19 FP32
    operations of geometry, exp, clamp and tests, per composited one 3 + 2C
    more (weight, C FMAs, transmittance), over 67 TFLOP/s.  Returns (ms,
    bound_by, bytes, operations)."""
    rows, pairs, starts, counts = args[:4]
    C, P = args[-1], args[5] ** 2
    n_bytes = 4 * (rows.numel() + pairs.numel() + starts.numel() + counts.numel()
                   + starts.numel() * (C + 1) * P)
    n_ops = stats["pairs_read"] * P * 19 + stats["live_pixels"] * (3 + 2 * C)
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations", n_bytes, n_ops


def captured_pair_inputs(torch, rb, render, alive):
    """B1's inputs as the Gaussian stage hands them over: runs ``render()``
    once under ``no_grad`` with recorders on ``resident_blend.blend_pairs_cuda``
    and the rasterizer's ``bin_gaussians_pairs``, and returns the first
    view's (rows, pairs, starts, counts, tiles_x, tile, cap, group, C) and its
    tile report: the fullest tile's pairs against the capacity, the pairs
    in all, and the pairs of dead slots (``alive`` False: opacity 0, which
    the binning's cull must drop)."""
    rz = importlib.import_module("dreammesh4d_tpu_torch.ops.gs.rasterize")
    blends, binnings = [], []
    real_blend, real_bin = rb.blend_pairs_cuda, rz.bin_gaussians_pairs

    def record_blend(*args, **kw):
        blends.append(args)
        return real_blend(*args, **kw)

    def record_bin(*args, **kw):
        out = real_bin(*args, **kw)
        binnings.append(out)
        return out

    rb.blend_pairs_cuda, rz.bin_gaussians_pairs = record_blend, record_bin
    try:
        with torch.no_grad():
            render()
    finally:
        rb.blend_pairs_cuda, rz.bin_gaussians_pairs = real_blend, real_bin
    check(len(blends) >= 1 and len(binnings) == len(blends), "the render did not reach B1 through the pairs")
    pa, args = binnings[0], blends[0]
    N = alive.shape[0]
    ids = pa.sorted_gauss.long()
    valid = ids < N
    report = {"max_tile_pairs": int(pa.counts.max()), "tile_capacity": int(args[6]),
              "tiles_over_capacity": int((pa.counts > args[6]).sum()), "pairs": int(valid.sum()),
              "dead_slot_pairs": int((~alive[ids[valid]]).sum()), "alive": int(alive.sum()), "slots": N}
    return args, report


def drive_gaussian_stage(torch, np, rb, card, launcher, device, tmp):
    """The Gaussian stage main path (phase 14): configs/sugar_static_refine.yaml
    with ``system.stage=gaussian`` through ``dreammesh4d_tpu_torch.launch.main``
    at the YAML's 512² and 1 + 4 views, capacity 200,000 (``max_num``'s
    default), the reference image phase 9's frame 0.

    (a) The YAML's random ball of 5,000 Gaussians with the intervals of
    ``GS_FREQ`` (a densify and prune at step 2, the opacity reset after step
    3, the neighbour table every 2 steps, the SuGaR terms from step 1): train
    GS_STEPS steps, guidance off, then ``resume=LAST`` to GS_RESUMED_STEPS,
    then ``--export resume=LAST`` (``gaussians.ply`` of the alive slots); the
    same start with the guidance at ``random:0`` for GS_GUIDED_STEPS steps.
    (b) ``init_num_pts=GS_BIG_INIT``, GS_BIG_STEPS steps; B1 and B2 on one
    view of its state held to their plain versions (``check_forward`` /
    ``check_backward``'s bands) and timed.  Checks the 5 + 5 B1/B2 launches
    of every step, ``n_alive`` changing at the densify (``gauss_num``), the
    SDS term with the guidance, the resumed start, the file's row count, and
    that no pair of a dead slot reaches a tile; prints ms/step, the seconds
    of ``refresh_knn`` and ``densify_and_prune``, peak memory and the fullest
    tile's pairs against the capacity."""
    from dreammesh4d_tpu_torch import launch
    from dreammesh4d_tpu_torch.config import load_config
    from dreammesh4d_tpu_torch.export.gaussian_io import load_gaussians_ply
    from dreammesh4d_tpu_torch.systems import assembly, gaussian_stage
    from dreammesh4d_tpu_torch.utils.checkpoint import restore_checkpoint

    def counts():
        return dict(rb.launch_counts)

    yaml = os.path.join(REPO, "configs", "sugar_static_refine.yaml")
    out = os.path.join(tmp, "gaussian_out")
    common = ["system.stage=gaussian", "system.guidance.pretrained_model_name_or_path=none",
              f"data.image_path={launcher['frames_dir']}/000_rgba.png", f"exp_root_dir={out}",
              "use_timestamp=false", "checkpoint.every_n_train_steps=2", "trainer.val_check_interval=1000"]
    run_a = common + GS_FREQ + ["tag=a"]
    trial_a = os.path.join(out, "sugar-refine", "a")
    spans = Spans(torch, counts)
    spans.time(launch, "build_experiment", "setup", keep=True)
    spans.time(assembly, "make_reg_state", "refresh_knn")
    spans.time(gaussian_stage, "densify_and_prune", "densify_and_prune")
    spans.train_steps(assembly.GaussianStageExperiment, "gaussian")
    res, peaks = {}, {}
    rb.reset_launch_counts()
    try:
        for label, verb, extra in (
                ("a", "train", [f"trainer.max_steps={GS_STEPS}"]),
                ("a resumed", "train", [f"trainer.max_steps={GS_RESUMED_STEPS}", "resume=LAST"]),
                ("a export", "export", [f"trainer.max_steps={GS_RESUMED_STEPS}", "resume=LAST"]),
                ("a guided", "train", [f"trainer.max_steps={GS_GUIDED_STEPS}", "tag=a_guided",
                                       "system.guidance.pretrained_model_name_or_path=random:0"]),
                ("b", "train", [f"trainer.max_steps={GS_BIG_STEPS}", "tag=b",
                                f"system.geometry.init_num_pts={GS_BIG_INIT}"])):
            torch.cuda.reset_peak_memory_stats()
            base = common + ["tag=b"] if label == "b" else run_a
            launch.main(launch.make_args(yaml, verb), base + extra)
            torch.cuda.synchronize()
            peaks[label] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        spans.close()
    res["launches"] = launches = counts()
    print(f"Gaussian stage launches (steps, test passes, none in the export): {json.dumps(launches)}")
    exps = dict(zip(("a", "a resumed", "a export", "a guided", "b"), spans.results["setup"]))
    views = 1 + exps["a"].data.cfg.random_camera.batch_size
    want = {"resident_fwd": views, "resident_bwd_accum": views}
    rows = spans.steps
    check([r[1] for r in rows] == list(range(GS_STEPS)) + list(range(GS_STEPS, GS_RESUMED_STEPS))
          + list(range(GS_GUIDED_STEPS)) + list(range(GS_BIG_STEPS)), "Gaussian stage: steps taken")
    for _, step, _, _, launched, metrics in rows:
        got = {k: v for k, v in launched.items() if v}
        check(got == want, f"Gaussian stage step {step}: launches {got} != {want}")
        check(all(math.isfinite(v) for v in metrics.values()), f"Gaussian stage step {step}: non-finite metric")
    check(launches["resident_bwd_pairs"] == 0, "the Gaussian stage launched B3")
    runs = {"a": rows[:GS_STEPS], "a resumed": rows[GS_STEPS:GS_RESUMED_STEPS],
            "a guided": rows[GS_RESUMED_STEPS:GS_RESUMED_STEPS + GS_GUIDED_STEPS],
            "b": rows[GS_RESUMED_STEPS + GS_GUIDED_STEPS:]}
    resumed = runs["a resumed"][0]
    check(resumed[1] == resumed[2] == GS_STEPS, "the resumed Gaussian run did not start at the saved step")
    init_alive = exps["a"].gcfg.init_num
    densified = [r for r in runs["a"] + runs["a resumed"] if "gauss_num" in r[5]]
    check([r[1] for r in densified] == [2, 4], f"densify at steps {[r[1] for r in densified]}, not [2, 4]")
    check(int(densified[0][5]["gauss_num"]) != init_alive, "the densify at step 2 left n_alive unchanged")
    check(all("loss_sds" in r[5] for r in runs["a guided"]) and not any("loss_sds" in r[5] for r in runs["a"]),
          "the SDS term is not in the guided steps' metrics only")
    cfg_a = load_config(yaml, cli_args=run_a + [f"trainer.max_steps={GS_RESUMED_STEPS}"], makedirs=False)
    exp = assembly.build_experiment(cfg_a, device=device)
    saved = restore_checkpoint(os.path.join(trial_a, "ckpts", f"step_{GS_RESUMED_STEPS:08d}"), device)
    exp.load_state(saved)
    n_alive = int(exp.state.gaussians.alive.sum())
    check(float(exp.state.opt_state.state[exp.state.gaussians.xyz]["step"]) == GS_RESUMED_STEPS,
          "the resumed run's Adam count is not the step count")
    ply = load_gaussians_ply(os.path.join(trial_a, "save", "gaussians.ply"))
    check(ply["xyz"].shape[0] == n_alive, f"gaussians.ply holds {ply['xyz'].shape[0]} rows, not {n_alive} alive")
    alive_np = exp.state.gaussians.alive.cpu().numpy()
    check(np.array_equal(ply["xyz"], exp.state.gaussians.xyz.detach().cpu().numpy()[alive_np]),
          "gaussians.ply's centres are not the alive slots'")
    _, report_a = captured_pair_inputs(torch, rb, lambda: exp.validate(GS_RESUMED_STEPS),
                                       exp.state.gaussians.alive)
    print(f"Gaussian stage (a) after {GS_RESUMED_STEPS} steps: n_alive {init_alive} -> "
          f"{', '.join(str(int(r[5]['gauss_num'])) for r in densified)} at steps "
          f"{[r[1] for r in densified]}; one view's binning {json.dumps(report_a)}")
    check(report_a["dead_slot_pairs"] == 0, "a dead slot (opacity 0) reached a tile")

    # (b) B1/B2 at ~100k alive against their plain versions
    big = exps["b"]
    args, report_b = captured_pair_inputs(torch, rb, lambda: big.validate(GS_BIG_STEPS), big.state.gaussians.alive)
    print(f"Gaussian stage (b), {report_b['alive']} alive of {report_b['slots']}: one view's binning "
          f"{json.dumps(report_b)}")
    check(report_b["dead_slot_pairs"] == 0, "(b): a dead slot reached a tile")
    b1_err, _, _ = check_forward(torch, rb, {"gaussian_100k": args})
    bwd_err, bwd_work, _ = check_backward(torch, rb, {"gaussian_100k": args})
    res["b1_err"], res["bwd_err"] = b1_err, bwd_err
    out_b = rb.blend_pairs_cuda(*args)
    cot = torch.randn(out_b.shape, generator=torch.Generator(device=device).manual_seed(5), device=device)
    seg, shape = args[:4], args[4:]
    res["b1_device_ms"] = device_ms(torch, lambda: rb.blend_pairs_cuda(*args), "resident_fwd_kernel")
    res["b2_device_ms"] = device_ms(torch, lambda: rb.blend_pairs_bwd_cuda(*seg, out_b, cot, *shape),
                                    "resident_bwd_kernel")
    res["b1_plain_ms"] = time_ms(torch, lambda: rb.blend_pairs_plain(*args), n=5)
    res["b2_plain_ms"] = time_ms(torch, lambda: rb.blend_pairs_bwd_plain(*seg, out_b, cot, *shape), n=5)
    b1_stats = {}
    rb.blend_pairs_plain(*args, stats=b1_stats)
    b1_bound = resident_fwd_bound(args, b1_stats)
    b2_bound = kernel_bounds(args, bwd_work["gaussian_100k"], args[0].shape[0], False)
    res["report_a"], res["report_b"] = report_a, report_b
    print(f"[{card}] B1 at {report_b['alive']} alive (C={args[-1]}): {res['b1_device_ms']:.4f} ms device time "
          f"(plain {res['b1_plain_ms']:.3f} ms; bound {b1_bound[0]:.4f} ms by {b1_bound[1]}); B2 "
          f"{res['b2_device_ms']:.4f} ms (plain {res['b2_plain_ms']:.3f} ms; bound {b2_bound[0]:.4f} ms by "
          f"{b2_bound[1]})")

    sec = spans.seconds
    for label, rws in runs.items():
        ms = [r[3] for r in rws]
        res[f"{label}_ms"] = statistics.median(ms[1:] or ms)
        print(f"[{card}] Gaussian stage {label} train_step ({json.dumps(want)} per step; the densify, "
              f"neighbour refresh and opacity reset inside the steps that run them): "
              f"{res[f'{label}_ms']:.2f} ms/step (median without the run's first step; all: "
              f"{', '.join(f'{x:.1f}' for x in ms)}); loss_total {rws[0][5]['loss_total']:.6g} -> "
              f"{rws[-1][5]['loss_total']:.6g}")
    res["knn_s"], res["densify_s"] = sec["refresh_knn"], sec["densify_and_prune"]
    print(f"[{card}] Gaussian stage seconds: refresh_knn at C = {exps['a'].gcfg.capacity} "
          f"{fmt_s(sec['refresh_knn'])}; densify_and_prune {fmt_s(sec['densify_and_prune'])}; setup "
          f"(build_experiment) {fmt_s(sec['setup'])}; peak memory {json.dumps({k: round(v, 3) for k, v in peaks.items()})} GiB")
    res["peaks"] = peaks
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


MULTI_STEPS = 2  # each guided layout of phase 16: the first step's checks and one later step's
MULTI_GS_STEPS = 3  # the Gaussian stage's layout: across its densify at step 2 (GS_FREQ)
MULTI_RTOL = 1e-4  # the first step's logged losses and gradient, two ranks against one process
MULTI_ATOL = 1e-7
# the later steps' losses: after one Adam step (eps 1e-8, 1e-15) a gradient
# element at rounding level has moved by ±lr, so two trajectories that sum
# in another order part at ~1e-4 (PERF.md, PR 12)
MULTI_RTOL_LATER = 1e-2
# the held guidance of phase 16, with cuDNN's TF32 off: TF32 convolutions
# round by the algorithm cuDNN picks for a batch, and the split batches
# pick others
MULTI_DTYPE = "float32"
MULTI_RENDER_N = 8  # render_4d orbit / play frames
EXP_DIRS = {"dynamic": "sugar-dynamic", "static": "sugar-refine"}  # the YAMLs' names


def multidevice_rank(rank, jobs, out_dir):
    """One rank of phase 16, spawned by ``launch.spawn`` inside a ``gloo``
    group on the one card: every job's ``launch.main`` in the group, each
    step timed (the card synchronised) with its B1/B2 launches, written to
    ``<out_dir>/<job>_rank<rank>.json`` with the peak memory, the UNet's
    parameter bytes on this rank and the alive Gaussians."""
    import torch

    from dreammesh4d_tpu_torch import launch
    from dreammesh4d_tpu_torch.ops.gs import resident_blend as rb
    from dreammesh4d_tpu_torch.systems import assembly

    torch.backends.cudnn.allow_tf32 = False  # as the one-process runs it is held to
    for name, yaml, extras in jobs:
        spans = Spans(torch, lambda: dict(rb.launch_counts))
        spans.time(launch, "build_experiment", "setup", keep=True)
        for cls in (assembly.SugarStaticExperiment, assembly.Sugar4DGenExperiment,
                    assembly.GaussianStageExperiment):
            spans.train_steps(cls, name)
        torch.cuda.reset_peak_memory_stats()
        try:
            launch.main(launch.make_args(yaml, "train"), extras)
        finally:
            spans.close()
        exp = spans.results["setup"][0]
        unet = exp.guidance.modules.unet if exp.guidance is not None else None
        gaussians = getattr(exp.state, "gaussians", None)
        rec = {"dp": exp.par.dp, "tp": exp.par.tp, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "steps": [{"step": r[1], "ms": r[3], "launches": r[4], "metrics": r[5]} for r in spans.steps],
               "unet_bytes": sum(p.numel() * p.element_size() for p in unet.parameters()) if unet else 0,
               "n_alive": int(gaussians.alive.sum()) if gaussians is not None else None}
        with open(os.path.join(out_dir, f"{name}_rank{rank}.json"), "w") as f:
            json.dump(rec, f)


def loss_errors(rows, ref):
    """Per metric row, the largest relative error of a logged loss of
    ``rows`` against ``ref`` (floored at MULTI_ATOL / MULTI_RTOL) and what
    it was."""
    out = []
    for a, b in zip(rows, ref):
        worst = (0.0, "")
        for k in b:
            if k.startswith("loss"):
                err = abs(a[k] - b[k]) / max(abs(b[k]), MULTI_ATOL / MULTI_RTOL)
                worst = max(worst, (err, f"{k} step {int(b['step'])}: {a[k]:.7g} vs {b[k]:.7g}"))
        out.append(worst)
    return out


def first_step_grad_error(trial, ref_trial):
    """The largest difference of Adam's first moment after the first step,
    (1 − β1)·g of the first step's gradient, between two trials, over the
    state's largest |value| (as ``tests/test_torch_launch_multidevice.py``
    holds it), and which leaf."""
    import torch

    def moments(t):
        state = torch.load(os.path.join(t, "ckpts", "step_00000001", "state.pt"), map_location="cpu",
                           weights_only=True)["opt_state"]["state"]
        return [state[k]["exp_avg"] for k in sorted(state)]

    a, b = moments(trial), moments(ref_trial)
    check(len(a) == len(b) > 0, f"{trial}: {len(a)} Adam entries, the single run {len(b)}")
    top = max(float(m.abs().max()) for m in b)
    return max((float((x - y).abs().max()) / top, f"leaf {i} of {len(b)}") for i, (x, y) in enumerate(zip(a, b)))


def metrics_rows(trial):
    import csv

    with open(os.path.join(trial, "metrics.csv")) as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def drive_multidevice(torch, np, rb, card, launcher, device, tmp):
    """More than one device (phase 16).  (a) The launcher refuses
    ``trainer.devices`` above the visible cards ("visible"), before any
    process or file.  (b) Two ranks spawned here (``launch.spawn``), both on
    the one card, in a ``gloo`` group carrying CUDA tensors through host
    memory (NCCL refuses two ranks on one device): configs/sugar_dynamic_dg.yaml
    at full width for MULTI_STEPS steps at mesh [2,1] (the frames split) and
    [1,2] (the UNet's attention and FF split), sugar_static_refine.yaml at
    [2,1], each with the guidance at ``random:0`` in MULTI_DTYPE with its
    output convolutions drawn (``zero_init=false``, so that the split layers
    reach the loss), on phase 9's assets; every logged loss held to the
    single-process run of the same dotlist (run here), cuDNN's TF32 off in
    both so that float32 convolutions do not round by the algorithm picked
    for each batch: the first step's losses and its gradient (Adam's first
    moment after one step, (1 − β1)·g) at MULTI_RTOL, the later steps'
    losses at MULTI_RTOL_LATER; the
    B1/B2 launches of every step on each rank (its share of the views); and
    the Gaussian stage at [2,1] across one densify (the YAML's ball,
    GS_FREQ, MULTI_GS_STEPS steps): ``n_alive`` equal on both ranks.
    Prints ms/step per layout and the peak
    memory per rank (two ranks sharing one card over ``gloo``: not a
    multi-card figure), and the UNet's parameter bytes per rank at tp=2
    against tp=1.  (c) ``scripts/render_4d`` on phase 9's dynamic trial:
    ``frame`` byte-equal to ``write_png`` of ``Viewer4D.render`` at the same
    arguments, ``orbit`` / ``play --n MULTI_RENDER_N`` numbered PNGs and the
    sidecar, with their seconds."""
    from dreammesh4d_tpu_torch import launch
    from dreammesh4d_tpu_torch.config import load_config
    from dreammesh4d_tpu_torch.data.png import read_png, write_png
    from dreammesh4d_tpu_torch.scripts import render_4d
    from dreammesh4d_tpu_torch.serving import Viewer4D

    res = {"launches": {}}
    before = dict(rb.launch_counts)
    drop = ("tag=", "trainer.max_steps=", "trainer.val_check_interval=", "exp_root_dir=",
            "system.guidance.pretrained_model_name_or_path=", "checkpoint.")
    out = os.path.join(tmp, "multi")

    def guidance(dtype):
        return ["system.guidance.pretrained_model_name_or_path=random:0", "system.guidance.zero_init=false",
                f"system.guidance.dtype={dtype}"]

    common = [f"exp_root_dir={out}", f"trainer.max_steps={MULTI_STEPS}", "trainer.val_check_interval=100000",
              "trainer.log_every_n_steps=1", "checkpoint.every_n_train_steps=1"]
    static_yaml, _, static_list = launcher["trials"]["static"]
    dyn_yaml, dyn_trial, dyn_list = launcher["trials"]["dynamic"]
    static = [x for x in static_list if not x.startswith(drop)] + common
    dynamic = [x for x in dyn_list if not x.startswith(drop)] + common

    # (a) the launcher's refusal
    over = torch.cuda.device_count() + 1
    try:
        launch.main(launch.make_args(static_yaml, "train"), static + guidance(MULTI_DTYPE)
                    + [f"trainer.devices={over}", "tag=refused"])
    except ValueError as e:
        check("visible" in str(e), f"trainer.devices={over}: {e}")
        print(f"[{card}] the launcher refuses trainer.devices={over} on {over - 1} card(s): {e}")
    else:
        fail(f"the launcher ran trainer.devices={over} on {over - 1} card(s)")
    check(not os.path.exists(os.path.join(out, "sugar-refine", "refused")), "the refused run wrote a trial")

    # (b) two ranks on the card, and one process for reference: name ->
    # (YAML, dotlist, mesh, the single run it is held to, steps)
    gaussian = [x for x in static if not x.startswith("system.geometry.surface")] + GS_FREQ + [
        "system.stage=gaussian", "system.guidance.pretrained_model_name_or_path=none",
        f"trainer.max_steps={MULTI_GS_STEPS}"]
    layouts = {"dynamic_dp": (dyn_yaml, dynamic + guidance(MULTI_DTYPE), "[2,1]", "dynamic", MULTI_STEPS),
               "dynamic_tp": (dyn_yaml, dynamic + guidance(MULTI_DTYPE), "[1,2]", "dynamic", MULTI_STEPS),
               "static_dp": (static_yaml, static + guidance(MULTI_DTYPE), "[2,1]", "static", MULTI_STEPS),
               "gaussian_dp": (static_yaml, gaussian, "[2,1]", None, MULTI_GS_STEPS)}
    jobs = [(name, yaml, dotlist + [f"tag={name}", "trainer.devices=2", f"trainer.mesh={mesh}"])
            for name, (yaml, dotlist, mesh, _, _) in layouts.items()]
    t0 = time.perf_counter()
    launch.spawn(multidevice_rank, 2, device, backend="gloo", args=(jobs, out))
    res["spawn_s"] = time.perf_counter() - t0
    single = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for kind, yaml, dotlist in (("dynamic", dyn_yaml, dynamic + guidance(MULTI_DTYPE)),
                                    ("static", static_yaml, static + guidance(MULTI_DTYPE))):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            launch.main(launch.make_args(yaml, "train"), dotlist + [f"tag={kind}_single"])
            single[kind] = {"s": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated() / 2**30,
                            "rows": metrics_rows(os.path.join(out, EXP_DIRS[kind.split("_")[0]],
                                                              f"{kind}_single"))}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    recs = {name: [json.load(open(os.path.join(out, f"{name}_rank{r}.json"))) for r in range(2)]
            for name in layouts}
    frames_n = int(load_config(dyn_yaml, cli_args=dynamic, makedirs=False).data["num_frames"])
    share = {"static": 1 + STATIC_RAND_VIEWS // 2, "gaussian": 1 + STATIC_RAND_VIEWS // 2}
    res["worst"] = {}
    for name, (_, _, mesh, ref_kind, n_steps) in layouts.items():
        dp = int(mesh[1])
        n_views = 2 * frames_n // dp if name.startswith("dynamic") else share[name.split("_")[0]]
        want = {"resident_fwd": n_views, "resident_bwd_accum": n_views}
        for r, rec in enumerate(recs[name]):
            check((rec["dp"], rec["tp"]) == (dp, 2 // dp), f"{name} rank {r}: grid {rec['dp']} x {rec['tp']}")
            check([s["step"] for s in rec["steps"]] == list(range(n_steps)), f"{name} rank {r}: steps taken")
            for s in rec["steps"]:
                got = {k: v for k, v in s["launches"].items() if v}
                check(got == want, f"{name} rank {r} step {s['step']}: launches {got} != {want} (its share)")
                for k, v in s["launches"].items():
                    res["launches"][k] = res["launches"].get(k, 0) + v
            ms = [s["ms"] for s in rec["steps"]]
            print(f"[{card}] two ranks sharing one card over gloo, {name} mesh {mesh} rank {r}: "
                  + ", ".join(f"{x:.1f}" for x in ms) + f" ms/step (median after the first "
                  f"{statistics.median(ms[1:]):.1f}), peak memory {rec['peak_gib']:.2f} GiB, "
                  f"{json.dumps(want)} launches a step")
        if ref_kind is None:
            continue
        rows = metrics_rows(os.path.join(out, EXP_DIRS[name.split("_")[0]], name))
        ref = single[ref_kind]["rows"]
        check(len(rows) == len(ref) == MULTI_STEPS, f"{name}: {len(rows)} metric rows, single {len(ref)}")
        check(all(sorted(a) == sorted(b) for a, b in zip(rows, ref)),
              f"{name}: metric keys differ from the single run's")
        errs = loss_errors(rows, ref)
        grad_err = first_step_grad_error(os.path.join(out, EXP_DIRS[name.split("_")[0]], name),
                                         os.path.join(out, EXP_DIRS[ref_kind.split("_")[0]],
                                                      f"{ref_kind}_single"))
        res["worst"][name] = {"losses": errs, "grad": grad_err}
        print(f"[{card}] {name} against one process: worst loss error per step "
              + ", ".join(f"{e:.3g} ({d})" for e, d in errs) + f"; the first step's gradient {grad_err[0]:.3g} "
              f"of the state's max ({grad_err[1]}); held to {MULTI_RTOL} (step 0, gradient) and "
              f"{MULTI_RTOL_LATER} (later steps)")
        for k, (e, d) in enumerate(errs):
            band = MULTI_RTOL if k == 0 else MULTI_RTOL_LATER
            check(e <= band, f"{name} step {k}: a logged loss off the single run by {e:.3g} > {band} ({d})")
        check(grad_err[0] <= MULTI_RTOL, f"{name}: the first step's gradient off by {grad_err[0]:.3g}")
    alive = [rec["n_alive"] for rec in recs["gaussian_dp"]]
    check(alive[0] == alive[1], f"Gaussian stage at [2,1]: n_alive {alive} differs between the ranks")
    print(f"[{card}] Gaussian stage at [2,1] after the densify at step 2: n_alive {alive[0]} on both ranks")
    bytes_tp = [rec["unet_bytes"] for rec in recs["dynamic_tp"]]
    bytes_dp = recs["dynamic_dp"][0]["unet_bytes"]
    check(bytes_tp[0] == bytes_tp[1] < bytes_dp, f"UNet bytes per rank at tp=2 {bytes_tp} vs tp=1 {bytes_dp}")
    res["unet_mib"] = (bytes_dp / 2**20, bytes_tp[0] / 2**20)
    print(f"[{card}] UNet parameter bytes per rank (float32 parameters): tp=1 {bytes_dp / 2**20:.1f} MiB, "
          f"tp=2 {bytes_tp[0] / 2**20:.1f} MiB; spawn + {len(layouts)} layouts {res['spawn_s']:.1f} s; one "
          "process: " + ", ".join(f"{k} {v['s']:.1f} s (peak {v['peak']:.2f} GiB)" for k, v in single.items()))

    # (c) the serving CLI on phase 9's dynamic trial
    cli = os.path.join(tmp, "render_4d")
    os.makedirs(cli, exist_ok=True)
    pose = ["--elevation", "10", "--azimuth", "45", "--distance", "3.8", "--t", "0.5", "--device", str(device)]
    res["cli_s"] = {}
    t0 = time.perf_counter()
    render_4d.main(["--trial", dyn_trial, "--mode", "frame", "--out", os.path.join(cli, "frame.png"), *pose])
    res["cli_s"]["frame"] = time.perf_counter() - t0
    img = Viewer4D.from_trial(dyn_trial, device=device).render(10.0, 45.0, 3.8, 0.5)
    ref = write_png(os.path.join(cli, "ref.png"), render_4d.to_u8(img))
    with open(os.path.join(cli, "frame.png"), "rb") as a, open(ref, "rb") as b:
        check(a.read() == b.read(), "render_4d frame is not byte-equal to write_png(Viewer4D.render)")
    for mode in ("orbit", "play"):
        t0 = time.perf_counter()
        written = render_4d.main(["--trial", dyn_trial, "--mode", mode, "--n", str(MULTI_RENDER_N),
                                  "--distance", "3.8", "--device", str(device),
                                  "--out", os.path.join(cli, f"{mode}.gif")])
        res["cli_s"][mode] = time.perf_counter() - t0
        check(len(written) == MULTI_RENDER_N + 1, f"render_4d {mode}: wrote {len(written)} files")
        check(json.load(open(os.path.join(cli, f"{mode}.json")))["frames"] == MULTI_RENDER_N,
              f"render_4d {mode}: sidecar")
        check(read_png(written[0]).std() > 0, f"render_4d {mode}: a blank frame")
    print(f"[{card}] render_4d on phase 9's dynamic trial: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in res["cli_s"].items()) + f" (frame byte-equal; orbit / play {MULTI_RENDER_N} PNGs)")
    after = dict(rb.launch_counts)
    for k in after:
        res["launches"][k] = res["launches"].get(k, 0) + after[k] - before.get(k, 0)
    return res


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


# ---------------------------------------------------------------------------
# 17. the zoo: the six NeRF YAMLs of configs/zoo through the launcher
# ---------------------------------------------------------------------------

ZOO_STEPS = 2  # trainer.max_steps of each zoo run
ZOO_PROMPT = "a test object"
# name: (configs/zoo/<name>.yaml takes an image, the guidance keys, the SDS metrics)
ZOO_YAMLS = {
    "zero123": (True, ("system.guidance",), ("loss_sds",)),
    "dreamfusion-sd": (False, ("system.guidance",), ("loss_sds",)),
    "magic3d-coarse-sd": (False, ("system.guidance",), ("loss_sds",)),
    "dreamfusion-sd-eff": (False, ("system.guidance",), ("loss_sds",)),
    "magic123-coarse-sd": (True, ("system.guidance", "system.guidance_3d"), ("loss_sds_2d", "loss_sds_3d")),
    "imagecondition": (True, ("system.guidance",), ("loss_sds_2d",)),
}
ZOO_EXPORTED = ("dreamfusion-sd", "magic123-coarse-sd")  # also --validate and --export
# profiled for one step: the profiler's own cost over magic123's ~141,600
# launches a step was ~100 s (H100 80GB HBM3, 700 W)
ZOO_PROFILED = ("dreamfusion-sd",)
ZOO_SD = {}  # the SD config of the card-vs-CPU check: SD 1.5's widths, float32


def zoo_point_counts(exp):
    """(fine, coarse) sample points of one zoo step: every rendered ray
    takes the renderer's coarse samples without gradients and its coarse +
    fine samples with the analytic normal; zero123-system's 3D normal
    smoothness evaluates its random views' samples once more."""
    s1, s2 = exp.rcfg.num_samples_coarse, exp.rcfg.num_samples_fine
    n = {k: v.reshape(-1, 3).shape[0] for k, v in exp.train_batch(0).items() if k.endswith("rays_o")}
    rays = sum(n.values())
    return (rays + n.get("rand_rays_o", 0)) * (s1 + s2), rays * s1


def zoo_guidance_ms(torch, exp, device):
    """Every SDS term of one zoo step, timed alone (CUDA events): each
    guidance's ``sds_loss`` and its backward into a render of the step's
    shape (efficient-dreamfusion's after its resize to ``data.height``)."""
    batch = exp.train_batch(0)
    rays = batch["rand_rays_o"] if "rand_rays_o" in batch else batch["rays_o"]
    B, H, W = rays.shape[:3]
    if getattr(exp, "_eff", False):
        H = W = int(exp.cfg.data.height)
    view = [batch[k] for k in ("elevation", "azimuth", "camera_distances")]
    gen = torch.Generator(device=device).manual_seed(5)
    rgb0 = torch.rand((B, H, W, 3), generator=gen, device=device)
    terms = []
    if getattr(exp, "pack", None) is not None:
        sd, prompts = exp.pack
        terms.append(lambda rgb: sd.sds_loss(prompts, rgb, *view, 0, gen)["loss_sds"])
    zero123 = getattr(exp, "guidance_3d", None) or getattr(exp, "guidance", None)
    if zero123 is not None:
        terms.append(lambda rgb: zero123.sds_loss(exp.bank, rgb, *view, None, 0, gen)["loss_sds"])

    def run():
        rgb = rgb0.clone().requires_grad_(True)
        sum(term(rgb) for term in terms).backward()

    return time_ms(torch, run, n=3, warmup=1), (B, H, W)


def corner_grid_ms(torch, geo_cfg, fine, coarse, device):
    """The corner hash grid's work in one step, timed alone (CUDA events):
    the coarse points encoded without gradients; the fine points encoded
    twice (the field, and the density whose point gradient is the normal),
    that gradient taken with its graph, and the backward of both into the
    tables.  One pass over all of the step's points: the step renders 8192
    rays at a time and recomputes each chunk's forward in the backward, so
    this is the least the grid costs there."""
    from dreammesh4d_tpu_torch.ops.hashgrid import hashgrid_encode, init_hashgrid

    cfg = geo_cfg.hashgrid
    gen = torch.Generator(device=device).manual_seed(3)
    params = {"tables": init_hashgrid(cfg, gen, device)["tables"].requires_grad_(True)}
    x = torch.rand((fine, 3), generator=gen, device=device)
    xc = torch.rand((coarse, 3), generator=gen, device=device)
    w = torch.randn((cfg.out_dim, 1), generator=gen, device=device)

    def run():
        with torch.no_grad():
            hashgrid_encode(params, cfg, xc)
        field = hashgrid_encode(params, cfg, x) @ w
        xr = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad((hashgrid_encode(params, cfg, xr) @ w).sum(), xr, create_graph=True)
        (field.sum() + g.square().sum()).backward()
        params["tables"].grad = None

    return time_ms(torch, run, n=3, warmup=1)


def zoo_sds_card_vs_cpu(torch, card, device):
    """One float32 SD ``sds_loss`` (B = 1) at full width on the card and on
    the CPU: the same weights (every layer drawn, the zero-initialised
    output convolutions too, so that the UNet's output is not zero), prompt
    embeddings and draws.  Returns the card's ms of one SDS forward +
    backward and the errors."""
    from dreammesh4d_tpu_torch.models.guidance.stable_diffusion import (StableDiffusionGuidance,
                                                                       StableDiffusionPromptProcessor)
    from dreammesh4d_tpu_torch.models.guidance.zero123.unet import init_weights

    on_card = StableDiffusionGuidance(ZOO_SD, device=device)
    init_weights(on_card.modules, torch.Generator(device=device).manual_seed(0))
    on_cpu = StableDiffusionGuidance(ZOO_SD, device="cpu")
    on_cpu.modules.load_state_dict({k: v.cpu() for k, v in on_card.modules.state_dict().items()})
    gen = torch.Generator().manual_seed(11)
    L = on_card.cfg.latent_size
    u, noise = torch.tensor([0.37]), torch.randn((1, 4, L, L), generator=gen)
    rgb0 = smooth_images(torch, 1, 64, 12)
    view = [torch.tensor([v]) for v in (20.0, 30.0, 1.8)]  # elevation, azimuth (front), distance
    outs = {}
    for label, g, dev in (("card", on_card, device), ("cpu", on_cpu, "cpu")):
        prompts = StableDiffusionPromptProcessor({"prompt": ZOO_PROMPT}, device=dev)()
        rgb = rgb0.to(dev).requires_grad_(True)
        out = g.sds_loss(prompts, rgb, *(v.to(dev) for v in view), 0, u=u, noise=noise)
        out["loss_sds"].backward()
        outs[label] = ({k: float(out[k]) for k in ("loss_sds", "grad_norm")}, rgb.grad.cpu())
        if label == "card":
            def sds_step(g=g, prompts=prompts):
                r = rgb0.to(dev).requires_grad_(True)
                g.sds_loss(prompts, r, *(v.to(dev) for v in view), 0, u=u, noise=noise)["loss_sds"].backward()

            ms = time_ms(torch, sds_step, n=5, warmup=1)
    (got, gc), (p, gp) = outs["card"], outs["cpu"]
    errs = {k: abs(got[k] - p[k]) / abs(p[k]) for k in got}
    grad_err = rel_err(gc, gp)
    c = on_card.cfg
    print(f"[{card}] SD sds_loss (UNet {c.model_channels} x {list(c.channel_mult)}, VAE {c.vae_ch} at "
          f"{c.image_size}^2, latents {c.latent_size}^2), float32, card vs CPU: loss {got['loss_sds']:.8g} vs {p['loss_sds']:.8g} (relative {errs['loss_sds']:.3g}), "
          f"grad_norm relative {errs['grad_norm']:.3g} (limit {SDS_CPU_TOL}); d loss/d rgb max |d| / max "
          f"{grad_err:.3g} (limit {SDS_CPU_GRAD_TOL}); one SDS forward + backward on the card {ms:.2f} ms; "
          f"{sum(x.numel() for x in on_card.modules.parameters())} parameters")
    check(all(e <= SDS_CPU_TOL for e in errs.values()) and grad_err <= SDS_CPU_GRAD_TOL and p["loss_sds"] > 0,
          "SD sds_loss: card and CPU differ")
    return {"sds_ms": ms, "sds_err": max(errs.values()), "sds_grad_err": grad_err}


def drive_zoo(torch, np, rb, tb, hc, card, launcher, device, tmp):
    """Phase 17, the zoo's NeRF systems: (a) the SD guidance float32 card vs
    CPU (``zoo_sds_card_vs_cpu``); (b) the six YAMLs of ZOO_YAMLS through
    ``launch.main`` at their full widths (hash grid 16 × 2 × 2^19 corner
    rows, 64 + 64 samples a ray; SD 1.5's and Stable Zero123's widths,
    float32) with every guidance at ``random:0``, ZOO_STEPS steps each;
    phase 9's frame 0 the image.  Checks the SDS terms in every step,
    finite losses, parameters that moved, no hand-written kernel launched
    (the corner grid is plain PyTorch), and ``--validate`` / ``--export``
    (``model.obj``) on ZOO_EXPORTED.  Prints ms/step (median after the
    first), the guidance's and the corner grid's shares (``zoo_guidance_ms``
    and ``corner_grid_ms``, each timed alone, over ms/step), peak memory
    above what earlier phases hold, and the profile of one step of
    ZOO_PROFILED.  Returns the phase's numbers."""
    from dreammesh4d_tpu_torch import launch
    from dreammesh4d_tpu_torch.export.mesh_io import load_obj
    from dreammesh4d_tpu_torch.models.geometry.implicit_volume import init_implicit_volume
    from dreammesh4d_tpu_torch.systems import assembly, assembly_zoo
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves

    res = zoo_sds_card_vs_cpu(torch, card, device)
    torch.cuda.empty_cache()

    def counts():
        return {**rb.launch_counts, **tb.launch_counts, **hc.launch_counts}

    image = os.path.join(launcher["frames_dir"], "000_rgba.png")
    out = os.path.join(tmp, "zoo")
    spans = Spans(torch, counts)
    spans.time(launch, "build_experiment", "setup", keep=True)
    for cls in (assembly.Zero123Experiment, assembly_zoo.ZooTextExperiment, assembly_zoo.ZooImageExperiment):
        spans.train_steps(cls, "zoo")
    rb.reset_launch_counts()
    tb.reset_launch_counts()
    hc.reset_launch_counts()
    runs, res["peak"], res["ms"], res["guidance_ms"], res["grid_ms"] = {}, {}, {}, {}, {}
    try:
        for name, (takes_image, keys, sds_keys) in ZOO_YAMLS.items():
            yaml = os.path.join(REPO, "configs", "zoo", f"{name}.yaml")
            dotlist = [f"system.prompt_processor.prompt={ZOO_PROMPT}", f"trainer.max_steps={ZOO_STEPS}",
                       "trainer.val_check_interval=0", "trainer.log_every_n_steps=1", f"exp_root_dir={out}",
                       "use_timestamp=false", "tag=sds"]
            dotlist += [f"{k}.pretrained_model_name_or_path=random:0" for k in keys]
            if takes_image:
                dotlist.append(f"data.image_path={image}")
            first = len(spans.steps)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated() / 2**30  # what earlier phases hold
            t0 = time.perf_counter()
            launch.main(launch.make_args(yaml, "train"), dotlist)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30 - resident
            exp = spans.results["setup"].pop()
            rows = spans.steps[first:]
            check([r[1] for r in rows] == list(range(ZOO_STEPS)), f"zoo {name}: steps taken")
            for _, step, _, _, _, metrics in rows:
                check(all(math.isfinite(v) for v in metrics.values()), f"zoo {name} step {step}: non-finite metric")
                for k in sds_keys:
                    check(metrics.get(k, 0.0) > 0, f"zoo {name} step {step}: no {k} in the metrics")
            fresh = init_implicit_volume(exp.geo_cfg, torch.Generator(device=device).manual_seed(
                int(exp.cfg.seed)), device=device)
            moved = max(float((a.detach() - b).abs().max()) for a, b in
                        zip(tree_leaves(exp.state.geo_params), tree_leaves(fresh)))
            check(moved > 0, f"zoo {name}: the parameters did not move")
            del fresh
            res["ms"][name] = statistics.median([r[3] for r in rows[1:]])
            res["peak"][name] = peak
            runs[name] = (yaml, dotlist, exp.cfg.trial_dir)
            totals = ", ".join(f"{r[5]['loss_total']:.5g}" for r in rows)
            print(f"[{card}] zoo {name}: {', '.join(f'{r[3]:.1f}' for r in rows)} ms/step; "
                  + "; ".join(f"{k} {', '.join(f'{r[5][k]:.5g}' for r in rows)}" for k in sds_keys)
                  + f"; loss_total {totals}; parameters moved {moved:.3g}; {wall:.1f} s through the launcher; "
                  f"peak memory {peak:.2f} GiB above the {resident:.2f} GiB resident before it")
            if name in ZOO_PROFILED:
                profile_call(torch, f"zoo {name} train step", lambda: exp.train_step(ZOO_STEPS), card)
            res["guidance_ms"][name], shape = zoo_guidance_ms(torch, exp, device)
            fine, coarse = zoo_point_counts(exp)
            geo_cfg = exp.geo_cfg
            del exp
            torch.cuda.empty_cache()
            res["grid_ms"][name] = corner_grid_ms(torch, geo_cfg, fine, coarse, device)
            print(f"[{card}] zoo {name}: alone, the SDS terms at renders {shape} {res['guidance_ms'][name]:.2f} ms, "
                  f"the corner grid at the step's {fine} + {coarse} points {res['grid_ms'][name]:.2f} ms")
        # --validate and --export of two trials, from their last checkpoint
        for name in ZOO_EXPORTED:
            yaml, dotlist, trial = runs[name]
            t0 = time.perf_counter()
            launch.main(launch.make_args(yaml, "validate"), dotlist + ["resume=LAST"])
            launch.main(launch.make_args(yaml, "export"), dotlist + ["resume=LAST"])
            spans.results["setup"].clear()
            mesh = load_obj(os.path.join(trial, "save", "model.obj"))
            saved = sorted(os.listdir(os.path.join(trial, "save")))
            print(f"[{card}] zoo {name} --validate and --export resume=LAST: {time.perf_counter() - t0:.1f} s, "
                  f"save/ {saved}; model.obj {mesh.v_pos.shape[0]} vertices, {mesh.t_pos_idx.shape[0]} faces")
            check(f"it{ZOO_STEPS}-val.png" in saved and mesh.v_pos.shape[0] > 0 and np.isfinite(mesh.v_pos).all(),
                  f"zoo {name}: --validate / --export wrote no image or mesh")
    finally:
        spans.close()
    launched = counts()
    res["launches"] = launched
    check(all(v == 0 for v in launched.values()), f"the zoo launched hand-written kernels {launched}: its "
          "corner grid has none")
    print(f"[{card}] zoo ms/step (median of steps 1..{ZOO_STEPS - 1}; guidance random:0, float32), the "
          "guidance's and the corner grid's (plain PyTorch) share, each timed alone at the step's shapes over "
          "ms/step, peak memory: " + "; ".join(
              f"{n} {res['ms'][n]:.1f} ms (guidance {res['guidance_ms'][n]:.1f} ms = "
              f"{res['guidance_ms'][n] / res['ms'][n]:.3f}, grid {res['grid_ms'][n]:.1f} ms = "
              f"{res['grid_ms'][n] / res['ms'][n]:.3f}, {res['peak'][n]:.2f} GiB)" for n in ZOO_YAMLS))
    return res


# ---------------------------------------------------------------------------
# 18. the zoo's last four YAMLs: latentnerf, sketchshape, sjc, prolificdreamer
# ---------------------------------------------------------------------------

LATENT_STEPS = 3  # trainer.max_steps of each run
# name: the metrics that must be positive in every step
LATENT_YAMLS = {"latentnerf": ("loss_sds",), "sketchshape": ("loss_sds", "loss_shape"),
                "sjc": ("loss_sds", "loss_emptiness"), "prolificdreamer": ("loss_vsd", "loss_lora")}
VSD_CPU_TOL = 1e-4  # float32 card vs CPU: loss_vsd, loss_lora and grad_norm, relative
VSD_CPU_GRAD_TOL = 1e-3  # d loss_vsd / d rgb and each LoRA leaf's d loss_lora, of its max |value|
# the card-vs-CPU VSD check: SD 1.5's layout (UNet [1,2,4,4] x 2 res blocks, 8 heads,
# context 768, VAE [1,2,4,4] at 512^2, latents 64^2) with the UNet and VAE narrowed, to
# keep the CPU's side short; the full width is timed on the card
VSD_CHECK = {"model_channels": 64, "vae_ch": 32}


def drawn_vsd(torch, cfg, device):
    """A float32 VSDGuidance on ``device`` with every layer drawn and a LoRA
    whose B is drawn non-zero (at its init B = 0 phi is the pretrained UNet)."""
    from dreammesh4d_tpu_torch.models.guidance.vsd import VSDGuidance

    guidance = VSDGuidance(cfg, device=device)
    guidance.modules.init_params(torch.Generator(device=device).manual_seed(0), zero_init=False)
    lora = guidance.init_lora_params(torch.Generator(device=device).manual_seed(1))
    gen = torch.Generator(device=device).manual_seed(2)
    with torch.no_grad():
        for leaves in lora.values():
            if "B" in leaves:
                leaves["B"].copy_(0.3 * torch.randn(leaves["B"].shape, generator=gen, device=device))
    return guidance, lora


def zoo_vsd_card_vs_cpu(torch, card, device):
    """One float32 ``vsd_loss`` (B = 2: one view's LoRA condition dropped,
    one kept) on the card and on the CPU at VSD_CHECK's widths, the same
    weights, LoRA, prompt embeddings and draws; then one full-width VSD
    forward + backward (B = 1, a 64^2 render) timed on the card.  Returns
    the errors and the ms."""
    from dreammesh4d_tpu_torch.models.guidance.stable_diffusion import StableDiffusionPromptProcessor
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves

    on_card, lora = drawn_vsd(torch, dict(VSD_CHECK), device)
    on_cpu = type(on_card)(dict(VSD_CHECK), device="cpu")
    on_cpu.modules.load_state_dict({k: v.cpu() for k, v in on_card.modules.state_dict().items()})
    gen = torch.Generator().manual_seed(11)
    L = on_card.cfg.latent_size
    draws = {"u": torch.tensor([0.37, 0.81]), "noise": torch.randn((2, 4, L, L), generator=gen),
             "u2": torch.tensor([0.52, 0.13]), "noise2": torch.randn((2, 4, L, L), generator=gen),
             "drop": torch.tensor([True, False])}
    rgb0 = smooth_images(torch, 2, 64, 12)
    view = [torch.tensor(v) for v in ([20.0, 10.0], [30.0, 150.0])]  # elevation, azimuth
    cam = torch.randn((2, 16), generator=gen)
    outs = {}
    for label, g, dev in (("card", on_card, device), ("cpu", on_cpu, "cpu")):
        prompts = StableDiffusionPromptProcessor({"prompt": ZOO_PROMPT}, device=dev)()
        rgb = rgb0.to(dev).requires_grad_(True)
        lo = {k: {n: v.detach().to(dev).requires_grad_(True) for n, v in leaves.items()}
              for k, leaves in lora.items()}
        out = g.vsd_loss(lo, prompts, rgb, *(v.to(dev) for v in view), cam.to(dev), 0, **draws)
        (out["loss_vsd"] + out["loss_lora"]).backward()
        outs[label] = ({k: float(out[k].detach()) for k in ("loss_vsd", "loss_lora", "grad_norm")}, rgb.grad.cpu(),
                       [v.grad.cpu() for v in tree_leaves(lo)])
    (got, gc, lc), (p, gp, lp) = outs["card"], outs["cpu"]
    errs = {k: abs(got[k] - p[k]) / abs(p[k]) for k in got}
    grad_err = rel_err(gc, gp)
    lora_err = max(rel_err(a, b) for a, b in zip(lc, lp))
    c = on_card.cfg
    print(f"[{card}] VSD vsd_loss (UNet {c.model_channels} x {list(c.channel_mult)}, VAE {c.vae_ch} at "
          f"{c.image_size}^2, latents {c.latent_size}^2, LoRA rank {c.lora_rank} on {len(lora) - 1} projections), "
          f"float32, card vs CPU: loss_vsd {got['loss_vsd']:.8g} vs {p['loss_vsd']:.8g}, loss_lora "
          f"{got['loss_lora']:.8g} vs {p['loss_lora']:.8g}; relative " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items()) + f" (limit {VSD_CPU_TOL}); d loss_vsd/d rgb max |d| / "
          f"max {grad_err:.3g}, d loss_lora/d LoRA worst leaf {lora_err:.3g} (limit {VSD_CPU_GRAD_TOL})")
    check(all(e <= VSD_CPU_TOL for e in errs.values()) and grad_err <= VSD_CPU_GRAD_TOL
          and lora_err <= VSD_CPU_GRAD_TOL and min(p.values()) > 0, "VSD vsd_loss: card and CPU differ")
    del on_card, on_cpu, lora
    torch.cuda.empty_cache()

    full, lora = drawn_vsd(torch, dict(ZOO_SD), device)
    prompts = StableDiffusionPromptProcessor({"prompt": ZOO_PROMPT}, device=device)()
    rgb1 = rgb0[:1].to(device)
    args = (view[0][:1].to(device), view[1][:1].to(device), cam[:1].to(device), 0)
    gen_card = torch.Generator(device=device).manual_seed(3)

    def vsd_step():
        rgb = rgb1.clone().requires_grad_(True)
        out = full.vsd_loss(lora, prompts, rgb, *args, gen_card)
        (out["loss_vsd"] + out["loss_lora"]).backward()
        for v in tree_leaves(lora):
            v.grad = None

    ms = time_ms(torch, vsd_step, n=5, warmup=1)
    print(f"[{card}] one full-width VSD forward + backward (UNet {full.cfg.model_channels} x "
          f"{list(full.cfg.channel_mult)}, a 64^2 render, B = 1, float32; the pretrained UNet at B = 2, phi "
          f"at B = 1 twice, the VAE encode): {ms:.2f} ms")
    del full, lora
    torch.cuda.empty_cache()
    return {"vsd_ms": ms, "vsd_err": max(errs.values()), "vsd_grad_err": grad_err, "vsd_lora_err": lora_err}


def latent_guidance_ms(torch, exp, device):
    """The guidance term of one step of a phase-18 run, timed alone (CUDA
    events) at the step's shapes: SDS of a 4-channel latent render
    (latentnerf) or a 3-channel one (sjc), or VSD with the LoRA's backward
    (prolificdreamer)."""
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves

    batch = exp.train_batch(0)
    B, H, W = batch["rays_o"].shape[:3]
    el, az, dist = (batch[k] for k in ("elevation", "azimuth", "camera_distances"))
    guidance, prompts = exp.pack
    gen = torch.Generator(device=device).manual_seed(5)
    latent = exp.cfg.system_type == "latentnerf-system" and exp.geo_cfg.n_feature_dims == 4
    rgb0 = torch.rand((B, H, W, 4 if latent else 3), generator=gen, device=device)
    if hasattr(exp.state, "lora_params"):
        lora, cam = exp.state.lora_params, batch["c2w"].reshape(B, -1)

        def run():
            out = guidance.vsd_loss(lora, prompts, rgb0.clone().requires_grad_(True), el, az, cam, 0, gen)
            (out["loss_vsd"] + out["loss_lora"]).backward()
            for v in tree_leaves(lora):
                v.grad = None
    else:
        def run():
            guidance.sds_loss(prompts, rgb0.clone().requires_grad_(True), el, az, dist, 0, gen,
                              rgb_as_latents=latent)["loss_sds"].backward()

    return time_ms(torch, run, n=3, warmup=1), tuple(rgb0.shape)


def drive_zoo_latent(torch, np, rb, tb, hc, card, guide_obj, device, tmp):
    """Phase 18, the zoo's last four YAMLs: (a) VSD card vs CPU and the
    full-width VSD time (``zoo_vsd_card_vs_cpu``); (b) LATENT_YAMLS through
    ``launch.main`` at their full widths (hash grid 16 x 2 x 2^19 corner
    rows, 64 + 64 samples a ray, SD 1.5's widths in float32) with the
    guidance at ``random:0`` (prolificdreamer's with every layer drawn,
    ``system.guidance.zero_init=false``), LATENT_STEPS steps each, sketchshape guided by
    ``guide_obj``.  Checks, per run, the steps, finite metrics, the
    LATENT_YAMLS terms in every step, parameters that moved; latentnerf's
    Adam lr = 0.01 · factor(k) in step k with the warm-up rising and its
    ``--validate`` / ``--export``; sketchshape's ShapeLoss built once;
    prolificdreamer's LoRA moved and a ``resume=LAST`` to LATENT_STEPS + 1
    that starts at step LATENT_STEPS with both Adams' counts at
    LATENT_STEPS; no hand-written kernel launched.  Prints ms/step (median
    after the first), peak memory above what earlier phases hold, the
    guide's bake (seconds, faces) and the guidance's share of a step.
    Returns the phase's numbers."""
    from dreammesh4d_tpu_torch import launch
    from dreammesh4d_tpu_torch.export.mesh_io import load_obj
    from dreammesh4d_tpu_torch.models.geometry.implicit_volume import init_implicit_volume
    from dreammesh4d_tpu_torch.systems import assembly_zoo
    from dreammesh4d_tpu_torch.systems.optim import scheduler_factor_fn
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves

    res = zoo_vsd_card_vs_cpu(torch, card, device)

    def counts():
        return {**rb.launch_counts, **tb.launch_counts, **hc.launch_counts}

    def adam_counts(opt):
        return sorted({int(s["step"]) for s in opt.state.values()})

    entries = []  # per step: system, step, state.step and Adam counts at entry, the scene's lr after

    def record(fn):
        def recorded(exp, step):
            e = {"system": exp.cfg.system_type, "step": step, "state_step": exp.state.step,
                 "adam": adam_counts(exp.state.opt_state)}
            if hasattr(exp.state, "lora_opt_state"):
                e["lora_adam"] = adam_counts(exp.state.lora_opt_state)
            metrics = fn(exp, step)
            e["lr"] = exp.state.opt_state.param_groups[0]["lr"]
            entries.append(e)
            return metrics
        return recorded

    out = os.path.join(tmp, "zoo_latent")
    spans = Spans(torch, counts)
    spans.time(launch, "build_experiment", "setup", keep=True)
    spans.time(assembly_zoo, "ShapeLoss", "shape bake", keep=True)
    for cls in (assembly_zoo.ZooTextExperiment, assembly_zoo.ZooVSDExperiment):
        spans._patch(cls, "train_step", record)
        spans.train_steps(cls, "zoo_latent")
    rb.reset_launch_counts()
    tb.reset_launch_counts()
    hc.reset_launch_counts()
    res.update(ms={}, peak={}, guidance_ms={})
    try:
        for name, keys in LATENT_YAMLS.items():
            yaml = os.path.join(REPO, "configs", "zoo", f"{name}.yaml")
            dotlist = [f"system.prompt_processor.prompt={ZOO_PROMPT}", "trainer.val_check_interval=0",
                       "trainer.log_every_n_steps=1", f"exp_root_dir={out}", "use_timestamp=false", "tag=latent",
                       "system.guidance.pretrained_model_name_or_path=random:0"]
            if name == "sketchshape":
                dotlist.append(f"system.guide_shape={guide_obj}")
            if name == "prolificdreamer":
                dotlist.append("system.guidance.zero_init=false")
            first, first_entry = len(spans.steps), len(entries)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated() / 2**30
            t0 = time.perf_counter()
            launch.main(launch.make_args(yaml, "train"), dotlist + [f"trainer.max_steps={LATENT_STEPS}"])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30 - resident
            exp = spans.results["setup"].pop()
            rows, seen = spans.steps[first:], entries[first_entry:]
            check([r[1] for r in rows] == list(range(LATENT_STEPS)), f"zoo {name}: steps taken")
            for _, step, _, _, _, metrics in rows:
                check(all(math.isfinite(v) for v in metrics.values()), f"zoo {name} step {step}: non-finite metric")
                for k in keys:
                    check(metrics.get(k, 0.0) > 0, f"zoo {name} step {step}: {k} not positive")
            fresh = init_implicit_volume(exp.geo_cfg, torch.Generator(device=device).manual_seed(
                int(exp.cfg.seed)), device=device)
            moved = max(float((a.detach() - b).abs().max()) for a, b in
                        zip(tree_leaves(exp.state.geo_params), tree_leaves(fresh)))
            check(moved > 0, f"zoo {name}: the parameters did not move")
            del fresh
            extra = ""
            if name == "latentnerf":
                factor = scheduler_factor_fn(exp.cfg.system.scheduler)
                lrs = [e["lr"] for e in seen]
                check(lrs == [0.01 * factor(k) for k in range(LATENT_STEPS)] and lrs == sorted(set(lrs)),
                      f"zoo latentnerf: Adam lr {lrs} is not 0.01 x the scheduler's warm-up")
                extra = f"; Adam lr {', '.join(f'{x:.6g}' for x in lrs)} = 0.01 x factor(k)"
            if name == "sketchshape":
                bake_s, (shape,) = spans.seconds["shape bake"], spans.results["shape bake"]
                check(len(bake_s) == 1 and shape is exp.shape_loss, "zoo sketchshape: the guide was not baked once")
                res["bake_s"], res["guide_faces"] = bake_s[0], shape.n_faces
                res["guide_inside"] = float(shape.occ_grid.mean())
                extra = (f"; guide {os.path.basename(guide_obj)} {shape.n_faces} faces baked at "
                         f"{shape.grid_res}^3 in {bake_s[0]:.2f} s, occupancy {res['guide_inside']:.4f}")
            if name == "prolificdreamer":
                fresh_lora = exp.pack[0].init_lora_params(torch.Generator(device=device).manual_seed(1))
                lora_moved = max(float((a.detach() - b.detach()).abs().max()) for a, b in
                                 zip(tree_leaves(exp.state.lora_params), tree_leaves(fresh_lora)))
                check(lora_moved > 0, "zoo prolificdreamer: the LoRA did not move")
                res["lora_moved"] = lora_moved
                extra = f"; LoRA moved {lora_moved:.3g}"
                del fresh_lora
            res["ms"][name] = statistics.median([r[3] for r in rows[1:]])
            res["peak"][name] = peak
            totals = ", ".join(f"{r[5]['loss_total']:.5g}" for r in rows)
            print(f"[{card}] zoo {name}: {', '.join(f'{r[3]:.1f}' for r in rows)} ms/step; "
                  + "; ".join(f"{k} {', '.join(f'{r[5][k]:.5g}' for r in rows)}" for k in keys)
                  + f"; loss_total {totals}; parameters moved {moved:.3g}{extra}; {wall:.1f} s through the launcher; peak memory "
                  f"{peak:.2f} GiB above the {resident:.2f} GiB resident before it")
            res["guidance_ms"][name], shape_g = latent_guidance_ms(torch, exp, device)
            print(f"[{card}] zoo {name}: alone, the guidance term at renders {shape_g} "
                  f"{res['guidance_ms'][name]:.2f} ms")
            del exp
            torch.cuda.empty_cache()
            if name == "prolificdreamer":  # resumed from LAST: step 3 with both Adams' counts restored
                first_entry = len(entries)
                launch.main(launch.make_args(yaml, "train"),
                            dotlist + [f"trainer.max_steps={LATENT_STEPS + 1}", "resume=LAST"])
                spans.results["setup"].clear()
                (e,) = entries[first_entry:]
                print(f"[{card}] zoo prolificdreamer resume=LAST: step {e['step']}, state.step {e['state_step']}, "
                      f"Adam counts scene {e['adam']} LoRA {e['lora_adam']} at entry")
                check(e["step"] == e["state_step"] == LATENT_STEPS and e["adam"] == e["lora_adam"] == [LATENT_STEPS],
                      "zoo prolificdreamer: resume=LAST did not restore the step and both Adams")
        # --validate and --export of latentnerf from its last checkpoint
        yaml = os.path.join(REPO, "configs", "zoo", "latentnerf.yaml")
        dotlist = [f"system.prompt_processor.prompt={ZOO_PROMPT}", f"exp_root_dir={out}", "use_timestamp=false",
                   "tag=latent", "system.guidance.pretrained_model_name_or_path=random:0",
                   f"trainer.max_steps={LATENT_STEPS}", "resume=LAST"]
        t0 = time.perf_counter()
        launch.main(launch.make_args(yaml, "validate"), dotlist)
        launch.main(launch.make_args(yaml, "export"), dotlist)
        trial = spans.results["setup"][-1].cfg.trial_dir
        spans.results["setup"].clear()
        mesh = load_obj(os.path.join(trial, "save", "model.obj"))
        saved = sorted(os.listdir(os.path.join(trial, "save")))
        print(f"[{card}] zoo latentnerf --validate and --export resume=LAST: {time.perf_counter() - t0:.1f} s, "
              f"save/ {saved}; model.obj {mesh.v_pos.shape[0]} vertices, {mesh.t_pos_idx.shape[0]} faces")
        check(f"it{LATENT_STEPS}-val.png" in saved and mesh.v_pos.shape[0] > 0 and np.isfinite(mesh.v_pos).all(),
              "zoo latentnerf: --validate / --export wrote no image or mesh")
    finally:
        spans.close()
    launched = counts()
    res["launches"] = launched
    check(all(v == 0 for v in launched.values()), f"phase 18 launched hand-written kernels {launched}: its "
          "corner grid, shape loss and VSD are plain PyTorch")
    print(f"[{card}] zoo (phase 18) ms/step (median of steps 1..{LATENT_STEPS - 1}; guidance random:0, float32), "
          "the guidance's share (timed alone at the step's shapes, over ms/step), peak memory: " + "; ".join(
              f"{n} {res['ms'][n]:.1f} ms (guidance {res['guidance_ms'][n]:.1f} ms = "
              f"{res['guidance_ms'][n] / res['ms'][n]:.3f}, {res['peak'][n]:.2f} GiB)" for n in LATENT_YAMLS)
          + f"; the guide's bake {res['bake_s']:.2f} s ({res['guide_faces']} faces); one full-width VSD forward + "
          f"backward {res['vsd_ms']:.2f} ms")
    return res


# ---------------------------------------------------------------------------
# 19. binning: rank through B1/B2, the registry's factory names, the saver's colour maps
# ---------------------------------------------------------------------------

RANK_STEPS = 3  # trainer.max_steps of each launcher run of phase 19
RANK_RGB_TOL = 3e-3  # rank against pairs on the served view: rgb and alpha (the reference's bands)
RANK_DEPTH_TOL = 6e-3  # and depth


def captured_blend_args(torch, rb, render):
    """The arguments of every ``resident_blend.blend_pairs_cuda`` call that
    ``render()`` makes (under ``no_grad``): what B1 is handed."""
    blends = []
    real = rb.blend_pairs_cuda

    def record(*args, **kw):
        blends.append(args)
        return real(*args, **kw)

    rb.blend_pairs_cuda = record
    try:
        with torch.no_grad():
            render()
    finally:
        rb.blend_pairs_cuda = real
    check(len(blends) >= 1, "the render did not reach B1")
    return blends


def served_view_attrs(torch, params, static, dparams, dyn_cfg, cams, t):
    """The served view's per-Gaussian attributes at time ``t`` (as
    ``view_blend_inputs`` takes them): means, quats, scales, opacities, SH
    and the face normals, and the view's ``GSCameraInfo``."""
    from dreammesh4d_tpu_torch.models.geometry.dynamic_sugar import timed_all
    from dreammesh4d_tpu_torch.models.geometry.sugar import gaussian_attributes
    from dreammesh4d_tpu_torch.ops.cameras import GSCameraInfo
    from dreammesh4d_tpu_torch.ops.meshops import face_normals

    ts = torch.tensor([t], device=params.points.device)
    gs, vert = timed_all(params, dparams, dyn_cfg.deformation, static, ts)
    attrs0 = gaussian_attributes(params, static.sugar)
    normals = torch.repeat_interleave(face_normals(vert.xyz, static.sugar.faces), 6, dim=-2)[0]
    cam = GSCameraInfo(cams.world_view[0], cams.full_proj[0], cams.camera_center[0])
    return dict(means3d=gs.means3d[0], quats=gs.quats[0], scales=gs.scales[0], opacities=attrs0.opacities,
                sh=attrs0.sh, sh_degree=3, gs_normals=normals, camera=cam), gs


def pair_tie_tiles(torch, pa, T, depth_bits=20):
    """Tiles in which pairs mode holds two pairs with the same packed key
    (the same 20-bit quantized depth): their order is free in pairs mode
    and exact in rank mode."""
    keys, starts, counts = pa.sorted_keys, pa.starts.long(), pa.counts.long()
    same = torch.zeros(keys.numel(), dtype=torch.bool, device=keys.device)
    same[1:] = keys[1:] == keys[:-1]
    tile_of = keys >> depth_bits
    return sorted({int(x) for x in tile_of[same & (tile_of < T)].tolist()})


def drive_rank(torch, np, rb, tb, hc, card, scene, launcher, device, tmp):
    """Phase 19: ``binning: rank`` through B1/B2, the registry's factory
    names and the saver's colour maps.

    (a) The served view of phase 4's full-width scene (t = 0, elevation 5°,
    distance 3.8) through ``find("diff-sugar-rasterizer-temporal")`` built
    from configs/sugar_dynamic_dg.yaml's renderer block with ``binning:
    rank``, its B1 inputs captured (C = 7), and those of the rgb-only blend
    (C = 4): B1 and B2 on them against their plain versions
    (``check_forward`` / ``check_backward``, their tolerances), and timed
    (device time).  (b) The same view with ``binning: pairs`` against rank:
    rgb and alpha within RANK_RGB_TOL, depth within RANK_DEPTH_TOL; where a
    pixel fails, the tiles where pairs mode holds two pairs of one quantized
    depth (free order there) are printed, and if every failing pixel lies in
    such a tile those tiles alone are left out, with the count printed.
    (c) ``python3 -m dreammesh4d_tpu_torch.launch --config
    configs/sugar_dynamic_dg.yaml --train --gpu 0 --verbose
    system.renderer.binning=rank`` with phase 9's dotlist (full width,
    guidance off) for RANK_STEPS steps, through ``launch.parse_args`` and
    ``launch.main``, beside the same run in pairs mode: B1/B2 launches of
    every step, the losses of the first and last step side by side.  (d)
    The 13 factory names of ``models/registry_names.py`` constructed on the
    card, one forward each where the component has one.  (e) One image
    grid with a colour-mapped depth layer (``jet``).  Returns the phase's
    numbers, its rank-mode launches among them."""
    from dreammesh4d_tpu_torch import launch, registry
    from dreammesh4d_tpu_torch.config import config_to_primitive, load_config
    from dreammesh4d_tpu_torch.data.png import read_png
    from dreammesh4d_tpu_torch.models.renderers import sugar_rasterizer
    from dreammesh4d_tpu_torch.serving import Viewer4D
    from dreammesh4d_tpu_torch.systems import assembly
    from dreammesh4d_tpu_torch.utils.colormaps import apply_colormap
    from dreammesh4d_tpu_torch.utils.saving import Saver

    t_phase = time.perf_counter()
    params, static, dparams, dyn_cfg, raster_cfg = scene
    rz = importlib.import_module("dreammesh4d_tpu_torch.ops.gs.rasterize")
    dyn_yaml = os.path.join(REPO, "configs", "sugar_dynamic_dg.yaml")
    block = config_to_primitive(load_config(dyn_yaml, makedirs=False).system.renderer)
    block.update(width=RES, height=RES, fovy_deg=20.0)

    def counts():
        return {**rb.launch_counts, **tb.launch_counts, **hc.launch_counts}

    # (a) the served view through the factory in rank mode, B1/B2 on its inputs
    rank_r = registry.find("diff-sugar-rasterizer-temporal")({**block, "binning": "rank"}, device=device)
    pairs_r = registry.find("diff-sugar-rasterizer-temporal")({**block, "binning": "pairs"}, device=device)
    check(rank_r.cfg.binning == "rank" and rank_r.cfg._replace(binning="pairs") == pairs_r.cfg
          and rank_r.cfg.tile_px == 32 and rank_r.cfg.tile_capacity == 2048
          and rank_r.cfg.max_tiles_per_gaussian == 6 and rank_r.cfg.backend == "pallas_resident",
          "the factory's rasterizer config is not the YAML's renderer block")
    viewer = Viewer4D(params, static, dparams, dyn_cfg, raster_cfg, RES, RES, 20.0, VIDEO_LEN, device=device)
    view, _ = served_view_attrs(torch, params, static, dparams, dyn_cfg, viewer._cameras(5.0, 0.0, 3.8), 0.0)
    white = torch.ones(3, device=device)
    ranks = []
    real_ranks = rz.bin_gaussians_ranks

    def record_ranks(*a, **kw):
        ranks.append(real_ranks(*a, **kw))
        return ranks[-1]

    rz.bin_gaussians_ranks = record_ranks
    try:
        cases = {7: captured_blend_args(torch, rb, lambda: rank_r.render_view(**view, bg_color=white))[0],
                 4: captured_blend_args(torch, rb, lambda: rank_r.render_view(
                     **{**view, "gs_normals": None}, bg_color=white))[0]}
    finally:
        rz.bin_gaussians_ranks = real_ranks
    check(len(ranks) == 2, "rank mode did not bin with bin_gaussians_ranks")
    N = view["means3d"].shape[0]
    check(cases[7][0].shape[0] == N + 1 and int(cases[7][1].max()) <= N,
          "rank mode: the pairs are not ranks into an (N + 1)-row table")
    order = ranks[0].depth_order
    check(bool((ranks[0].inv_rank[order] == torch.arange(N, device=order.device)).all()),
          "rank mode: inv_rank is not the inverse of depth_order")
    rank_cases = {C: {"rank_view": cases[C]} for C in (7, 4)}
    b1_err, _, b1_kept = check_forward(torch, rb, rank_cases[7])
    bwd_err, bwd_work = {}, {}
    for C in (7, 4):
        errs, bwd_work[C], _ = check_backward(torch, rb, rank_cases[C])
        for k, v in errs.items():
            old = bwd_err.get(k, (0.0, 0.0))
            bwd_err[k] = (max(old[0], v[0]), max(old[1], v[1]))
    res = {"b1_err": b1_err, "bwd_err": bwd_err, "b1_kept": b1_kept}
    a7 = cases[7]
    res["b1_device_ms"] = device_ms(torch, lambda: rb.blend_pairs_cuda(*a7), "resident_fwd_kernel")
    res["b1_plain_ms"] = time_ms(torch, lambda: rb.blend_pairs_plain(*a7), n=5)
    b1_stats = {}
    rb.blend_pairs_plain(*a7, stats=b1_stats)
    res["b1_bound"] = resident_fwd_bound(a7, b1_stats)
    a4 = cases[4]
    out4 = rb.blend_pairs_cuda(*a4)
    cot4 = torch.randn(out4.shape, generator=torch.Generator(device=out4.device).manual_seed(5),
                       device=out4.device)
    res["b2_device_ms"] = device_ms(torch, lambda: rb.blend_pairs_bwd_cuda(*a4[:4], out4, cot4, *a4[4:]),
                                    "resident_bwd_kernel")
    res["b2_plain_ms"] = time_ms(torch, lambda: rb.blend_pairs_bwd_plain(*a4[:4], out4, cot4, *a4[4:]), n=5)
    res["b2_bound"] = kernel_bounds(a4, bwd_work[4]["rank_view"], a4[0].shape[0], False)
    print(f"[{card}] rank mode, served view: B1 C=7 {res['b1_device_ms']:.4f} ms device time (plain "
          f"{res['b1_plain_ms']:.4f} ms; bound {res['b1_bound'][0]:.4f} ms by {res['b1_bound'][1]}), B2 C=4 "
          f"{res['b2_device_ms']:.4f} ms (plain {res['b2_plain_ms']:.4f} ms; bound {res['b2_bound'][0]:.4f} ms "
          f"by {res['b2_bound'][1]}); B1 max|d| {b1_err:.3g}, B2 max rel {bwd_err['resident_bwd_accum'][0]:.3g}")

    # (b) rank against pairs on the served view, through the factory's render_view
    pair_bins = []
    real_pairs = rz.bin_gaussians_pairs

    def record_pairs(*a, **kw):
        pair_bins.append(real_pairs(*a, **kw))
        return pair_bins[-1]

    rb.reset_launch_counts()
    with torch.no_grad():
        out_r = rank_r.render_view(**view, bg_color=white)
        torch.cuda.synchronize()
        served_launches = dict(rb.launch_counts)  # rank mode's, on the path a user calls
        rz.bin_gaussians_pairs = record_pairs
        try:
            out_p = pairs_r.render_view(**view, bg_color=white)
        finally:
            rz.bin_gaussians_pairs = real_pairs
        direct = sugar_rasterizer.render_view(**view, bg_color=white, cfg=rank_r.cfg)
    torch.cuda.synchronize()
    check(served_launches["resident_fwd"] == 1 and rb.launch_counts["resident_fwd"] == 3,
          "the served-view renders did not launch B1 once each")
    check(bool((direct["comp_rgb"] == out_r["comp_rgb"]).all()), "the factory's render_view is not the module's")
    tol = {"comp_rgb": RANK_RGB_TOL, "comp_mask": RANK_RGB_TOL, "comp_depth": RANK_DEPTH_TOL}
    err = {k: (out_r[k] - out_p[k]).abs().amax(-1) for k in tol}  # (H, W) each
    bad = (err["comp_rgb"] > tol["comp_rgb"]) | (err["comp_mask"] > tol["comp_mask"]) | (
        err["comp_depth"] > tol["comp_depth"])
    tile = rank_r.cfg.tile_px
    tiles_x = (RES + tile - 1) // tile
    res["excluded_pixels"] = 0
    if bool(bad.any()):
        ys, xs = torch.nonzero(bad, as_tuple=True)
        bad_tiles = sorted({int(t) for t in ((ys // tile) * tiles_x + xs // tile).tolist()})
        ties = pair_tie_tiles(torch, pair_bins[0], tiles_x * tiles_x)
        print(f"rank vs pairs: {int(bad.sum())} pixels over the bands, in tiles {bad_tiles}; tiles where pairs "
              f"mode holds two pairs of one quantized depth: {ties}; first pixels "
              f"{[(int(y), int(x)) for y, x in zip(ys[:10], xs[:10])]}")
        check(set(bad_tiles) <= set(ties), "rank vs pairs: a pixel over the bands lies in a tile without a tie")
        keep = torch.ones((RES, RES), dtype=torch.bool, device=bad.device)
        for t in ties:
            ty, tx = divmod(t, tiles_x)
            keep[ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile] = False
        res["excluded_pixels"] = int((~keep).sum())
        print(f"rank vs pairs: {res['excluded_pixels']} pixels of the {len(ties)} tied tiles left out")
        err = {k: torch.where(keep, v, torch.zeros_like(v)) for k, v in err.items()}
    res["rank_vs_pairs"] = {k: float(v.max()) for k, v in err.items()}
    print(f"rank vs pairs on the served view, max|d|: {json.dumps(res['rank_vs_pairs'])} (limits rgb/alpha "
          f"{RANK_RGB_TOL}, depth {RANK_DEPTH_TOL}); coverage {float((out_r['comp_mask'] > 0.5).float().mean()):.4f}")
    for k, v in res["rank_vs_pairs"].items():
        check(v <= tol[k], f"rank vs pairs {k}: {v:.3g} > {tol[k]}")

    # (c) the launcher with C2's flags, rank and pairs
    spans = Spans(torch, counts)
    spans.train_steps(assembly.Sugar4DGenExperiment, "dynamic")
    dyn = [x for x in launcher["trials"]["dynamic"][2]
           if not x.startswith(("tag=", "trainer.max_steps=", "resume="))]
    runs, rank_launches = {}, {}
    try:
        for binning in ("rank", "pairs"):
            argv = ["--config", dyn_yaml, "--train", "--gpu", "0", "--verbose", *dyn,
                    f"system.renderer.binning={binning}", f"trainer.max_steps={RANK_STEPS}", f"tag={binning}"]
            args, extras = launch.parse_args(argv)
            check(args.train and args.gpu == "0" and args.verbose and extras == argv[6:],
                  "parse_args: the JAX launcher's flags reached the dotlist")
            first = len(spans.steps)
            rb.reset_launch_counts()
            tb.reset_launch_counts()
            hc.reset_launch_counts()
            t0 = time.perf_counter()
            launch.main(args, extras)
            torch.cuda.synchronize()
            runs[binning] = {"s": time.perf_counter() - t0, "launches": counts(), "steps": spans.steps[first:]}
            if binning == "rank":
                rank_launches = dict(runs[binning]["launches"])
    finally:
        spans.close()
    for binning, run in runs.items():
        steps = run["steps"]
        check([s[1] for s in steps] == list(range(RANK_STEPS)), f"launcher {binning}: steps taken")
        for _, step, _, _, launched, metrics in steps:
            got = {k: v for k, v in launched.items() if v}
            check(got.get("resident_fwd", 0) > 0 and got.get("resident_bwd_accum", 0) > 0
                  and set(got) == {"resident_fwd", "resident_bwd_accum"},
                  f"launcher {binning} step {step}: launches {got}")
            check(all(math.isfinite(v) for v in metrics.values()), f"launcher {binning} step {step}: non-finite")
        run["loss"] = (steps[0][5]["loss_total"], steps[-1][5]["loss_total"])
        run["ms"] = statistics.median([s[3] for s in steps[1:]])
    r, p = runs["rank"], runs["pairs"]
    print(f"[{card}] launcher configs/sugar_dynamic_dg.yaml --train --gpu 0 --verbose, {RANK_STEPS} steps: "
          f"binning=rank loss_total {r['loss'][0]:.6g} -> {r['loss'][1]:.6g} ({r['ms']:.2f} ms/step, "
          f"{r['s']:.1f} s, launches {json.dumps({k: v for k, v in r['launches'].items() if v})}); "
          f"binning=pairs {p['loss'][0]:.6g} -> {p['loss'][1]:.6g} ({p['ms']:.2f} ms/step, {p['s']:.1f} s)")
    check(abs(r["loss"][0] - p["loss"][0]) <= 1e-3 * abs(p["loss"][0]),
          "launcher: the first step's loss_total in rank and pairs mode differ by more than 1e-3 relative")
    res["launcher"] = {b: {"loss_first": run["loss"][0], "loss_last": run["loss"][1], "ms_per_step": run["ms"],
                           "seconds": run["s"]} for b, run in runs.items()}

    # (d) the registry's factory names on the card, one forward each where there is one
    gen = torch.Generator(device="cpu").manual_seed(9)
    tet = {"v_pos": np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float32) * 0.5,
           "t_pos_idx": np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32),
           "v_rgb": np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)}
    grid = {"n_neurons": 64, "n_hidden_layers": 2, "hashgrid": {"n_levels": 16, "log2_hashmap_size": 16}}
    pts = (torch.rand((4096, 3), generator=gen) * 1.8 - 0.9).to(device)
    built = {}
    t0 = time.perf_counter()
    sug = registry.find("sugar")({"mesh": tet, "n_gaussians_per_surface_triangle": 6,
                                  "mesh_component_min_ratio": 0.0}, device=device)
    built["sugar"] = tuple(sug.gaussian_attributes().means3d.shape)
    dsug = registry.find("dynamic-sugar")({"mesh": tet, "n_gaussians_per_surface_triangle": 6,
                                           "mesh_component_min_ratio": 0.0, "num_frames": 4, "n_dg_nodes": 4,
                                           "dg_node_connectivity": 2, "dist_mode": "eucdisc"}, device=device)
    built["dynamic-sugar"] = tuple(dsug.timed_all(torch.tensor([0.0, 0.5], device=device))[0].means3d.shape)
    gsp = registry.find("gaussian-splatting")({"capacity": 8192, "init_num": 4096}, device=device)
    built["gaussian-splatting"] = tuple(gsp.renderable()[0].shape)
    vol = registry.find("implicit-volume")(grid, device=device)
    built["implicit-volume"] = tuple(vol.forward_density(pts).shape)
    rb.reset_launch_counts()
    for name in ("diff-sugar-rasterizer-normal", "diff-sugar-rasterizer-shading"):
        comp = registry.find(name)({**block, "binning": "rank"}, device=device)
        with torch.no_grad():
            built[name] = tuple(comp.render_view(**view, bg_color=white)["comp_rgb"].shape)
    torch.cuda.synchronize()
    served_launches = {k: v + served_launches[k] for k, v in rb.launch_counts.items()}
    built["diff-sugar-rasterizer-temporal"] = tuple(out_r["comp_rgb"].shape)
    nerf = registry.find("nerf-volume-renderer")({"num_samples_coarse": 32, "num_samples_fine": 32,
                                                  "ray_chunk_train": 0, "geometry": grid}, device=device)
    rays_o = torch.tensor([[0.0, 0.0, 3.0]], device=device).expand(256, 3)
    rays_d = torch.nn.functional.normalize(torch.cat([0.2 * torch.rand((256, 2), generator=gen).to(device) - 0.1,
                                                      -torch.ones((256, 1), device=device)], -1), dim=-1)
    with torch.no_grad():
        built["nerf-volume-renderer"] = tuple(nerf.render_rays(vol.state, rays_o, rays_d, rays_o,
                                                               torch.zeros(3, device=device))["comp_rgb"].shape)
    lin = np.linspace(-1, 1, 32, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    mesh = registry.find("mesh-exporter")({}, device=device)(np.maximum(0.6 - np.sqrt(x ** 2 + y ** 2 + z ** 2), 0) * 10)
    built["mesh-exporter"] = (len(mesh.v_pos), len(mesh.t_pos_idx))
    attrs = sug.gaussian_attributes()
    registry.find("gaussian-mesh-exporter")({}, device=device)(os.path.join(tmp, "rank_tet.obj"), tet["v_pos"],
                                                               tet["t_pos_idx"], v_rgb=tet["v_rgb"])
    built["gaussian-mesh-exporter"] = os.path.getsize(os.path.join(tmp, "rank_tet.obj"))
    gio = registry.find("gaussian-splatting-io")({}, device=device)
    n_g = attrs.means3d.shape[0]
    gio.save_ply(os.path.join(tmp, "rank_g.ply"), attrs.means3d.cpu().numpy(),
                 attrs.sh.transpose(-1, -2).cpu().numpy(),
                 np.zeros(n_g, np.float32), np.full((n_g, 3), -2.0, np.float32),
                 attrs.quats.cpu().numpy())
    built["gaussian-splatting-io"] = tuple(gio.load_ply(os.path.join(tmp, "rank_g.ply"))["xyz"].shape)
    perc = registry.find("perceptual-loss")({}, device=device)
    img = torch.rand((2, 64, 64, 3), generator=gen).to(device)
    built["perceptual-loss"] = [round(float(v), 6) for v in perc(img, img.flip(1))]
    built["dummy-exporter"] = registry.find("dummy-exporter")({}, device=device)()
    torch.cuda.synchronize()
    factory_s = time.perf_counter() - t0
    print(f"[{card}] the registry's 13 factory names on the card ({factory_s:.2f} s): {json.dumps(built)}")
    check(len(built) == 13 and built["dummy-exporter"] == [] and built["mesh-exporter"][1] > 0
          and all(v > 0 for v in built["perceptual-loss"]), "a factory name did not construct or run")
    check(bool(torch.isfinite(vol.forward_density(pts)).all()), "implicit-volume: non-finite density")
    check(all(p.device.type == torch.device(device).type for p in vol.state["density_mlp"][0].values()),
          "implicit-volume: the parameters are not on the card")
    rank_launches = {k: v + served_launches.get(k, 0) for k, v in rank_launches.items()}

    # (e) a colour-mapped image: the served view's depth through jet
    depth = out_r["comp_depth"][..., 0].cpu().numpy()
    path = Saver(os.path.join(tmp, "rank_save")).save_image_grid("depth_jet.png", [
        {"type": "rgb", "img": out_r["comp_rgb"].cpu().numpy()},
        {"type": "grayscale", "img": depth, "kwargs": {"cmap": "jet"}}])
    grid_img = read_png(path)
    lo, hi = float(depth.min()), float(depth.max())
    g8 = (np.clip((depth - lo) / max(hi - lo, 1e-8), 0, 1) * 255).astype(np.uint8)
    check(grid_img.shape == (RES, 2 * RES, 3) and np.array_equal(grid_img[:, RES:], apply_colormap(g8, "jet")),
          "the colour-mapped depth layer is not jet's table")
    print(f"colour map: {path} ({grid_img.shape}), {len(np.unique(grid_img[:, RES:].reshape(-1, 3), axis=0))} "
          f"colours in the depth layer")
    res["launches"] = {k: v for k, v in rank_launches.items()}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 19 (binning: rank, registry names, colour maps): rank-mode launches "
          f"{json.dumps({k: v for k, v in rank_launches.items() if v})}, {res['seconds']:.1f} s")
    return res


UNIFIED_TOL = 1e-4  # the unified guidance, float32 card vs CPU: every loss and grad_norm, relative
UNIFIED_GRAD_TOL = 1e-3  # d loss / d rgb and each LoRA leaf's d loss_lora, of its max |value|
COMP_POINTS = 512 * 512  # points of each material and background (a 512^2 render's pixels)
# the 8 components: the card's float32 against the CPU's float64, forward max |d| and each gradient
# of its max |value|, within COMP_TOL or COMP_ROUNDING times the CPU's own float32 rounding on the
# same inputs, where that is larger (pbr-material's arccos near the poles: 2.7e-5 from float64 at
# 262,144 points; the card's acosf / atan2f / rsqrtf carry a few ulp more than the CPU's)
COMP_TOL = 1e-5
COMP_ROUNDING = 4
ADAN_STEPS = 10
ADAN_TOL = 1e-6  # Adan card vs CPU: each parameter leaf after every step, of its max |value|
# one render in each Perp-Neg branch: front-side, side-back, overhead
PERP_VIEWS = {"elevation": [10.0, 20.0, 75.0], "azimuth": [30.0, -130.0, 200.0], "distance": [3.8, 3.8, 3.8]}


SD_UNIFIED = {}  # stable-diffusion-unified-guidance's widths in phase 20: SD 1.5's (the defaults)
Z_UNIFIED = {"use_clip": False}  # zero123-unified-guidance's: Stable Zero123's, the bank given


def drawn_lora_tree(torch, guidance):
    """The guidance's fresh LoRA with every B drawn (at its init B = 0 and
    phi would be the pretrained UNet), as detached tensors on the CPU."""
    lora = guidance.init_lora_params(torch.Generator(device=guidance.modules.device).manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    return {k: {n: 0.3 * torch.randn(v.shape, generator=gen) if n == "B" else v.detach().cpu()
                for n, v in leaves.items()} for k, leaves in lora.items()}


def on_device(tree, dev):
    """A LoRA tree's leaves on ``dev`` as fresh leaves that require grad."""
    return {k: {n: v.to(dev).clone().requires_grad_(True) for n, v in leaves.items()} for k, leaves in tree.items()}


def leaf(x, dev):
    """``x`` on ``dev`` as a fresh leaf that requires grad (``x`` untouched)."""
    return x.detach().to(dev).clone().requires_grad_(True)


def unified_plan(torch):
    """Phase 20's guidance checks: family → (registry name, config, [(case,
    config overrides, label, run)]); ``run(guidance, dev, lora)`` → (its
    outputs, the gradients [rgb, LoRA leaves …]) on fixed inputs and draws."""
    from dreammesh4d_tpu_torch.models.guidance.stable_diffusion import StableDiffusionPromptProcessor
    from dreammesh4d_tpu_torch.models.guidance.unified import SDUnifiedConfig, Zero123UnifiedConfig
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves

    gen = torch.Generator().manual_seed(11)

    def latent(cfg, b):
        L = cfg.image_size // 2 ** (len(cfg.vae_ch_mult) - 1)  # the VAE's downsampling
        return torch.randn((b, 4, L, L), generator=gen)

    # (a) SD unified: Perp-Neg SDS on one 512^2 render per branch, the vsd dispatch on a 64^2 one
    sdc = SDUnifiedConfig(**SD_UNIFIED)
    B = len(PERP_VIEWS["elevation"])
    view = [torch.tensor(PERP_VIEWS[k]) for k in ("elevation", "azimuth", "distance")]
    rgb_perp, rgb_vsd = smooth_images(torch, B, 512, 12), smooth_images(torch, 1, 64, 13)
    cam = torch.randn((1, 16), generator=gen)
    perp_draws = {"u": torch.tensor([0.37, 0.81, 0.55]), "noise": latent(sdc, B)}
    vsd_draws = {"u": torch.tensor([0.37]), "noise": latent(sdc, 1), "u2": torch.tensor([0.52]),
                 "noise2": latent(sdc, 1), "drop": torch.tensor([False])}

    def run_perp(g, dev, lora):
        prompts = StableDiffusionPromptProcessor({"prompt": ZOO_PROMPT}, device=dev)()
        rgb = leaf(rgb_perp, dev)
        out = g.loss(prompts, rgb, *(v.to(dev) for v in view), 0, **perp_draws)
        out["loss_sds"].backward()
        return {k: float(out[k].detach()) for k in ("loss_sds", "grad_norm")}, [rgb.grad]

    def run_sd_vsd(g, dev, lora):
        prompts = StableDiffusionPromptProcessor({"prompt": ZOO_PROMPT}, device=dev)()
        lora, rgb = on_device(lora, dev), leaf(rgb_vsd, dev)
        out = g.loss(prompts, rgb, *(v[:1].to(dev) for v in view), 0, camera_condition=cam.to(dev), lora=lora,
                     **vsd_draws)
        (out["loss_vsd"] + out["loss_lora"]).backward()
        return ({k: float(out[k].detach()) for k in ("loss_vsd", "loss_lora", "grad_norm")},
                [rgb.grad] + [v.grad for v in tree_leaves(lora)])

    # (b) Zero123 unified: sds, and vsd with the phi CFG against a zero camera, on 2 renders at 256^2
    zc = Zero123UnifiedConfig(**Z_UNIFIED)
    zview = [torch.tensor(v) for v in ([10.0, 35.0], [30.0, -120.0], [1.8, 2.2])]
    rgb_z, zcam, frames = smooth_images(torch, 2, 256, 14), torch.randn((2, 16), generator=gen), torch.tensor([1, 0])
    bank = {"c_crossattn": torch.randn((2, zc.context_dim), generator=gen), "c_concat": latent(zc, 2)}
    z_draws = {"u": torch.tensor([0.3, 0.9]), "noise": latent(zc, 2), "u2": torch.tensor([0.45, 0.12]),
               "noise2": latent(zc, 2), "drop": torch.tensor([True, False])}

    def run_z(g, dev, lora):
        args = ({k: v.to(dev) for k, v in bank.items()}, leaf(rgb_z, dev), *(v.to(dev) for v in zview), 0)
        rgb = args[1]
        if g.cfg.guidance_type == "sds":
            out = g.loss(*args, frame_indices=frames.to(dev), u=z_draws["u"], noise=z_draws["noise"])
            out["loss_sds"].backward()
            return {k: float(out[k].detach()) for k in ("loss_sds", "grad_norm")}, [rgb.grad]
        lora = on_device(lora, dev)
        out = g.loss(*args, frame_indices=frames.to(dev), camera_condition=zcam.to(dev), lora=lora, **z_draws)
        (out["loss_vsd"] + out["loss_lora"]).backward()
        return ({k: float(out[k].detach()) for k in ("loss_vsd", "loss_lora", "grad_norm")},
                [rgb.grad] + [v.grad for v in tree_leaves(lora)])

    return {
        "sd": ("stable-diffusion-unified-guidance", dict(SD_UNIFIED), [
            ("sd_perp_neg", {"use_perp_neg": True}, f"SD unified Perp-Neg SDS ({B} renders at 512^2, one per branch)",
             run_perp),
            ("sd_vsd", {"guidance_type": "vsd"}, "SD unified vsd dispatch (LoRA rank 8, one 64^2 render)",
             run_sd_vsd)]),
        "z": ("zero123-unified-guidance", dict(Z_UNIFIED), [
            ("z_sds", {}, "Zero123 unified sds (2 renders at 256^2)", run_z),
            ("z_vsd", {"guidance_type": "vsd", "vsd_guidance_scale_phi": 1.5, "vsd_lora_cfg_training": True},
             "Zero123 unified vsd (2 renders at 256^2, phi scale 1.5, the camera token, one camera dropped)",
             run_z)])}


class CpuReferences(threading.Thread):
    """The CPU sides of phase 20's guidance checks and phase 21's step
    checks, computed in a thread that phase 16 starts (it touches no CUDA),
    so that their minutes of CPU work run beside phases 16–19: per family,
    the guidance built on the CPU with every weight drawn from a CPU
    generator (the output convolutions too), each case's LoRA (every B
    drawn), outputs and gradients, and the weights for the card; then one
    step of each of phase 21's four (``zmesh_check_side``); then phase 22's
    (``editing_check_side``).  ``wait(part)`` returns when ``"unified"``,
    ``"zmesh"`` or ``"editing"`` is done (or the thread failed)."""

    def __init__(self, torch, plan):
        super().__init__(daemon=True)
        self.torch, self.plan, self.results, self.error = torch, plan, {}, None
        self.done = {part: threading.Event() for part in ("unified", "zmesh", "editing")}

    def wait(self, part):
        while not self.done[part].wait(timeout=1.0):
            if not self.is_alive():
                break
        if self.error is not None:
            raise self.error
        check(self.done[part].is_set(), f"the CPU references' {part} part did not finish")

    def run(self):
        torch = self.torch
        from dreammesh4d_tpu_torch import registry

        try:
            for family, (name, cfg, cases) in self.plan.items():
                base = registry.find(name)(cfg, device="cpu")
                base.modules.init_params(torch.Generator().manual_seed(0), zero_init=False)
                for case, over, _, run in cases:
                    t0 = time.perf_counter()
                    g = registry.find(name)({**cfg, **over}, modules=base.modules, device="cpu")
                    lora = drawn_lora_tree(torch, g) if g.cfg.guidance_type == "vsd" else None
                    out, grads = run(g, "cpu", lora)
                    self.results[case] = {"out": out, "grads": [x.detach() for x in grads], "lora": lora,
                                          "s": time.perf_counter() - t0}
                self.results[family] = base.modules.state_dict()
                del base
            self.done["unified"].set()
            self.results["zmesh"] = zmesh_check_side(torch, "cpu")
            self.results["zmesh64"] = zmesh_check_side(torch, "cpu", torch.float64)
            self.done["zmesh"].set()
            self.results["editing"] = editing_check_side(torch, "cpu")
            self.done["editing"].set()
        except BaseException as e:  # noqa: BLE001  (raised again by phases 20, 21 and 22)
            self.error = e


def unified_card_vs_cpu(torch, card, refs, device):
    """Phase 20's guidance checks on the card against ``refs`` (its unified part): per
    family the CPU's weights loaded on the card, each case run there from
    the same inputs, draws and LoRA, held within UNIFIED_TOL (losses) /
    UNIFIED_GRAD_TOL (gradients), then timed (CUDA events, one call)."""
    from dreammesh4d_tpu_torch import registry

    refs.wait("unified")
    res = {}
    for family, (name, cfg, cases) in refs.plan.items():
        base = registry.find(name)(cfg, device=device)
        base.modules.load_state_dict(refs.results[family])
        c = base.cfg
        for case, over, label, run in cases:
            g = registry.find(name)({**cfg, **over}, modules=base.modules, device=device)
            ref = refs.results[case]
            got, g_card = run(g, device, ref["lora"])
            want, g_cpu = ref["out"], ref["grads"]
            errs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want}
            grad_errs = [rel_err(a.cpu(), b) for a, b in zip(g_card, g_cpu)]
            ms = time_ms(torch, lambda: run(g, device, ref["lora"]), n=3, warmup=1)
            print(f"[{card}] {label} (UNet {c.model_channels} x {list(c.channel_mult)}, context {c.context_dim}, "
                  f"VAE {c.vae_ch} at {c.image_size}^2), float32, card vs CPU: " + ", ".join(
                      f"{k} {got[k]:.8g} vs {want[k]:.8g} (relative {errs[k]:.3g})" for k in want)
                  + f" (limit {UNIFIED_TOL}); d loss / d rgb max |d| / max {grad_errs[0]:.3g}"
                  + (f", worst of {len(grad_errs) - 1} LoRA leaves {max(grad_errs[1:]):.3g}"
                     if len(grad_errs) > 1 else "")
                  + f" (limit {UNIFIED_GRAD_TOL}); one call (forward + backward) on the card {ms:.2f} ms; the CPU's "
                  f"side {ref['s']:.1f} s (beside phases 16-19)")
            check(all(e <= UNIFIED_TOL for e in errs.values()) and max(grad_errs) <= UNIFIED_GRAD_TOL
                  and min(want.values()) > 0 and len(g_card) == len(g_cpu), f"{label}: card and CPU differ")
            res[case] = {"ms": ms, "err": max(errs.values()), "grad_err": max(grad_errs), "losses": want,
                         "cpu_s": ref["s"]}
        del base
        torch.cuda.empty_cache()
    return res


def clone_tree(tree, dev, dtype):
    """A copy of a parameter tree (dicts and lists of tensors) on ``dev`` in
    ``dtype``, every leaf a fresh leaf that requires grad."""
    if isinstance(tree, dict):
        return {k: clone_tree(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v, dev, dtype) for v in tree]
    return tree.detach().to(dev, dtype).clone().requires_grad_(True)


def component_cases(torch, device):
    """name → (config, inputs builder) of the 8 material and background
    names on COMP_POINTS points."""
    g = torch.Generator().manual_seed(21)
    n = COMP_POINTS

    def unit():
        d = torch.randn((n, 3), generator=g)
        return d / d.norm(dim=-1, keepdim=True)

    x = {"feat8": torch.randn((n, 8), generator=g), "feat7": torch.randn((n, 7), generator=g),
         "feat4": torch.randn((n, 4), generator=g), "dirs": unit(), "view": unit(), "tangent": unit(),
         "w": torch.randn((n, 3), generator=g)}
    return x, {
        "pbr-material": ({}, "feat8", lambda o, f, t, p: o(f, viewdirs=t["view"], shading_normal=t["dirs"],
                                                          tangent=t["tangent"], params=p)),
        "neural-radiance-material": ({}, "feat8", lambda o, f, t, p: o(f, viewdirs=t["dirs"], params=p)),
        "hybrid-rgb-latent-material": ({}, "feat7", lambda o, f, t, p: o(f)),
        "sd-latent-adapter-material": ({}, "feat4", lambda o, f, t, p: o(f, params=p)),
        "neural-environment-map-background": ({}, None, lambda o, f, t, p: o(t["dirs"], params=p)),
        "gaussian-mvdream-neural-environment-map-background": (
            {"n_frequencies": 4}, None, lambda o, f, t, p: o(t["dirs"], params=p)),
        "solid-color-background": ({"learned": True}, None, lambda o, f, t, p: o(params=p).expand(n, 3)),
        "textured-background": ({}, None, lambda o, f, t, p: o(t["dirs"], params=p)),
    }


def drive_components(torch, np, rb, tb, hc, card, refs, device):
    """Phase 20, the unified guidance, the materials and backgrounds and
    Adan, each built as a user builds it (``registry.find(name)(cfg)``, or
    ``Adan(params)``).  (a) ``stable-diffusion-unified-guidance`` at SD 1.5's
    widths (float32, every weight drawn on the CPU, the output convolutions
    too, and loaded on the card):
    Perp-Neg SDS (``use_perp_neg``) forward + backward on 3 renders at 512²,
    one in each branch (front-side, side-back, overhead), and the ``vsd``
    dispatch with a rank-8 LoRA (every B drawn) on one 64² render; (b)
    ``zero123-unified-guidance`` at Stable Zero123's widths (the CLIP tower's
    bank given: random ``c_crossattn`` / ``c_concat``): ``sds``, and ``vsd``
    with ``vsd_guidance_scale_phi`` 1.5, the camera token and
    ``vsd_lora_cfg_training`` (one view's camera dropped) on 2 renders at
    256²; each card against CPU on the same weights and draws within
    UNIFIED_TOL (losses) / UNIFIED_GRAD_TOL (gradients), and timed, the
    CPU's side from ``refs`` (a ``CpuReferences`` that ran beside phases
    16–19); (c) the
    8 material and background names on COMP_POINTS points, forward +
    backward of a weighted sum, the card's float32 against the CPU's float64
    within COMP_TOL or COMP_ROUNDING × the CPU's own float32 rounding, timed; (d)
    Adan, ADAN_STEPS steps over configs/zoo/dreamfusion-sd.yaml's
    ``implicit-volume`` parameters (corner grid 16 × 2 × 2^19 and its MLPs)
    with seeded gradients, card against CPU within ADAN_TOL of each leaf's
    max after every step, ms/step.  No hand-written kernel lies on this path:
    the launch counts must stay 0."""
    from dreammesh4d_tpu_torch import registry
    from dreammesh4d_tpu_torch.config import config_to_primitive, load_config
    from dreammesh4d_tpu_torch.models.geometry.implicit_volume import init_implicit_volume
    from dreammesh4d_tpu_torch.models.guidance.stable_diffusion import StableDiffusionPromptProcessor
    from dreammesh4d_tpu_torch.systems.adan import Adan
    from dreammesh4d_tpu_torch.systems.assembly import implicit_volume_config
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves

    res = {}
    for m in (rb, tb, hc):
        m.reset_launch_counts()

    # (a), (b) the unified guidances, card against the CPU's side computed beside phases 16-19
    res.update(unified_card_vs_cpu(torch, card, refs, device))

    # (c) the materials and backgrounds on COMP_POINTS points: the card's float32 against the CPU's
    # float64, within COMP_TOL or COMP_ROUNDING x the CPU's own float32 rounding on these inputs
    x, cases = component_cases(torch, device)
    res["components"] = {}
    for name, (cfg, fkey, call) in cases.items():
        outs = {}
        on_card = registry.find(name)(cfg, device=device)
        for label, dev, dtype in (("card", device, torch.float32), ("cpu", "cpu", torch.float32),
                                  ("cpu64", "cpu", torch.float64)):
            obj = on_card if dev == device else registry.find(name)(cfg, device="cpu")
            params = clone_tree(on_card.params, dev, dtype)
            t = {k: v.to(dev, dtype) for k, v in x.items()}
            feat = leaf(x[fkey].to(dtype), dev) if fkey else None

            def fwd_bwd(obj=obj, params=params, t=t, feat=feat):
                out = call(obj, feat, t, params)
                (out[..., :3] * t["w"]).sum().backward()
                return out

            out = fwd_bwd()
            outs[label] = (out.detach().cpu().double().clone(),
                           [g.grad.cpu().double().clone() for g in [feat] + tree_leaves(params) if g is not None])
            if label == "card":
                ms = time_ms(torch, fwd_bwd, n=5, warmup=1)
        (o_c, g_c), (o_p, g_p), (o_64, g_64) = outs["card"], outs["cpu"], outs["cpu64"]
        err = {"fwd": float((o_c - o_64).abs().max()), "grad": max(rel_err(a, b) for a, b in zip(g_c, g_64))}
        rounding = {"fwd": float((o_p - o_64).abs().max()), "grad": max(rel_err(a, b) for a, b in zip(g_p, g_64))}
        band = {k: max(COMP_TOL, COMP_ROUNDING * rounding[k]) for k in err}
        vs_cpu = {"fwd": float((o_c - o_p).abs().max()), "grad": max(rel_err(a, b) for a, b in zip(g_c, g_p))}
        res["components"][name] = {"ms": ms, "err": err, "rounding": rounding, "vs_cpu": vs_cpu}
        print(f"[{card}] {name} on {COMP_POINTS} points, forward + backward: {ms:.3f} ms; against the CPU's float64: "
              f"forward max |d| {err['fwd']:.3g}, gradients ({'features and ' if fkey else ''}"
              f"{len(g_c) - (1 if fkey else 0)} parameter leaves) max |d| / max {err['grad']:.3g} (limits "
              f"{band['fwd']:.3g}, {band['grad']:.3g}: {COMP_TOL} or {COMP_ROUNDING} x the CPU's float32 rounding, "
              f"{rounding['fwd']:.3g} and {rounding['grad']:.3g}); card vs CPU float32 {vs_cpu['fwd']:.3g}, "
              f"{vs_cpu['grad']:.3g}")
        check(all(err[k] <= band[k] for k in err) and len(g_c) == len(g_p) == len(g_64) > 0,
              f"{name}: the card's float32 is off the CPU's float64 by more than the band")

    # (d) Adan over dreamfusion-sd's implicit-volume parameters
    zoo_cfg = load_config(os.path.join(REPO, "configs", "zoo", "dreamfusion-sd.yaml"),
                          cli_args=[f"system.prompt_processor.prompt={ZOO_PROMPT}"], makedirs=False)
    geo_cfg = implicit_volume_config(config_to_primitive(zoo_cfg.system.geometry))
    init = tree_leaves(init_implicit_volume(geo_cfg, torch.Generator().manual_seed(3), device="cpu"))
    leaves = {dev: [v.detach().to(dev).clone().requires_grad_(True) for v in init] for dev in (device, "cpu")}
    opts = {dev: Adan(leaves[dev], lr=1e-2, weight_decay=1e-4) for dev in (device, "cpu")}
    worst, step_ms, ggen = 0.0, [], torch.Generator().manual_seed(4)
    for _ in range(ADAN_STEPS):
        grads = [torch.randn(v.shape, generator=ggen) for v in init]
        for dev in (device, "cpu"):
            for p, g in zip(leaves[dev], grads):
                p.grad = g.to(dev)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        opts[device].step()
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        opts["cpu"].step()
        worst = max([worst] + [rel_err(a.detach().cpu(), b.detach()) for a, b in zip(leaves[device], leaves["cpu"])])
    n_params = sum(v.numel() for v in init)
    res["adan"] = {"ms": statistics.median(step_ms[1:]), "err": worst, "n_params": n_params}
    print(f"[{card}] Adan over dreamfusion-sd's implicit-volume ({n_params} parameters in {len(init)} leaves: corner "
          f"grid {geo_cfg.hashgrid.n_levels} x {geo_cfg.hashgrid.n_features_per_level} x "
          f"2^{geo_cfg.hashgrid.log2_hashmap_size}), {ADAN_STEPS} steps: ms/step " + ", ".join(
              f"{v:.3f}" for v in step_ms) + f" (median after the first {res['adan']['ms']:.3f}); card vs CPU "
          f"worst leaf after any step {worst:.3g} of its max (limit {ADAN_TOL})")
    check(worst <= ADAN_TOL, f"Adan: card and CPU differ by {worst:.3g} > {ADAN_TOL}")

    torch.cuda.synchronize()
    res["launches"] = {**rb.launch_counts, **tb.launch_counts, **hc.launch_counts}
    check(not any(res["launches"].values()), f"phase 20 launched a hand-written kernel: {res['launches']}")
    print(f"[{card}] phase 20: no hand-written kernel launched (the unified guidance is cuDNN, cuBLAS and SDPA; "
          f"the components and Adan elementwise PyTorch)")
    return res



# --- phase 21: the SDF and mesh geometries (fantasia3d, magic3d refine, textmesh) ------------
ZMESH_STEPS = 2  # steps of each of the four steps at full width
ZMESH_VIEWS = 4  # data.random_camera.batch_size
# the rasterized steps' render side: the random-camera datamodule's 512^2 is refused by both
# packages at isosurface_resolution 64 (3,145,728 face slots need 22 rank bits; 512^2 has 1024
# 16-px tiles, 11 bits: past the int32 key's 31), so the largest side the key holds, 256^2
ZMESH_HW = 256
ZMESH_REFUSED_HW = 512
ZMESH_TEXTMESH_HW = (64, 128, 256)  # textmesh: the largest of these that the card holds
# card vs CPU, one step of each, both in float64 (zmesh_card_vs_cpu): every metric (relative)
# within ZMESH_TOL, every parameter leaf's gradient (of its max |value|) within ZMESH_GRAD_TOL,
# and the views' face maps before the step apart on at most ZMESH_FLIP_SHARE of their pixels
ZMESH_TOL = 1e-4
ZMESH_GRAD_TOL = 1e-3
ZMESH_FLIP_SHARE = 1e-3
ZMESH_EXPORT_RES = 256  # export_sdf_grid before mc-cpu
# the card-vs-CPU check, to keep the CPU's side short: the default hash grids and MLPs, the tet
# grid at resolution 32 and 2 views at 128^2 (textmesh 32^2, 32 + 32 samples), a deterministic
# guidance term in place of SD
ZMESH_CHECK = {"res": 32, "hw": 128, "views": 2, "textmesh_hw": 32, "samples": 32}
# the full width: the dataclasses' defaults (hash grids 16 x 2 x 2^19, 64-wide MLPs, 64 + 64 samples)
ZMESH_FULL = {"res": 64, "hw": ZMESH_HW, "views": ZMESH_VIEWS, "textmesh_hw": ZMESH_TEXTMESH_HW[0], "samples": 64}


def zmesh_batch(torch, hw, views, seed, device):
    """A random-camera batch (the datamodule's sampler at ``hw``², ``views``
    views) with the per-view ``GSCameraInfo`` list and camera positions the
    rasterized steps read."""
    from dreammesh4d_tpu_torch.data.uncond import RandomCameraConfig, RandomCameraSampler
    from dreammesh4d_tpu_torch.ops.cameras import GSCameraInfo

    batch = RandomCameraSampler(RandomCameraConfig(height=hw, width=hw, batch_size=views), seed=seed,
                                device=device).sample()
    rc = batch["rand_cameras"]
    batch["cameras"] = [GSCameraInfo(rc.world_view[i], rc.full_proj[i], rc.camera_center[i]) for i in range(views)]
    batch["camera_positions"] = rc.camera_center
    return batch


def zmesh_steps(torch, guidance, device, c):
    """The four steps: name -> (make(geo params) -> (train_step, state), the
    parameters' factory name and config, the batch's (hw, views)), at the
    sizes of ``c`` (ZMESH_FULL or ZMESH_CHECK; a ``hashgrid`` entry narrows
    the grids); ``guidance(rgb_as_latents)`` gives each step's guidance
    closure."""
    from dreammesh4d_tpu_torch.models.geometry.dmtet import TetSDFGridConfig
    from dreammesh4d_tpu_torch.models.geometry.implicit_sdf import ImplicitSDFConfig
    from dreammesh4d_tpu_torch.models.renderers.mesh_rasterizer import MeshRasterizer
    from dreammesh4d_tpu_torch.models.renderers.neus_volume_renderer import NeuSRendererConfig
    from dreammesh4d_tpu_torch.ops.hashgrid import HashGridConfig
    from dreammesh4d_tpu_torch.systems import threestudio_zoo2 as z2
    from dreammesh4d_tpu_torch.systems.threestudio_zoo import init_scene_state

    grid = HashGridConfig(**c.get("hashgrid", {}))
    geo = TetSDFGridConfig(isosurface_resolution=c["res"], hashgrid=grid)
    hw, views = c["hw"], c["views"]
    sdf_cfg = ImplicitSDFConfig(hashgrid=grid)
    rcfg = NeuSRendererConfig(num_samples_coarse=c["samples"], num_samples_fine=c["samples"])
    raster = MeshRasterizer(device=device)

    def state(p):
        return init_scene_state(p, lr=1e-2, betas=(0.9, 0.99), eps=1e-15, device=device)

    return {
        "fantasia3d-geometry": (lambda p: (z2.make_fantasia3d_train_step(
            geo, z2.Fantasia3DLosses(), guidance(True), raster, texture=False, H=hw, W=hw, device=device), state(p)),
            "tetrahedra-sdf-grid", geo, (hw, views)),
        "fantasia3d-texture": (lambda p: (z2.make_fantasia3d_train_step(
            geo, z2.Fantasia3DLosses(), guidance(False), raster, texture=True, H=hw, W=hw, device=device),
            state(p)), "tetrahedra-sdf-grid", geo, (hw, views)),
        "magic3d-refine": (lambda p: (z2.make_magic3d_refine_train_step(
            geo, z2.Magic3DLosses(), guidance(False), raster, H=hw, W=hw, device=device), state(p)),
            "tetrahedra-sdf-grid", geo, (hw, views)),
        "textmesh": (lambda p: (z2.make_textmesh_train_step(sdf_cfg, rcfg, z2.TextMeshLosses(), guidance(False),
                                                            device=device), state(p)),
                     "implicit-sdf", sdf_cfg, (c["textmesh_hw"], views)),
    }


def zmesh_params(torch, name, cfg, seed):
    """Seeded parameters on the CPU: the factory's init, the hash tables
    drawn in ±0.05 and (tet grid) the SDF and deformation perturbed, so that
    every term has a gradient; ``{"geo", "var"}`` for textmesh."""
    from dreammesh4d_tpu_torch import registry
    from dreammesh4d_tpu_torch.models.renderers.neus_volume_renderer import NeuSRendererConfig, init_neus_variance

    p = registry.find(name)(dataclasses.asdict(cfg) | {"seed": seed}, device="cpu").state
    gen = torch.Generator().manual_seed(seed + 1)
    p["encoding"]["tables"] = (torch.rand(p["encoding"]["tables"].shape, generator=gen) * 2 - 1) * 0.05
    if name == "tetrahedra-sdf-grid":
        p["sdf"] = p["sdf"] + 0.01 * torch.randn(p["sdf"].shape, generator=gen)
        p["deform"] = 0.3 * torch.randn(p["deform"].shape, generator=gen)
        return p
    return {"geo": p, "var": init_neus_variance(NeuSRendererConfig(), device="cpu")}


def zmesh_check_side(torch, device, dtype=None):
    """One step of each of the four at ZMESH_CHECK's widths on ``device``
    from the same seeded parameters and batch, the renderer's draws from a
    CPU generator, and a deterministic guidance term in place of SD (a
    weighted squared distance of the image to a seeded target; SD's own
    card-vs-CPU band is phase 17's): {name: (metrics, gradients on the CPU,
    seconds, the views' face maps before the step)}.  ``dtype`` float64
    runs the parameters, rays, rasterizer and guidance in double."""
    from dreammesh4d_tpu_torch.models.geometry.dmtet import isosurface
    from dreammesh4d_tpu_torch.ops.cameras import GSCameraInfo
    from dreammesh4d_tpu_torch.ops.mesh_raster import rasterize_mesh
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves, tree_map

    dtype = dtype or torch.float32

    def guidance(latents):
        def fn(generator, img, batch):
            g = torch.Generator().manual_seed(7)
            target = torch.rand(img.shape, generator=g).to(img.device, img.dtype)
            wts = (0.5 + torch.rand(img.shape, generator=g)).to(img.device, img.dtype)
            return ((img - target) ** 2 * wts).sum() / img.shape[0]  # SDS's scale: a sum per view
        return fn

    out = {}
    for name, (make, geo_name, geo_cfg, (hw, views)) in zmesh_steps(torch, guidance, device, ZMESH_CHECK).items():
        step, state = make(tree_map(lambda x: x.to(dtype), zmesh_params(torch, geo_name, geo_cfg, 3)))
        # drawn on the CPU and copied: the card's own float32 camera arithmetic moves the rays
        # and view matrices by an ulp, enough to move hash-grid queries across cells
        batch = zmesh_batch(torch, hw, views, 5, "cpu")
        batch["cameras"] = [GSCameraInfo(*(x.to(device) for x in cam)) for cam in batch["cameras"]]
        batch.update({k: v.to(device) for k, v in batch.items() if torch.is_tensor(v)})
        batch.update({k: batch[k].to(dtype) for k in ("rays_o", "rays_d")})
        face_idx = None
        if geo_name == "tetrahedra-sdf-grid":  # the views' face maps before the step (discrete decisions)
            with torch.no_grad():
                surf = isosurface(state.geo_params, geo_cfg)
                face_idx = torch.stack([rasterize_mesh(surf.verts, surf.faces, cam, hw, hw).face_idx.cpu()
                                        for cam in batch["cameras"]])
        t0 = time.perf_counter()
        # the renderer's draws from a CPU generator on both sides
        state, metrics = step(state, batch, torch.Generator().manual_seed(9))
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     [None if x.grad is None else x.grad.detach().cpu().double() for x in
                      tree_leaves(state.geo_params)],
                     time.perf_counter() - t0, face_idx)
    return out


def zmesh_card_vs_cpu(torch, card, refs, device):
    """Phase 21 (c): the same steps on the card against the CPU's side from
    ``refs``, both in float64: every metric within ZMESH_TOL (relative),
    every gradient leaf within ZMESH_GRAD_TOL of its max, and the views'
    face maps before the step apart on at most ZMESH_FLIP_SHARE of their
    pixels.  In float64 (the rasterizer's screen geometry too) a position's
    rounding no longer moves a hash-grid query into another cell, which in
    float32 puts the tables' gradients 1e-2 apart on the CPU itself.  The float32 steps of both sides are printed beside
    them, each against its own device's float64 (``log_s``, one scalar
    summed over every sample, is the leaf where float32 drifts most)."""
    refs.wait("zmesh")
    cpu32, cpu64 = refs.results["zmesh"], refs.results["zmesh64"]
    card32, card64 = zmesh_check_side(torch, device), zmesh_check_side(torch, device, torch.float64)

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-12)

    res = {}
    for name, (m_64, g_64, s_64, f_64) in cpu64.items():
        m_card, g_card, _, f_card = card64[name]
        m_32, g_32, s_32, _ = cpu32[name]
        m_c32, g_c32, _, _ = card32[name]
        check(sorted(m_card) == sorted(m_64) == sorted(m_32) == sorted(m_c32), f"{name}: metrics differ in their keys")
        check(all((a is None) == (b is None) for a, b in zip(g_card, g_64)), f"{name}: gradients differ in presence")
        pairs = [(a, b) for a, b in zip(g_card, g_64) if b is not None]
        check(all(torch.isfinite(a).all() for a, _ in pairs), f"{name}: a gradient on the card is not finite")
        m_err = max(rel(m_card[k], v) for k, v in m_64.items())
        g_err = [rel_err(a, b) for a, b in pairs]
        pixels = None if f_64 is None else f_64.numel()
        flips = None if f_64 is None else int((f_64 != f_card).sum())
        # the float32 witnesses: each device's float32 against its own float64
        w_card = [rel_err(a, b) for a, b in zip(g_c32, g_card) if b is not None]
        w_cpu = [rel_err(a, b) for a, b in zip(g_32, g_64) if b is not None]
        res[name] = {"metric_err": m_err, "grad_err": g_err, "face_flips": flips, "pixels": pixels,
                     "card32_vs_card64": w_card, "cpu32_vs_cpu64": w_cpu, "cpu_s": s_32, "cpu64_s": s_64}
        print(f"[{card}] {name} at ZMESH_CHECK's widths, the card's float64 against the CPU's float64: metrics max "
              f"relative {m_err:.3g} (limit {ZMESH_TOL:g}); {len(pairs)} gradient leaves max |d| / max "
              + ", ".join(f"{e:.3g}" for e in g_err) + f" (limit {ZMESH_GRAD_TOL:g}); face_idx differs on "
              f"{flips} of {pixels} pixels before the step (limit {ZMESH_FLIP_SHARE:g} of them); float32 against "
              f"float64 on the card " + ", ".join(f"{e:.3g}" for e in w_card) + ", on the CPU "
              + ", ".join(f"{e:.3g}" for e in w_cpu) + f"; loss_total {m_64['loss_total']:.6g}; the CPU's steps "
              f"{s_32:.1f} s, float64 {s_64:.1f} s")
        check(m_err <= ZMESH_TOL and all(e <= ZMESH_GRAD_TOL for e in g_err),
              f"{name}: the card's float64 is off the CPU's float64 by more than ZMESH_TOL / ZMESH_GRAD_TOL")
        check(flips is None or flips <= ZMESH_FLIP_SHARE * pixels,
              f"{name}: the card's face maps differ from the CPU's on {flips} of {pixels} pixels")
    return res


def step_ms(torch, train_step, state, batch, gen):
    """One step, timed with CUDA events -> (state, metrics, ms)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, metrics = train_step(state, batch, gen)
    end.record()
    end.synchronize()
    return state, metrics, start.elapsed_time(end)


def drive_zoo_mesh(torch, np, rb, tb, hc, card, refs, device):
    """Phase 21, the SDF and mesh geometries with their renderers and steps,
    each built through ``registry.find``: (a) the four steps at full width
    (``tetrahedra-sdf-grid`` at resolution 64 with the default hash grid,
    ``nvdiff-rasterizer`` at capacity 256 and 64 tiles a face, 4 views at
    ZMESH_HW² for the three rasterized steps; ``implicit-sdf`` 16 × 2 ×
    2^19 with 64 × 2 MLPs and ``neus-volume-renderer`` 64 + 64 samples for
    textmesh, at the largest of ZMESH_TEXTMESH_HW whose peak the card holds)
    with SD 1.5 at ``random:0`` in float32, ZMESH_STEPS steps each: ms per
    step, the SDS term alone, peak memory; the refusal at 512²; (b) one
    view's rasterization with the 3,145,728 face slots against the real
    faces alone (time, memory, the pixels the masked slots cost through the
    tile capacity); (c) card against CPU (``zmesh_card_vs_cpu``); (d)
    ``export_mesh`` at resolution 64 and ``export_sdf_grid`` at
    ZMESH_EXPORT_RES³ then ``mesh-exporter`` (mc-cpu).  No hand-written
    kernel lies on this path: the launch counts must stay 0."""
    from dreammesh4d_tpu_torch import registry
    from dreammesh4d_tpu_torch.models.geometry.dmtet import export_mesh, isosurface
    from dreammesh4d_tpu_torch.models.geometry.implicit_sdf import export_sdf_grid
    from dreammesh4d_tpu_torch.models.guidance.stable_diffusion import (StableDiffusionGuidance,
                                                                       StableDiffusionPromptProcessor)
    from dreammesh4d_tpu_torch.ops.mesh_raster import rasterize_mesh
    from dreammesh4d_tpu_torch.utils.tree import tree_map

    res = {"steps": {}}
    for m in (rb, tb, hc):
        m.reset_launch_counts()
    sd = StableDiffusionGuidance(ZOO_SD, device=device)
    sd.modules.init_params(torch.Generator(device=device).manual_seed(0), zero_init=sd.cfg.zero_init)
    prompts = StableDiffusionPromptProcessor({"prompt": ZOO_PROMPT}, device=device)()
    def sds(latents):
        def fn(generator, img, batch):
            return sd.sds_loss(prompts, img, batch["elevation"], batch["azimuth"], batch["camera_distances"], 0,
                               generator, rgb_as_latents=latents)["loss_sds"]
        return fn

    steps = zmesh_steps(torch, sds, device, ZMESH_FULL)
    gen = torch.Generator(device=device).manual_seed(4)

    def sds_alone_ms(shape, latents, batch):
        img0 = torch.rand(shape, generator=gen, device=device)

        def run():
            img = img0.clone().requires_grad_(True)
            sd.sds_loss(prompts, img, batch["elevation"], batch["azimuth"], batch["camera_distances"], 0, gen,
                        rgb_as_latents=latents)["loss_sds"].backward()

        return time_ms(torch, run, n=3, warmup=1)

    def run_steps(name, hw):
        make, geo_name, geo_cfg, (_, views) = steps[name]
        params = tree_map(lambda x: x.to(device), zmesh_params(torch, geo_name, geo_cfg, 3))
        batch = zmesh_batch(torch, hw, views, 5, device)
        train_step, state = make(params)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms, metrics = [], None
        for _ in range(ZMESH_STEPS):
            state, metrics, t = step_ms(torch, train_step, state, batch, gen)
            ms.append(t)
            check(all(np.isfinite(float(v)) for v in metrics.values()), f"{name}: a metric is not finite: {metrics}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(float(metrics["loss_sds"]) > 0, f"{name}: no SDS term")
        channels = 4 if name == "fantasia3d-geometry" else 3
        sds = sds_alone_ms((views, hw, hw, channels), name == "fantasia3d-geometry", batch)
        res["steps"][f"{name}@{hw}"] = {"ms": ms, "sds_ms": sds, "peak_gib": peak,
                                        "metrics": {k: float(v) for k, v in metrics.items()}}
        print(f"[{card}] {name}: {views} views at {hw}^2, ms/step " + ", ".join(f"{v:.1f}" for v in ms)
              + f"; the SDS term alone (SD 1.5, float32, forward + backward) {sds:.1f} ms; peak "
              f"{peak:.2f} GiB; " + ", ".join(f"{k} {float(v):.5g}" for k, v in metrics.items()))
        del state, train_step
        torch.cuda.empty_cache()
        return peak

    # (a) the three rasterized steps at full width, then textmesh at the largest side the card holds
    for name in ("fantasia3d-geometry", "fantasia3d-texture", "magic3d-refine"):
        run_steps(name, ZMESH_FULL["hw"])
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    sides = [s for s in ZMESH_TEXTMESH_HW if s >= ZMESH_FULL["textmesh_hw"]]
    side = sides.pop(0)
    peak = run_steps("textmesh", side)
    # every sample of every ray is held at once: the peak grows with the pixels
    while sides and peak * (sides[0] / side) ** 2 < 0.9 * total:
        side_next = sides.pop(0)
        peak = run_steps("textmesh", side_next)
        side = side_next
    res["textmesh_hw"] = side
    print(f"[{card}] textmesh: the largest of {list(ZMESH_TEXTMESH_HW)} run is {side}^2 ({peak:.2f} GiB of "
          f"{total:.1f}; the next would take ~{peak * 4:.1f} GiB by the pixel count)")

    # the datamodule's 512^2 is refused, as the JAX package's int32 key refuses it
    geo_cfg = steps["magic3d-refine"][2]
    tet = registry.find("tetrahedra-sdf-grid")(dataclasses.asdict(geo_cfg), device=device)
    surf = isosurface(tet.state, geo_cfg)
    faces = surf.faces  # the masked slots are (0, 0, 0)
    hw = ZMESH_FULL["hw"]
    batch = zmesh_batch(torch, hw, 1, 6, device)
    refused = None
    try:
        rasterize_mesh(surf.verts, faces, batch["cameras"][0], ZMESH_REFUSED_HW, ZMESH_REFUSED_HW)
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "overflow" in refused, f"{ZMESH_REFUSED_HW}^2 was not refused")
    print(f"[{card}] {ZMESH_REFUSED_HW}^2 with {faces.shape[0]} face slots refused, as by the JAX package: {refused}")

    # (b) one view with every slot against the real faces alone
    real = faces[surf.face_mask]
    cam = batch["cameras"][0]
    out = {}
    for label, f in (("slots", faces), ("real", real)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = time_ms(torch, lambda f=f: rasterize_mesh(surf.verts.detach(), f, cam, hw, hw), n=3, warmup=1)
        r = rasterize_mesh(surf.verts.detach(), f, cam, hw, hw)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        out[label] = (ms, peak, r.face_idx)
    fid_slots, fid_real = out["slots"][2], out["real"][2]
    hit_real = int((fid_real >= 0).sum())
    lost = int(((fid_real >= 0) & (fid_slots < 0)).sum())
    res["masked_slots"] = {"slots": faces.shape[0], "real": real.shape[0], "ms": out["slots"][0],
                           "ms_real": out["real"][0], "gib": out["slots"][1], "gib_real": out["real"][1],
                           "pixels_lost": lost, "pixels_hit": hit_real}
    print(f"[{card}] one view at {hw}^2: {faces.shape[0]} face slots ({real.shape[0]} real) "
          f"{out['slots'][0]:.2f} ms, {out['slots'][1]:.2f} GiB over the baseline; the real faces alone "
          f"{out['real'][0]:.2f} ms, {out['real'][1]:.3f} GiB; pixels the real faces cover that the slots' render "
          f"loses to the tile capacity: {lost} of {hit_real}")
    del surf, faces, real, out, fid_slots, fid_real
    torch.cuda.empty_cache()

    # (c) card against CPU, the CPU's side computed beside phases 16-20
    res["check"] = zmesh_card_vs_cpu(torch, card, refs, device)

    # (d) the exports
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v, f = export_mesh(tet.state, geo_cfg)
    res["export_mesh_s"] = time.perf_counter() - t0
    check(len(f) > 1000 and np.isfinite(v).all(), "export_mesh: no surface")
    sdf = registry.find("implicit-sdf")({"hashgrid": ZMESH_FULL.get("hashgrid", {})}, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = export_sdf_grid(sdf.state, sdf.cfg, ZMESH_EXPORT_RES)
    t1 = time.perf_counter()
    r = sdf.cfg.radius
    mesh = registry.find("mesh-exporter")({"isosurface_threshold": 0.0}, device=device)(
        grid, bbox_min=(-r, -r, -r), bbox_max=(r, r, r))
    t2 = time.perf_counter()
    radii = np.linalg.norm(mesh.v_pos, axis=-1)
    res["export_sdf_s"], res["mc_s"] = t1 - t0, t2 - t1
    print(f"[{card}] export_mesh at resolution {geo_cfg.isosurface_resolution}: {res['export_mesh_s']:.2f} s, "
          f"{len(v)} vertices, {len(f)} faces; export_sdf_grid at {ZMESH_EXPORT_RES}^3: {t1 - t0:.2f} s, then "
          f"mc-cpu {t2 - t1:.2f} s: {len(mesh.v_pos)} vertices, {len(mesh.t_pos_idx)} faces, radius "
          f"{radii.min():.3f}-{radii.max():.3f} (the init sphere's {sdf.cfg.shape_init_params})")
    check(len(mesh.t_pos_idx) > 1000 and abs(float(np.median(radii)) - sdf.cfg.shape_init_params) < 0.05,
          "export_sdf_grid + mc-cpu: not the init sphere")

    torch.cuda.synchronize()
    res["launches"] = {**rb.launch_counts, **tb.launch_counts, **hc.launch_counts}
    check(not any(res["launches"].values()), f"phase 21 launched a hand-written kernel: {res['launches']}")
    print(f"[{card}] phase 21: no hand-written kernel launched (the corner hash grid, the mesh z-buffer, "
          f"marching tets and NeuS are plain PyTorch)")
    return res


# phase 22: the guidance zoo (ControlNet, InstructPix2Pix, DeepFloyd) and the editing systems
EDIT_PROMPT = "turn it into a bronze statue"
EDIT_HW = 512  # every render: the edit decodes at image_size, and the L1 needs equal sizes
EDIT_VIEWS = 4  # renders of each guidance's loss at full width
IN2N_STEPS = 4
IN2N_EDIT_EVERY = 2  # a fresh ip2p_edit_images before steps 0, 2, …: the caller's dataset update
C4D_STEPS = 2  # steps at each generator_level
# card vs CPU at EDIT_CHECK's widths, both sides in float64 (the hash grid on the corner layout:
# B4/B5 are float32 kernels): every metric relative, every gradient leaf of its max
EDIT_TOL = 1e-8
EDIT_GRAD_TOL = 1e-6
EDIT_SD = {}  # the full-width guidances: SD 1.5's UNet 320 x [1,2,4,4] and VAE 128 at 512^2 (the defaults)
EDIT_FLOYD = {}  # DeepFloyd at DeepFloydConfig's defaults (320 x [1,2,4,4], context 4096, 64^2 pixels)
EDIT_FULL = {"gan": {}, "disc": {}}  # the GAN renderer (ch 64, (1,2,4), z 4) and the PatchGAN at their defaults
EDIT_CHECK = {"hw": 32, "gan_hw": 64, "hashgrid": {"n_levels": 8, "log2_hashmap_size": 14, "layout": "corner"},
              "sd": dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, num_heads=4, context_dim=64,
                         vae_ch=16, vae_ch_mult=(1, 2, 4, 4), vae_num_res_blocks=1, image_size=64, latent_size=8),
              "floyd": dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, num_heads=4, context_dim=64,
                            image_size=32, latent_size=32),
              "gan": {"ch": 16}, "disc": {"ndf": 16}}
EDIT_GUIDANCES = ("stable-diffusion-controlnet-guidance", "stable-diffusion-instructpix2pix-guidance",
                  "deep-floyd-guidance")


def editing_scene(torch, device, n_feature_dims=3, hashgrid=None, seed=0):
    """configs/stable-zero123.yaml's ``system.geometry`` (``n_feature_dims``
    as given; ``hashgrid`` overrides its grid) through ``implicit-volume`` and
    its ``system.renderer`` through ``nerf-volume-renderer``."""
    from dreammesh4d_tpu_torch import registry
    from dreammesh4d_tpu_torch.config import load_config
    from dreammesh4d_tpu_torch.systems.assembly import implicit_volume_config

    cfg = load_config(os.path.join(REPO, "configs", "stable-zero123.yaml"), makedirs=False,
                      cli_args=["data.image_path=/nonexistent/ref_rgba.png"])
    geo = dataclasses.asdict(implicit_volume_config(dict(cfg.system.geometry), n_feature_dims=n_feature_dims))
    geo["hashgrid"].update(hashgrid or {})
    volume = registry.find("implicit-volume")({**geo, "seed": seed}, device=device)
    renderer = registry.find("nerf-volume-renderer")({**dict(cfg.system.renderer), "geometry": geo}, device=device)
    return volume, renderer


def editing_rays(torch, hw, device, dtype=None):
    """The reference camera of stage 1 (elevation 5°, distance 3.8, fovy 20°)
    at ``hw``²: flat rays (hw², 3) computed on the CPU and copied, and the
    sphere's reference image (1, hw, hw, 3) as the edit's condition image."""
    from dreammesh4d_tpu_torch.ops.cameras import make_c2w_numpy

    ref = sphere_reference(torch, torch.as_tensor(make_c2w_numpy(5.0, 0.0, 3.8)), hw, 20.0, "cpu")
    dt = dtype or torch.float32
    return (ref["ref_rays_o"].to(device, dt), ref["ref_rays_d"].to(device, dt),
            ref["ref_rgb"].reshape(1, hw, hw, 3).to(device, dt))


def nerf_render_fn(torch, renderer, hw, channels):
    """``render_fn(geo, batch, generator)``: the batch's flat rays through the
    NeRF renderer (no material; the background sets ``channels``: white rgb,
    zero latent moments) → (B, h, w, channels); rays may come as (B, h, w, 3)."""

    def render(geo, rays_o, rays_d, generator):
        shape = rays_o.shape[:-1]
        ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        bg = torch.cat([torch.ones(3), torch.zeros(channels - 3)]).to(ro)
        out = renderer.render_rays(geo, ro, rd, torch.zeros_like(ro), bg, rng=generator)
        return out["comp_rgb"].reshape(*(shape if len(shape) > 1 else (1, hw, hw)), channels)

    return render


def gan_render_fn(torch, gan, base_render, level, with_noise=False):
    """control4d's ``render_fn(scene, batch, generator)``: the GAN renderer
    (through ``functional_call`` on ``scene["gan"]``) around the NeRF base."""
    from torch.func import functional_call

    def render(scene, batch, generator):
        def base(lo, ld):
            return {"comp_rgb": base_render(scene["geo"], lo, ld, generator)}
        kw = {"gt_rgb": batch["edited_rgb"], "generator_level": level, "generator": generator}
        if with_noise:
            kw["noise"] = batch["noise"]
        return functional_call(gan, scene["gan"], (base, batch["rays_o"], batch["rays_d"]), kw)

    return render


def double_guidance(torch, name, cfg, seed, device):
    """``name`` at ``cfg``'s widths on ``device`` with every weight drawn
    from a CPU generator (the zero-initialised layers too), in float64."""
    from dreammesh4d_tpu_torch import registry
    from dreammesh4d_tpu_torch.models.guidance.zero123.unet import set_compute_dtype

    g = registry.find(name)(cfg, device=device)
    g.modules.init_params(torch.Generator().manual_seed(seed), zero_init=False)
    g.modules.double()
    set_compute_dtype(g.modules, torch.float64)
    return g


def guidance_call(torch, g, name, rgb, normals, views, draws, prompts):
    """One loss of ``g`` (ControlNet: SDS with the given hint, canny without;
    InstructPix2Pix: ``edit_loss`` with the renders' flipped copy as the
    condition; DeepFloyd: SDS), forward and backward: (loss, grad_norm, d / d rgb)."""
    el, az, dist = views
    if name == "stable-diffusion-instructpix2pix-guidance":
        out = g.edit_loss(prompts, rgb, rgb.detach().flip(2), el, az, 0, **draws)
    elif name == "stable-diffusion-controlnet-guidance":
        hint = None if normals is None else g.make_hint(rgb, normals)
        out = g.sds_loss(prompts, rgb, el, az, dist, 0, hint=hint, **draws)
    else:
        out = g.sds_loss(prompts, rgb, el, az, dist, 0, **draws)
    out["loss_sds"].backward()
    return float(out["loss_sds"].detach()), float(out["grad_norm"]), rgb.grad


def editing_check_side(torch, device):
    """Phase 22 (d), one side: at EDIT_CHECK's widths in float64, one call
    of each guidance (2 renders at 64²), one in2n step (32², the corner
    grid, the perceptual net) and one control4d step (64² over a 16² base,
    ``generator_level`` 1 with the posterior's draw given), every input and
    draw made on the CPU and copied: {"guidance": {name: (loss, grad_norm,
    d / d rgb)}, "in2n": (metrics, gradients), "control4d": (metrics,
    gradients)}, gradients on the CPU."""
    from dreammesh4d_tpu_torch.models.guidance.stable_diffusion import StableDiffusionPromptProcessor
    from dreammesh4d_tpu_torch.models.renderers.gan_volume_renderer import GANVolumeRenderer
    from dreammesh4d_tpu_torch.systems import editing
    from dreammesh4d_tpu_torch.utils.gan import DiscriminatorConfig, init_discriminator
    from dreammesh4d_tpu_torch.utils.perceptual import init_perceptual
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves, tree_map

    f64 = torch.float64
    c = EDIT_CHECK
    t0 = time.perf_counter()
    res = {"guidance": {}}
    gen = torch.Generator().manual_seed(31)
    views = [torch.tensor(v, dtype=torch.float32).to(device) for v in ([10.0, 40.0], [20.0, -150.0], [3.8, 3.8])]
    rgb0 = smooth_images(torch, 2, 64, 32).double()
    normals = (smooth_images(torch, 2, 64, 33).double() * 2 - 1)
    for i, name in enumerate(EDIT_GUIDANCES):
        floyd = name == "deep-floyd-guidance"
        cfg = dict(c["floyd"] if floyd else c["sd"], control_type="normal")
        g = double_guidance(torch, name, cfg, 40 + i, device)
        S = cfg["image_size"] if floyd else cfg["image_size"] // 8
        draws = {"u": torch.tensor([0.31, 0.77]), "noise": torch.randn((2, 3 if floyd else 4, S, S), generator=gen)}
        prompts = StableDiffusionPromptProcessor({"prompt": EDIT_PROMPT, "context_dim": cfg["context_dim"]},
                                                 device=device)()
        loss, norm, grad = guidance_call(torch, g, name, leaf(rgb0, device), normals.to(device) if i == 0 else None,
                                         views, draws, prompts)
        res["guidance"][name] = (loss, norm, grad.cpu())
        del g
    # one in2n step
    volume, renderer = editing_scene(torch, "cpu", 3, c["hashgrid"], seed=5)
    geo = tree_map(lambda x: x.to(device, f64), volume.state)
    _, renderer = editing_scene(torch, device, 3, c["hashgrid"], seed=5)
    net = init_perceptual(torch.Generator().manual_seed(6), device=device).double()
    ro, rd, _ = editing_rays(torch, c["hw"], device, f64)
    batch = {"rays_o": ro, "rays_d": rd, "edited_rgb": smooth_images(torch, 1, c["hw"], 34).to(device, f64)}
    render = nerf_render_fn(torch, renderer, c["hw"], 3)
    step = editing.make_in2n_train_step(lambda p, b, g: render(p, b["rays_o"], b["rays_d"], g),
                                        editing.In2NLosses(), net, device=device)
    state = editing.init_in2n_state(geo, device=device)
    state, metrics = step(state, batch, torch.Generator().manual_seed(7))
    res["in2n"] = ({k: float(v) for k, v in metrics.items()}, [p.grad.cpu() for p in tree_leaves(state.geo_params)])
    # one control4d step
    volume, _ = editing_scene(torch, "cpu", 11, c["hashgrid"], seed=8)
    _, renderer = editing_scene(torch, device, 11, c["hashgrid"], seed=8)
    gan_cpu = GANVolumeRenderer(c["gan"], device="cpu")
    gan = GANVolumeRenderer(c["gan"], device=device)
    gan.load_state_dict(gan_cpu.state_dict())
    gan.double()
    scene = {"geo": tree_map(lambda x: x.to(f64), volume.state),
             "gan": {k: v.to(f64) for k, v in gan_cpu.state_dict().items()}}
    disc = tree_map(lambda x: x.detach().to(f64),
                    init_discriminator(DiscriminatorConfig(**c["disc"]), torch.Generator().manual_seed(9), "cpu"))
    hw = c["gan_hw"]
    ro, rd, _ = editing_rays(torch, hw, "cpu", f64)
    lr_hw = hw // gan.scale
    batch = {"rays_o": ro.reshape(1, hw, hw, 3), "rays_d": rd.reshape(1, hw, hw, 3),
             "edited_rgb": smooth_images(torch, 1, hw, 35).double(),
             "noise": torch.randn((1, lr_hw, lr_hw, 4), generator=gen, dtype=f64)}
    batch = {k: v.to(device) for k, v in batch.items()}
    base = nerf_render_fn(torch, renderer, lr_hw, 11)
    step = editing.make_control4d_train_step(gan_render_fn(torch, gan, base, 1, with_noise=True),
                                             editing.Control4DLosses(), net, device=device)
    state = editing.init_control4d_state(scene, disc, device=device)
    state, metrics = step(state, batch, torch.Generator().manual_seed(10))
    res["control4d"] = ({k: float(v) for k, v in metrics.items()},
                        [None if p.grad is None else p.grad.cpu() for p in
                         tree_leaves(state.scene_params) + tree_leaves(state.disc_params)])
    res["s"] = time.perf_counter() - t0
    return res


def editing_card_vs_cpu(torch, card, refs, device):
    """Phase 22 (d): ``editing_check_side`` on the card against the CPU's,
    from ``refs`` (computed beside phases 16–21), both in float64."""
    refs.wait("editing")
    cpu = refs.results["editing"]
    t0 = time.perf_counter()
    got = editing_check_side(torch, device)
    card_s = time.perf_counter() - t0

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-300)

    out = {}
    for name, (loss, norm, grad) in cpu["guidance"].items():
        g_loss, g_norm, g_grad = got["guidance"][name]
        m_err, g_err = max(rel(g_loss, loss), rel(g_norm, norm)), rel_err(g_grad.double(), grad.double())
        out[name] = (m_err, [g_err], 0)
    for part in ("in2n", "control4d"):
        m_cpu, g_cpu = cpu[part]
        m_card, g_card = got[part]
        check(sorted(m_card) == sorted(m_cpu), f"{part}: the metrics differ in their keys")
        check(all((a is None) == (b is None) for a, b in zip(g_card, g_cpu)), f"{part}: gradients differ in presence")
        check(all(math.isfinite(v) and v != 0 for k, v in m_cpu.items() if k != "loss_D"), f"{part}: a zero metric")
        # a bias before a norm with one channel a group (the PatchGAN's) has no gradient but
        # rounding: such leaves (≤ 1e-10 of the largest leaf's max on the CPU) are held to that size
        pairs = [(a, b) for a, b in zip(g_card, g_cpu) if b is not None]
        top = max(float(b.abs().max()) for _, b in pairs)
        noise = [float(b.abs().max()) <= 1e-10 * top for _, b in pairs]
        check(all(float(a.abs().max()) <= 1e-10 * top for (a, _), n in zip(pairs, noise) if n),
              f"{part}: a leaf without gradient has one on the card")
        out[part] = (max(rel(m_card[k], v) for k, v in m_cpu.items()),
                     [rel_err(a, b) for (a, b), n in zip(pairs, noise) if not n], sum(noise))
    for part, (m_err, g_errs, n_noise) in out.items():
        print(f"[{card}] phase 22 (d) {part} at EDIT_CHECK's widths, float64, card vs CPU: metrics max relative "
              f"{m_err:.3g} (limit {EDIT_TOL:g}); {len(g_errs)} gradient leaves max |d| / max {max(g_errs):.3g} "
              f"(limit {EDIT_GRAD_TOL:g})" + (f"; {n_noise} leaves with rounding only, both sides within 1e-10 of "
                                              f"the largest leaf's max" if n_noise else ""))
        check(m_err <= EDIT_TOL and max(g_errs) <= EDIT_GRAD_TOL, f"phase 22 (d) {part}: card and CPU differ")
    print(f"[{card}] phase 22 (d): the CPU's side {cpu['s']:.1f} s (beside phases 16-21), the card's {card_s:.1f} s")
    return {k: {"metric_err": v[0], "grad_err": max(v[1])} for k, v in out.items()} | {"cpu_s": cpu["s"],
                                                                                      "card_s": card_s}


def in2n_predicted(n_rays, chunk, with_edit):
    """B4 / B5 launches of one in2n step over ``n_rays`` rays (stage 1's
    count for a reference view: an encode per chunk, run again when the chunk
    is rematerialised, and one backward), plus, with the dataset update, the
    edit's render (no gradient: one encode per chunk)."""
    fwd, bwd = stage1_predicted((n_rays, 0), False)
    return fwd + (-(-n_rays // chunk) if with_edit else 0), bwd


def drive_editing(torch, np, rb, tb, hc, card, refs, device):
    """Phase 22, the guidance zoo and the editing systems, each built through
    ``registry.find``, float32, every guidance at ``random:0`` with its
    zero-initialised layers drawn.  (a) ControlNet (SD 1.5's UNet and the
    ControlNet copy, VAE 128 at 512²) SDS on EDIT_VIEWS renders at 512² with
    a normal and a canny hint; InstructPix2Pix ``edit_loss`` on as many and
    one ``ip2p_edit_images`` at its defaults (20 DDIM steps from 0.7) on one
    view; DeepFloyd at its defaults: forward + backward each, CUDA events.
    (b) instructnerf2nerf over stage 1's geometry and renderer
    (configs/stable-zero123.yaml: the cell hash grid, so B4/B5 launch in
    every step) on one 512² view: L1 + the perceptual net, IN2N_STEPS steps,
    the edited target replaced by a fresh edit every IN2N_EDIT_EVERY steps;
    the launches against ``in2n_predicted``.  (c) control4d: the GAN renderer
    at its defaults (512² over a 128² base of the same grid with 11 feature
    channels), the PatchGAN, two Adams, ``generator_level`` 0, 1 and 2 in
    turn; the discriminator's gradient against its term's alone.  (d) card
    against CPU in float64 (``editing_card_vs_cpu``).  Returns the launches
    and the numbers printed."""
    from dreammesh4d_tpu_torch import registry
    from dreammesh4d_tpu_torch.models.guidance.stable_diffusion import StableDiffusionPromptProcessor
    from dreammesh4d_tpu_torch.systems import editing
    from dreammesh4d_tpu_torch.utils.gan import DiscriminatorConfig, discriminator_loss, init_discriminator
    from dreammesh4d_tpu_torch.utils.tree import tree_leaves, tree_map

    res = {"guidance": {}}
    for m in (rb, tb, hc):
        m.reset_launch_counts()
    gen = torch.Generator(device=device).manual_seed(22)
    views = [torch.tensor(v[:EDIT_VIEWS], device=device)
             for v in ([5.0, 20.0, 35.0, 70.0], [0.0, 90.0, -100.0, 180.0], [3.8] * 4)]
    rgb0 = smooth_images(torch, EDIT_VIEWS, EDIT_HW, 36).to(device)
    normals = (smooth_images(torch, EDIT_VIEWS, EDIT_HW, 37) * 2 - 1).to(device)

    def build(name, cfg, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = registry.find(name)(cfg, device=device)
        g.modules.init_params(torch.Generator(device=device).manual_seed(seed), zero_init=False)
        prompts = StableDiffusionPromptProcessor({"prompt": EDIT_PROMPT, "context_dim": g.cfg.context_dim},
                                                 device=device)()
        torch.cuda.synchronize()
        return g, prompts, time.perf_counter() - t0

    # (a) the three guidances at full width
    ip2p = None
    for i, (name, cfg) in enumerate(zip(EDIT_GUIDANCES, (EDIT_SD, EDIT_SD, EDIT_FLOYD))):
        g, prompts, build_s = build(name, cfg, i)
        n_params = sum(p.numel() for p in g.modules.parameters())
        hints = [("normal", normals), ("canny", None)] if i == 0 else [("", None)]
        for label, hint in hints:
            torch.cuda.reset_peak_memory_stats()

            def call():
                return guidance_call(torch, g, name, leaf(rgb0, device), hint, views, {"generator": gen}, prompts)

            loss, norm, grad = call()
            ms = time_ms(torch, call, n=3, warmup=0)
            peak = torch.cuda.max_memory_allocated() / 2**30
            check(math.isfinite(loss) and loss > 0 and bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0,
                  f"{name} {label}: no finite loss or gradient")
            key = f"{name}{'/' + label if label else ''}"
            res["guidance"][key] = {"ms": ms, "peak_gib": peak, "loss": loss, "build_s": build_s, "params": n_params}
            c = g.cfg
            print(f"[{card}] {key}: UNet {c.model_channels} x {list(c.channel_mult)}, context {c.context_dim}, "
                  f"{'pixels' if g.modules.vae is None else f'VAE {c.vae_ch}'} at {c.image_size}^2, {n_params} "
                  f"parameters (built in {build_s:.2f} s); {EDIT_VIEWS} renders at {EDIT_HW}^2, forward + backward "
                  f"{ms:.2f} ms (median of 3 after the first); loss {loss:.6g}, grad_norm {norm:.6g}; peak {peak:.2f} GiB")
        if name == "stable-diffusion-instructpix2pix-guidance":
            ip2p = (g, prompts)
        else:
            del g
        torch.cuda.empty_cache()

    # (b) instructnerf2nerf over stage 1's geometry
    g, prompts = ip2p
    volume, renderer = editing_scene(torch, device, 3)
    ro, rd, cond = editing_rays(torch, EDIT_HW, device)
    view = [v[:1] for v in views]
    render = nerf_render_fn(torch, renderer, EDIT_HW, 3)
    perceptual = registry.find("perceptual-loss")({}, device=device)
    step = editing.make_in2n_train_step(lambda p, b, gg: render(p, b["rays_o"], b["rays_d"], gg),
                                        editing.In2NLosses(), perceptual, device=device)
    state = editing.init_in2n_state(volume.state, device=device)
    before = [p.detach().clone() for p in tree_leaves(state.geo_params)]
    batch = {"rays_o": ro, "rays_d": rd}
    hc.reset_launch_counts()
    want = [0, 0]
    ms, edit_s, metrics_hist = [], [], []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    for i in range(IN2N_STEPS):
        edit = i % IN2N_EDIT_EVERY == 0
        if edit:  # the caller's dataset update: the current render, edited toward the instruction
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                current = render(state.geo_params, ro, rd, gen)
            batch["edited_rgb"] = editing.ip2p_edit_images(g, prompts, current, cond, *view[:2], generator=gen)
            torch.cuda.synchronize()
            edit_s.append(time.perf_counter() - t0)
        state, metrics, t = step_ms(torch, step, state, batch, gen)
        ms.append(t)
        metrics_hist.append({k: float(v) for k, v in metrics.items()})
        fwd, bwd = in2n_predicted(ro.shape[0], renderer.cfg.ray_chunk_train, edit)
        want[0] += fwd
        want[1] += bwd
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: v for k, v in hc.launch_counts.items()}
    moved = [float((a.detach() - b).abs().max()) for a, b in zip(tree_leaves(state.geo_params), before)]
    share = sum(edit_s) / loop_s
    res["in2n"] = {"ms": ms, "edit_s": edit_s, "share": share, "peak_gib": peak, "launches": launches,
                   "predicted": want, "metrics": metrics_hist[-1]}
    print(f"[{card}] in2n: {IN2N_STEPS} steps on one {EDIT_HW}^2 view ({ro.shape[0]} rays), ms/step "
          + ", ".join(f"{t:.1f}" for t in ms) + f"; {len(edit_s)} edits (ip2p_edit_images, 20 DDIM steps) "
          + ", ".join(f"{s:.2f}" for s in edit_s) + f" s, {share:.3f} of the loop's {loop_s:.2f} s; peak {peak:.2f} GiB; "
          f"B4/B5 launches {json.dumps(launches)}, predicted {want}; plain {json.dumps(hc.plain_counts)}; "
          + ", ".join(f"{k} {v:.5g}" for k, v in metrics_hist[-1].items())
          + f"; parameters moved {min(moved):.3g}..{max(moved):.3g}")
    check(launches["hashgrid_cell_fwd"] == want[0] and launches["hashgrid_cell_bwd"] == want[1],
          "in2n: B4/B5 launches != predicted")
    check(sum(hc.plain_counts.values()) == 0, "in2n: the plain hash grid ran on the card")
    check(all(math.isfinite(v) for m in metrics_hist for v in m.values()), "in2n: a metric is not finite")
    check(min(moved) > 0, "in2n: a parameter leaf did not move")
    res["launches"] = dict(launches)
    edited = batch["edited_rgb"]
    del ip2p, g, state, step, volume
    torch.cuda.empty_cache()

    # (c) control4d: the GAN renderer over the same grid with 11 feature channels
    volume, renderer = editing_scene(torch, device, 11)
    gan = registry.find("gan-volume-renderer")(EDIT_FULL["gan"], device=device)
    lr_hw = EDIT_HW // gan.scale
    base = nerf_render_fn(torch, renderer, lr_hw, 3 + 2 * gan.cfg.z_channels)
    scene = {"geo": volume.state, "gan": {k: v.detach() for k, v in gan.state_dict().items()}}
    disc = init_discriminator(DiscriminatorConfig(**EDIT_FULL["disc"]), torch.Generator(device=device).manual_seed(3),
                              device=device)
    state = editing.init_control4d_state(scene, disc, device=device)
    c4d_batch = {"rays_o": ro.reshape(1, EDIT_HW, EDIT_HW, 3), "rays_d": rd.reshape(1, EDIT_HW, EDIT_HW, 3),
                 "edited_rgb": edited}
    steps = {lvl: editing.make_control4d_train_step(gan_render_fn(torch, gan, base, lvl), editing.Control4DLosses(),
                                                    perceptual, device=device) for lvl in (0, 1, 2)}
    # the discriminator's gradient in one step against its own term's alone, on the step's own fake images
    d_before = tree_map(lambda p: p.detach().clone(), state.disc_params)
    seen = []
    render1 = gan_render_fn(torch, gan, base, 1)

    def keeping(scene, batch, generator):
        out = render1(scene, batch, generator)
        seen.append(out["comp_gan_rgb"].detach().clone())
        return out

    scene_before = [p.detach().clone() for p in tree_leaves(state.scene_params)]
    # cuDNN's deterministic algorithms for both backwards: its others sum a weight gradient in
    # an order that varies from call to call (~7e-7 of max apart on the same inputs)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    state, _ = editing.make_control4d_train_step(keeping, editing.Control4DLosses(), perceptual, device=device)(
        state, c4d_batch, gen)
    d_params = tree_map(lambda p: p.clone().requires_grad_(True), d_before)
    (editing.Control4DLosses().lambda_D * discriminator_loss(d_params, edited, seen[0])).backward()
    torch.backends.cudnn.deterministic = deterministic
    d_err = max(rel_err(a.grad, b.grad) for a, b in zip(tree_leaves(state.disc_params), tree_leaves(d_params)))
    check(d_err <= 1e-6, f"control4d: the discriminator's gradient is not its D term's alone ({d_err:.3g})")
    hc.reset_launch_counts()
    ms = {}
    torch.cuda.reset_peak_memory_stats()
    hist = []
    for lvl in (0, 1, 2):
        ms[lvl] = []
        for _ in range(C4D_STEPS):
            state, metrics, t = step_ms(torch, steps[lvl], state, c4d_batch, gen)
            ms[lvl].append(t)
            hist.append({k: float(v) for k, v in metrics.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    c4d_launches = dict(hc.launch_counts)
    n_steps = 3 * C4D_STEPS
    c4d_want = [n_steps * x for x in stage1_predicted((lr_hw * lr_hw, 0), False)]
    moved_scene = [float((a.detach() - b).abs().max()) for a, b in zip(tree_leaves(state.scene_params), scene_before)]
    moved_disc = [float((a.detach() - b).abs().max()) for a, b in zip(tree_leaves(state.disc_params),
                                                                       tree_leaves(d_before))]
    res["control4d"] = {"ms": ms, "peak_gib": peak, "launches": c4d_launches, "predicted": c4d_want,
                        "d_err": d_err, "metrics": hist[-1]}
    print(f"[{card}] control4d: GAN renderer ch {gan.cfg.ch} x {list(gan.cfg.ch_mult)}, z {gan.cfg.z_channels} "
          f"({sum(v.numel() for v in scene['gan'].values())} parameters), {EDIT_HW}^2 over a {lr_hw}^2 base; "
          f"PatchGAN ndf {DiscriminatorConfig(**EDIT_FULL['disc']).ndf}; ms/step "
          + "; ".join(f"level {k} " + ", ".join(f"{t:.1f}" for t in v) for k, v in ms.items())
          + f"; peak {peak:.2f} GiB; B4/B5 launches {json.dumps(c4d_launches)}, predicted {c4d_want}; the "
          f"discriminator's gradient vs its D term's alone max |d| / max {d_err:.3g} (limit 1e-6); "
          + ", ".join(f"{k} {v:.5g}" for k, v in hist[-1].items())
          + f"; moved: scene {min(moved_scene):.3g}.., discriminator {min(moved_disc):.3g}..")
    check(c4d_launches["hashgrid_cell_fwd"] == c4d_want[0] and c4d_launches["hashgrid_cell_bwd"] == c4d_want[1],
          "control4d: B4/B5 launches != predicted")
    check(all(math.isfinite(v) for m in hist for v in m.values()), "control4d: a metric is not finite")
    # every scene leaf moved: the local encoder too (level 2)
    check(min(moved_scene) > 0 and min(moved_disc) > 0, "control4d: a parameter leaf did not move")
    for k, v in c4d_launches.items():
        res["launches"][k] = res["launches"].get(k, 0) + v
    del state, steps, gan, volume, disc, perceptual
    torch.cuda.empty_cache()

    # (d) card against CPU in float64
    res["check"] = editing_card_vs_cpu(torch, card, refs, device)
    launched = {**rb.launch_counts, **tb.launch_counts}
    check(not any(launched.values()), f"phase 22 launched a compositing kernel: {launched}")
    print(f"[{card}] phase 22: B4/B5 launches on the editing path {json.dumps(res['launches'])} (in2n "
          f"{json.dumps(res['in2n']['launches'])}, control4d {json.dumps(c4d_launches)})")
    return res


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
    phases = PhaseClock()

    # 1. the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    phases.mark("2")
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

    phases.mark("3")
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

    phases.mark("4")
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

    # the guidance of phases 5 and 6: random:0 at the YAMLs' widths, bfloat16;
    # one set of modules under the dynamic YAML's and stage 1's settings
    from dreammesh4d_tpu_torch.models.guidance.zero123.guidance import StableZero123Guidance, config_from_dict
    from dreammesh4d_tpu_torch.systems.assembly import maybe_build_guidance

    t0 = time.perf_counter()
    dyn_guidance = maybe_build_guidance(yaml_guidance("sugar_dynamic_dg.yaml",
                                                      pretrained_model_name_or_path="random:0"), device=dev)
    torch.cuda.synchronize()
    s1_guidance = StableZero123Guidance(config_from_dict(yaml_guidance("stable-zero123.yaml")["guidance"]),
                                        modules=dyn_guidance.modules)
    print(f"[{card}] guidance random:0 built in {time.perf_counter() - t0:.2f} s: "
          f"{sum(p.numel() for p in dyn_guidance.modules.parameters())} parameters, "
          f"{dyn_guidance.cfg.dtype}; resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    phases.mark("5")
    # 5. the training main path
    make_step, video, sample_batch, (bank_s, bank_peak) = training_setup(
        torch, np, viewer, params, static, dparams, dyn_cfg, raster_cfg, dyn_guidance, dev)
    print(f"target video: {tuple(video[0].shape)} on {video[0].device}, "
          f"mask coverage {float(video[1].mean()):.4f}")
    check(float(video[1].mean()) > 0.05, "the target video is empty")
    train_launches, pair_launches, step_ms, bare_step_ms, one_step = drive_training(
        torch, np, rb, card, make_step, sample_batch, dparams, dev)

    phases.mark("6")
    # 6. the stage-1 training main path, 7. the export pass
    s1_launches, s1, s1_geo, s1_params, s1_step = drive_stage1(torch, np, hc, card, s1_guidance, dev)
    export_launches, export_s = drive_export(torch, np, hc, card, s1_geo, s1_params)

    phases.mark("8")
    # 8. the static refine main path on both backends
    static_res, static_steps = drive_static(torch, np, rb, tb, card,
                                            (static_params, static_sugar, static_target, ref_cams), dev)

    phases.mark("9")
    # 9. the launcher main path: both Gaussian YAMLs through dreammesh4d_tpu_torch.launch.main
    launch_tmp = tempfile.TemporaryDirectory()  # phase 11 exports the trials
    launcher = drive_launcher(torch, np, rb, tb, card, video, dev, launch_tmp.name)
    print(f"[{card}] launcher ms/step: static {launcher['static_ms']:.2f} (direct make_static_train_step "
          f"on pallas_resident, phase 8: {static_res['pallas_resident']['ms']:.2f}); static on pallas "
          f"{launcher['static_pallas_ms']:.2f} (direct, phase 8: {static_res['pallas']['ms']:.2f}); dynamic "
          f"{launcher['dynamic_ms']:.2f} (direct make_dynamic_train_step with guidance_fn=None, phase 5: "
          f"{bare_step_ms:.2f})")
    del video

    phases.mark("10")
    # 10. times (CUDA events, median of 30 after warm-up)
    args = cases[7]["main_view"]
    b1_ms = time_ms(torch, lambda: rb.blend_pairs_cuda(*args))
    b1_more = {"ms_r10": time_ms(torch, lambda: rb.blend_pairs_cuda(*args), reps=10),
               "device_ms": device_ms(torch, lambda: rb.blend_pairs_cuda(*args), "resident_fwd_kernel")}
    plain_ms = time_ms(torch, lambda: rb.blend_pairs_plain(*args))
    render_ms = time_ms(torch, lambda: viewer.render(5.0, 0.0, 3.8, t=0.25))
    play_ms = time_ms(torch, lambda: viewer.play(5.0, 0.0, 3.8, n_frames=VIDEO_LEN))
    bound_ms, bound_by, n_bytes, n_ops = resident_fwd_bound(args, main_stats)
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

    phases.mark("11")
    # 11. the recovery recipe and the exports of phase 9's trials
    recov = drive_recovery_and_export(torch, np, rb, tb, card, launcher, dev)

    phases.mark("12")
    # 12. the README recipe chained: stages 1-6 through the launcher and the simplification tool
    recipe = drive_recipe(torch, np, rb, tb, hc, card, launcher, s1, dev, launch_tmp.name)
    recipe_launches = recipe["total_launches"]

    phases.mark("13")
    # 13. the guidance at full width: card against CPU, a checkpoint, stages 1, 4 and 5 with it on
    del dyn_guidance, s1_guidance, make_step, one_step, s1_step
    torch.cuda.empty_cache()
    guided = drive_guidance(torch, np, rb, tb, hc, card, launcher, recipe,
                            {"bank_s": bank_s, "bank_peak": bank_peak, "s1_bank_s": s1["bank_s"]},
                            dev, launch_tmp.name)

    phases.mark("14")
    # 14. the Gaussian stage through the launcher at capacity 200,000
    torch.cuda.empty_cache()
    gaussian = drive_gaussian_stage(torch, np, rb, card, launcher, dev, launch_tmp.name)

    phases.mark("16")
    # 16. more than one device: the launcher's refusal, two ranks on the card, render_4d;
    # beside it, and 17-19, the CPU's side of phase 20's guidance checks
    refs = CpuReferences(torch, unified_plan(torch))
    refs.start()
    torch.cuda.empty_cache()
    multi = drive_multidevice(torch, np, rb, card, launcher, dev, launch_tmp.name)

    phases.mark("17")
    # 17. the zoo's six NeRF YAMLs through the launcher, SD on the card against the CPU
    torch.cuda.empty_cache()
    zoo = drive_zoo(torch, np, rb, tb, hc, card, launcher, dev, launch_tmp.name)

    phases.mark("18")
    # 18. the zoo's last four YAMLs through the launcher, VSD on the card against the CPU
    torch.cuda.empty_cache()
    zoo_latent = drive_zoo_latent(torch, np, rb, tb, hc, card, recipe["model_obj"], dev, launch_tmp.name)

    phases.mark("19")
    # 19. binning: rank through B1/B2 on the served view and the launcher, the registry's names, a colour map
    torch.cuda.empty_cache()
    rank = drive_rank(torch, np, rb, tb, hc, card, (params, static, dparams, dyn_cfg, raster_cfg), launcher,
                      dev, launch_tmp.name)
    launch_tmp.cleanup()

    phases.mark("20")
    # 20. the unified guidance, the materials and backgrounds, Adan: card against CPU
    torch.cuda.empty_cache()
    components = drive_components(torch, np, rb, tb, hc, card, refs, dev)

    phases.mark("21")
    # 21. the SDF and mesh geometries: fantasia3d, magic3d refine and textmesh at full width, card against CPU
    torch.cuda.empty_cache()
    zoo_mesh = drive_zoo_mesh(torch, np, rb, tb, hc, card, refs, dev)

    phases.mark("22")
    # 22. the guidance zoo and the editing systems: in2n and control4d over stage 1's grid, card against CPU
    torch.cuda.empty_cache()
    editing = drive_editing(torch, np, rb, tb, hc, card, refs, dev)

    phases.mark("end")
    print(f"[{card}] wall seconds per phase: {json.dumps(phases.seconds)}")

    # 15. result lines
    def entry(name, kid, source, replaces, tpu, n_launches, err, ms, plain, b_ms, b_by, **extra):
        # every path's launches: the recipe's (phase 12), the guided launcher's
        # (phase 13), the Gaussian stage's (phase 14), the two ranks' and
        # render_4d's (phase 16), the zoo's (phases 17 and 18, none: their
        # corner grid, shape loss and VSD are plain PyTorch) and rank mode's
        # (phase 19: the launcher's rank run and the factory's served views),
        # phase 20's (none: the unified guidance, the components and Adan),
        # phase 21's (none: the SDF and mesh geometries and their steps) and
        # phase 22's (B4/B5: in2n and control4d over stage 1's grid) included
        n_recipe = recipe_launches.get(name, 0)
        n_guided = guided["launches"].get(name, 0)
        n_gaussian = gaussian["launches"].get(name, 0)
        n_multi = multi["launches"].get(name, 0)
        n_zoo = zoo["launches"].get(name, 0)
        n_latent = zoo_latent["launches"].get(name, 0)
        n_rank = rank["launches"].get(name, 0)
        n_components = components["launches"].get(name, 0)
        n_zoo_mesh = zoo_mesh["launches"].get(name, 0)
        n_editing = editing["launches"].get(name, 0)
        return {"name": name, "id": kid, "route": "cuda", "source": source, "replaces": replaces,
                "tpu": tpu,
                "launches": (n_launches + n_recipe + n_guided + n_gaussian + n_multi + n_zoo + n_latent + n_rank
                             + n_components + n_zoo_mesh + n_editing),
                "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "launches_recipe": n_recipe, "launches_guided": n_guided,
                "launches_gaussian": n_gaussian, "launches_multidevice": n_multi, "launches_zoo": n_zoo,
                "launches_zoo_latent": n_latent, "launches_rank": n_rank, "launches_components": n_components,
                "launches_zoo_mesh": n_zoo_mesh, "launches_editing": n_editing,
                **extra}

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
              device_ms_gaussian_100k=gaussian["b1_device_ms"], plain_ms_gaussian_100k=gaussian["b1_plain_ms"],
              max_abs_err_gaussian_100k=gaussian["b1_err"], device_ms_rank=rank["b1_device_ms"],
              plain_ms_rank=rank["b1_plain_ms"], bound_ms_rank=rank["b1_bound"][0],
              max_abs_err_rank=rank["b1_err"], **b1_more),
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
              device_ms_c7=bwd_more["resident_bwd_accum", 7]["device_ms"],
              device_ms_gaussian_100k=gaussian["b2_device_ms"], plain_ms_gaussian_100k=gaussian["b2_plain_ms"],
              max_abs_err_gaussian_100k=gaussian["bwd_err"]["resident_bwd_accum"][1],
              device_ms_rank=rank["b2_device_ms"], plain_ms_rank=rank["b2_plain_ms"],
              bound_ms_rank=rank["b2_bound"][0], max_abs_err_rank=rank["bwd_err"]["resident_bwd_accum"][1]),
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

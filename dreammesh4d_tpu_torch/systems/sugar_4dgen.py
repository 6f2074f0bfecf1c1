"""sugar-4dgen-system, the dynamic ("motion") stage (counterpart of
``dreammesh4d_tpu/systems/sugar_4dgen.py``): the train step and the timed
evaluation render.

Per step, for the T sampled video frames:

- random-camera substep: render the timed Gaussians from random cameras →
  the guidance term (a pluggable ``guidance_fn``; absent without one) + TV
  regularizers;
- ref substep: render from the fixed reference camera → masked rgb MSE +
  mask MSE against the video frames + PSNR, optional depth / relative depth
  / normal supervision, timed-mesh normal consistency + Laplacian, frame-0
  anchor, object-centric regularizer, key-frame ARAP;
- inter-frame substep: ARAP over densely sampled timestamps (the caller
  samples the window).

The static SuGaR parameters are frozen (detached once); only the deformation
parameters train.  ARAP rotations come from the skinning chain.

PyTorch idiom: the deformation parameters are leaf tensors with
``requires_grad`` held in a :class:`DynTrainState` together with their
``torch.optim.Adam``; one step is ``loss.backward()`` + ``optimizer.step()``
and updates the parameters in place.  Randomness comes from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.geometry.deformation import DeformationConfig, plane_tv_loss
from ..models.geometry.dynamic_sugar import DynamicStatic, timed_all
from ..models.geometry.sugar import SuGaRParams, gaussian_attributes
from ..models.renderers.sugar_rasterizer import CameraBatch, render_batch
from ..ops.gs.rasterize import RasterizerConfig
from ..ops.meshops import (
    arap_energy_quat_planar,
    face_normals,
    laplacian_smoothing_loss,
    normal_consistency_loss,
    tv_loss,
)
from ..parallel.context import ParallelContext
from ..utils.schedule import C_max, C_step
from ..utils.tree import tree_leaves, tree_map, tree_to


@dataclass
class Sugar4DGenLosses:
    lambda_sds_zero123: Any = 0.1
    lambda_rgb: Any = 5000.0
    lambda_mask: Any = field(default_factory=lambda: [200, 500.0, 5000.0, 1000])
    # ref-view geometry supervision against per-frame depth/normal maps
    lambda_depth: Any = 0.0
    lambda_depth_rel: Any = 0.0
    lambda_normal: Any = 0.0
    lambda_normal_consistency: Any = 100.0
    lambda_laplacian_smoothing: Any = 0.0
    lambda_arap_reg_key_frame: Any = 10.0
    lambda_arap_reg_inter_frame: Any = 10.0
    lambda_ref_xyz: Any = 0.0
    lambda_obj_centric: Any = 0.0
    lambda_rgb_tv: Any = 0.0
    lambda_normal_tv: Any = 0.0
    lambda_depth_tv: Any = 0.0
    lambda_plane_tv: Any = 0.0001
    lambda_time_smoothness: Any = 0.01


class DynTrainState(NamedTuple):
    deform_params: Any  # the deformation tree; its leaves require grad
    opt_state: torch.optim.Optimizer  # Adam over those leaves (holds the moments)
    step: int


def init_dyn_state(deform_params, lr: float = 1.6e-3, betas: Tuple[float, float] = (0.9, 0.99),
                   eps: float = 1e-8, step: int = 0, device="cuda") -> DynTrainState:
    """Fresh training state: the deformation tree copied to ``device`` as
    leaf tensors with ``requires_grad``, and Adam over them with zero
    moments.  The defaults are the dynamic stage's: lr 1.6e-3, betas
    (0.9, 0.99) and eps 1e-8 — the stage's ``optimizer.args.eps`` of the YAML
    is never read by the JAX package, which this follows."""
    dev = torch.device(device)
    params = tree_map(lambda x: x.detach().to(dev).clone().requires_grad_(True), deform_params)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=lr, betas=betas, eps=eps)
    return DynTrainState(params, optimizer, int(step))


# guidance_fn(guidance_state, generator, rgb, batch) -> scalar loss; ``rgb``
# is the random-camera render (T, H, W, 3) and ``batch`` carries "step".
GuidanceFn = Callable[[Any, torch.Generator, torch.Tensor, Dict[str, Any]], torch.Tensor]


def _static_zero(w) -> bool:
    return isinstance(w, (int, float)) and float(w) == 0.0


def make_dynamic_train_step(
    sugar_params: SuGaRParams,
    static: DynamicStatic,
    deform_cfg: DeformationConfig,
    raster_cfg: RasterizerConfig,
    losses: Sugar4DGenLosses,
    arap_weights,  # (V, K) cotangent weights on the rest mesh
    guidance_fn: Optional[GuidanceFn] = None,
    bg_color=(1.0, 1.0, 1.0),
    invert_bg_prob: float = 1.0,
    arap_start_step: int = 0,
    ref_raster_cfg: Optional[RasterizerConfig] = None,
    video_frames: Optional[tuple] = None,
    rand_raster_cfg: Optional[RasterizerConfig] = None,
    video_depths: Optional[torch.Tensor] = None,  # (L, H, W, 1)
    video_normals: Optional[torch.Tensor] = None,  # (L, H, W, 3)
    device="cuda",
    par: Optional[ParallelContext] = None,
):
    """Build ``train_step(state, batch, generator, guidance_state=None) ->
    (state, metrics)``.  The optimizer lives in the state
    (:func:`init_dyn_state`); everything given here is placed on ``device``.

    ``batch`` layout:

    - ``timestamps`` (T,), ``frame_indices`` (T,) integer
    - ``ref_cameras`` CameraBatch (T views, the fixed ref camera repeated),
      ``ref_rgb`` (T,H,W,3) video frames, ``ref_mask`` (T,H,W,1)
    - ``rand_cameras`` CameraBatch (T random views, frame-aligned)
    - ``inter_timestamps`` (num_inter,) — a densely sampled window

    ``video_frames=(rgb (L,H,W,3), mask (L,H,W,1))`` keeps the whole video on
    the device: the step gathers the frames by ``frame_indices`` and batches
    may omit ref_rgb/ref_mask.  ``ref_raster_cfg`` / ``rand_raster_cfg``
    give the two substeps their own render sizes.

    ``metrics`` holds ``loss_<term>`` for every term, ``loss_total`` and
    ``psnr`` as detached 0-d tensors on ``device``.

    Under ``par`` (more than one device) the frame leaves of ``batch``
    (timestamps, frame indices, both camera batches) hold this rank's rows
    and ``inter_timestamps`` the whole window.  Per-frame means (rgb, mask,
    the TV terms, the SDS) stay per rank; the terms of the whole frame
    batch (the timed mesh's normal consistency, Laplacian, key-frame ARAP
    and object-centric terms, and the ref depth / normal terms) read the
    gathered timed vertices and ref maps; the anchor, the inter-frame ARAP
    and the grid regularizers are the same on every rank.  The gradients
    and the metrics are averaged over ``data``."""
    dev = torch.device(device)
    par = par or ParallelContext()
    sugar_params = tree_map(lambda x: x.detach().to(dev), sugar_params)
    static = tree_to(static, dev)
    bg_base = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    sg = static.sugar
    G = sg.n_per_face
    attrs0 = gaussian_attributes(sugar_params, sg)
    rest_points = sugar_params.points
    ring = (sg.ring_idx, sg.ring_mask)
    if video_frames is not None:
        video_frames = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in video_frames)
    if video_depths is not None:
        video_depths = torch.as_tensor(video_depths, dtype=torch.float32, device=dev)
    if video_normals is not None:
        video_normals = torch.as_tensor(video_normals, dtype=torch.float32, device=dev)

    ref_cfg = ref_raster_cfg or raster_cfg
    rand_cfg = rand_raster_cfg or raster_cfg

    # the rendered normal map is read only under lambda_normal (ref substep)
    # and lambda_normal_tv (random substep): dropping the 3 normal channels
    # otherwise blends C = 4 instead of 7
    rand_normals = not _static_zero(losses.lambda_normal_tv)
    need_depth = C_max(losses.lambda_depth) > 0
    need_depth_rel = C_max(losses.lambda_depth_rel) > 0
    need_ref_normal = C_max(losses.lambda_normal) > 0

    def _timed_render(deform_params, cameras, timestamps, bg, cfg, with_normals, frame_indices):
        gs, vert = timed_all(sugar_params, deform_params, deform_cfg, static,
                             timestamps, frame_indices=frame_indices)
        gs_normals = None
        if with_normals:
            gs_normals = torch.repeat_interleave(face_normals(vert.xyz, sg.faces), G, dim=-2)
        out = render_batch(
            attrs0.means3d, attrs0.quats, attrs0.scales, attrs0.opacities,
            attrs0.sh, sg.sh_degree, None, cameras, bg, cfg,
            timed_attrs=(gs.means3d, gs.quats, gs.scales, gs_normals),
        )
        return out, vert

    # ARAP with the rest-pose edges precomputed once, in the JAX package's
    # (K, V) argument layout
    arap_idx_t = sg.ring_idx.T  # (K, V)
    arap_w = torch.as_tensor(arap_weights, dtype=torch.float32, device=dev)
    arap_m_t = ((sg.ring_mask & (sg.ring_idx >= 0)).to(torch.float32) * arap_w).T  # (K, V)
    rest_p = rest_points.T  # (3, V)
    e_ref_p = rest_p[:, None, :] - rest_p[:, arap_idx_t]  # (3, K, V)

    def _arap(vert_xyz, vert_rots):
        return arap_energy_quat_planar(e_ref_p, arap_idx_t, arap_m_t, vert_xyz, vert_rots)

    weights = {
        "sds_zero123": losses.lambda_sds_zero123,
        "rgb": losses.lambda_rgb,
        "mask": losses.lambda_mask,
        "depth": losses.lambda_depth,
        "depth_rel": losses.lambda_depth_rel,
        "normal": losses.lambda_normal,
        "normal_consistency": losses.lambda_normal_consistency,
        "laplacian_smoothing": losses.lambda_laplacian_smoothing,
        "arap_reg_key_frame": losses.lambda_arap_reg_key_frame,
        "arap_reg_inter_frame": losses.lambda_arap_reg_inter_frame,
        "ref_xyz": losses.lambda_ref_xyz,
        "obj_centric": losses.lambda_obj_centric,
        "rgb_tv": losses.lambda_rgb_tv,
        "normal_tv": losses.lambda_normal_tv,
        "depth_tv": losses.lambda_depth_tv,
        "plane_tv": losses.lambda_plane_tv,
        "time_smoothness": losses.lambda_time_smoothness,
    }

    def loss_fn(deform_params, batch, generator, step: int, gstate):
        terms: Dict[str, torch.Tensor] = {}
        u = torch.rand((), generator=generator, device=generator.device).to(dev)
        train_bg = torch.where(u > (1.0 - invert_bg_prob), 1.0 - bg_base, bg_base)
        ts = batch["timestamps"]
        # discrete mode indexes its per-frame tables by the true video frame
        fi = batch.get("frame_indices")

        # --- random-camera substep ----------------------------------------
        rand_out, _ = _timed_render(deform_params, batch["rand_cameras"], ts, train_bg,
                                    rand_cfg, rand_normals, fi)
        if guidance_fn is not None:
            terms["sds_zero123"] = guidance_fn(gstate, generator, rand_out["comp_rgb"],
                                               {**batch, "step": step})
        if not _static_zero(losses.lambda_rgb_tv):
            terms["rgb_tv"] = tv_loss(rand_out["comp_rgb"])
        if rand_normals:
            terms["normal_tv"] = tv_loss(rand_out["comp_normal"])
        if not _static_zero(losses.lambda_depth_tv):
            terms["depth_tv"] = tv_loss(rand_out["comp_depth"])

        # --- ref substep (video frames) -----------------------------------
        ref_out, vert = _timed_render(deform_params, batch["ref_cameras"], ts, bg_base,
                                      ref_cfg, need_ref_normal, fi)
        if video_frames is not None:
            gt_mask = video_frames[1][batch["frame_indices"]]
            gt_rgb = video_frames[0][batch["frame_indices"]] * gt_mask
        else:
            gt_mask = batch["ref_mask"]
            gt_rgb = batch["ref_rgb"] * gt_mask
        terms["rgb"] = ((gt_rgb - ref_out["comp_rgb"] * gt_mask) ** 2).mean()
        terms["mask"] = ((gt_mask - ref_out["comp_mask"]) ** 2).mean()
        if need_depth or need_depth_rel or need_ref_normal:  # these read the whole frame batch
            fi_all = par.gather(batch["frame_indices"])
            gt_mask = par.gather(gt_mask)

        # ref-view geometry supervision: lstsq-aligned depth MSE, Pearson
        # relative depth, masked normal cosine
        if need_depth or need_depth_rel:
            from .zero123_system import masked_lstsq_depth_loss, masked_pearson

            gt_depth = (video_depths[fi_all] if video_depths is not None
                        else par.gather(batch["ref_depth"]))
            mflat = (gt_mask[..., 0] > 0.5).to(torch.float32)
            pred_depth = par.gather(ref_out["comp_depth"])
            if need_depth:
                terms["depth"] = masked_lstsq_depth_loss(pred_depth[..., 0], gt_depth[..., 0], mflat)
            if need_depth_rel:
                terms["depth_rel"] = 1.0 - masked_pearson(pred_depth[..., 0], gt_depth[..., 0], mflat)
        if need_ref_normal:
            gt_normal = (video_normals[fi_all] if video_normals is not None
                         else par.gather(batch["ref_normal"]))
            gt_n = 1.0 - 2.0 * gt_normal
            pred_n = 2.0 * par.gather(ref_out["comp_normal"]) - 1.0
            cos = (pred_n * gt_n).sum(-1) / (
                torch.linalg.norm(pred_n, dim=-1) * torch.linalg.norm(gt_n, dim=-1) + 1e-8)
            m1 = (gt_mask[..., 0] > 0.5).to(torch.float32)
            terms["normal"] = 1.0 - (cos * m1).sum() / torch.clamp(m1.sum(), min=1.0)

        vert_xyz, vert_rots = par.gather(vert.xyz), par.gather(vert.rots)
        terms["normal_consistency"] = normal_consistency_loss(vert_xyz, sg.faces, sg.edge_face_pairs)
        terms["laplacian_smoothing"] = laplacian_smoothing_loss(vert_xyz, ring)

        arap_on = 1.0 if step >= arap_start_step else 0.0
        terms["arap_reg_key_frame"] = arap_on * _arap(vert_xyz, vert_rots)

        # frame-0 anchor
        _, vert_t0 = timed_all(sugar_params, deform_params, deform_cfg, static,
                               torch.zeros((1,), dtype=torch.float32, device=dev))
        terms["ref_xyz"] = (vert_t0.xyz[0] - rest_points).abs().mean()

        # object-centric regularizer
        terms["obj_centric"] = vert_xyz[..., 0].mean().abs() + vert_xyz[..., 1].mean().abs()

        # --- inter-frame ARAP substep -------------------------------------
        _, vert_inter = timed_all(sugar_params, deform_params, deform_cfg, static,
                                  batch["inter_timestamps"])
        terms["arap_reg_inter_frame"] = arap_on * _arap(vert_inter.xyz, vert_inter.rots)

        # HexPlane grid regularizers; discrete mode has per-frame tables
        # instead of plane grids and no TV terms
        if static.dynamic_mode == "deformation":
            terms["plane_tv"] = plane_tv_loss(deform_params)
            terms["time_smoothness"] = plane_tv_loss(deform_params, only_time_planes=True)

        total = torch.zeros((), dtype=torch.float32, device=dev)
        for name, value in terms.items():
            total = total + C_step(weights[name], step) * value
        metrics = {f"loss_{k}": v.detach() for k, v in terms.items()}
        metrics["loss_total"] = total.detach()
        metrics["psnr"] = -10.0 * torch.log10(terms["rgb"].detach() + 1e-8)
        return total, metrics

    def train_step(state: DynTrainState, batch, generator: torch.Generator, guidance_state=None):
        """One optimisation step; updates ``state.deform_params`` and the
        optimizer's moments in place and returns the advanced state."""
        batch = tree_to(batch, dev)
        state.opt_state.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.deform_params, batch, generator, state.step, guidance_state)
        loss.backward()
        par.average_gradients(tree_leaves(state.deform_params))
        state.opt_state.step()
        return (DynTrainState(state.deform_params, state.opt_state, state.step + 1),
                par.reduce_metrics(metrics))

    return train_step


def make_dynamic_render_eval(sugar_params: SuGaRParams, static: DynamicStatic,
                             deform_cfg: DeformationConfig, raster_cfg: RasterizerConfig,
                             bg_color=(1.0, 1.0, 1.0)):
    """Timed evaluation render: ``render_eval(deform_params, cameras,
    timestamps, frame_indices=None)`` renders view b at ``timestamps[b]``
    (rgb + face normals + depth in one blend per view)."""
    sg = static.sugar
    G = sg.n_per_face
    attrs0 = gaussian_attributes(sugar_params, sg)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=sugar_params.points.device)

    def render_eval(deform_params, cameras: CameraBatch, timestamps, frame_indices=None):
        gs, vert = timed_all(sugar_params, deform_params, deform_cfg, static,
                             timestamps, frame_indices=frame_indices)
        gs_normals = torch.repeat_interleave(face_normals(vert.xyz, sg.faces), G, dim=-2)
        return render_batch(
            attrs0.means3d, attrs0.quats, attrs0.scales, attrs0.opacities,
            attrs0.sh, sg.sh_degree, None, cameras, bg, raster_cfg,
            timed_attrs=(gs.means3d, gs.quats, gs.scales, gs_normals),
        )

    return render_eval

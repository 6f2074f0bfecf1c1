"""sugar-static-system, the static SuGaR refine stage (stage 4; counterpart of
``dreammesh4d_tpu/systems/sugar_static.py``): mesh-bound Gaussians refined
together with the mesh vertices.

Per step:

- ref substep: render the reference views on the base background → masked
  rgb MSE and mask MSE, and behind their weights the lstsq-aligned depth
  MSE, 1 − Pearson relative depth and the masked normal cosine;
- rand substep: render the random views on the (possibly inverted)
  background → the guidance term (a pluggable ``guidance_fn``; absent
  without one), rgb / normal / depth TV, and behind its weight the
  agreement of the rendered normal map with the normal derived from the
  rendered depth (:func:`depth_to_normal`);
- mesh regularizers: normal consistency, uniform Laplacian, opacity-max;
- loss weights are ``C`` schedules of the step.

PyTorch idiom, as in the other stages: the ``SuGaRParams`` leaves require
grad and live in a :class:`StaticTrainState` with their Adam
(``systems/optim.sugar_optimizer``: one group per field, lr schedules set
every step); one step is ``loss.backward()`` + ``optimizer.step()`` and
updates the parameters in place.  Randomness comes from an explicit
``torch.Generator`` through :func:`draw_uniform`, which a test can replace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..models.geometry.sugar import SuGaRParams, SuGaRStatic, gaussian_attributes
from ..models.renderers.sugar_rasterizer import CameraBatch, depth_to_normal, render_batch
from ..ops.gs.rasterize import RasterizerConfig
from ..ops.meshops import face_normals, laplacian_smoothing_loss, normal_consistency_loss, tv_loss
from ..parallel.context import ParallelContext
from ..utils.schedule import C_max, C_step
from ..utils.tree import tree_map, tree_to
from .optim import set_learning_rates, sugar_optimizer
from .zero123_system import masked_lstsq_depth_loss, masked_pearson


@dataclass
class SugarStaticLosses:
    lambda_sds: Any = 0.01
    lambda_rgb: Any = 1000.0
    lambda_mask: Any = 100.0
    lambda_normal_consistency: Any = 10.0
    lambda_laplacian_smoothing: Any = 1.0
    lambda_opacity_max: Any = 0.0
    lambda_rgb_tv: Any = 1.0
    lambda_normal_tv: Any = 1.0
    lambda_depth_tv: Any = 1.0
    # ref-view geometry supervision and the normal/depth agreement term
    lambda_depth: Any = 0.0
    lambda_depth_rel: Any = 0.0
    lambda_normal: Any = 0.0
    lambda_normal_depth_consistency: Any = 0.0


class StaticTrainState(NamedTuple):
    params: SuGaRParams  # leaves require grad
    opt_state: torch.optim.Adam  # one group per field (holds the moments)
    step: int


def init_static_state(params: SuGaRParams, optimizer: Optional[Dict[str, Any]] = None,
                      step: int = 0, device="cuda") -> StaticTrainState:
    """Fresh training state: the parameters copied to ``device`` as leaf
    tensors with ``requires_grad``, and :func:`~.optim.sugar_optimizer`
    over them with zero moments.  ``optimizer`` holds its keyword arguments
    (the geometry's ``position_lr`` … ``spatial_lr_scale``, ``eps``)."""
    dev = torch.device(device)
    params = tree_map(lambda x: x.detach().to(dev).clone().requires_grad_(True), params)
    return StaticTrainState(params, sugar_optimizer(params, **(optimizer or {})), int(step))


def draw_uniform(generator: torch.Generator, device) -> torch.Tensor:
    """One uniform [0, 1) number from ``generator``, on ``device``."""
    return torch.rand((), generator=generator, device=generator.device).to(device)


# guidance_fn(guidance_state, generator, rgb, batch) -> scalar loss; ``rgb``
# is the random-view render (B, H, W, 3) and ``batch`` carries "step".
GuidanceFn = Callable[[Any, torch.Generator, torch.Tensor, Dict[str, Any]], torch.Tensor]


def _gaussians(params: SuGaRParams, static: SuGaRStatic):
    """Renderable attributes and the per-Gaussian face normals."""
    attrs = gaussian_attributes(params, static)
    normals = torch.repeat_interleave(face_normals(params.points, static.faces),
                                      static.n_per_face, dim=0)
    return attrs, normals


def make_static_train_step(
    static: SuGaRStatic,
    raster_cfg: RasterizerConfig,
    losses: SugarStaticLosses,
    guidance_fn: Optional[GuidanceFn] = None,
    bg_color=(1.0, 1.0, 1.0),
    invert_bg_prob: float = 1.0,
    ref_raster_cfg: Optional[RasterizerConfig] = None,
    device="cuda",
    par: Optional[ParallelContext] = None,
):
    """Build ``train_step(state, batch, generator, guidance_state=None) ->
    (state, metrics)``.  The optimizer lives in the state
    (:func:`init_static_state`); ``static`` is placed on ``device``.

    Under ``par`` (more than one device) ``batch`` holds this rank's random
    views and the whole reference view: every term is then either the
    reference view's or the parameters' (the same on every rank) or a mean
    over the random views (a mean of equal per-rank means), so the step
    averages the gradients and the metrics over ``data``.

    ``batch`` layout:

    - ``ref_cameras`` CameraBatch (B_ref views), ``ref_rgb`` (B,H,W,3),
      ``ref_mask`` (B,H,W,1), and with their weights ``ref_depth``
      (B,H,W,1) / ``ref_normal`` (B,H,W,3)
    - ``rand_cameras`` CameraBatch (B_rand views), with the normal–depth
      term ``rand_rays_o`` / ``rand_rays_d`` (B,H,W,3), plus what the
      guidance reads (elevation / azimuth / camera_distances)

    ``metrics`` holds ``loss_<term>`` for every term, ``loss_total`` and
    ``psnr`` as detached 0-d tensors on ``device``."""
    dev = torch.device(device)
    par = par or ParallelContext()
    static = tree_to(static, dev)
    bg_base = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    ref_cfg = ref_raster_cfg or raster_cfg

    need_depth = C_max(losses.lambda_depth) > 0
    need_depth_rel = C_max(losses.lambda_depth_rel) > 0
    need_normal = C_max(losses.lambda_normal) > 0
    need_nd_consistency = C_max(losses.lambda_normal_depth_consistency) > 0
    weights = {
        "rgb": losses.lambda_rgb,
        "mask": losses.lambda_mask,
        "sds": losses.lambda_sds,
        "normal_consistency": losses.lambda_normal_consistency,
        "laplacian_smoothing": losses.lambda_laplacian_smoothing,
        "opacity_max": losses.lambda_opacity_max,
        "rgb_tv": losses.lambda_rgb_tv,
        "normal_tv": losses.lambda_normal_tv,
        "depth_tv": losses.lambda_depth_tv,
        "depth": losses.lambda_depth,
        "depth_rel": losses.lambda_depth_rel,
        "normal": losses.lambda_normal,
        "normal_depth_consistency": losses.lambda_normal_depth_consistency,
    }

    def loss_fn(params: SuGaRParams, batch, generator, step: int, gstate):
        attrs, gs_normals = _gaussians(params, static)
        invert = draw_uniform(generator, dev) > (1.0 - invert_bg_prob)
        train_bg = torch.where(invert, 1.0 - bg_base, bg_base)
        terms: Dict[str, torch.Tensor] = {}

        # --- ref substep (white-composited ground truth) ------------------
        ref_out = render_batch(attrs.means3d, attrs.quats, attrs.scales, attrs.opacities,
                               attrs.sh, static.sh_degree, gs_normals, batch["ref_cameras"],
                               bg_base, ref_cfg)
        gt_mask = batch["ref_mask"]
        gt_rgb = batch["ref_rgb"] * gt_mask
        terms["rgb"] = ((gt_rgb - ref_out["comp_rgb"] * gt_mask) ** 2).mean()
        terms["mask"] = ((gt_mask - ref_out["comp_mask"]) ** 2).mean()

        m1 = (gt_mask[..., 0] > 0.5).to(torch.float32)
        if (need_depth or need_depth_rel) and "ref_depth" in batch:
            pred_d, gt_d = ref_out["comp_depth"][..., 0], batch["ref_depth"][..., 0]
            if need_depth:
                terms["depth"] = masked_lstsq_depth_loss(pred_d, gt_d, m1)
            if need_depth_rel:
                terms["depth_rel"] = 1.0 - masked_pearson(pred_d, gt_d, m1)
        if need_normal and "ref_normal" in batch:
            gt_n = 1.0 - 2.0 * batch["ref_normal"]  # the reference flips its normal maps
            pred_n = 2.0 * ref_out["comp_normal"] - 1.0
            cos = (pred_n * gt_n).sum(-1) / (
                torch.linalg.norm(pred_n, dim=-1) * torch.linalg.norm(gt_n, dim=-1) + 1e-8)
            terms["normal"] = 1.0 - (cos * m1).sum() / torch.clamp(m1.sum(), min=1.0)

        # --- rand substep -------------------------------------------------
        rand_out = render_batch(attrs.means3d, attrs.quats, attrs.scales, attrs.opacities,
                                attrs.sh, static.sh_degree, gs_normals, batch["rand_cameras"],
                                train_bg, raster_cfg)
        if guidance_fn is not None:
            terms["sds"] = guidance_fn(gstate, generator, rand_out["comp_rgb"],
                                       {**batch, "step": step})

        terms["normal_consistency"] = normal_consistency_loss(
            params.points, static.faces, static.edge_face_pairs)
        terms["laplacian_smoothing"] = laplacian_smoothing_loss(
            params.points, (static.ring_idx, static.ring_mask))
        terms["opacity_max"] = (attrs.opacities - 1.0).abs().mean()
        if need_nd_consistency:
            nd_map = depth_to_normal(rand_out["comp_depth"], batch["rand_rays_o"],
                                     batch["rand_rays_d"], rand_out["comp_mask"])
            raw_n = 2.0 * rand_out["comp_normal"] - 1.0
            raw_nd = 2.0 * nd_map - 1.0
            terms["normal_depth_consistency"] = (1.0 - (raw_n * raw_nd).sum(-1)).mean()
        terms["rgb_tv"] = tv_loss(rand_out["comp_rgb"])
        terms["normal_tv"] = tv_loss(rand_out["comp_normal"])
        terms["depth_tv"] = tv_loss(rand_out["comp_depth"])

        total = torch.zeros((), dtype=torch.float32, device=dev)
        for name, value in terms.items():
            total = total + C_step(weights[name], step) * value
        metrics = {f"loss_{k}": v.detach() for k, v in terms.items()}
        metrics["loss_total"] = total.detach()
        metrics["psnr"] = -10.0 * torch.log10(terms["rgb"].detach() + 1e-8)
        return total, metrics

    def train_step(state: StaticTrainState, batch, generator: torch.Generator,
                   guidance_state=None):
        """One optimisation step; updates ``state.params`` and the
        optimizer's moments in place and returns the advanced state."""
        batch = tree_to(batch, dev)
        state.opt_state.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.params, batch, generator, state.step, guidance_state)
        loss.backward()
        par.average_gradients(state.params)
        set_learning_rates(state.opt_state)
        state.opt_state.step()
        return StaticTrainState(state.params, state.opt_state, state.step + 1), par.reduce_metrics(metrics)

    return train_step


def make_render_eval(static: SuGaRStatic, raster_cfg: RasterizerConfig,
                     bg_color=(1.0, 1.0, 1.0), device="cuda"):
    """Evaluation render (validation orbits): ``render_eval(params, cameras)``
    renders every view with rgb, face normals and depth in one blend."""
    dev = torch.device(device)
    static = tree_to(static, dev)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)

    def render_eval(params: SuGaRParams, cameras: CameraBatch):
        attrs, gs_normals = _gaussians(tree_to(params, dev), static)
        return render_batch(attrs.means3d, attrs.quats, attrs.scales, attrs.opacities, attrs.sh,
                            static.sh_degree, gs_normals, tree_to(cameras, dev), bg, raster_cfg)

    return render_eval

"""zero123-system: the static NeRF generation stage as one train step
(counterpart of ``dreammesh4d_tpu/systems/zero123_system.py``).

- ref substep: rgb·mask MSE and mask MSE on the reference view, and behind
  their weights the lstsq-aligned depth MSE, 1 − Pearson relative depth and
  the masked normal cosine;
- rand substep: the guidance loss on random cameras (a pluggable
  ``guidance_fn``), 2D normal smoothness, 3D normal smoothness against
  normals at perturbed positions, the orientation loss
  Σ w·max(n·d, 0)² / #opaque with detached weights, sparsity
  sqrt(o² + 0.01) and the opacity BCE(o, o) on the clipped opacity;
- loss weights are ``C`` schedules of the step.

Rays are made by the data modules; the step takes flat (R, 3) ray bundles
for the reference view and (B, H, W, 3) bundles for the random views.  As
in the dynamic stage the step has no ``optimizer`` argument: Adam lives in
the state (:func:`init_nerf_state`) and the parameters are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.geometry.implicit_volume import ImplicitVolumeConfig
from ..models.renderers.nerf_volume_renderer import NeRFRendererConfig, OccGridState, render_rays
from ..ops.cameras import binary_cross_entropy
from ..parallel.context import ParallelContext
from ..utils.schedule import C_max, C_step
from ..utils.tree import tree_leaves, tree_map, tree_to


@dataclass
class Zero123Losses:
    lambda_sds: Any = 0.1
    lambda_rgb: Any = field(default_factory=lambda: [100, 500.0, 1000.0, 400])
    lambda_mask: Any = 50.0
    lambda_depth: Any = 0.0  # lstsq-aligned ref depth MSE
    lambda_depth_rel: Any = 0.0  # 1 - Pearson
    lambda_normal: Any = 0.0  # ref normal cosine
    lambda_normal_smooth: Any = field(default_factory=lambda: [100, 7.0, 5.0, 150, 10.0, 200])
    lambda_3d_normal_smooth: Any = field(default_factory=lambda: [100, 7.0, 5.0, 150, 10.0, 200])
    lambda_orient: Any = 1.0
    lambda_sparsity: Any = 0.5
    lambda_opaque: Any = 0.5


def masked_lstsq_depth_loss(pred: torch.Tensor, gt: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Least-squares-align gt depth to pred inside the mask (scale and shift
    from the 2x2 weighted normal equations, as constants), then the masked
    MSE."""
    m = mask.reshape(-1)
    p = pred.reshape(-1)
    g = gt.reshape(-1)
    n = torch.clamp(m.sum(), min=1.0)
    sgg = (m * g * g).sum()
    sg = (m * g).sum()
    sgp = (m * g * p).sum()
    sp = (m * p).sum()
    det = sgg * n - sg * sg
    det = torch.where(det.abs() < 1e-8, torch.ones_like(det), det)
    a = (sgp * n - sg * sp) / det
    b = (sgg * sp - sg * sgp) / det
    aligned = a.detach() * g + b.detach()
    return (m * (aligned - p) ** 2).sum() / n


def masked_pearson(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pearson correlation over the masked pixels."""
    m = mask.reshape(-1)
    p = pred.reshape(-1)
    g = gt.reshape(-1)
    n = torch.clamp(m.sum(), min=1.0)
    mp = (m * p).sum() / n
    mg = (m * g).sum() / n
    cov = (m * (p - mp) * (g - mg)).sum()
    vp = (m * (p - mp) ** 2).sum()
    vg = (m * (g - mg) ** 2).sum()
    return cov / torch.sqrt(torch.clamp(vp * vg, min=1e-8))


class NeRFTrainState(NamedTuple):
    geo_params: Any  # the implicit-volume tree; its leaves require grad
    opt_state: torch.optim.Optimizer  # Adam over those leaves (holds the moments)
    step: int


def init_nerf_state(geo_params, lr: float = 0.01, betas: Tuple[float, float] = (0.9, 0.99),
                    eps: float = 1e-8, step: int = 0, device="cuda") -> NeRFTrainState:
    """Fresh training state: the geometry tree copied to ``device`` as leaf
    tensors with ``requires_grad``, and Adam over them with zero moments.
    The defaults are the stage's ``optimizer.args`` (this stage reads all of
    them, ``eps`` included)."""
    dev = torch.device(device)
    params = tree_map(lambda x: x.detach().to(dev).clone().requires_grad_(True), geo_params)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=lr, betas=betas, eps=eps)
    return NeRFTrainState(params, optimizer, int(step))


# guidance_fn(guidance_state, generator, rgb, batch) -> scalar loss; ``rgb``
# is the random-view render (B, H, W, 3) and ``batch`` carries "step".
GuidanceFn = Callable[[Any, torch.Generator, torch.Tensor, Dict[str, Any]], torch.Tensor]


def make_zero123_train_step(
    geo_cfg: ImplicitVolumeConfig,
    rcfg: NeRFRendererConfig,
    losses: Zero123Losses,
    material=None,
    guidance_fn: Optional[GuidanceFn] = None,
    bg_color=(1.0, 1.0, 1.0),
    device="cuda",
    par: Optional[ParallelContext] = None,
):
    """Build ``train_step(state, batch, generator, level_mask, ambient_ratio,
    guidance_state=None, occ_state=None) -> (state, metrics)``.

    ``batch`` layout:

    - ``ref_rays_o`` / ``ref_rays_d`` (R, 3) flat reference-view rays,
      ``ref_rgb`` (R, 3), ``ref_mask`` (R, 1), ``ref_light`` (3,), and with
      their weights on ``ref_depth`` (R, 1) / ``ref_normal`` (R, 3)
    - ``rand_rays_o`` / ``rand_rays_d`` (B, H, W, 3), ``light_positions``
      (B, 3), plus what the guidance reads (elevation / azimuth /
      camera_distances)

    ``metrics`` holds ``loss_<term>`` for every term, ``loss_total`` and
    ``psnr`` as detached 0-d tensors on ``device``.

    Under ``par`` (more than one device) the random-view leaves hold this
    rank's rows and the reference view is whole: the random rays take the
    draws of the whole batch's rays (``render_rays(rows=)``), the
    orientation loss divides the sum over all ranks by the opaque count of
    all ranks, the other terms are the reference view's or means of equal
    per-rank means; the gradients and the metrics are averaged over
    ``data``."""
    dev = torch.device(device)
    par = par or ParallelContext()
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    need_depth = C_max(losses.lambda_depth) > 0
    need_depth_rel = C_max(losses.lambda_depth_rel) > 0
    need_normal = C_max(losses.lambda_normal) > 0
    need_3d_smooth = C_max(losses.lambda_3d_normal_smooth) > 0
    weights_map = {
        "sds": losses.lambda_sds, "rgb": losses.lambda_rgb, "mask": losses.lambda_mask,
        "normal_smooth": losses.lambda_normal_smooth, "depth": losses.lambda_depth,
        "depth_rel": losses.lambda_depth_rel, "normal": losses.lambda_normal,
        "3d_normal_smooth": losses.lambda_3d_normal_smooth, "orient": losses.lambda_orient,
        "sparsity": losses.lambda_sparsity, "opaque": losses.lambda_opaque,
    }

    def loss_fn(geo_params, batch, generator, step: int, level_mask, ambient_ratio, gstate,
                occ_state):
        terms: Dict[str, torch.Tensor] = {}

        # --- ref substep ---------------------------------------------------
        ref_out = render_rays(
            geo_params, geo_cfg, rcfg, batch["ref_rays_o"], batch["ref_rays_d"],
            batch["ref_light"].expand(batch["ref_rays_o"].shape), bg, generator,
            ambient_ratio=ambient_ratio, level_mask=level_mask, material=material,
            occ_state=occ_state)
        gt_mask = batch["ref_mask"]
        gt_rgb = batch["ref_rgb"] * gt_mask
        terms["rgb"] = ((gt_rgb - ref_out["comp_rgb"] * gt_mask) ** 2).mean()
        terms["mask"] = ((gt_mask - ref_out["opacity"]) ** 2).mean()
        if need_depth:
            terms["depth"] = masked_lstsq_depth_loss(ref_out["depth"], batch["ref_depth"], gt_mask)
        if need_depth_rel:
            terms["depth_rel"] = 1.0 - masked_pearson(ref_out["depth"], batch["ref_depth"], gt_mask)
        if need_normal:
            gt_n = 1.0 - 2.0 * batch["ref_normal"].reshape(-1, 3)
            pred_n = 2.0 * ref_out["comp_normal"].reshape(-1, 3) - 1.0
            cos = (gt_n * pred_n).sum(-1) / (
                torch.linalg.norm(gt_n, dim=-1) * torch.linalg.norm(pred_n, dim=-1) + 1e-8)
            m = gt_mask.reshape(-1)
            terms["normal"] = 1.0 - (m * cos).sum() / torch.clamp(m.sum(), min=1.0)

        # --- rand substep --------------------------------------------------
        B, H, W = batch["rand_rays_o"].shape[:3]
        lo, total = par.rows(B)
        rand_out = render_rays(
            geo_params, geo_cfg, rcfg, batch["rand_rays_o"].reshape(-1, 3),
            batch["rand_rays_d"].reshape(-1, 3),
            torch.repeat_interleave(batch["light_positions"], H * W, dim=0), bg, generator,
            ambient_ratio=ambient_ratio, level_mask=level_mask, material=material,
            return_normal_perturb=need_3d_smooth, occ_state=occ_state,
            rows=(lo * H * W, total * H * W) if par.active else None)
        if guidance_fn is not None:
            terms["sds"] = guidance_fn(gstate, generator, rand_out["comp_rgb"].reshape(B, H, W, 3),
                                       {**batch, "step": step})

        normal_img = rand_out["comp_normal"].reshape(B, H, W, 3)
        terms["normal_smooth"] = (((normal_img[:, 1:] - normal_img[:, :-1]) ** 2).mean()
                                  + ((normal_img[:, :, 1:] - normal_img[:, :, :-1]) ** 2).mean())
        if need_3d_smooth:
            terms["3d_normal_smooth"] = (rand_out["normal"] - rand_out["normal_perturb"]).abs().mean()

        w_det = rand_out["weights"].detach()
        ndotd = (rand_out["normal"] * rand_out["t_dirs"]).sum(-1)
        n_opaque = torch.clamp(par.all_sum((rand_out["opacity"] > 0).sum()), min=1)
        terms["orient"] = par.all_sum((w_det * torch.clamp(ndotd, min=0.0) ** 2).sum()) / n_opaque
        terms["sparsity"] = torch.sqrt(rand_out["opacity"] ** 2 + 0.01).mean()
        oc = torch.clamp(rand_out["opacity"], 1e-3, 1 - 1e-3)
        terms["opaque"] = binary_cross_entropy(oc, oc)

        total = torch.zeros((), dtype=torch.float32, device=dev)
        for name, value in terms.items():
            total = total + C_step(weights_map[name], step) * value
        metrics = {f"loss_{k}": v.detach() for k, v in terms.items()}
        metrics["loss_total"] = total.detach()
        metrics["psnr"] = -10.0 * torch.log10(terms["rgb"].detach() + 1e-8)
        return total, metrics

    def train_step(state: NeRFTrainState, batch, generator: torch.Generator, level_mask,
                   ambient_ratio, guidance_state=None, occ_state: Optional[OccGridState] = None):
        """One optimisation step; updates ``state.geo_params`` and the
        optimizer's moments in place and returns the advanced state."""
        batch = tree_to(batch, dev)
        if level_mask is not None:
            level_mask = torch.as_tensor(level_mask, dtype=torch.float32, device=dev)
        state.opt_state.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.geo_params, batch, generator, state.step, level_mask,
                                ambient_ratio, guidance_state, occ_state)
        loss.backward()
        par.average_gradients(tree_leaves(state.geo_params))
        state.opt_state.step()
        return (NeRFTrainState(state.geo_params, state.opt_state, state.step + 1),
                par.reduce_metrics(metrics))

    return train_step

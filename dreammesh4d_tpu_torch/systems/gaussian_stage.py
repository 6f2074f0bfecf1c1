"""The Gaussian stage of sugar-static-system (``system.stage: gaussian``;
counterpart of ``dreammesh4d_tpu/systems/gaussian_stage.py``): vanilla 3DGS
with adaptive density control and the SuGaR regulariser.

Per step:

- the reference views on the base background → masked rgb MSE and mask
  MSE; the random views on the (possibly inverted) background → the
  guidance term (a pluggable ``guidance_fn``; absent without one) and rgb TV;
- the opacity entropy of the visible Gaussians and the SuGaR density and
  SDF-normal terms (``ops/sugar_reg.py``), each multiplied by
  ``step >= sugar_reg_start`` and computed before that too;
- the screen-space gradient of every Gaussian: ONE zero ``(C, 2)`` offset
  leaf is added to the projected centres of all views, so its gradient is
  the sum over the views, and :func:`~..models.geometry.gaussian.update_stats`
  takes its norm; the radii are the max over the views, the visibility any;
- every loss weight is a ``C`` schedule of the step.

Under more than one device each rank renders the whole reference view and
its own random views; the visibility and the radii are combined over
``data`` (any, max) before the loss reads them, and the offset leaf's
gradient is averaged with the parameters' gradients, so that the
statistics are the single-device ones on every rank and the density
control runs alike everywhere.

``density_control_step`` (called by the experiment every densify interval)
runs ``densify_and_prune`` and writes its result into the parameter leaves
and the Adam moments in place.

PyTorch idiom, as in the other stages: the ``GaussianParams`` leaves
require grad and live in a :class:`GaussianTrainState` with their Adam
(:func:`gaussian_optimizer`, one group per field); one step is
``loss.backward()`` + ``optimizer.step()``.  Randomness comes from an
explicit ``torch.Generator`` through :func:`draw_uniform` (the background
inversion) and :func:`draw_samples` (the regulariser's samples), which a
test can replace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..models.geometry.gaussian import (DensifyStats, GaussianConfig, GaussianState,
                                        densify_and_prune, empty_stats, renderable, reset_opacity,
                                        update_stats)
from ..ops.cameras import GSCameraInfo
from ..ops.gs.rasterize import RasterizerConfig, rasterize
from ..ops.meshops import tv_loss
from ..ops.sugar_reg import SugarRegState, draw_samples, refresh_knn, sugar_density_regularization
from ..parallel.context import ParallelContext
from ..utils.schedule import C_step
from ..utils.tree import tree_to
from .optim import set_learning_rates
from .sugar_static import draw_uniform


class GaussianParams(NamedTuple):
    """The differentiable fields of ``GaussianState`` (``alive`` is carried aside)."""

    xyz: torch.Tensor
    sh_dc: torch.Tensor
    sh_rest: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logits: torch.Tensor


def split_state(state: GaussianState):
    return GaussianParams(*(getattr(state, f) for f in GaussianParams._fields)), state.alive


def merge_state(params: GaussianParams, alive: torch.Tensor) -> GaussianState:
    return GaussianState(*params, alive=alive)


@dataclass
class GaussianStageLosses:
    lambda_sds: Any = 0.1
    lambda_rgb: Any = 1000.0
    lambda_mask: Any = 100.0
    lambda_opacity_binary: Any = 1.0
    lambda_sugar_density_reg: Any = 1.0
    lambda_sugar_sdf_normal_reg: Any = 1.0
    lambda_rgb_tv: Any = 1.0


def gaussian_optimizer(params: GaussianParams, position_lr: Any = 0.00016, feature_lr: Any = 0.0025,
                       opacity_lr: Any = 0.05, scaling_lr: Any = 0.005, rotation_lr: Any = 0.001,
                       spatial_lr_scale: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-15) -> torch.optim.Adam:
    """Adam over the six ``GaussianParams`` leaves, one group each: xyz at
    ``position_lr`` × ``spatial_lr_scale``, ``sh_rest`` at ``feature_lr`` /
    20.  Each lr is ``C(value, count, "exp")`` at the update's own count
    (1 for the first update), as the JAX package reads it after
    incrementing its count; :func:`~.optim.set_learning_rates` sets it."""
    lrs = {"xyz": (position_lr, spatial_lr_scale), "sh_dc": (feature_lr, 1.0),
           "sh_rest": (feature_lr, 1.0 / 20.0), "log_scales": (scaling_lr, 1.0),
           "quats": (rotation_lr, 1.0), "opacity_logits": (opacity_lr, 1.0)}
    groups = []
    for name in GaussianParams._fields:
        value, scale = lrs[name]

        def sched(done: int, value=value, scale=scale) -> float:
            return C_step(value, done + 1, interpolation="exp") * scale

        groups.append({"params": [getattr(params, name)], "lr": sched(0), "betas": (b1, b2),
                       "eps": eps, "schedule": sched, "name": name})
    return torch.optim.Adam(groups)


class GaussianTrainState(NamedTuple):
    gaussians: GaussianState  # float fields are leaves that require grad
    opt_state: torch.optim.Adam
    stats: DensifyStats
    step: int


def init_gaussian_train_state(gaussians: GaussianState, optimizer: Optional[Dict[str, Any]] = None,
                              step: int = 0, device="cuda") -> GaussianTrainState:
    """Fresh training state on ``device``: the float fields as leaf tensors
    with ``requires_grad``, :func:`gaussian_optimizer` over them with zero
    moments (``optimizer`` holds its keyword arguments), empty statistics."""
    dev = torch.device(device)
    params, alive = split_state(gaussians)
    params = GaussianParams(*(p.detach().to(dev, torch.float32).clone().requires_grad_(True)
                              for p in params))
    return GaussianTrainState(merge_state(params, alive.to(dev, torch.bool).clone()),
                              gaussian_optimizer(params, **(optimizer or {})),
                              empty_stats(alive.shape[0], dev), int(step))


# guidance_fn(guidance_state, generator, rgb, batch) -> scalar loss, as in the static stage
GuidanceFn = Callable[[Any, torch.Generator, torch.Tensor, Dict[str, Any]], torch.Tensor]


def make_gaussian_train_step(gcfg: GaussianConfig, raster_cfg: RasterizerConfig,
                             losses: GaussianStageLosses, guidance_fn: Optional[GuidanceFn] = None,
                             bg_color=(1.0, 1.0, 1.0), invert_bg_prob: float = 1.0,
                             sugar_reg_start: int = 3000, n_sdf_samples: int = 1000, device="cuda",
                             par: Optional[ParallelContext] = None):
    """Build ``(train_step, density_control_step)``.

    ``train_step(state, batch, reg_state, generator, guidance_state=None) ->
    (state, metrics)``; ``batch`` holds ``ref_cameras`` / ``rand_cameras``
    (CameraBatch), ``ref_rgb`` (B,H,W,3), ``ref_mask`` (B,H,W,1) and what
    the guidance reads; ``metrics`` holds ``loss_<term>`` for every term,
    ``loss_total`` and ``psnr`` as detached 0-d tensors.

    ``density_control_step(state, generator, noise=None) -> (state, info)``:
    ``densify_and_prune`` with the Adam moments, written in place."""
    dev = torch.device(device)
    par = par or ParallelContext()
    bg_base = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    C = gcfg.capacity
    weights = {"sds": losses.lambda_sds, "rgb": losses.lambda_rgb, "mask": losses.lambda_mask,
               "opacity_binary": losses.lambda_opacity_binary,
               "sugar_density_reg": losses.lambda_sugar_density_reg,
               "sugar_sdf_normal_reg": losses.lambda_sugar_sdf_normal_reg,
               "rgb_tv": losses.lambda_rgb_tv}

    def render_views(attrs, cameras, bg, offset):
        means, quats, scales, opac, sh = attrs
        outs = [rasterize(means, opac, GSCameraInfo(wv, fp, cc), raster_cfg, bg, sh=sh,
                          sh_degree=gcfg.sh_degree, scales=scales, quats=quats,
                          means2d_offset=offset, device=dev)
                for wv, fp, cc in zip(*cameras)]
        return (torch.stack([o.rgb for o in outs]), torch.stack([o.alpha for o in outs]),
                torch.stack([o.radii for o in outs]))

    def loss_fn(params: GaussianParams, offset, alive, batch, reg_state, generator, step, gstate):
        attrs = renderable(merge_state(params, alive))
        terms: Dict[str, torch.Tensor] = {}
        invert = draw_uniform(generator, dev) > (1.0 - invert_bg_prob)
        train_bg = torch.where(invert, 1.0 - bg_base, bg_base)

        ref_rgb, ref_alpha, ref_radii = render_views(attrs, batch["ref_cameras"], bg_base, offset)
        gt_mask = batch["ref_mask"]
        gt_rgb = batch["ref_rgb"] * gt_mask
        terms["rgb"] = ((gt_rgb - torch.clamp(ref_rgb, 0, 1) * gt_mask) ** 2).mean()
        terms["mask"] = ((gt_mask - ref_alpha) ** 2).mean()

        rand_rgb, _, rand_radii = render_views(attrs, batch["rand_cameras"], train_bg, offset)
        if guidance_fn is not None:
            terms["sds"] = guidance_fn(gstate, generator, torch.clamp(rand_rgb, 0, 1),
                                       {**batch, "step": step})
        terms["rgb_tv"] = tv_loss(rand_rgb)

        visibility = par.all_max_(((ref_radii > 0).any(0) | (rand_radii > 0).any(0)).to(torch.int32)) > 0
        reg_on = float(step >= sugar_reg_start)
        opac = torch.sigmoid(params.opacity_logits)
        vis_w = (visibility & alive).to(torch.float32)
        entropy = -(opac * torch.log(opac + 1e-10) + (1 - opac) * torch.log(1 - opac + 1e-10))
        terms["opacity_binary"] = reg_on * (entropy * vis_w).sum() / torch.clamp(vis_w.sum(), min=1.0)

        means, quats, scales, opac_r, _ = attrs
        reg = sugar_density_regularization(reg_state, means, quats, scales, opac_r, alive,
                                           draw_samples(generator, alive, n_sdf_samples))
        terms["sugar_density_reg"] = reg_on * reg["density_regulation"]
        terms["sugar_sdf_normal_reg"] = reg_on * reg["normal_regulation"]

        total = torch.zeros((), dtype=torch.float32, device=dev)
        for name, value in terms.items():
            total = total + C_step(weights[name], step) * value
        metrics = {f"loss_{k}": v.detach() for k, v in terms.items()}
        metrics["loss_total"] = total.detach()
        metrics["psnr"] = -10.0 * torch.log10(terms["rgb"].detach() + 1e-8)
        radii = par.all_max_(torch.maximum(ref_radii.max(0).values, rand_radii.max(0).values))
        return total, metrics, radii, visibility

    def train_step(state: GaussianTrainState, batch, reg_state: SugarRegState,
                   generator: torch.Generator, guidance_state=None):
        """One optimisation step; updates the parameter leaves and the
        moments in place and returns the advanced state."""
        batch = tree_to(batch, dev)
        params, alive = split_state(state.gaussians)
        state.opt_state.zero_grad(set_to_none=True)
        offset = torch.zeros((C, 2), device=dev, requires_grad=True)
        loss, metrics, radii, visibility = loss_fn(params, offset, alive, batch, reg_state, generator,
                                                   state.step, guidance_state)
        loss.backward()
        par.average_gradients(list(params) + [offset])
        set_learning_rates(state.opt_state)
        state.opt_state.step()
        stats = update_stats(state.stats, offset.grad, radii, visibility)
        return (GaussianTrainState(state.gaussians, state.opt_state, stats, state.step + 1),
                par.reduce_metrics(metrics))

    def density_control_step(state: GaussianTrainState, generator: torch.Generator, noise=None):
        """Clone / split / prune; the moments of every rewritten slot zeroed."""
        opt = state.opt_state
        params, _ = split_state(state.gaussians)
        moments = None
        if params.xyz in opt.state:
            moments = [{f: opt.state[getattr(params, f)][key] for f in GaussianParams._fields}
                       for key in ("exp_avg", "exp_avg_sq")]
        new, stats, mu, nu, info = densify_and_prune(
            GaussianState(*(x.detach() for x in state.gaussians)), state.stats, gcfg,
            generator=generator, noise=noise, adam_mu=moments and moments[0],
            adam_nu=moments and moments[1])
        with torch.no_grad():
            for f in GaussianParams._fields:
                leaf = getattr(params, f)
                leaf.copy_(getattr(new, f))
                if moments is not None:
                    opt.state[leaf]["exp_avg"].copy_(mu[f])
                    opt.state[leaf]["exp_avg_sq"].copy_(nu[f])
        return GaussianTrainState(merge_state(params, new.alive), opt, stats, state.step), info

    return train_step, density_control_step


def reset_state_opacity(state: GaussianTrainState, max_opacity: float = 0.01) -> GaussianTrainState:
    """``reset_opacity`` on the opacity leaf, in place."""
    with torch.no_grad():
        state.gaussians.opacity_logits.copy_(
            reset_opacity(state.gaussians, max_opacity).opacity_logits)
    return state


def make_reg_state(state: GaussianTrainState) -> SugarRegState:
    return refresh_knn(state.gaussians.xyz, state.gaussians.alive)

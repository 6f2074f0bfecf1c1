"""The threestudio zoo's NeRF train steps: dreamfusion, efficient-dreamfusion,
prolificdreamer and magic123 (counterpart of
``dreammesh4d_tpu/systems/threestudio_zoo.py``; latentnerf and sjc are in
``threestudio_zoo2.py``).

- ``dreamfusion-system`` (and ``magic3d-system``'s coarse stage): random-
  camera renders driven by an SDS term, plus the orientation / sparsity /
  opacity regularisers;
- ``efficient-dreamfusion-system``: only a strided subgrid of rays is
  rendered and the low-resolution render is resized (bilinear, as
  ``jax.image.resize``) to ``full_hw`` before SDS; an optional z-variance
  term;
- ``prolificdreamer-system``: a VSD term (``models/guidance/vsd.py``) and
  the LoRA's diffusion loss from one backward, which steps two Adams: the
  scene's (``optimizer.args``) and the LoRA's (betas (0.9, 0.999), eps
  1e-8, ``lr_lora``);
- ``magic123-system``: reference-view rgb and mask losses, a 2D (Stable
  Diffusion) and a 3D (Zero123) SDS term with their own weights, 2D normal
  smoothness and the regularisers; ``image-condition-dreamfusion-system``
  is the same step without the 3D term.

Each factory takes guidance closures ``(generator, rgb (B, H, W, 3), batch)
-> scalar``.  As in the stage-1 step (``zero123_system.py``) Adam lives in
the state and the parameters are updated in place; the random numbers (the
samples' jitter, the SDS draws) come from one ``torch.Generator``, where
the JAX package splits a ``PRNGKey``.  Loss weights are ``C`` schedules of
the state's step; a ``system.scheduler`` block makes the scene's Adam group
carry ``lr · factor(step)`` (``systems/optim.scheduled_lr``), written before
each update.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..models.geometry.implicit_volume import ImplicitVolumeConfig
from ..models.renderers.nerf_volume_renderer import NeRFRendererConfig, render_rays
from ..ops.cameras import binary_cross_entropy
from ..ops.resize import resize_hw
from ..utils.schedule import C_step
from ..utils.tree import tree_leaves, tree_map, tree_to
from .optim import set_learning_rates
from .zero123_system import NeRFTrainState, init_nerf_state

# guidance_fn(generator, rgb (B, H, W, 3), batch) -> scalar loss
ZooGuidanceFn = Callable[[torch.Generator, torch.Tensor, Dict[str, Any]], torch.Tensor]

# the scene state of every zoo step: (geo_params, Adam over its leaves, step)
SceneTrainState = NeRFTrainState


def init_scene_state(geo_params, lr: float = 0.01, betas=(0.9, 0.99), eps: float = 1e-8,
                     step: int = 0, device="cuda", schedule: Optional[Callable[[int], float]] = None
                     ) -> SceneTrainState:
    """Fresh state: the implicit-volume tree on ``device`` with Adam
    (``optimizer.args``) over it, zero moments; ``schedule`` (step -> lr)
    becomes its group's ``"schedule"``."""
    state = init_nerf_state(geo_params, lr=lr, betas=betas, eps=eps, step=step, device=device)
    if schedule is not None:
        state.opt_state.param_groups[0]["schedule"] = schedule
    return state


def _regularizers(out, terms: Dict[str, torch.Tensor]) -> None:
    """Orientation Σ w·max(n·d, 0)² / #opaque with detached weights,
    sparsity sqrt(o² + 0.01) and the opacity BCE(o, o) on the clipped
    opacity."""
    w_det = out["weights"].detach()
    ndotd = (out["normal"] * out["t_dirs"]).sum(-1)
    n_opaque = torch.clamp((out["opacity"] > 0).sum(), min=1)
    terms["orient"] = (w_det * torch.clamp(ndotd, min=0.0) ** 2).sum() / n_opaque
    terms["sparsity"] = torch.sqrt(out["opacity"] ** 2 + 0.01).mean()
    oc = torch.clamp(out["opacity"], 1e-3, 1 - 1e-3)
    terms["opaque"] = binary_cross_entropy(oc, oc)


def _total(terms, weights_map, step: int, device):
    total = torch.zeros((), dtype=torch.float32, device=device)
    for name, value in terms.items():
        total = total + C_step(weights_map[name], step) * value
    metrics = {f"loss_{k}": v.detach() for k, v in terms.items()}
    metrics["loss_total"] = total.detach()
    return total, metrics


def _rand_render(geo_params, geo_cfg, rcfg, batch, bg, generator, material):
    """The random views' rays (B, H, W, 3) rendered flat; returns (out, B, H, W)."""
    B, H, W = batch["rays_o"].shape[:3]
    out = render_rays(geo_params, geo_cfg, rcfg, batch["rays_o"].reshape(-1, 3),
                      batch["rays_d"].reshape(-1, 3),
                      torch.repeat_interleave(batch["light_positions"], H * W, dim=0), bg, generator,
                      material=material)
    return out, B, H, W


def _make_step(loss_fn, device):
    """``train_step(state, batch, generator) -> (state, metrics)`` around
    ``loss_fn(geo_params, batch, generator, step)``."""
    dev = torch.device(device)

    def train_step(state: SceneTrainState, batch, generator: torch.Generator):
        """One optimisation step; updates ``state.geo_params`` and the
        optimizer's moments in place and returns the advanced state."""
        batch = tree_to(batch, dev)
        state.opt_state.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.geo_params, batch, generator, state.step)
        loss.backward()
        set_learning_rates(state.opt_state)
        state.opt_state.step()
        return SceneTrainState(state.geo_params, state.opt_state, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# dreamfusion-system
# ---------------------------------------------------------------------------


@dataclass
class DreamFusionLosses:
    lambda_sds: Any = 1.0
    lambda_orient: Any = field(default_factory=lambda: [0, 10.0, 1000.0, 5000])
    lambda_sparsity: Any = 1.0
    lambda_opaque: Any = 0.0
    # HiFA z-variance (efficient-dreamfusion); 0 disables
    lambda_z_variance: Any = 0.0


def make_dreamfusion_train_step(geo_cfg: ImplicitVolumeConfig, rcfg: NeRFRendererConfig,
                                losses: DreamFusionLosses, guidance_fn: ZooGuidanceFn, material=None,
                                bg_color=(1.0, 1.0, 1.0), device="cuda"):
    """``batch``: ``rays_o`` / ``rays_d`` (B, H, W, 3), ``light_positions``
    (B, 3) and what the guidance reads (elevation / azimuth /
    camera_distances)."""
    dev = torch.device(device)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    weights = {"sds": losses.lambda_sds, "orient": losses.lambda_orient,
               "sparsity": losses.lambda_sparsity, "opaque": losses.lambda_opaque}

    def loss_fn(geo_params, batch, generator, step):
        out, B, H, W = _rand_render(geo_params, geo_cfg, rcfg, batch, bg, generator, material)
        terms = {"sds": guidance_fn(generator, out["comp_rgb"].reshape(B, H, W, 3), batch)}
        _regularizers(out, terms)
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)


# ---------------------------------------------------------------------------
# efficient-dreamfusion-system (subsampled-ray SDS)
# ---------------------------------------------------------------------------


def make_eff_dreamfusion_train_step(geo_cfg: ImplicitVolumeConfig, rcfg: NeRFRendererConfig,
                                    losses: DreamFusionLosses, guidance_fn: ZooGuidanceFn, full_hw: int,
                                    material=None, bg_color=(1.0, 1.0, 1.0), device="cuda"):
    """``batch`` as the dreamfusion step's with the rays of the subgrid
    (``RandomCameraSampler.sample_efficient``); the (B, sH, sW) render is
    resized to ``full_hw``² before SDS.  With ``lambda_z_variance`` the
    z-variance of the rays with opacity > 0.5 joins the loss."""
    dev = torch.device(device)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)

    def loss_fn(geo_params, batch, generator, step):
        out, B, sH, sW = _rand_render(geo_params, geo_cfg, rcfg, batch, bg, generator, material)
        rgb = resize_hw(out["comp_rgb"].reshape(B, sH, sW, 3), full_hw, full_hw, "bilinear")
        terms = {"sds": guidance_fn(generator, rgb, batch)}
        _regularizers(out, terms)
        weights = {"sds": losses.lambda_sds, "orient": losses.lambda_orient,
                   "sparsity": losses.lambda_sparsity, "opaque": losses.lambda_opaque}
        if losses.lambda_z_variance:
            zmask = (out["opacity"].reshape(-1) > 0.5).float()
            terms["z_variance"] = ((out["z_variance"].reshape(-1) * zmask).sum()
                                   / torch.clamp(zmask.sum(), min=1.0))
            weights["z_variance"] = losses.lambda_z_variance
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)


# ---------------------------------------------------------------------------
# prolificdreamer-system (VSD, two optimizers in one step)
# ---------------------------------------------------------------------------


@dataclass
class ProlificDreamerLosses(DreamFusionLosses):
    lambda_vsd: Any = 1.0
    lambda_lora: Any = 1.0


class VSDTrainState(NamedTuple):
    geo_params: Any  # the implicit-volume tree
    lora_params: Any  # the LoRA tree (``VSDGuidance.init_lora_params``)
    opt_state: torch.optim.Optimizer  # the scene's Adam
    lora_opt_state: torch.optim.Optimizer  # the LoRA's Adam
    step: int


def init_vsd_state(geo_params, lora_params, lr: float = 0.01, betas=(0.9, 0.99), eps: float = 1e-8,
                   lora_lr: float = 1e-3, step: int = 0, device="cuda",
                   schedule: Optional[Callable[[int], float]] = None) -> VSDTrainState:
    """Fresh state: the scene as :func:`init_scene_state`, the LoRA tree on
    ``device`` with optax ``adam(lora_lr)``'s defaults (betas (0.9, 0.999),
    eps 1e-8), zero moments."""
    scene = init_scene_state(geo_params, lr=lr, betas=betas, eps=eps, step=step, device=device,
                             schedule=schedule)
    lora = tree_map(lambda x: x.detach().to(device).clone().requires_grad_(True), lora_params)
    lora_opt = torch.optim.Adam(tree_leaves(lora), lr=lora_lr, betas=(0.9, 0.999), eps=1e-8)
    return VSDTrainState(scene.geo_params, lora, scene.opt_state, lora_opt, int(step))


def make_prolificdreamer_train_step(geo_cfg: ImplicitVolumeConfig, rcfg: NeRFRendererConfig,
                                    losses: ProlificDreamerLosses, vsd_fn: Callable, material=None,
                                    bg_color=(1.0, 1.0, 1.0), device="cuda"):
    """``vsd_fn(lora_params, generator, rgb (B, H, W, 3), batch) ->
    {"loss_vsd", "loss_lora", ...}``; ``batch`` as the dreamfusion step's
    (and what ``vsd_fn`` reads, e.g. ``c2w``).  One backward of the total
    gives both trees their gradients; both Adams step."""
    dev = torch.device(device)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    weights = {"vsd": losses.lambda_vsd, "lora": losses.lambda_lora, "orient": losses.lambda_orient,
               "sparsity": losses.lambda_sparsity, "opaque": losses.lambda_opaque}

    def train_step(state: VSDTrainState, batch, generator: torch.Generator):
        """One optimisation step of the scene and the LoRA (in place);
        returns the advanced state and the metrics."""
        batch = tree_to(batch, dev)
        for opt in (state.opt_state, state.lora_opt_state):
            opt.zero_grad(set_to_none=True)
        out, B, H, W = _rand_render(state.geo_params, geo_cfg, rcfg, batch, bg, generator, material)
        g = vsd_fn(state.lora_params, generator, out["comp_rgb"].reshape(B, H, W, 3), batch)
        terms = {"vsd": g["loss_vsd"], "lora": g["loss_lora"]}
        _regularizers(out, terms)
        loss, metrics = _total(terms, weights, state.step, dev)
        loss.backward()
        set_learning_rates(state.opt_state)
        state.opt_state.step()
        state.lora_opt_state.step()
        return state._replace(step=state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# magic123-system (image-to-3D, 2D + 3D SDS)
# ---------------------------------------------------------------------------


@dataclass
class Magic123Losses:
    lambda_sds_2d: Any = 0.025
    lambda_sds_3d: Any = 1.0
    lambda_rgb: Any = 1000.0
    lambda_mask: Any = 100.0
    lambda_normal_smooth: Any = 4.0
    lambda_orient: Any = 1.0
    lambda_sparsity: Any = 0.5
    lambda_opaque: Any = 0.5


def make_magic123_train_step(geo_cfg: ImplicitVolumeConfig, rcfg: NeRFRendererConfig,
                             losses: Magic123Losses, guidance_2d_fn: Optional[ZooGuidanceFn] = None,
                             guidance_3d_fn: Optional[ZooGuidanceFn] = None, material=None,
                             bg_color=(1.0, 1.0, 1.0), device="cuda"):
    """``batch``: the reference view (``ref_rays_o`` / ``ref_rays_d`` (R, 3),
    ``ref_rgb`` (R, 3), ``ref_mask`` (R, 1), ``ref_light`` (3,)) and the
    random views as in the dreamfusion step."""
    dev = torch.device(device)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    weights = {"sds_2d": losses.lambda_sds_2d, "sds_3d": losses.lambda_sds_3d,
               "rgb": losses.lambda_rgb, "mask": losses.lambda_mask,
               "normal_smooth": losses.lambda_normal_smooth, "orient": losses.lambda_orient,
               "sparsity": losses.lambda_sparsity, "opaque": losses.lambda_opaque}

    def loss_fn(geo_params, batch, generator, step):
        terms: Dict[str, torch.Tensor] = {}
        ref_out = render_rays(geo_params, geo_cfg, rcfg, batch["ref_rays_o"], batch["ref_rays_d"],
                              batch["ref_light"].expand(batch["ref_rays_o"].shape), bg, generator,
                              material=material)
        gt_mask = batch["ref_mask"]
        gt_rgb = batch["ref_rgb"] * gt_mask
        terms["rgb"] = ((gt_rgb - ref_out["comp_rgb"] * gt_mask) ** 2).mean()
        terms["mask"] = ((gt_mask - ref_out["opacity"]) ** 2).mean()

        out, B, H, W = _rand_render(geo_params, geo_cfg, rcfg, batch, bg, generator, material)
        rgb = out["comp_rgb"].reshape(B, H, W, 3)
        if guidance_2d_fn is not None:
            terms["sds_2d"] = guidance_2d_fn(generator, rgb, batch)
        if guidance_3d_fn is not None:
            terms["sds_3d"] = guidance_3d_fn(generator, rgb, batch)
        normal_img = out["comp_normal"].reshape(B, H, W, 3)
        terms["normal_smooth"] = (((normal_img[:, 1:] - normal_img[:, :-1]) ** 2).mean()
                                  + ((normal_img[:, :, 1:] - normal_img[:, :, :-1]) ** 2).mean())
        _regularizers(out, terms)
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)


class ImageConditionDreamFusionSystem:
    """``image-condition-dreamfusion-system``: reference-view supervision and
    one text SDS term on random views, the magic123 step without its 3D
    guidance."""

    @staticmethod
    def make_train_step(geo_cfg, rcfg, losses: Magic123Losses, guidance_fn: ZooGuidanceFn,
                        material=None, bg_color=(1.0, 1.0, 1.0), device="cuda"):
        return make_magic123_train_step(geo_cfg, rcfg, losses, guidance_2d_fn=guidance_fn,
                                        guidance_3d_fn=None, material=material, bg_color=bg_color,
                                        device=device)


"""The threestudio zoo's latentnerf and sjc train steps (counterpart of
``dreammesh4d_tpu/systems/threestudio_zoo2.py``, :139-212 and :219-284).

- ``latentnerf-system``: the field's feature head emits 4 channels that
  the renderer composites over a zero background (its channel count is the
  background's) and SDS reads as the latents themselves
  (``rgb_as_latents``); ``refinement`` switches to 3-channel rgb SDS.  With
  a sketch-shape guide (``ops/shape_loss.ShapeLoss``) the occupancy term
  ``shape_loss(pts, σ(pts)) / N`` joins, at N points drawn uniformly over
  the geometry's box each step.
- ``sjc-system``: a white background, the emptiness term
  log(1 + s·w) averaged over the ray weights and, with ``lambda_depth``,
  the centre-against-border depth contrast.

The fantasia3d and magic3d-refine steps of the JAX module (DMTet) are not
ported yet (ROADMAP A8).  The steps share ``_rand_render``, ``_total``,
``_regularizers`` and ``_make_step`` with ``threestudio_zoo.py``: one
``torch.Generator`` draws the samples' jitter, the guidance's draws and
the shape term's points; the guidance closure takes ``(generator, image,
batch, rgb_as_latents)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..models.geometry.implicit_volume import ImplicitVolumeConfig, forward_density
from ..models.renderers.nerf_volume_renderer import NeRFRendererConfig
from .threestudio_zoo import _make_step, _rand_render, _regularizers, _total


def draw_uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) draws of the shape term's points (a function of its own so
    that tests can hand both packages the same numbers)."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device).to(device)


# ---------------------------------------------------------------------------
# latentnerf-system
# ---------------------------------------------------------------------------


@dataclass
class LatentNeRFLosses:
    lambda_sds: Any = 1.0
    lambda_orient: Any = field(default_factory=lambda: [0, 10.0, 1000.0, 5000])
    lambda_sparsity: Any = 0.0005
    lambda_opaque: Any = 0.0
    lambda_shape: Any = 5.0  # the sketch-shape guide's weight


def make_latentnerf_train_step(geo_cfg: ImplicitVolumeConfig, rcfg: NeRFRendererConfig,
                               losses: LatentNeRFLosses, guidance_fn: Callable, refinement: bool = False,
                               shape_loss: Optional[Callable] = None, shape_loss_samples: int = 4096,
                               device="cuda"):
    """``geo_cfg.n_feature_dims`` must be 4 unless ``refinement``;
    ``guidance_fn(generator, image (B, H, W, C), batch, rgb_as_latents)``.
    ``batch`` as the dreamfusion step's."""
    dev = torch.device(device)
    bg = torch.zeros((3 if refinement else 4,), dtype=torch.float32, device=dev)
    weights = {"sds": losses.lambda_sds, "orient": losses.lambda_orient,
               "sparsity": losses.lambda_sparsity, "opaque": losses.lambda_opaque}
    if shape_loss is not None:
        weights["shape"] = losses.lambda_shape

    def loss_fn(geo_params, batch, generator, step):
        out, B, H, W = _rand_render(geo_params, geo_cfg, rcfg, batch, bg, generator, None)
        img = out["comp_rgb"].reshape(B, H, W, out["comp_rgb"].shape[-1])
        terms = {"sds": guidance_fn(generator, img, batch, not refinement)}
        if shape_loss is not None:
            r = geo_cfg.radius
            pts = draw_uniform(generator, (shape_loss_samples, 3), dev) * (2.0 * r) - r
            sigmas = forward_density(geo_params, geo_cfg, pts)[..., 0]
            terms["shape"] = shape_loss(pts, sigmas) / shape_loss_samples
        _regularizers(out, terms)
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)


# ---------------------------------------------------------------------------
# sjc-system
# ---------------------------------------------------------------------------


@dataclass
class SJCLosses:
    lambda_sds: Any = 1.0
    lambda_emptiness: Any = field(default_factory=lambda: [10000, 10.0, 200.0, 20000])
    emptiness_scale: float = 10.0
    lambda_depth: Any = 0.0
    center_ratio: float = 0.78125


def make_sjc_train_step(geo_cfg: ImplicitVolumeConfig, rcfg: NeRFRendererConfig, losses: SJCLosses,
                        guidance_fn: Callable, bg_color=(1.0, 1.0, 1.0), device="cuda"):
    """``guidance_fn(generator, rgb, batch)``; ``batch`` as the dreamfusion
    step's.  The depth contrast pulls the centre crop (``center_ratio`` of
    each side) nearer than the border, in depth + 10·(1 − opacity)."""
    dev = torch.device(device)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)

    def loss_fn(geo_params, batch, generator, step):
        out, B, H, W = _rand_render(geo_params, geo_cfg, rcfg, batch, bg, generator, None)
        terms = {"sds": guidance_fn(generator, out["comp_rgb"].reshape(B, H, W, 3), batch),
                 "emptiness": torch.log1p(losses.emptiness_scale * out["weights"]).mean()}
        weights = {"sds": losses.lambda_sds, "emptiness": losses.lambda_emptiness}
        if losses.lambda_depth:
            comp_depth = out["depth"].reshape(B, H, W) + 10.0 * (1.0 - out["opacity"].reshape(B, H, W))
            ch, cw = int(losses.center_ratio * H), int(losses.center_ratio * W)
            bh, bw = (H - ch) // 2, (W - cw) // 2
            center = comp_depth[:, bh:bh + ch, bw:bw + cw]
            border_sum = comp_depth.sum((1, 2)) - center.sum((1, 2))
            terms["depth"] = -(border_sum / (H * W - ch * cw) - center.mean((1, 2))).mean()
            weights["depth"] = losses.lambda_depth
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, dev)

"""Experiment assembly: config -> runnable stage experiments (counterpart of
``dreammesh4d_tpu/systems/assembly.py`` for the stages the port runs from
their YAML: the static NeRF, the static SuGaR refine, its Gaussian stage
and the dynamic stage).

For each ``system_type`` it builds the data module, the geometry, the
optimizer and the train step, and exposes the trainer-facing callbacks
(``train_step`` / ``validate`` / ``export`` / checkpoint state).  Everything
lives on ``device`` (default the card).  Randomness: the data modules draw
from ``np.random.RandomState(cfg.seed)`` as the JAX ones do; the step's own
draws (the background inversion) come from a ``torch.Generator`` seeded with
``cfg.seed``, where the JAX package splits a ``PRNGKey``.

``export()`` writes the JAX package's file set: the NeRF stage
``save/model.obj`` with vertex colours, the static stage
``save/refined_mesh.obj`` and ``save/gaussians.ply``, the Gaussian stage
``save/gaussians.ply`` of its alive slots, the dynamic stage one
textured ``save/4d_export/frame_XXX.obj`` per timestamp sharing
``material0.mtl`` / ``material0.png``.

With ``system.guidance.pretrained_model_name_or_path`` at ``random[:seed]``
or an existing checkpoint, each stage adds the Stable Zero123 SDS term
(``loss_sds``, or ``loss_sds_zero123`` in the dynamic stage) to its loss;
its embedding bank is built once, at construction, and rides every step as
the step's ``guidance_state``.  ``freq.guidance_eval`` (stages 1 and 5)
writes ``it{step}-guidance.png`` every that many steps.

``trainer.devices`` / ``trainer.mesh`` (more than one device, inside the
process group the launcher makes): each experiment builds its
:class:`~..parallel.context.ParallelContext` from ``cfg.trainer``, checks
that the batch divides the data axis (``random_camera.batch_size`` in
stages 1 and 4 and the Gaussian stage, ``num_frames`` in stage 5), splits
the guidance's UNet over ``model`` and gives every rank its rows of the
random views / frames; the reference view and the embedding bank stay
whole on every rank.  Rank 0 writes the files (the saver and the trainer).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any, Dict

import numpy as np
import torch

from ..data.image import SingleImageConfig, SingleImageDataModule
from ..data.temporal_image import (TemporalImageConfig, TemporalImageDataModule,
                                   frame_timestamps)
from ..data.uncond import RandomCameraConfig
from ..export.gaussian_io import save_gaussians_ply
from ..export.isosurface import extract_isosurface
from ..export.mesh_io import MeshData, load_mesh, save_obj
from ..export.texture_bake import bake_texture, export_textured_mesh
from ..models.geometry.deformation import DeformationConfig, init_deformation
from ..models.geometry.dynamic_sugar import (DynamicSuGaRConfig, build_dynamic_static,
                                             init_discrete_params, timed_all)
from ..models.geometry.gaussian import (GaussianConfig, GaussianState, from_mesh_vertices,
                                        init_random_sphere, renderable)
from ..models.geometry.implicit_volume import (ImplicitVolumeConfig, export_density_grid,
                                               forward_field, init_implicit_volume)
from ..models.geometry.sugar import SuGaRConfig, SuGaRParams, create_sugar, gaussian_attributes
from ..models.guidance.zero123.checkpoint import load_zero123_checkpoint
from ..models.guidance.zero123.guidance import config_from_dict
from ..models.materials import DiffuseWithPointLightMaterial
from ..models.renderers.nerf_volume_renderer import (NeRFRendererConfig, init_occgrid,
                                                     make_image_renderer, make_occgrid_update)
from ..ops.cameras import GSCameraInfo, get_ray_directions, get_rays
from ..ops.gs.rasterize import RasterizerConfig, rasterize
from ..ops.hashgrid import HashGridConfig, progressive_level_mask
from ..ops.meshops import build_one_ring, cotangent_weights
from ..ops.resize import resize_hw
from ..parallel.context import ParallelContext, check_batch_size
from ..registry import find, register
from ..utils.checkpoint import restore_checkpoint
from ..utils.saving import Saver
from ..utils.schedule import C_max
from ..utils.tree import tree_leaves, tree_map
from .gaussian_stage import (GaussianStageLosses, init_gaussian_train_state, make_gaussian_train_step,
                             make_reg_state, reset_state_opacity)
from .sugar_4dgen import (Sugar4DGenLosses, init_dyn_state, make_dynamic_render_eval,
                          make_dynamic_train_step)
from .sugar_static import (SugarStaticLosses, init_static_state, make_render_eval,
                           make_static_train_step)
from .zero123_system import Zero123Losses, init_nerf_state, make_zero123_train_step

log = logging.getLogger(__name__)

EVAL_CHUNK = 8  # views per evaluation render: 120 test views never sit in memory at once


def _filtered_dataclass(cls, cfg: dict):
    """``cls`` from a config dict, ignoring keys it does not have (the YAML
    carries keys of the reference the port accepts and does not read)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dict(cfg).items() if k in names})


def make_random_camera_config(cfg: dict) -> RandomCameraConfig:
    return _filtered_dataclass(RandomCameraConfig, cfg)


def make_single_image_datamodule(data_cfg: dict, seed: int, device="cuda") -> SingleImageDataModule:
    c = _filtered_dataclass(SingleImageConfig, {k: v for k, v in dict(data_cfg).items()
                                                if k != "random_camera"})
    c.random_camera = make_random_camera_config(dict(data_cfg.get("random_camera", {})))
    return SingleImageDataModule(c, seed, device=device)


def make_temporal_datamodule(data_cfg: dict, seed: int, device="cuda") -> TemporalImageDataModule:
    c = _filtered_dataclass(TemporalImageConfig, {k: v for k, v in dict(data_cfg).items()
                                                  if k != "random_camera"})
    c.random_camera = make_random_camera_config(dict(data_cfg.get("random_camera", {})))
    return TemporalImageDataModule(c, seed, device=device)


def build_raster_config(height, width, fovy_deg: float, system_cfg: dict) -> RasterizerConfig:
    """The rasterizer settings of ``system.renderer`` at (height, width); a
    list-valued (milestone) size renders at its last entry.  Every field of
    the YAML is accepted; the port ignores the TPU-only ones
    (``RasterizerConfig``'s docstring)."""
    if isinstance(height, (list, tuple)):
        height = height[-1]
    if isinstance(width, (list, tuple)):
        width = width[-1]
    t = math.tan(math.radians(fovy_deg) / 2)
    r = system_cfg.get("renderer", {})
    return RasterizerConfig(
        width=int(width), height=int(height), tan_fovx=t, tan_fovy=t,
        tile_capacity=int(r.get("tile_capacity", 1024)),
        max_tiles_per_gaussian=int(r.get("max_tiles_per_gaussian", 16)),
        chunk=int(r.get("chunk", 32)),
        backend=str(r.get("backend", "pallas_resident")),
        interpret=bool(r.get("interpret", False)),
        bf16_matmuls=bool(r.get("bf16_matmuls", False)),
        binning=str(r.get("binning", "pairs")),
        stream_rows=bool(r.get("stream_rows", True)),
        tile_px=int(r.get("tile_px", 16)),
    )


# the JAX launcher builds StableZero123Guidance whatever ``guidance_type``
# says, so ``zero123-guidance`` YAMLs (zoo/zero123.yaml, magic123's
# ``guidance_3d``) train with the stable camera embedding; ``find`` alone
# reaches the vanilla class
LAUNCHER_GUIDANCE = {"zero123-guidance": "stable-zero123-guidance"}


def maybe_build_guidance(system_cfg: dict, device="cuda"):
    """The guidance of ``system.guidance`` (a ``StableZero123Guidance`` of
    ``system.guidance_type``, on ``device``), or None when it is off.

    ``pretrained_model_name_or_path``: ``""`` / ``none`` — off, None; a
    missing path — ``FileNotFoundError``, unless ``allow_missing: true``,
    which warns and returns None (a typo must not silently train
    reconstruction-only); ``random[:seed]`` — random weights from a
    ``torch.Generator`` seeded with ``seed`` (0 without one), at the
    configured widths; an existing path — a Stable Zero123 ``.ckpt`` in the
    LDM layout, loaded by key name."""
    gcfg = dict(system_cfg.get("guidance", {}))
    path = str(gcfg.get("pretrained_model_name_or_path", "") or "")
    if not path or path.lower() == "none":
        return None
    is_random = path == "random" or path.startswith("random:")
    if not is_random and not os.path.exists(path):
        if gcfg.get("allow_missing", False):
            log.warning("Zero123 checkpoint not found (%r) — SDS guidance disabled "
                        "(guidance.allow_missing=true).", path)
            return None
        raise FileNotFoundError(
            f"Zero123 guidance checkpoint not found: {path!r}. Set "
            "system.guidance.pretrained_model_name_or_path to a real checkpoint, "
            "'random[:seed]' for an SDS smoke run, or 'none' / "
            "system.guidance.allow_missing=true to train reconstruction-only.")
    name = str(system_cfg.get("guidance_type") or "stable-zero123-guidance")
    cls = find(LAUNCHER_GUIDANCE.get(name, name))
    guidance = cls(config_from_dict(gcfg), device=device)
    if is_random:
        seed = int(path.partition(":")[2] or 0)
        guidance.modules.init_params(torch.Generator(device=device).manual_seed(seed),
                                     zero_init=guidance.cfg.zero_init)
    else:
        report = load_zero123_checkpoint(path, guidance.modules)
        if report["unmapped"]:
            log.warning("Zero123 checkpoint %s: %d keys not used by the guidance, e.g. %s", path,
                        len(report["unmapped"]), report["unmapped"][:5])
    return guidance


def sds_guidance_fn(guidance, temporal: bool = False, par: ParallelContext = None):
    """The train steps' ``guidance_fn(bank, generator, rgb, batch)``: the SDS
    loss of the random-view renders, with the step's draws; ``temporal``
    indexes the bank by ``batch["frame_indices"]``.  Under ``par`` the
    renders are this rank's rows and the draws the whole batch's."""
    par = par or ParallelContext()

    def guidance_fn(bank, generator, rgb, batch):
        return guidance.sds_loss(bank, rgb, batch["elevation"], batch["azimuth"],
                                 batch["camera_distances"],
                                 batch["frame_indices"] if temporal else None, batch["step"],
                                 generator, rows=par.rows(rgb.shape[0]) if par.active else None)["loss_sds"]

    return guidance_fn


def guidance_eval_snapshot(saver, guidance, bank, generator, rgb, elevation, azimuth,
                           camera_distances, step, frame_indices=None, max_views: int = 2) -> None:
    """``freq.guidance_eval``: for up to ``max_views`` views, one grid row of
    [render | noised | one-step x0 | DDIM denoise] as ``it{step}-guidance.png``."""
    B = min(int(rgb.shape[0]), max_views)
    out = guidance.guidance_eval(bank, rgb[:B], elevation[:B], azimuth[:B], camera_distances[:B],
                                 None if frame_indices is None else frame_indices[:B],
                                 generator=generator)
    S = out["img_noisy"].shape[1]
    render = resize_hw(rgb[:B].float(), S, S, "bilinear")
    layers = []
    for i in range(B):
        for img in (render[i], out["img_noisy"][i], out["img_1step"][i], out["img_final"][i]):
            layers.append({"type": "rgb", "img": torch.clamp(img, 0, 1).cpu().numpy()})
    saver.save_image_grid(f"it{step}-guidance.png", layers)


def check_parallel_batch(cfg, dp: int) -> None:
    """``ValueError`` ("divisible") unless the batch that shards over
    ``data`` divides ``dp``: ``data.num_frames`` in the dynamic stage,
    ``data.random_camera.batch_size`` (every milestone) in the others."""
    data = dict(cfg.data or {})
    if cfg.system_type == "sugar-4dgen-system":
        c = _filtered_dataclass(TemporalImageConfig, {k: v for k, v in data.items()
                                                      if k != "random_camera"})
        check_batch_size(c.num_frames, dp, "data.num_frames")
    else:
        rc = make_random_camera_config(dict(data.get("random_camera", {})))
        check_batch_size(rc.batch_size, dp, "data.random_camera.batch_size")


def make_parallel_context(cfg, device) -> ParallelContext:
    """The experiment's context from ``cfg.trainer``, its batch checked."""
    par = ParallelContext.from_trainer_cfg(dict(cfg.trainer or {}), device)
    if par.active:
        check_parallel_batch(cfg, par.dp)
    return par


# the batch entries that shard over ``data``: the random views of stages 1
# and 4 and of the Gaussian stage, the frames of stage 5
RAND_VIEW_KEYS = ("rand_cameras", "elevation", "azimuth", "camera_distances", "rand_rays_o",
                  "rand_rays_d")
RAND_RAY_KEYS = ("rand_rays_o", "rand_rays_d", "light_positions", "elevation", "azimuth",
                 "camera_distances")
FRAME_KEYS = ("timestamps", "frame_indices", "ref_cameras", "rand_cameras", "elevation", "azimuth",
              "camera_distances")


def _shard(par: ParallelContext, batch: dict, keys) -> dict:
    """``batch`` with this rank's rows of its entries ``keys``; the rest whole."""
    return {k: par.shard_batch(v) if k in keys else v for k, v in batch.items()}


def sugar_config(geo: dict) -> SuGaRConfig:
    return _filtered_dataclass(SuGaRConfig, {
        k: v for k, v in geo.items()
        if k in ("n_gaussians_per_surface_triangle", "sh_degree", "init_gs_scales_s",
                 "color_clip", "spatial_extent")})


def dynamic_config(geo: dict) -> DynamicSuGaRConfig:
    return DynamicSuGaRConfig(
        num_frames=int(geo.get("num_frames", 32)),
        dynamic_mode=str(geo.get("dynamic_mode", "deformation")),
        use_deform_graph=bool(geo.get("use_deform_graph", True)),
        n_dg_nodes=int(geo.get("n_dg_nodes", 1000)),
        dg_node_connectivity=int(geo.get("dg_node_connectivity", 4)),
        dist_mode=str(geo.get("dist_mode", "geodisc")),
        skinning_method=str(geo.get("skinning_method", "hybrid")),
        d_scale=bool(geo.get("d_scale", True)),
        deformation=_filtered_dataclass(DeformationConfig, dict(geo.get("deformation", {}))),
    )


def load_static_weights(weights: str, like: SuGaRParams, device) -> SuGaRParams:
    """The refined ``SuGaRParams`` of a static-stage checkpoint
    (``system.weights``).  A checkpoint without ``params``, or one whose
    shapes differ from ``like`` (the bind mesh's), raises ``ValueError``:
    training on from the mesh's own initialisation would be another run."""
    prev = restore_checkpoint(str(weights), device)
    params = prev.get("params") if isinstance(prev, dict) else None
    if not isinstance(params, dict) or set(params) != set(SuGaRParams._fields):
        raise ValueError(f"system.weights={weights!r} has no 'params' entry with the SuGaR "
                         "fields — not a static SuGaR checkpoint")
    loaded = SuGaRParams(**{k: params[k].to(device=device, dtype=torch.float32)
                            for k in SuGaRParams._fields})
    for name in SuGaRParams._fields:
        want, got = tuple(getattr(like, name).shape), tuple(getattr(loaded, name).shape)
        if want != got:
            raise ValueError(
                f"system.weights={weights!r}: shape mismatch for {name!r}: checkpoint {got} vs "
                f"bind mesh {want} — was the static stage trained on a different mesh?")
    return loaded


def _optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    # the moments only: the groups hold lr schedules (functions), rebuilt from the config
    return {"state": optimizer.state_dict()["state"]}


def _load_optimizer_state(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    optimizer.load_state_dict({"state": saved["state"],
                               "param_groups": optimizer.state_dict()["param_groups"]})


def _chunks(cameras, n: int):
    for i in range(0, n, EVAL_CHUNK):
        yield i, type(cameras)(*(x[i:i + EVAL_CHUNK] for x in cameras))


def _loss_config(cls, system) -> Any:
    return _filtered_dataclass(cls, dict(system.get("loss", {})))


def _step_for_current(exp):
    """``exp``'s train step for the data module's current (random-view,
    reference-view) resolution, built on first use: a resolution milestone
    switches to (or builds) that size's step."""
    rs = exp.data.random_sampler
    key = (int(rs.height if rs is not None else exp.data.height),
           int(rs.width if rs is not None else exp.data.width),
           int(exp.data.height), int(exp.data.width))
    if key not in exp._steps:
        exp._steps[key] = exp._build_step(*key)
    return exp._steps[key]


# ---------------------------------------------------------------------------
# the Gaussian stage of sugar-static (vanilla 3DGS with density control)
# ---------------------------------------------------------------------------


class GaussianStageExperiment:
    """``system.stage: gaussian`` of sugar-static-system: vanilla 3DGS with
    adaptive density control and the SuGaR regulariser.

    The geometry keys of the YAML (``max_num``, ``init_num_pts``,
    ``percent_dense``, ``densify_grad_threshold``, ``min_opac_prune``, the
    learning rates) set :class:`GaussianConfig` and ``gaussian_optimizer``;
    the Gaussians start from the points of ``geometry_convert_from`` /
    ``init_from`` where that file exists, else from the random ball (drawn
    by a ``torch.Generator`` seeded with ``cfg.seed``).  ``system.freq``:
    ``densify`` / ``densify_from`` / ``densify_until`` (the density control
    after a step), ``opacity_reset``, ``reset_neighbors`` (the regulariser's
    neighbour table) and ``start_sugar_reg``.  The reference and random views
    render at the random views' size, as in the JAX package."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = dev = torch.device(device)
        system = cfg.system
        self.par = par = make_parallel_context(cfg, dev)
        self.saver = Saver(os.path.join(cfg.trial_dir, "save"))
        self.data = make_single_image_datamodule(cfg.data, cfg.seed, device=dev)

        geo = dict(system.get("geometry", {}))
        self.gcfg = GaussianConfig(
            capacity=int(geo.get("max_num", 200_000)), init_num=int(geo.get("init_num_pts", 5000)),
            sh_degree=int(geo.get("sh_degree", 3)), spatial_extent=float(geo.get("spatial_extent", 3.8)),
            percent_dense=float(geo.get("percent_dense", 0.01)),
            densify_grad_threshold=float(geo.get("densify_grad_threshold", 0.0002)),
            min_opacity=float(geo.get("min_opac_prune", 0.005)))
        init_path = geo.get("geometry_convert_from") or geo.get("init_from")
        if init_path and os.path.exists(str(init_path)):
            mesh = load_mesh(str(init_path))
            gaussians = from_mesh_vertices(self.gcfg, mesh.v_pos, mesh.v_rgb, device=dev)
        else:
            gaussians = init_random_sphere(self.gcfg, torch.Generator(device=dev).manual_seed(int(cfg.seed)),
                                           device=dev)
        self.optimizer_kwargs = dict(
            position_lr=geo.get("position_lr", 0.00016), feature_lr=geo.get("feature_lr", 0.0025),
            opacity_lr=geo.get("opacity_lr", 0.05), scaling_lr=geo.get("scaling_lr", 0.005),
            rotation_lr=geo.get("rotation_lr", 0.001),
            spatial_lr_scale=float(geo.get("spatial_lr_scale", 1.0)))
        losses = _loss_config(GaussianStageLosses, system)
        d = self.data.cfg
        self.raster_cfg = build_raster_config(d.random_camera.height, d.random_camera.width,
                                              d.default_fovy_deg, system)
        freq = dict(system.get("freq", {}))
        self.densify_every = int(freq.get("densify", 100))
        self.densify_from = int(freq.get("densify_from", 500))
        self.densify_until = int(freq.get("densify_until", 7000))
        self.opacity_reset_every = int(freq.get("opacity_reset", 3000))
        self.reset_neighbors_every = int(freq.get("reset_neighbors", 50))

        self.guidance = par.shard_guidance(maybe_build_guidance(system, device=dev))
        self.bank = guidance_fn = None
        if self.guidance is not None:
            self.bank = self.guidance.prepare_embeddings(self.data.ref_batch()["ref_rgb"])
            guidance_fn = sds_guidance_fn(self.guidance, par=par)
        self._train_step, self._density_step = make_gaussian_train_step(
            self.gcfg, self.raster_cfg, losses, guidance_fn,
            invert_bg_prob=float(system.get("renderer", {}).get("invert_bg_prob", 1.0)),
            sugar_reg_start=int(freq.get("start_sugar_reg", 3000)), device=dev, par=par)
        self.state = init_gaussian_train_state(gaussians, self.optimizer_kwargs, device=dev)
        par.replicate(x for x in self.state.gaussians if x.is_floating_point())
        self.reg_state = make_reg_state(self.state)
        self.generator = torch.Generator(device=dev).manual_seed(int(cfg.seed))

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        """One step, then the density control (its ``gauss_num`` joins the
        metrics), the neighbour refresh and the opacity reset where their
        intervals fall."""
        batch = self.data.train_batch(step)
        keep = ["ref_cameras", "ref_rgb", "ref_mask", "rand_cameras"]
        if self.guidance is not None:  # the SDS conditioning reads the view poses
            keep += ["elevation", "azimuth", "camera_distances"]
        batch = _shard(self.par, {k: batch[k] for k in keep}, RAND_VIEW_KEYS)
        self.state, metrics = self._train_step(self.state, batch, self.reg_state, self.generator,
                                               self.bank)
        if self.densify_from <= step < self.densify_until and step % self.densify_every == 0 and step > 0:
            self.state, info = self._density_step(self.state, self.generator)
            metrics = {**metrics, "gauss_num": info["n_alive"]}
        if step % self.reset_neighbors_every == 0:
            self.reg_state = make_reg_state(self.state)
        if self.opacity_reset_every > 0 and step > 0 and step % self.opacity_reset_every == 0:
            self.state = reset_state_opacity(self.state)
        return metrics

    def validate(self, step: int, test: bool = False) -> None:
        """4 orbit views on white as one image grid, ``it{step}-gaussian.png``
        (also for ``test``, as in the JAX package)."""
        cams = self.data.random_sampler.orbit(n_views=4)["rand_cameras"]
        white = torch.ones(3, device=self.device)
        frames = []
        with torch.no_grad():
            means, quats, scales, opac, sh = renderable(self.state.gaussians)
            for wv, fp, cc in zip(*cams):
                out = rasterize(means, opac, GSCameraInfo(wv, fp, cc), self.raster_cfg, white, sh=sh,
                                sh_degree=self.gcfg.sh_degree, scales=scales, quats=quats,
                                device=self.device)
                frames.append(torch.clamp(out.rgb, 0, 1).cpu().numpy())
        self.saver.save_image_grid(f"it{step}-gaussian.png", [{"type": "rgb", "img": f} for f in frames])

    def export(self) -> None:
        """``save/gaussians.ply`` (3DGS layout) of the alive slots."""
        g = GaussianState(*(x.detach().cpu().numpy() for x in self.state.gaussians))
        alive = g.alive
        sh = np.concatenate([g.sh_dc, g.sh_rest], 1)
        save_gaussians_ply(self.saver.path("gaussians.ply"), g.xyz[alive], sh[alive],
                           g.opacity_logits[alive], g.log_scales[alive], g.quats[alive])

    # checkpoint protocol: every slot, the moments, the statistics and the
    # step; the neighbour table is rebuilt on load
    def state_for_checkpoint(self) -> dict:
        s = self.state
        return {"gaussians": {f: getattr(s.gaussians, f).detach() for f in GaussianState._fields},
                "opt_state": _optimizer_state(s.opt_state), "stats": s.stats._asdict(), "step": s.step}

    def load_state(self, saved: dict) -> None:
        gaussians = GaussianState(**{f: saved["gaussians"][f] for f in GaussianState._fields})
        state = init_gaussian_train_state(gaussians, self.optimizer_kwargs, step=int(saved["step"]),
                                          device=self.device)
        _load_optimizer_state(state.opt_state, saved["opt_state"])
        stats = type(state.stats)(**{k: v.to(self.device) for k, v in saved["stats"].items()})
        self.state = state._replace(stats=stats)
        self.reg_state = make_reg_state(self.state)


# ---------------------------------------------------------------------------
# sugar-static experiment
# ---------------------------------------------------------------------------


@register("sugar-static-system")
class SugarStaticExperiment:
    """Stage 4: Gaussians bound to the coarse mesh, refined with it.

    The optimizer is ``sugar_optimizer`` (betas 0.9 / 0.999, eps 1e-15) with
    the geometry's learning rates; ``system.optimizer.args`` is never read,
    as in the JAX package.  One train step is built per (random-view,
    reference-view) resolution."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = dev = torch.device(device)
        system = cfg.system
        self.par = par = make_parallel_context(cfg, dev)
        self.saver = Saver(os.path.join(cfg.trial_dir, "save"))
        self.data = make_single_image_datamodule(cfg.data, cfg.seed, device=dev)

        geo = dict(system.get("geometry", {}))
        sugar_cfg = sugar_config(geo)
        if "init_gs_opacity" in geo:
            sugar_cfg.init_gs_opacity = float(geo["init_gs_opacity"])
        params, self.static = create_sugar(sugar_cfg, load_mesh(str(geo.get("surface_mesh_to_bind_path"))),
                                           device=dev)
        self.optimizer_kwargs = dict(
            position_lr=geo.get("position_lr", 0.00048), scaling_lr=geo.get("scaling_lr", 0.005),
            feature_lr=geo.get("feature_lr", 0.001), opacity_lr=geo.get("opacity_lr", 0.02),
            rotation_lr=geo.get("rotation_lr", 0.001),
            spatial_lr_scale=float(geo.get("spatial_lr_scale", 1.0)))
        self.losses = _loss_config(SugarStaticLosses, system)
        self.guidance = par.shard_guidance(maybe_build_guidance(system, device=dev))
        self.bank = guidance_fn = None
        if self.guidance is not None:
            self.bank = self.guidance.prepare_embeddings(self.data.ref_batch()["ref_rgb"])
            guidance_fn = sds_guidance_fn(self.guidance, par=par)
        d = self.data.cfg
        self.raster_cfg = build_raster_config(d.random_camera.height, d.random_camera.width,
                                              d.default_fovy_deg, system)
        invert_bg_prob = float(system.get("renderer", {}).get("invert_bg_prob", 1.0))

        def build_step(rc_h, rc_w, ref_h, ref_w):
            return make_static_train_step(
                self.static, build_raster_config(rc_h, rc_w, d.default_fovy_deg, system),
                self.losses, guidance_fn, invert_bg_prob=invert_bg_prob,
                ref_raster_cfg=build_raster_config(ref_h, ref_w, d.default_fovy_deg, system),
                device=dev, par=par)

        self._build_step = build_step
        self._steps: Dict[tuple, Any] = {}
        _step_for_current(self)
        self._render_eval = make_render_eval(self.static, self.raster_cfg, device=dev)
        self.state = init_static_state(params, self.optimizer_kwargs, device=dev)
        par.replicate(self.state.params)
        self.generator = torch.Generator(device=dev).manual_seed(int(cfg.seed))

    def train_batch(self, step: int) -> dict:
        """The step's batch: what the train step reads of ``train_batch``,
        this rank's rows of the random views."""
        batch = self.data.train_batch(step)
        keep = ["ref_cameras", "ref_rgb", "ref_mask", "rand_cameras"]
        if self.guidance is not None:  # the SDS conditioning reads the view poses
            keep += ["elevation", "azimuth", "camera_distances"]
        lw = self.losses
        if C_max(lw.lambda_depth) > 0 or C_max(lw.lambda_depth_rel) > 0:
            keep.append("ref_depth")
        if C_max(lw.lambda_normal) > 0:
            keep.append("ref_normal")
        if C_max(lw.lambda_normal_depth_consistency) > 0:
            batch["rand_rays_o"], batch["rand_rays_d"] = batch["rays_o"], batch["rays_d"]
            keep += ["rand_rays_o", "rand_rays_d"]
        return _shard(self.par, {k: batch[k] for k in keep}, RAND_VIEW_KEYS)

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        batch = self.train_batch(step)
        self.state, metrics = _step_for_current(self)(self.state, batch, self.generator, self.bank)
        return metrics

    def validate(self, step: int, test: bool = False) -> None:
        """8 orbit views (image grids of the first 4), or with ``test`` the
        ``n_test_views`` orbit as an image sequence."""
        n = self.data.cfg.random_camera.n_test_views if test else 8
        cams = self.data.random_sampler.orbit(n_views=n)["rand_cameras"]
        outs = []
        with torch.no_grad():
            for _, chunk in _chunks(cams, n):
                out = self._render_eval(self.state.params, chunk)
                outs.append({k: out[k].cpu().numpy() for k in ("comp_rgb", "comp_normal", "comp_mask")})
        out = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        if test:
            self.saver.save_img_sequence(f"it{step}-test.mp4", list(out["comp_rgb"]))
            return
        for i in range(min(n, 4)):
            self.saver.save_image_grid(f"it{step}-{i}.png", [
                {"type": "rgb", "img": out["comp_rgb"][i]},
                {"type": "rgb", "img": out["comp_normal"][i]},
                {"type": "grayscale", "img": out["comp_mask"][i]},
            ])

    def export(self) -> None:
        """``save/refined_mesh.obj`` (the refined vertices on the bind mesh's
        faces) and ``save/gaussians.ply`` (3DGS layout)."""
        params = self.state.params
        with torch.no_grad():
            attrs = gaussian_attributes(params, self.static)
        save_obj(self.saver.path("refined_mesh.obj"),
                 MeshData(v_pos=params.points.detach().cpu().numpy(),
                          t_pos_idx=self.static.faces.cpu().numpy()))
        save_gaussians_ply(
            self.saver.path("gaussians.ply"), attrs.means3d.cpu().numpy(),
            attrs.sh.transpose(-1, -2).cpu().numpy(), params.density_logits.detach().cpu().numpy(),
            torch.log(attrs.scales).cpu().numpy(), attrs.quats.cpu().numpy())

    # checkpoint protocol
    def state_for_checkpoint(self) -> dict:
        s = self.state
        return {"params": {f: getattr(s.params, f).detach() for f in SuGaRParams._fields},
                "opt_state": _optimizer_state(s.opt_state), "step": s.step}

    def load_state(self, saved: dict) -> None:
        params = SuGaRParams(**{f: saved["params"][f] for f in SuGaRParams._fields})
        self.state = init_static_state(params, self.optimizer_kwargs, step=int(saved["step"]),
                                       device=self.device)
        _load_optimizer_state(self.state.opt_state, saved["opt_state"])


# ---------------------------------------------------------------------------
# sugar-4dgen experiment
# ---------------------------------------------------------------------------


@register("sugar-4dgen-system")
class Sugar4DGenExperiment:
    """Stage 5: the deformation of the refined, mesh-bound Gaussians over the
    video.

    ``system.weights`` (a static-stage checkpoint) replaces the mesh's own
    initialisation before the deformation graph is built, so that the graph
    and its skinning weights come from the refined points.  Adam takes
    ``optimizer.args.lr`` with betas (0.9, 0.99) and eps 1e-8; the YAML's
    ``eps`` is not read, as in the JAX package.  With the guidance, the
    embedding bank comes from every video frame at the last milestone's size,
    and the random views render at ``guidance.guidance_render_size`` (0:
    at the data's size); without it that size is ignored."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = dev = torch.device(device)
        system = cfg.system
        self.par = par = make_parallel_context(cfg, dev)
        self.saver = Saver(os.path.join(cfg.trial_dir, "save"))
        self.data = make_temporal_datamodule(cfg.data, cfg.seed, device=dev)

        geo = dict(system.get("geometry", {}))
        sugar_params, sugar_static = create_sugar(
            sugar_config(geo), load_mesh(str(geo.get("surface_mesh_to_bind_path"))), device=dev)
        weights = system.get("weights")
        if weights:
            sugar_params = load_static_weights(weights, sugar_params, dev)
            log.info("Loaded static SuGaR weights from %s", weights)
        self.dyn_cfg = dyn_cfg = dynamic_config(geo)
        deform_cfg = dyn_cfg.deformation
        points = sugar_params.points.cpu().numpy()
        self.static = build_dynamic_static(dyn_cfg, sugar_static, points, device=dev)
        self.sugar_params = sugar_params
        faces = sugar_static.faces.cpu().numpy()
        arap_w = cotangent_weights(points, faces, build_one_ring(faces, len(points)))

        self.lr = float(system.get("optimizer", {}).get("args", {}).get("lr", 1.6e-3))
        self.losses = _loss_config(Sugar4DGenLosses, system)
        self.guidance = par.shard_guidance(maybe_build_guidance(system, device=dev))
        self.bank = guidance_fn = None
        grs = 0
        if self.guidance is not None:
            frames_rgb, _ = self.data.frames_at(int(self.data.heights[-1]), int(self.data.widths[-1]))
            self.bank = self.guidance.prepare_embeddings(frames_rgb)
            guidance_fn = sds_guidance_fn(self.guidance, temporal=True, par=par)
            grs = int(dict(system.get("guidance", {})).get("guidance_render_size", 0) or 0)
        self.guidance_eval_every = int(dict(system.get("freq", {})).get("guidance_eval", 0))
        d = self.data.cfg
        self.raster_cfg = build_raster_config(d.random_camera.height, d.random_camera.width,
                                              d.default_fovy_deg, system)
        self.num_inter_frames = int(system.get("num_inter_frames", 10))
        self.length_inter_frames = float(system.get("length_inter_frames", 0.2))
        if dyn_cfg.dynamic_mode == "discrete":
            deform_params = init_discrete_params(dyn_cfg, len(points), device=dev)
        else:
            deform_params = init_deformation(
                deform_cfg, torch.Generator(device=dev).manual_seed(int(cfg.seed)), device=dev)
        lw = self.losses
        need_depth = C_max(lw.lambda_depth) > 0 or C_max(lw.lambda_depth_rel) > 0
        need_normal = C_max(lw.lambda_normal) > 0
        invert_bg = float(system.get("renderer", {}).get("invert_bg_prob", 1.0))
        arap_start = int(dict(system.get("freq", {})).get("milestone_arap_reg", 0))

        def build_step(rc_h, rc_w, ref_h, ref_w):
            rand_rc = None
            if grs and grs != rc_h:
                rand_rc = build_raster_config(grs, grs, d.default_fovy_deg, system)
            return make_dynamic_train_step(
                sugar_params, self.static, deform_cfg,
                build_raster_config(rc_h, rc_w, d.default_fovy_deg, system), lw, arap_w,
                guidance_fn, invert_bg_prob=invert_bg, arap_start_step=arap_start,
                ref_raster_cfg=build_raster_config(ref_h, ref_w, d.default_fovy_deg, system),
                rand_raster_cfg=rand_rc,
                video_frames=self.data.frames_at(ref_h, ref_w),
                video_depths=self.data.load_depths(ref_h, ref_w) if need_depth else None,
                video_normals=self.data.load_normals(ref_h, ref_w) if need_normal else None,
                device=dev, par=par)

        self._build_step = build_step
        self._steps: Dict[tuple, Any] = {}
        _step_for_current(self)
        self._render_eval = make_dynamic_render_eval(sugar_params, self.static, deform_cfg,
                                                     self.raster_cfg)
        self.state = init_dyn_state(deform_params, lr=self.lr, device=dev)
        par.replicate(tree_leaves(self.state.deform_params))
        self.generator = torch.Generator(device=dev).manual_seed(int(cfg.seed))

    def train_batch(self, step: int) -> dict:
        """The step's batch, all frames; the frames stay on the device inside
        the step, only cameras and timestamps are read here."""
        batch = self.data.train_batch(step)
        batch["inter_timestamps"] = self.data.inter_frame_timestamps(self.num_inter_frames,
                                                                     self.length_inter_frames)
        keep = ["timestamps", "frame_indices", "ref_cameras", "rand_cameras", "inter_timestamps"]
        if self.guidance is not None:  # the SDS conditioning reads the view poses
            keep += ["elevation", "azimuth", "camera_distances"]
        return {k: batch[k] for k in keep}

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        batch = self.train_batch(step)
        self.state, metrics = _step_for_current(self)(self.state, _shard(self.par, batch, FRAME_KEYS),
                                                      self.generator, self.bank)
        if (self.guidance_eval_every > 0 and self.guidance is not None
                and (step + 1) % self.guidance_eval_every == 0):
            # every rank (the generator and the UNet's model group stay in
            # step); rank 0's saver writes
            V = 2  # render only the views the snapshot reads
            cams = type(batch["rand_cameras"])(*(x[:V] for x in batch["rand_cameras"]))
            with torch.no_grad():
                out = self._render_eval(self.state.deform_params, cams, batch["timestamps"][:V],
                                        batch["frame_indices"][:V])
            guidance_eval_snapshot(self.saver, self.guidance, self.bank, self.generator,
                                   out["comp_rgb"], batch["elevation"], batch["azimuth"],
                                   batch["camera_distances"], step + 1,
                                   frame_indices=batch["frame_indices"])
        return metrics

    def render(self, cameras, timestamps, frame_indices=None) -> Dict[str, np.ndarray]:
        """Evaluation renders of the current state (rgb, normal, mask, depth)
        as numpy, ``EVAL_CHUNK`` views at a time."""
        outs = []
        with torch.no_grad():
            for i, chunk in _chunks(cameras, len(timestamps)):
                fi = None if frame_indices is None else frame_indices[i:i + EVAL_CHUNK]
                out = self._render_eval(self.state.deform_params, chunk,
                                        timestamps[i:i + EVAL_CHUNK], fi)
                outs.append({k: v.cpu().numpy() for k, v in out.items()
                             if k in ("comp_rgb", "comp_normal", "comp_mask", "comp_depth")})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def validate(self, step: int, test: bool = False) -> None:
        """Each eval azimuth's sweep over the video's timestamps as an image
        sequence; the first azimuth only, unless ``test``."""
        for batch in self.data.eval_batches():
            out = self.render(batch["cameras"], batch["timestamps"], batch["frame_indices"])
            self.saver.save_img_sequence(f"it{step}-az{int(batch['azimuth'])}.mp4",
                                         list(out["comp_rgb"]))
            if not test:
                break

    def export(self) -> None:
        """One textured OBJ per timestamp, ``save/4d_export/frame_XXX.obj``,
        sharing ONE baked texture (``material0.mtl`` / ``material0.png``,
        written once): the timed Gaussians of the first timestamp are rendered
        from the predict orbit at the predict size (``system.exporter.
        bake_resolution`` overrides it) and baked onto that frame's mesh;
        ``system.exporter.texture_size`` (1024) and ``atlas`` (``square``)."""
        L = self.data.video_length
        dev = self.device
        ts = torch.as_tensor(frame_timestamps(L), device=dev)
        sugar_static = self.static.sugar
        with torch.no_grad():
            gs, vert = timed_all(self.sugar_params, self.state.deform_params,
                                 self.dyn_cfg.deformation, self.static, ts,
                                 frame_indices=torch.arange(L, device=dev))
            attrs0 = gaussian_attributes(self.sugar_params, sugar_static)
        faces = sugar_static.faces.cpu().numpy()

        pred = self.data.predict_batch()
        exporter = dict(self.cfg.system.get("exporter", {}) or {})
        bake_hw = int(exporter.get("bake_resolution", 0)) or int(pred["height"])
        t_tan = math.tan(math.radians(self.data.cfg.default_fovy_deg) / 2)
        bake_cfg = self.raster_cfg._replace(width=bake_hw, height=bake_hw, tan_fovx=t_tan,
                                            tan_fovy=t_tan)
        white = torch.ones(3, device=dev)

        def render_rgb(cam):
            return rasterize(gs.means3d[0], attrs0.opacities, cam, bake_cfg, white, sh=attrs0.sh,
                             sh_degree=sugar_static.sh_degree, scales=gs.scales[0],
                             quats=gs.quats[0], device=dev).rgb

        cams = pred["cameras"]
        texture, v_tex, t_tex = bake_texture(
            vert.xyz[0], sugar_static.faces, cams.world_view, cams.full_proj, cams.camera_center,
            render_rgb, bake_hw, bake_hw, tex_size=int(exporter.get("texture_size", 1024)),
            atlas=str(exporter.get("atlas", "square")))
        xyz = vert.xyz.cpu().numpy()
        for i in range(L):
            export_textured_mesh(self.saver.path(f"4d_export/frame_{i:03d}.obj"), xyz[i], faces,
                                 texture if i == 0 else None, v_tex, t_tex, mtl_name="material0")

    # checkpoint protocol
    def state_for_checkpoint(self) -> dict:
        s = self.state
        return {"deform_params": tree_map(lambda x: x.detach(), s.deform_params),
                "opt_state": _optimizer_state(s.opt_state), "step": s.step}

    def load_state(self, saved: dict) -> None:
        self.state = init_dyn_state(saved["deform_params"], lr=self.lr, step=int(saved["step"]),
                                    device=self.device)
        _load_optimizer_state(self.state.opt_state, saved["opt_state"])


# ---------------------------------------------------------------------------
# zero123 (static NeRF) experiment
# ---------------------------------------------------------------------------


def implicit_volume_config(geo: dict, **extra) -> ImplicitVolumeConfig:
    """``system.geometry`` as the implicit volume's config, its hash grid
    from ``pos_encoding_config`` (the corner layout unless ``layout`` says
    otherwise); ``extra`` sets further fields."""
    pos_enc = dict(geo.get("pos_encoding_config", {}))
    hg = HashGridConfig(
        n_levels=int(pos_enc.get("n_levels", 16)),
        n_features_per_level=int(pos_enc.get("n_features_per_level", 2)),
        log2_hashmap_size=int(pos_enc.get("log2_hashmap_size", 19)),
        base_resolution=int(pos_enc.get("base_resolution", 16)),
        per_level_scale=float(pos_enc.get("per_level_scale", 1.447269237440378)),
        layout=str(pos_enc.get("layout", "corner")))
    return ImplicitVolumeConfig(
        radius=float(geo.get("radius", 2.0)),
        density_bias=geo.get("density_bias", "blob_magic3d"),
        density_activation=str(geo.get("density_activation", "softplus")),
        density_blob_scale=float(geo.get("density_blob_scale", 10.0)),
        density_blob_std=float(geo.get("density_blob_std", 0.5)),
        normal_type=str(geo.get("normal_type", "analytic")),
        hashgrid=hg, **extra)


def adam_args(system: dict) -> dict:
    """Adam's ``lr`` / ``betas`` / ``eps`` from ``system.optimizer.args``."""
    args = dict(system.get("optimizer", {}).get("args", {}))
    betas = args.get("betas", [0.9, 0.99])
    return dict(lr=float(args.get("lr", 0.01)), betas=(float(betas[0]), float(betas[1])),
                eps=float(args.get("eps", 1e-8)))


class NeRFSceneExperiment:
    """What the implicit-volume experiments share: the ``model.obj`` export
    and the checkpoint of (``geo_params``, Adam's moments, step).  Needs
    ``cfg``, ``device``, ``geo_cfg``, ``adam``, ``saver`` and ``state``."""

    def export(self) -> None:
        """``save/model.obj`` with vertex colours: the density grid at
        ``system.exporter.isosurface_resolution`` (128; the only resolution
        key read, as in the JAX package) over the geometry's box, marching
        tetrahedra at the auto threshold, small components removed, and
        sigmoid of the field's first three features at every vertex."""
        res = int(self.cfg.system.get("exporter", {}).get("isosurface_resolution", 128))
        params = self.state.geo_params
        grid = export_density_grid(params, self.geo_cfg, res)
        r = self.geo_cfg.radius
        mesh = extract_isosurface(grid, None, (-r,) * 3, (r,) * 3)
        if mesh.n_verts:
            with torch.no_grad():
                _, feats = forward_field(params, self.geo_cfg,
                                         torch.as_tensor(mesh.v_pos, device=self.device))
                mesh.v_rgb = torch.sigmoid(feats[:, :3]).cpu().numpy()
        save_obj(self.saver.path("model.obj"), mesh)

    # checkpoint protocol: an occupancy grid is not saved (nor in the JAX package)
    def state_for_checkpoint(self) -> dict:
        s = self.state
        return {"geo_params": tree_map(lambda x: x.detach(), s.geo_params),
                "opt_state": _optimizer_state(s.opt_state), "step": s.step}

    def load_state(self, saved: dict) -> None:
        self.state = init_nerf_state(saved["geo_params"], **self.adam, step=int(saved["step"]),
                                     device=self.device)
        _load_optimizer_state(self.state.opt_state, saved["opt_state"])


@register("zero123-system")
class Zero123Experiment(NeRFSceneExperiment):
    """Stage 1: the implicit volume fitted to the reference image (and, with
    the guidance, to Zero123's novel views), and its ``mc-cpu`` mesh export
    (stage 2).

    Adam reads all of ``optimizer.args`` (lr, betas, ``eps``).  The step's
    draws (the occupancy grid's jitter, the ray samples) come from a
    ``torch.Generator`` seeded with ``cfg.seed + 1``, where the JAX package
    splits ``PRNGKey(seed + 1)``; the ambient ratio after
    ``ambient_only_steps`` is drawn from the global numpy stream, as the JAX
    package draws it.  The occupancy grid is not part of the checkpoint: a
    restored experiment starts fully occupied until its next update."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = dev = torch.device(device)
        system = cfg.system
        self.par = par = make_parallel_context(cfg, dev)
        self.saver = Saver(os.path.join(cfg.trial_dir, "save"))
        self.data = make_single_image_datamodule(cfg.data, cfg.seed, device=dev)

        self.geo_cfg = implicit_volume_config(dict(system.get("geometry", {})))
        self.hg = self.geo_cfg.hashgrid
        rend = dict(system.get("renderer", {}))
        self.rcfg = NeRFRendererConfig(
            radius=self.geo_cfg.radius,
            num_samples_coarse=int(rend.get("num_samples_coarse", 64)),
            num_samples_fine=int(rend.get("num_samples_fine", 64)),
            estimator=str(rend.get("estimator", "importance")),
            grid_resolution=int(rend.get("grid_resolution", 32)),
            occ_candidates=int(rend.get("occ_candidates", 192)),
            occ_samples=int(rend.get("occ_samples", 64)),
            occ_thre=float(rend.get("occ_thre", 0.01)),
            grid_update_every=int(rend.get("grid_update_every", 16)))
        self.material = DiffuseWithPointLightMaterial()
        self.adam = adam_args(system)
        self.losses = _loss_config(Zero123Losses, system)
        self.guidance = par.shard_guidance(maybe_build_guidance(system, device=dev))
        self.bank = guidance_fn = None
        if self.guidance is not None:
            self.bank = self.guidance.prepare_embeddings(self.data.ref_batch()["ref_rgb"])
            guidance_fn = sds_guidance_fn(self.guidance, par=par)
        self.guidance_eval_every = int(dict(system.get("freq", {})).get("guidance_eval", 0))
        self._train_step = make_zero123_train_step(self.geo_cfg, self.rcfg, self.losses,
                                                    self.material, guidance_fn, device=dev, par=par)
        self._image_renderer = make_image_renderer(self.geo_cfg, self.rcfg, self.material)
        params = init_implicit_volume(self.geo_cfg, torch.Generator(device=dev).manual_seed(int(cfg.seed)),
                                      device=dev)
        self.state = init_nerf_state(params, **self.adam, device=dev)
        par.replicate(tree_leaves(self.state.geo_params))
        self.generator = torch.Generator(device=dev).manual_seed(int(cfg.seed) + 1)
        self.ambient_only_steps = int(system.get("material", {}).get("ambient_only_steps", 0))
        self.occ_state = self._occ_update = None
        if self.rcfg.estimator == "occgrid":
            self.occ_state = init_occgrid(self.rcfg, device=dev)
            self._occ_update = make_occgrid_update(self.geo_cfg, self.rcfg, device=dev)
        self.ref_light = torch.tensor([0.0, 0.0, 3.0], device=dev)

    def train_batch(self, step: int) -> dict:
        """The step's batch: the flattened reference view and the random
        views of the step's milestone."""
        batch = self.data.train_batch(step)
        b = {"ref_rays_o": batch["ref_rays_o"].reshape(-1, 3),
             "ref_rays_d": batch["ref_rays_d"].reshape(-1, 3),
             "ref_rgb": batch["ref_rgb"].reshape(-1, 3),
             "ref_mask": batch["ref_mask"].reshape(-1, 1),
             "ref_light": self.ref_light,
             "rand_rays_o": batch["rays_o"], "rand_rays_d": batch["rays_d"]}
        for k in ("light_positions", "elevation", "azimuth", "camera_distances"):
            b[k] = batch[k]
        if "ref_depth" in batch:
            b["ref_depth"] = batch["ref_depth"].reshape(-1, 1)
        if "ref_normal" in batch:
            b["ref_normal"] = batch["ref_normal"].reshape(-1, 3)
        return b

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        batch = self.train_batch(step)
        lm = progressive_level_mask(self.hg, step)
        ambient = 1.0 if step < self.ambient_only_steps else 0.1 + 0.9 * float(np.random.rand())
        if self._occ_update is not None and step % self.rcfg.grid_update_every == 0:
            self.occ_state = self._occ_update(self.occ_state, self.state.geo_params, self.generator,
                                              torch.as_tensor(lm, device=self.device))
        self.state, metrics = self._train_step(self.state, _shard(self.par, batch, RAND_RAY_KEYS),
                                               self.generator, lm, ambient, self.bank, self.occ_state)
        if (self.guidance_eval_every > 0 and self.guidance is not None
                and (step + 1) % self.guidance_eval_every == 0):
            # the first random view again (the step's own render is inside its
            # loss), on every rank; rank 0's saver writes
            out = self._image_renderer(self.state.geo_params, batch["rand_rays_o"][0],
                                       batch["rand_rays_d"][0], batch["light_positions"][0],
                                       torch.ones(3, device=self.device), level_mask=lm,
                                       ambient_ratio=1.0)
            guidance_eval_snapshot(self.saver, self.guidance, self.bank, self.generator,
                                   out["comp_rgb"][None], batch["elevation"], batch["azimuth"],
                                   batch["camera_distances"], step + 1)
        return metrics

    def validate(self, step: int, test: bool = False) -> None:
        """4 orbit views at min(eval_height, 128)² as one image grid,
        ``it{step}-nerf.png`` (also for ``test``, as in the JAX package)."""
        R = min(int(self.data.cfg.random_camera.eval_height), 128)
        orbit = self.data.random_sampler.orbit(n_views=4, height=R, width=R)
        fovy = math.radians(self.data.cfg.default_fovy_deg)
        dirs = get_ray_directions(R, R, 0.5 * R / math.tan(0.5 * fovy), device=self.device)
        white = torch.ones(3, device=self.device)
        frames = []
        for i in range(4):
            ro, rd = get_rays(dirs, orbit["c2w"][i], keepdim=True)
            out = self._image_renderer(self.state.geo_params, ro, rd, self.ref_light, white,
                                       ambient_ratio=1.0)
            frames.append(out["comp_rgb"].cpu().numpy())
        self.saver.save_image_grid(f"it{step}-nerf.png", [{"type": "rgb", "img": f} for f in frames])


EXPERIMENTS = {"sugar-static-system": SugarStaticExperiment,
               "sugar-4dgen-system": Sugar4DGenExperiment,
               "zero123-system": Zero123Experiment}


def build_experiment(cfg, device="cuda"):
    """The experiment of ``cfg.system_type`` on ``device``; sugar-static-system
    dispatches on ``system.stage``: ``gaussian`` runs :class:`GaussianStageExperiment`,
    ``sugar`` (the default) the bound refine.  The zoo's systems come from
    ``assembly_zoo``."""
    from . import assembly_zoo  # noqa: F401  (adds the zoo's systems to EXPERIMENTS)

    if cfg.system_type not in EXPERIMENTS:
        raise KeyError(f"Unknown system_type {cfg.system_type!r}; known: {sorted(EXPERIMENTS)}")
    cls = EXPERIMENTS[cfg.system_type]
    if cfg.system_type == "sugar-static-system" and str(cfg.system.get("stage", "sugar")) == "gaussian":
        cls = GaussianStageExperiment
    return cls(cfg, device=device)

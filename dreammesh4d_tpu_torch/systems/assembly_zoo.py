"""Launcher assembly of the threestudio zoo's NeRF systems (counterpart of
``dreammesh4d_tpu/systems/assembly_zoo.py``): ``dreamfusion-system``,
``magic3d-system``, ``efficient-dreamfusion-system``, ``latentnerf-system``
and ``sjc-system`` (:class:`ZooTextExperiment`), ``prolificdreamer-system``
(:class:`ZooVSDExperiment`), ``magic123-system`` and
``image-condition-dreamfusion-system`` (:class:`ZooImageExperiment`), each
run from its YAML through the port's launcher:

    python3 -m dreammesh4d_tpu_torch.launch --config configs/zoo/dreamfusion-sd.yaml --train \\
        system.prompt_processor.prompt="a test object" \\
        system.guidance.pretrained_model_name_or_path=random:0

The geometry is the YAML's implicit volume (a corner-layout hash grid by
default; 4 feature channels for latentnerf without ``refinement``), the
renderer the NeRF renderer with its defaults (64 + 64 samples a ray), Adam
from ``optimizer.args`` under ``system.scheduler`` when the YAML has one
(``systems/optim.py``; latentnerf's warm-up and decay).  The text guidance
is Stable Diffusion (``models/guidance/stable_diffusion.py``; VSD for
prolificdreamer, ``models/guidance/vsd.py``) with
``system.guidance.pretrained_model_name_or_path`` at ``""`` / ``none``
(off: the SDS term is zero), ``random[:seed]`` (random weights at the
configured widths) or an SD 1.x ``.ckpt``; a missing path raises unless
``allow_missing: true``.  Magic123's 3D prior is ``system.guidance_3d``
through ``assembly.maybe_build_guidance`` (Stable Zero123, its bank from the
reference image).  Latentnerf's sketch-shape guide is ``system.guide_shape``
(``ops/shape_loss.py``).  Every SDS and VSD call gets step 0, as in the JAX
package, so a scheduled ``min/max_step_percent`` stays at its step-0 value
(prolificdreamer's ``max_step_percent`` among them).  A ``guide_shape``
that names no file drops the shape term with a warning, as the JAX package
drops it silently.

The experiments run in one process: the launcher refuses ``trainer.devices
> 1`` for them (ROADMAP A8).

| system_type | experiment | train step |
|---|---|---|
| dreamfusion-system, magic3d-system | ZooTextExperiment | make_dreamfusion_train_step |
| efficient-dreamfusion-system | ZooTextExperiment | make_eff_dreamfusion_train_step |
| latentnerf-system | ZooTextExperiment | make_latentnerf_train_step |
| sjc-system | ZooTextExperiment | make_sjc_train_step |
| prolificdreamer-system | ZooVSDExperiment | make_prolificdreamer_train_step |
| magic123-system, image-condition-dreamfusion-system | ZooImageExperiment | make_magic123_train_step |
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict

import torch

from ..data.uncond import RandomCameraSampler
from ..models.geometry.implicit_volume import init_implicit_volume
from ..models.guidance.stable_diffusion import (PromptProcessorConfig, StableDiffusionConfig,
                                                StableDiffusionGuidance, StableDiffusionPromptProcessor)
from ..models.guidance.vsd import VSDConfig, VSDGuidance
from ..models.guidance.zero123.checkpoint import load_sd_checkpoint
from ..models.materials import DiffuseWithPointLightMaterial
from ..models.renderers.nerf_volume_renderer import NeRFRendererConfig, make_image_renderer
from ..ops.cameras import get_ray_directions, get_rays
from ..ops.shape_loss import ShapeLoss
from ..registry import register
from ..utils.saving import Saver
from ..utils.tree import tree_leaves, tree_map
from . import assembly
from .assembly import (NeRFSceneExperiment, _filtered_dataclass, _load_optimizer_state, _optimizer_state,
                       adam_args, implicit_volume_config, make_random_camera_config,
                       make_single_image_datamodule, maybe_build_guidance)
from .optim import scheduled_lr
from .threestudio_zoo import (DreamFusionLosses, ImageConditionDreamFusionSystem, Magic123Losses,
                              ProlificDreamerLosses, init_scene_state, init_vsd_state,
                              make_dreamfusion_train_step, make_eff_dreamfusion_train_step,
                              make_magic123_train_step, make_prolificdreamer_train_step)
from .threestudio_zoo2 import LatentNeRFLosses, SJCLosses, make_latentnerf_train_step, make_sjc_train_step

log = logging.getLogger(__name__)

A8 = "not ported yet (ROADMAP A8)"


def build_implicit_volume(system: dict, n_feature_dims: int = 3):
    """The implicit volume's config of ``system.geometry`` (which may set
    ``n_feature_dims``, unlike stage 1's; ``n_feature_dims`` is the default)."""
    geo = dict(system.get("geometry", {}))
    return implicit_volume_config(geo, n_feature_dims=int(geo.get("n_feature_dims", n_feature_dims)))


def maybe_build_sd_guidance(system: dict, device="cuda", guidance_cls=StableDiffusionGuidance,
                            config_cls=StableDiffusionConfig):
    """(guidance, prompt embeddings) of ``system.guidance`` /
    ``system.prompt_processor`` on ``device``, or None when the guidance is
    off (``""`` / ``none``, or a missing path with ``allow_missing: true``).
    ``random[:seed]``: random weights from a ``torch.Generator`` seeded with
    ``seed`` (the output convolutions zero unless ``zero_init: false``); any
    other path: an SD 1.x ``.ckpt`` (UNet and VAE by key name;
    its text tower is reported, not loaded).  ``guidance_cls`` /
    ``config_cls``: the guidance and its config (VSD for prolificdreamer)."""
    gcfg = dict(system.get("guidance", {}))
    path = str(gcfg.get("pretrained_model_name_or_path", "") or "")
    if not path or path.lower() == "none":
        return None
    is_random = path == "random" or path.startswith("random:")
    if not is_random and not os.path.exists(path):
        if gcfg.get("allow_missing", False):
            log.warning("SD checkpoint not found (%r) — text SDS disabled "
                        "(guidance.allow_missing=true).", path)
            return None
        raise FileNotFoundError(
            f"SD guidance checkpoint not found: {path!r}. Set "
            "system.guidance.pretrained_model_name_or_path to a Stable Diffusion 1.x .ckpt, "
            "'random[:seed]' for an SDS smoke run, or 'none' / "
            "system.guidance.allow_missing=true to train without text SDS.")
    guidance = guidance_cls(_filtered_dataclass(config_cls, gcfg), device=device)
    if is_random:
        seed = int(path.partition(":")[2] or 0)
        guidance.modules.init_params(torch.Generator(device=device).manual_seed(seed),
                                     zero_init=guidance.cfg.zero_init)
    else:
        report = load_sd_checkpoint(path, guidance.modules)
        if report["unmapped"]:
            log.warning("SD checkpoint %s: %d keys not used by the guidance, e.g. %s", path,
                        len(report["unmapped"]), report["unmapped"][:5])
        if report["text"]:
            log.info("SD checkpoint %s: %d text-tower keys not loaded (%s)", path, len(report["text"]), A8)
    pp_cfg = _filtered_dataclass(PromptProcessorConfig, dict(system.get("prompt_processor", {})))
    prompts = StableDiffusionPromptProcessor(pp_cfg, device=device)()
    return guidance, prompts


def sd_guidance_fn(pack):
    """The zoo steps' ``guidance_fn(generator, rgb, batch, rgb_as_latents=False)``:
    the SD SDS loss at step 0 (as in the JAX package), or zero without
    guidance."""
    if pack is None:
        return lambda generator, rgb, batch, rgb_as_latents=False: 0.0 * rgb.mean()
    guidance, prompts = pack

    def guidance_fn(generator, rgb, batch, rgb_as_latents=False):
        return guidance.sds_loss(prompts, rgb, batch["elevation"], batch["azimuth"],
                                 batch["camera_distances"], 0, generator,
                                 rgb_as_latents=rgb_as_latents)["loss_sds"]

    return guidance_fn


def vsd_guidance_fn(pack):
    """The prolificdreamer step's ``vsd_fn(lora, generator, rgb, batch)``: VSD
    at step 0 (as in the JAX package) with the batch's ``c2w`` flattened to
    (B, 16) as the camera condition, or zeros without guidance (the LoRA's
    gradient then zero)."""
    if pack is None:
        def off(lora, generator, rgb, batch):
            zero = 0.0 * rgb.mean()
            return {"loss_vsd": zero, "loss_lora": 0.0 * sum(v.sum() for v in tree_leaves(lora)),
                    "grad_norm": zero.detach()}

        return off
    guidance, prompts = pack

    def vsd_fn(lora, generator, rgb, batch):
        cam = batch["c2w"].reshape(batch["c2w"].shape[0], -1)
        return guidance.vsd_loss(lora, prompts, rgb, batch["elevation"], batch["azimuth"], cam, 0, generator)

    return vsd_fn


_SHAPE_LOSSES: dict = {}  # (path, mtime, size, device) -> ShapeLoss: the bake is read-only after init


def build_shape_loss(system: dict, device):
    """The sketch-shape loss of ``system.guide_shape``, or None without one;
    a path that names no file drops the term with a warning (the JAX
    package drops it silently).  The guide's grids are baked once per file
    (its path, modification time and size) and device in a process, so the
    verbs of one guide share a bake."""
    guide = str(system.get("guide_shape", "") or "")
    if not guide:
        return None
    if not os.path.exists(guide):
        log.warning("system.guide_shape %r names no file: the sketch-shape term is dropped", guide)
        return None
    st = os.stat(guide)
    key = (os.path.realpath(guide), st.st_mtime_ns, st.st_size, str(torch.device(device)))
    if key not in _SHAPE_LOSSES:
        _SHAPE_LOSSES[key] = ShapeLoss(guide, device=device)
    return _SHAPE_LOSSES[key]


class ZooNeRFBase(NeRFSceneExperiment):
    """What the zoo's NeRF experiments share: validation, the ``model.obj``
    export and the checkpoint (``NeRFSceneExperiment``)."""

    def _finish_init(self, cfg, geo_cfg, rcfg, adam, material=None):
        dev = self.device
        self.cfg = cfg
        self.geo_cfg = geo_cfg
        self.rcfg = rcfg
        self.adam = adam
        self.lr_schedule = scheduled_lr(adam["lr"], cfg.system.get("scheduler"))
        self.saver = Saver(os.path.join(cfg.trial_dir, "save"))
        self._image_renderer = make_image_renderer(geo_cfg, rcfg, material)
        params = init_implicit_volume(geo_cfg, torch.Generator(device=dev).manual_seed(int(cfg.seed)),
                                      device=dev)
        self.state = self._new_state(params)
        self.generator = torch.Generator(device=dev).manual_seed(int(cfg.seed) + 1)

    def _new_state(self, geo_params, step: int = 0):
        return init_scene_state(geo_params, **self.adam, step=step, device=self.device,
                                schedule=self.lr_schedule)

    def load_state(self, saved: dict) -> None:
        self.state = self._new_state(saved["geo_params"], int(saved["step"]))
        _load_optimizer_state(self.state.opt_state, saved["opt_state"])

    def validate(self, step: int, test: bool = False) -> None:
        """4 orbit views at min(eval_height, 128)² under a light at (0, 0, 3),
        ambient ratio 1, as one image grid ``it{step}-val.png`` (``-test``
        with ``test``)."""
        cam = self.sampler.cfg
        R = min(int(cam.eval_height), 128)
        orbit = self.sampler.orbit(n_views=4, height=R, width=R)
        fovy = math.radians(float(cam.eval_fovy_deg))
        dirs = get_ray_directions(R, R, 0.5 * R / math.tan(0.5 * fovy), device=self.device)
        light = torch.tensor([0.0, 0.0, 3.0], device=self.device)
        white = torch.ones(3, device=self.device)
        frames = []
        for i in range(4):
            ro, rd = get_rays(dirs, orbit["c2w"][i], keepdim=True)
            out = self._image_renderer(self.state.geo_params, ro, rd, light, white, ambient_ratio=1.0)
            frames.append(out["comp_rgb"][..., :3].cpu().numpy())
        self.saver.save_image_grid(f"it{step}-{'test' if test else 'val'}.png",
                                   [{"type": "rgb", "img": f} for f in frames])


@register("dreamfusion-system")
@register("magic3d-system")
@register("efficient-dreamfusion-system")
@register("latentnerf-system")
@register("sjc-system")
class ZooTextExperiment(ZooNeRFBase):
    """Text-to-3D NeRF systems: dreamfusion, magic3d (coarse),
    efficient-dreamfusion, latentnerf and sjc.  The random views come from
    the YAML's ``data`` block (``RandomCameraSampler``); efficient-dreamfusion
    renders a (H/4)² subgrid of each view (at least 8²) and resizes it to
    ``data.height`` before SDS; latentnerf renders 4 latent channels (3
    with ``refinement``) and may carry a sketch-shape guide."""

    def __init__(self, cfg, device="cuda"):
        st = cfg.system_type
        self.device = dev = torch.device(device)
        system = cfg.system
        refinement = bool(system.get("refinement", False))
        geo_cfg = build_implicit_volume(system, 4 if st == "latentnerf-system" and not refinement else 3)
        rcfg = NeRFRendererConfig(radius=geo_cfg.radius)
        adam = adam_args(system)
        self.sampler = RandomCameraSampler(make_random_camera_config(dict(cfg.data or {})), seed=cfg.seed,
                                           device=dev)
        self.pack = maybe_build_sd_guidance(system, device=dev)
        guidance_fn = sd_guidance_fn(self.pack)
        loss_d = dict(system.get("loss", {}))
        self._eff = st == "efficient-dreamfusion-system"
        self.shape_loss = None
        if self._eff:
            losses = _filtered_dataclass(DreamFusionLosses, loss_d)
            full_hw = int(dict(cfg.data or {}).get("height", 64))
            self._step = make_eff_dreamfusion_train_step(geo_cfg, rcfg, losses, guidance_fn, full_hw,
                                                         device=dev)
        elif st == "latentnerf-system":
            self.shape_loss = build_shape_loss(system, dev)
            self._step = make_latentnerf_train_step(geo_cfg, rcfg, _filtered_dataclass(LatentNeRFLosses, loss_d),
                                                    guidance_fn, refinement=refinement,
                                                    shape_loss=self.shape_loss, device=dev)
        elif st == "sjc-system":
            self._step = make_sjc_train_step(geo_cfg, rcfg, _filtered_dataclass(SJCLosses, loss_d), guidance_fn,
                                             device=dev)
        else:
            losses = _filtered_dataclass(DreamFusionLosses, loss_d)
            self._step = make_dreamfusion_train_step(geo_cfg, rcfg, losses, guidance_fn, device=dev)
        self._finish_init(cfg, geo_cfg, rcfg, adam)

    def train_batch(self, step: int) -> dict:
        """The step's random views (a subgrid of each with efficient-dreamfusion)."""
        if self._eff:
            s = max(int(self.sampler.cfg.height) // 4, 8)
            batch = self.sampler.sample_efficient(s, s)
        else:
            batch = self.sampler.sample()
        return {k: batch[k] for k in ("rays_o", "rays_d", "light_positions", "elevation", "azimuth",
                                      "camera_distances")}

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        self.state, metrics = self._step(self.state, self.train_batch(step), self.generator)
        return metrics


@register("prolificdreamer-system")
class ZooVSDExperiment(ZooNeRFBase):
    """prolificdreamer-system: VSD (``VSDGuidance``) with the scene's and the
    LoRA's Adam stepped from one backward.  The LoRA starts from a
    ``torch.Generator`` seeded with 1 (B = 0: phi is the pretrained UNet at
    step 0); its Adam is optax ``adam(optimizer.args.lr_lora)``'s.  The
    checkpoint carries the LoRA tree and both Adams' moments."""

    def __init__(self, cfg, device="cuda"):
        self.device = dev = torch.device(device)
        system = cfg.system
        geo_cfg = build_implicit_volume(system)
        rcfg = NeRFRendererConfig(radius=geo_cfg.radius)
        adam = adam_args(system)
        self.lora_lr = float(dict(system.get("optimizer", {}).get("args", {})).get("lr_lora", 1e-3))
        self.sampler = RandomCameraSampler(make_random_camera_config(dict(cfg.data or {})), seed=cfg.seed,
                                           device=dev)
        self.pack = maybe_build_sd_guidance(system, device=dev, guidance_cls=VSDGuidance, config_cls=VSDConfig)
        if self.pack is not None:
            self.lora0 = self.pack[0].init_lora_params(torch.Generator(device=dev).manual_seed(1))
        else:
            self.lora0 = {"unused": torch.zeros((1,), device=dev)}
        losses = _filtered_dataclass(ProlificDreamerLosses, dict(system.get("loss", {})))
        self._step = make_prolificdreamer_train_step(geo_cfg, rcfg, losses, vsd_guidance_fn(self.pack),
                                                     device=dev)
        self._finish_init(cfg, geo_cfg, rcfg, adam)

    def _new_state(self, geo_params, step: int = 0, lora_params=None):
        return init_vsd_state(geo_params, self.lora0 if lora_params is None else lora_params, **self.adam,
                              lora_lr=self.lora_lr, step=step, device=self.device, schedule=self.lr_schedule)

    def train_batch(self, step: int) -> dict:
        """The step's random views with their c2w (the LoRA's camera condition)."""
        batch = self.sampler.sample()
        return {k: batch[k] for k in ("rays_o", "rays_d", "light_positions", "elevation", "azimuth",
                                      "camera_distances", "c2w")}

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        self.state, metrics = self._step(self.state, self.train_batch(step), self.generator)
        return metrics

    def state_for_checkpoint(self) -> dict:
        s = self.state
        return {"geo_params": tree_map(lambda x: x.detach(), s.geo_params),
                "lora_params": tree_map(lambda x: x.detach(), s.lora_params),
                "opt_state": _optimizer_state(s.opt_state), "lora_opt_state": _optimizer_state(s.lora_opt_state),
                "step": s.step}

    def load_state(self, saved: dict) -> None:
        self.state = self._new_state(saved["geo_params"], int(saved["step"]), saved["lora_params"])
        _load_optimizer_state(self.state.opt_state, saved["opt_state"])
        _load_optimizer_state(self.state.lora_opt_state, saved["lora_opt_state"])


@register("magic123-system")
@register("image-condition-dreamfusion-system")
class ZooImageExperiment(ZooNeRFBase):
    """Image-conditioned NeRF systems: magic123 (the SD term ``sds_2d`` and
    the Stable Zero123 term ``sds_3d`` of ``system.guidance_3d``) and
    image-condition-dreamfusion (``sds_2d`` only), with the reference view's
    rgb and mask losses; shading by ``DiffuseWithPointLightMaterial``."""

    def __init__(self, cfg, device="cuda"):
        self.device = dev = torch.device(device)
        system = cfg.system
        geo_cfg = build_implicit_volume(system)
        rcfg = NeRFRendererConfig(radius=geo_cfg.radius)
        adam = adam_args(system)
        self.data = make_single_image_datamodule(cfg.data, cfg.seed, device=dev)
        self.sampler = self.data.random_sampler
        material = DiffuseWithPointLightMaterial()
        self.pack = maybe_build_sd_guidance(system, device=dev)
        g2d = sd_guidance_fn(self.pack)
        self.guidance_3d = self.bank = g3d = None
        if cfg.system_type == "magic123-system":
            self.guidance_3d = maybe_build_guidance({"guidance": dict(system.get("guidance_3d", {}))},
                                                    device=dev)
        if self.guidance_3d is not None:
            self.bank = self.guidance_3d.prepare_embeddings(self.data.ref_batch()["ref_rgb"])

            def g3d(generator, rgb, batch):
                return self.guidance_3d.sds_loss(self.bank, rgb, batch["elevation"], batch["azimuth"],
                                                 batch["camera_distances"], None, 0, generator)["loss_sds"]

        losses = _filtered_dataclass(Magic123Losses, dict(system.get("loss", {})))
        if cfg.system_type == "magic123-system":
            self._step = make_magic123_train_step(geo_cfg, rcfg, losses, guidance_2d_fn=g2d,
                                                  guidance_3d_fn=g3d, material=material, device=dev)
        else:
            self._step = ImageConditionDreamFusionSystem.make_train_step(geo_cfg, rcfg, losses, g2d,
                                                                         material=material, device=dev)
        self.ref_light = torch.tensor([0.0, 0.0, 3.0], device=dev)
        self._finish_init(cfg, geo_cfg, rcfg, adam, material)

    def train_batch(self, step: int) -> dict:
        """The flattened reference view and the step's random views."""
        rand = self.data.train_batch(step)
        ref = self.data.ref_batch()
        batch = {"ref_rays_o": ref["ref_rays_o"].reshape(-1, 3), "ref_rays_d": ref["ref_rays_d"].reshape(-1, 3),
                 "ref_rgb": ref["ref_rgb"].reshape(-1, 3), "ref_mask": ref["ref_mask"].reshape(-1, 1),
                 "ref_light": self.ref_light}
        for k in ("rays_o", "rays_d", "light_positions", "elevation", "azimuth", "camera_distances"):
            batch[k] = rand[k]
        return batch

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        self.state, metrics = self._step(self.state, self.train_batch(step), self.generator)
        return metrics


# every zoo system_type the launcher knows
ZOO_EXPERIMENTS = {name: ZooTextExperiment for name in (
    "dreamfusion-system", "magic3d-system", "efficient-dreamfusion-system", "latentnerf-system",
    "sjc-system")}
ZOO_EXPERIMENTS["prolificdreamer-system"] = ZooVSDExperiment
ZOO_EXPERIMENTS.update({name: ZooImageExperiment for name in (
    "magic123-system", "image-condition-dreamfusion-system")})


def register_zoo_experiments() -> None:
    """Add the zoo's systems to ``assembly.EXPERIMENTS``."""
    for name, cls in ZOO_EXPERIMENTS.items():
        assembly.EXPERIMENTS.setdefault(name, cls)


register_zoo_experiments()

"""The editing systems, instructnerf2nerf and control4d (counterpart of
``dreammesh4d_tpu/systems/editing.py``).

- ``instructnerf2nerf-system``: iterative dataset update.  A scene is
  fitted photometrically (L1 and perceptual terms) to views whose images
  the caller replaces, every few steps, by InstructPix2Pix edits of the
  current renders: :func:`ip2p_edit_images` (partial noising to ``edit_t``
  of the schedule, then DDIM with the three-way guidance) and
  :func:`make_in2n_train_step`.  The dataset update (``batch["edited_rgb"]``)
  stays with the caller, as in the JAX package.
- ``control4d-system`` (and ``control4d-multiview-system``): the GAN
  renderer's super-resolved output against edited images with L1,
  perceptual and hinge-GAN terms; one backward steps two Adams, the scene's
  (geometry and generator) and the discriminator's.  The generator term
  sees the discriminator's parameters detached and the discriminator's
  hinge detached images, so the discriminator's gradient is its own term's
  alone and the scene's that of L1, the perceptual term and G.

As in the zoo's steps, Adam lives in the state, the parameters are updated
in place and the random numbers come from one ``torch.Generator``; loss
weights are ``C`` schedules of the state's step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models.guidance.instructpix2pix import InstructPix2PixGuidance
from ..models.guidance.zero123.guidance import LATENT_SCALE, _draw, linspace_int_f32
from ..models.guidance.zero123.scheduler import add_noise, ddim_step
from ..registry import register
from ..utils.gan import discriminator_loss, generator_loss
from ..utils.tree import tree_leaves, tree_map, tree_to
from .threestudio_zoo import SceneTrainState, _make_step, _total, init_scene_state

# ---------------------------------------------------------------------------
# InstructPix2Pix DDIM editing (the in2n dataset update)
# ---------------------------------------------------------------------------


def edit_timesteps(diffusion_steps: int, edit_t: float, num_train_timesteps: int = 1000) -> np.ndarray:
    """The edit's DDIM timesteps: ``jnp.linspace(t_start, 1, n).astype(int32)``
    as the JAX package computes it (float32, then truncated), t_start =
    int(edit_t · (T − 1))."""
    t_start = int(edit_t * (num_train_timesteps - 1))
    if diffusion_steps == 1:
        return np.array([t_start], np.int32)
    return linspace_int_f32(t_start, 1, diffusion_steps)


@torch.no_grad()
def ip2p_edit_images(guidance: InstructPix2PixGuidance, prompts, rgb: torch.Tensor, cond_rgb: torch.Tensor,
                     elevation: torch.Tensor, azimuth: torch.Tensor, diffusion_steps: int = 20,
                     edit_t: float = 0.7, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Edit ``rgb`` (B, H, W, 3) toward the instruction: its latents noised
    to ``edit_t`` of the schedule (ε: ``noise`` (B, 4, L, L), or drawn from
    ``generator``), then ``diffusion_steps`` DDIM steps with the three-way
    guidance on ``cond_rgb``'s latents, the last step to t = 0; returns the
    decoded images (B, S, S, 3) clipped to [0, 1]."""
    mod = guidance.modules
    dev = mod.device
    sched = mod.schedule
    B = rgb.shape[0]
    latents = mod.encode_images(rgb.to(dev))
    cond_latents = mod.encode_images(cond_rgb.to(dev)) / LATENT_SCALE
    cond, uncond = prompts.get(elevation, azimuth)
    context = torch.cat([cond, uncond, uncond]).to(dev)
    ts = edit_timesteps(diffusion_steps, edit_t, sched.num_train_timesteps)
    if noise is None:
        noise = _draw(generator, tuple(latents.shape), True, dev)
    noise = noise.to(dev, torch.float32)

    def full(t):
        return torch.full((B,), int(t), dtype=torch.long, device=dev)

    x = add_noise(sched, latents, noise, full(ts[0]))
    for i in range(diffusion_steps):
        t_prev = ts[i + 1] if i + 1 < diffusion_steps else 0
        eps = guidance.guided_eps(x, full(ts[i]), cond_latents, context)
        x = ddim_step(sched, x, eps, full(ts[i]), full(t_prev))
    return mod.decode_latents(x)


# ---------------------------------------------------------------------------
# instructnerf2nerf-system
# ---------------------------------------------------------------------------


@dataclass
class In2NLosses:
    lambda_l1: Any = 10.0
    lambda_p: Any = 10.0  # perceptual


# (geo_params, Adam over its leaves, step): the zoo's scene state
In2NState = SceneTrainState
init_in2n_state = init_scene_state


def _photometric(terms, weights, losses, pred, gt, perceptual_fn):
    terms["l1"] = (pred - gt).abs().mean()
    weights["l1"] = losses.lambda_l1
    if perceptual_fn is not None:
        terms["p"] = perceptual_fn(pred, gt).mean()
        weights["p"] = losses.lambda_p


def make_in2n_train_step(render_fn: Callable, losses: In2NLosses, perceptual_fn: Optional[Callable] = None,
                         device="cuda"):
    """``train_step(state, batch, generator) -> (state, metrics)``;
    ``render_fn(geo_params, batch, generator) -> (B, H, W, 3)``;
    ``batch["edited_rgb"]`` holds the current edited view(s), which the
    caller swaps between steps; ``perceptual_fn(x, y)`` e.g. the
    ``perceptual-loss`` component."""
    dev = torch.device(device)

    def loss_fn(geo_params, batch, generator, step):
        rgb = render_fn(geo_params, batch, generator)
        terms: Dict[str, torch.Tensor] = {}
        weights: Dict[str, Any] = {}
        _photometric(terms, weights, losses, rgb, batch["edited_rgb"], perceptual_fn)
        return _total(terms, weights, step, dev)

    return _make_step(loss_fn, device)


@register("instructnerf2nerf-system")
class InstructNeRF2NeRFSystem:
    """Holds its config, as the JAX package's class (the step is
    :func:`make_in2n_train_step`)."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg


# ---------------------------------------------------------------------------
# control4d-system
# ---------------------------------------------------------------------------


@dataclass
class Control4DLosses:
    lambda_l1: Any = 10.0
    lambda_p: Any = 10.0
    lambda_G: Any = 1.0  # generator hinge
    lambda_D: Any = 1.0  # discriminator hinge


class Control4DState(NamedTuple):
    scene_params: Any  # geometry and the GAN renderer's networks; leaves require grad
    disc_params: Any  # the discriminator's tree
    opt_state: torch.optim.Optimizer  # Adam over the scene's leaves
    disc_opt_state: torch.optim.Optimizer  # Adam over the discriminator's
    step: int


def init_control4d_state(scene_params, disc_params, lr: float = 1e-2, disc_lr: float = 1e-3,
                         betas=(0.9, 0.99), eps: float = 1e-8, device="cuda") -> Control4DState:
    """Both trees copied to ``device`` as leaves that require grad, each
    with its Adam (``lr`` / ``disc_lr``, shared ``betas`` and ``eps``), zero
    moments, step 0."""
    dev = torch.device(device)

    def leaves(tree):
        return tree_map(lambda x: x.detach().to(dev).clone().requires_grad_(True), tree)

    scene, disc = leaves(scene_params), leaves(disc_params)
    return Control4DState(scene, disc, torch.optim.Adam(tree_leaves(scene), lr=lr, betas=betas, eps=eps),
                          torch.optim.Adam(tree_leaves(disc), lr=disc_lr, betas=betas, eps=eps), 0)


def make_control4d_train_step(render_fn: Callable, losses: Control4DLosses,
                              perceptual_fn: Optional[Callable] = None, device="cuda"):
    """``train_step(state, batch, generator) -> (state, metrics)``;
    ``render_fn(scene_params, batch, generator) -> {"comp_gan_rgb", …}``
    (the GAN renderer around the base renderer); ``batch["edited_rgb"]``
    the edited targets."""
    dev = torch.device(device)

    def train_step(state: Control4DState, batch, generator: torch.Generator):
        batch = tree_to(batch, dev)
        state.opt_state.zero_grad(set_to_none=True)
        state.disc_opt_state.zero_grad(set_to_none=True)
        fake = render_fn(state.scene_params, batch, generator)["comp_gan_rgb"]
        gt = batch["edited_rgb"]
        terms: Dict[str, torch.Tensor] = {}
        weights: Dict[str, Any] = {}
        _photometric(terms, weights, losses, fake, gt, perceptual_fn)
        terms["G"] = generator_loss(tree_map(torch.Tensor.detach, state.disc_params), fake)
        weights["G"] = losses.lambda_G
        terms["D"] = discriminator_loss(state.disc_params, gt, fake)
        weights["D"] = losses.lambda_D
        loss, metrics = _total(terms, weights, state.step, dev)
        loss.backward()
        state.opt_state.step()
        state.disc_opt_state.step()
        return Control4DState(state.scene_params, state.disc_params, state.opt_state, state.disc_opt_state,
                              state.step + 1), metrics

    return train_step


@register("control4d-multiview-system")
@register("control4d-system")
class Control4DSystem:
    """Holds its config, as the JAX package's class (the step is
    :func:`make_control4d_train_step`)."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg

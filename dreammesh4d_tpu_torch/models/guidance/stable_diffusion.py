"""Stable Diffusion SDS guidance (text-conditioned) and its prompt processor
(counterpart of ``dreammesh4d_tpu/models/guidance/stable_diffusion.py``).

- The UNet is the Zero123 UNet (``zero123/unet.py``) with ``in_channels=4``
  and a text context (768 wide, 77 tokens: CLIP ViT-L text); the VAE is
  ``zero123/vae.py``.  Their ``state_dict()`` is a Stable Diffusion 1.x LDM
  checkpoint's ``model.diffusion_model.*`` / ``first_stage_model.*``.
- Prompts: without a text encoder (none is ported), each prompt's embedding
  is read from the cache directory (``<cache_dir>/<md5 of [model] prompt>.npy``,
  the file the JAX package's processor writes), from ``embeddings_path``, or
  is the deterministic hash embedding (sha256 of the text → a
  ``np.random.RandomState`` draw), bit-equal to the JAX package's.
  View-dependent prompting picks front / side / back / overhead rows by
  azimuth and elevation; prompt debiasing scores words with the JAX
  package's hash probe.
- SDS: the render resized to ``image_size`` (``ops.resize``, bilinear),
  VAE-encoded (× 0.18215), or with ``rgb_as_latents`` resized to the latent
  size as the latents themselves; t ~ U[min_step, max_step]; the UNet on the
  classifier-free-guidance batch (uncond first); w(t) by
  ``weighting_strategy`` (``sds`` 1 − ᾱ_t, ``uniform`` 1, ``fantasia3d``
  √ᾱ_t (1 − ᾱ_t)); the reparameterised MSE whose gradient in the latents is
  w(t) (ε̂ − ε) / B.

What needs ``transformers`` or a tokenizer directory is refused with a
``RuntimeError`` (ROADMAP A8): a text tower (``use_text_encoder``,
``encode_tokens``), computing embeddings from a tokenizer directory, and a
BERT directory for debiasing.  Tensors are NCHW inside; renders come in as
(B, H, W, 3) in [0, 1]; the guidance's weights are frozen.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops.resize import resize_hw
from ...registry import register
from .zero123.guidance import DTYPES, LATENT_SCALE, _draw, _Holder, sds_timesteps
from .zero123.scheduler import add_noise, make_schedule
from .zero123.unet import UNetModel, init_weights, set_compute_dtype
from .zero123.vae import AutoencoderKL

log = logging.getLogger(__name__)

A8 = "not ported yet (ROADMAP A8)"


def _filtered(cls, cfg: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dict(cfg).items() if k in names})


# ---------------------------------------------------------------------------
# Prompt processing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PromptProcessorConfig:
    prompt: str = "a high quality photo"
    negative_prompt: str = ""
    pretrained_model_name_or_path: str = ""
    use_view_dependent_prompting: bool = True
    overhead_threshold: float = 60.0
    front_threshold: float = 45.0
    back_threshold: float = 45.0
    context_dim: int = 768
    seq_len: int = 77
    embeddings_path: str = ""  # optional .npz of precomputed embeddings, keyed by prompt
    use_cache: bool = True
    cache_dir: str = ".threestudio_cache/text_embeddings"
    use_prompt_debiasing: bool = False
    pretrained_model_name_or_path_prompt_debiasing: str = "bert-base-uncased"
    prompt_debiasing_mask_ids: Optional[tuple] = None  # word indices to consider


class PromptEmbeddings:
    """``cond`` (5, L, C) for [base, front, side, back, overhead] and
    ``uncond`` (L, C); :meth:`get` picks each view's row."""

    def __init__(self, cond: torch.Tensor, uncond: torch.Tensor, cfg: PromptProcessorConfig):
        self.cond = cond
        self.uncond = uncond
        self.cfg = cfg

    def view_index(self, elevation: torch.Tensor, azimuth: torch.Tensor) -> torch.Tensor:
        """(B,) row of each view: front |az| < front_threshold, back |az| >
        180 − back_threshold, else side; overhead above overhead_threshold;
        0 (the base prompt) without view-dependent prompting."""
        cfg = self.cfg
        if not cfg.use_view_dependent_prompting:
            return torch.zeros(elevation.shape[0], dtype=torch.long, device=elevation.device)
        az = torch.remainder(azimuth + 180.0, 360.0) - 180.0
        idx = torch.where(az.abs() < cfg.front_threshold, 1,
                          torch.where(az.abs() > 180.0 - cfg.back_threshold, 3, 2))
        return torch.where(elevation > cfg.overhead_threshold, 4, idx).long()

    def get(self, elevation: torch.Tensor, azimuth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cond (B, L, C), uncond (B, L, C)) of the views."""
        idx = self.view_index(elevation.to(self.cond.device), azimuth.to(self.cond.device))
        cond = self.cond[idx]
        return cond, self.uncond.expand(cond.shape)


def _hash_embedding(text: str, seq_len: int, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "little")
    rng = np.random.RandomState(seed)
    return rng.randn(seq_len, dim).astype(np.float32) * 0.02


def hash_prompt(model: str, prompt: str) -> str:
    """The cache file's key of ``prompt`` under ``model``."""
    return hashlib.md5(f"[{model}] {prompt}".encode()).hexdigest()


def _hash_probe(prompt: str) -> np.ndarray:
    """The debiasing probe without a language model: view pseudo-probabilities
    from the text's hash (the JAX package's fallback)."""
    seed = int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:4], "little")
    p = np.random.RandomState(seed).rand(4).astype(np.float64) + 0.25
    return p / p.sum()


@register("stable-diffusion-prompt-processor")
@register("deep-floyd-prompt-processor")
class StableDiffusionPromptProcessor:
    """``processor()`` → :class:`PromptEmbeddings` on ``device``.  Also
    ``deep-floyd-prompt-processor``, as in the JAX package (DeepFloyd's
    YAMLs set ``context_dim: 4096``)."""

    _DEBIAS_VIEWS = ("side", "front", "back", "overhead")

    def __init__(self, cfg: PromptProcessorConfig | dict | None = None, device="cuda"):
        if isinstance(cfg, dict):
            cfg = _filtered(PromptProcessorConfig, cfg)
        self.cfg = cfg or PromptProcessorConfig()
        self.device = torch.device(device)

    def _cache_path(self, text: str) -> str:
        return os.path.join(self.cfg.cache_dir,
                            f"{hash_prompt(self.cfg.pretrained_model_name_or_path, text)}.npy")

    def _has_text_encoder(self) -> bool:
        p = str(self.cfg.pretrained_model_name_or_path)
        return bool(p) and os.path.isdir(p) and (
            os.path.exists(os.path.join(p, "tokenizer_config.json"))
            or os.path.exists(os.path.join(p, "tokenizer.json")))

    def prepare_text_embeddings(self, prompts) -> None:
        """Computing embeddings with a CLIP text encoder: refused."""
        raise RuntimeError(f"text embeddings from {self.cfg.pretrained_model_name_or_path!r}: the CLIP "
                           f"text encoder is {A8}; write the cache files "
                           f"(<cache_dir>/<hash_prompt>.npy) or drop the tokenizer directory")

    def _embed(self, text: str) -> np.ndarray:
        cfg = self.cfg
        if os.path.exists(self._cache_path(text)):
            return np.load(self._cache_path(text))
        if cfg.embeddings_path:
            data = np.load(cfg.embeddings_path)
            if text in data:
                return np.asarray(data[text], np.float32)
        return _hash_embedding(text, cfg.seq_len, cfg.context_dim)

    def _bert_modulate_fn(self):
        """``modulate(prompt) -> (4,)`` view probabilities: the hash probe;
        a BERT directory is refused."""
        path = str(self.cfg.pretrained_model_name_or_path_prompt_debiasing)
        if os.path.isdir(path):
            raise RuntimeError(f"prompt debiasing with the masked LM in {path!r} is {A8}")
        return _hash_probe

    def get_debiased_prompt(self, prompt: str, modulate=None) -> list:
        """Per-view word-pruned prompts [side, front, back, overhead]: a view
        whose pointwise mutual information full / ((part + full) / 2) drops
        below 0.95 without a word has that word removed from its prompt."""
        modulate = modulate or self._bert_modulate_fn()
        words = prompt.split(" ")
        prompts = [list(words) for _ in self._DEBIAS_VIEWS]
        full_probe = np.asarray(modulate(prompt), np.float64)
        mask_ids = (list(self.cfg.prompt_debiasing_mask_ids)
                    if self.cfg.prompt_debiasing_mask_ids is not None else list(range(len(words))))
        for idx in mask_ids:
            part = " ".join(words[:idx] + words[idx + 1:])
            part_probe = np.asarray(modulate(part), np.float64)
            pmi = full_probe / (0.5 * (part_probe + full_probe))
            for i in range(len(self._DEBIAS_VIEWS)):
                if pmi[i] < 0.95:
                    prompts[i][idx] = ""
        out = [" ".join(w for w in p if w) for p in prompts]
        for view, dp in zip(self._DEBIAS_VIEWS, out):
            log.info("Debiased prompt of the %s view is [%s]", view, dp)
        return out

    def view_prompts(self) -> list:
        """[base, front, side, back, overhead] prompts."""
        cfg = self.cfg
        if cfg.use_prompt_debiasing:
            side_p, front_p, back_p, over_p = self.get_debiased_prompt(cfg.prompt)
        else:
            side_p = front_p = back_p = over_p = cfg.prompt
        return [cfg.prompt, f"{front_p}, front view", f"{side_p}, side view", f"{back_p}, back view",
                f"{over_p}, overhead view"]

    def __call__(self) -> PromptEmbeddings:
        cfg = self.cfg
        views = self.view_prompts()
        if self._has_text_encoder():
            missing = [p for p in views + [cfg.negative_prompt]
                       if not (cfg.use_cache and os.path.exists(self._cache_path(p)))]
            if missing:
                self.prepare_text_embeddings(missing)
        cond = torch.as_tensor(np.stack([self._embed(v) for v in views]), device=self.device)
        uncond = torch.as_tensor(self._embed(cfg.negative_prompt), device=self.device)
        return PromptEmbeddings(cond, uncond, cfg)


# ---------------------------------------------------------------------------
# Guidance
# ---------------------------------------------------------------------------


@dataclass
class StableDiffusionConfig:
    pretrained_model_name_or_path: str = ""
    guidance_scale: float = 100.0
    grad_clip: Optional[float] = None
    min_step_percent: Any = 0.02
    max_step_percent: Any = 0.98
    weighting_strategy: str = "sds"  # sds | uniform | fantasia3d
    num_train_timesteps: int = 1000
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    num_heads: int = 8
    context_dim: int = 768
    latent_size: int = 64
    image_size: int = 512
    vae_ch: int = 128
    vae_ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    vae_num_res_blocks: int = 2
    use_text_encoder: bool = False  # the CLIP text tower: refused (ROADMAP A8)
    dtype: Any = torch.float32
    # random[:seed] keeps the LDM's zero-initialised output convolutions (a
    # port key, as Stable Zero123's: false draws them, so that VSD is not zero)
    zero_init: bool = True

    def __post_init__(self):
        # "float16"/"fp16" run in bfloat16, as in the JAX package
        if isinstance(self.dtype, str):
            try:
                self.dtype = DTYPES[self.dtype.lower()]
            except KeyError:
                raise ValueError(f"guidance.dtype {self.dtype!r} not in {sorted(DTYPES)}")
        self.channel_mult = tuple(self.channel_mult)
        self.vae_ch_mult = tuple(self.vae_ch_mult)


class StableDiffusionModules(nn.Module):
    """The UNet (``in_channels`` in, ``out_channels`` out: 4 and 4 for
    Stable Diffusion; text context) and, with ``vae``, the VAE on
    ``device``, frozen; ``state_dict()`` is the SD LDM checkpoint's layout
    for these two.  Uninitialised until :meth:`init_params` or a load."""

    def __init__(self, cfg: StableDiffusionConfig, device="cuda", in_channels: int = 4, out_channels: int = 4,
                 vae: bool = True):
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            unet = UNetModel(in_channels=in_channels, out_channels=out_channels, model_channels=cfg.model_channels,
                             channel_mult=cfg.channel_mult, num_res_blocks=cfg.num_res_blocks,
                             num_heads=cfg.num_heads, context_dim=cfg.context_dim)
            self.model = _Holder(diffusion_model=unet)
            if vae:
                self.first_stage_model = AutoencoderKL(embed_dim=4, ch=cfg.vae_ch, ch_mult=cfg.vae_ch_mult,
                                                       num_res_blocks=cfg.vae_num_res_blocks)
        self.to_empty(device=torch.device(device))
        self.requires_grad_(False)
        set_compute_dtype(self, cfg.dtype)
        self.schedule = make_schedule(cfg.num_train_timesteps, device=device)

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    @property
    def vae(self) -> Optional[AutoencoderKL]:
        return getattr(self, "first_stage_model", None)

    @property
    def device(self) -> torch.device:
        return self.unet.time_embed[0].weight.device

    def zero_init_names(self) -> list:
        return [f"model.diffusion_model.{n}" for n in self.unet.zero_init_names()]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator, zero_init: bool = True) -> "StableDiffusionModules":
        """Random weights drawn from ``generator`` (``unet.init_weights``).
        ``zero_init`` keeps the LDM's zero-initialised output convolutions,
        as the JAX package's ``init_params`` does (the UNet then returns
        zeros); without it they are drawn too."""
        init_weights(self, generator, set(self.zero_init_names()) if zero_init else set())
        return self

    def encode_images(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] → latents (B, 4, L, L) × 0.18215, the
        posterior mean, differentiable in ``rgb`` (float32, or float64 where
        the VAE computes in float64)."""
        S = self.cfg.image_size
        img = (resize_hw(rgb, S, S, "bilinear") * 2.0 - 1.0).permute(0, 3, 1, 2)
        latents = self.vae.encode_moments(img)[0] * LATENT_SCALE
        return latents if latents.dtype == torch.float64 else latents.float()

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, 4, L, L) latents × 0.18215 → (B, S, S, 3) images clipped to
        [0, 1]."""
        img = self.vae.decode(latents / LATENT_SCALE)
        img = img if img.dtype == torch.float64 else img.float()
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)


@register("stable-diffusion-guidance")
class StableDiffusionGuidance:
    def __init__(self, cfg: StableDiffusionConfig | dict | None = None,
                 modules: Optional[StableDiffusionModules] = None, device="cuda"):
        if isinstance(cfg, dict):
            cfg = _filtered(StableDiffusionConfig, cfg)
        self.cfg = cfg or StableDiffusionConfig()
        if self.cfg.use_text_encoder:
            raise RuntimeError(f"guidance.use_text_encoder: the CLIP text tower is {A8}")
        self.modules = modules if modules is not None else self.make_modules(self.cfg, device)

    @staticmethod
    def make_modules(cfg: StableDiffusionConfig, device) -> StableDiffusionModules:
        """The guidance's networks (the UNet and the VAE here; a subclass
        with other networks overrides this)."""
        return StableDiffusionModules(cfg, device=device)

    def encode_tokens(self, input_ids):
        raise RuntimeError(f"encode_tokens: the CLIP text tower is {A8}")

    def encode_images(self, rgb: torch.Tensor) -> torch.Tensor:
        return self.modules.encode_images(rgb)

    def _weight(self, t: torch.Tensor) -> torch.Tensor:
        acp = self.modules.schedule.alphas_cumprod[t]
        strategy = self.cfg.weighting_strategy
        if strategy == "sds":
            w = 1.0 - acp
        elif strategy == "uniform":
            w = torch.ones_like(acp)
        elif strategy == "fantasia3d":
            w = torch.sqrt(acp) * (1 - acp)
        else:
            raise ValueError(strategy)
        return w.reshape(-1, 1, 1, 1)

    def sds_loss(self, prompts: PromptEmbeddings, rgb: torch.Tensor, elevation: torch.Tensor,
                 azimuth: torch.Tensor, camera_distances: torch.Tensor, step: int,
                 generator: Optional[torch.Generator] = None, rgb_as_latents: bool = False,
                 u: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """SDS of ``rgb`` (B, H, W, C).  ``u`` (B,) in [0, 1) picks t and
        ``noise`` (B, 4, L, L) is ε; each is drawn from ``generator`` (u
        first) when not given.  Returns ``loss_sds`` (its gradient reaches
        ``rgb``), ``grad_norm``, ``min_step``, ``max_step`` and ``t``."""
        cfg, mod = self.cfg, self.modules
        sched = mod.schedule
        dev = mod.device
        T = sched.num_train_timesteps
        B = rgb.shape[0]
        if rgb_as_latents:
            L = cfg.latent_size
            latents = (resize_hw(rgb.to(dev), L, L, "bilinear") * 2 - 1).permute(0, 3, 1, 2)
        else:
            latents = mod.encode_images(rgb.to(dev))
        with torch.no_grad():
            cond, uncond = prompts.get(elevation, azimuth)
            context = torch.cat([uncond, cond]).to(dev)
            if u is None:
                u = _draw(generator, (B,), False, dev)
            if noise is None:
                noise = _draw(generator, tuple(latents.shape), True, dev)
            noise = noise.to(dev, torch.float32)
            t, min_p, max_p = sds_timesteps(cfg, u.to(dev, torch.float32), step, T)
            latents_noisy = add_noise(sched, latents.detach(), noise, t)
            x_in = torch.cat([latents_noisy, latents_noisy])
            e_u, e_c = mod.unet(x_in, torch.cat([t, t]), context).chunk(2)
            eps = e_u + cfg.guidance_scale * (e_c - e_u)
            grad = torch.nan_to_num(self._weight(t) * (eps - noise))
            if cfg.grad_clip is not None:
                grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
            target = latents.detach() - grad
        loss_sds = 0.5 * ((latents - target) ** 2).sum() / B
        return {"loss_sds": loss_sds, "grad_norm": torch.linalg.norm(grad),
                "min_step": min_p * T, "max_step": max_p * T, "t": t}

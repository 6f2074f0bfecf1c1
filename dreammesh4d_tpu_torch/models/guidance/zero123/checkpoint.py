"""Load a Stable Zero123 ``.ckpt`` into the port's guidance modules
(counterpart of ``load_zero123_checkpoint`` in
``dreammesh4d_tpu/models/guidance/zero123/convert.py``).

The modules' own ``state_dict()`` is the checkpoint's LDM layout, so loading
is by key name: ``model.diffusion_model.*`` → UNet, ``first_stage_model.*``
→ VAE, ``cc_projection.*`` → the projection, ``cond_stage_model.model.
visual.*`` → CLIP.  Every other key is ``skipped`` when it matches
``EXPECTED_SKIP`` (schedule buffers, EMA shadows, the text tower, the VAE's
loss heads) and ``unmapped`` otherwise.

The Stable Diffusion 1.x loader (:func:`load_sd_checkpoint`, counterpart of
``load_sd_checkpoint`` / ``convert_sd_state_dict``) takes the UNet and the
VAE into a ``StableDiffusionModules`` by key name the same way; its skip
list is ``SD_EXPECTED_SKIP``, and the CLIP text tower's keys
(``cond_stage_model.transformer.text_model.*``), which the JAX converter
converts, are reported under ``text`` and not loaded: the text tower is not
ported (ROADMAP A8).

The JAX package's loaders also restore an orbax cache directory; the port
reads only the torch checkpoint and refuses a directory.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

# the keys a checkpoint rightly carries that the guidance does not use
EXPECTED_SKIP = [
    r"^betas$", r"^alphas_cumprod", r"^sqrt_", r"^log_one_minus_",
    r"^posterior_", r"^logvar$", r"^model_ema\.",
    r"^cond_stage_model\.model\.(?!visual\.)",
    r"^cond_stage_model\.(?!model\.)",
    r"^first_stage_model\.loss\.",
]
_SKIP_RE = [re.compile(p) for p in EXPECTED_SKIP]
SD_EXPECTED_SKIP = [
    r"^betas$", r"^alphas_cumprod", r"^sqrt_", r"^log_one_minus_",
    r"^posterior_", r"^logvar$", r"^model_ema\.",
    r"\.position_ids$",
    r"^cond_stage_model\.transformer\.text_model\.embeddings\.position_ids$",
    r"^first_stage_model\.loss\.",
]
_SD_SKIP_RE = [re.compile(p) for p in SD_EXPECTED_SKIP]
SD_TEXT_PREFIX = "cond_stage_model.transformer.text_model."


def _torch_load(path: str) -> Dict[str, object]:
    if os.path.isdir(path):
        raise ValueError(f"{path!r} is a directory: the JAX package's converted (orbax) caches are "
                         "not readable by the PyTorch port; pass the torch .ckpt itself")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt)


def _check_keys(sd, wanted, unmapped, strict: bool) -> None:
    """``KeyError`` for a key the modules need and ``sd`` lacks, and with
    ``strict`` for an unmapped key."""
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"{len(missing)} guidance weights missing from the state dict (layout or "
                       f"config mismatch?), e.g. {missing[:5]}")
    if strict and unmapped:
        raise KeyError("Checkpoint keys not mapped by the loader (layout mismatch?):\n  "
                       + "\n  ".join(sorted(unmapped)))


def _tensors(sd, wanted) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(sd[k]) if not torch.is_tensor(sd[k]) else sd[k])
            for k in wanted}


def load_ldm_state_dict(modules, sd: Dict[str, object], strict: bool = False) -> Dict[str, list]:
    """Load the LDM-layout state dict ``sd`` (tensors or numpy arrays) into
    ``modules`` (a ``Zero123Modules``) and return the report ``{"consumed",
    "skipped", "unmapped"}`` of its keys.  A key the modules need and ``sd``
    lacks raises ``KeyError``; so do unmapped keys with ``strict``.  Without
    CLIP, ``clip_proj`` is the JAX loader's mean-colour projector
    (``np.random.default_rng(0)``, N(0, 0.02²))."""
    wanted = modules.ldm_keys()
    consumed = set(wanted)
    skipped, unmapped = [], []
    for k in sd:
        if k not in consumed:
            (skipped if any(r.search(k) for r in _SKIP_RE) else unmapped).append(k)
    _check_keys(sd, wanted, unmapped, strict)
    state = _tensors(sd, wanted)
    if modules.clip is None:
        rng = np.random.default_rng(0)
        state["clip_proj"] = torch.as_tensor(
            rng.normal(0, 0.02, (3, modules.cfg.context_dim)).astype(np.float32))
    modules.load_state_dict(state)
    return {"consumed": sorted(consumed), "skipped": sorted(skipped), "unmapped": sorted(unmapped)}


def load_zero123_checkpoint(path: str, modules, strict: bool = False) -> Dict[str, list]:
    """``torch.load`` a Stable Zero123 ``.ckpt`` (its ``state_dict`` entry,
    or the file itself when it is the state dict) into ``modules``; returns
    the key report of :func:`load_ldm_state_dict`."""
    return load_ldm_state_dict(modules, _torch_load(path), strict=strict)


def load_sd_state_dict(modules, sd: Dict[str, object], strict: bool = False) -> Dict[str, list]:
    """Load a Stable Diffusion 1.x LDM state dict into ``modules`` (a
    ``StableDiffusionModules``): ``model.diffusion_model.*`` and
    ``first_stage_model.*`` by key name.  Returns ``{"consumed", "skipped",
    "unmapped", "text"}``: ``text`` holds the CLIP text tower's keys, which
    the JAX converter consumes and the port does not load."""
    wanted = list(modules.state_dict())
    consumed = set(wanted)
    skipped, unmapped, text = [], [], []
    for k in sd:
        if k in consumed:
            continue
        if any(r.search(k) for r in _SD_SKIP_RE):
            skipped.append(k)
        elif k.startswith(SD_TEXT_PREFIX):
            text.append(k)
        else:
            unmapped.append(k)
    _check_keys(sd, wanted, unmapped, strict)
    modules.load_state_dict(_tensors(sd, wanted))
    return {"consumed": sorted(consumed), "skipped": sorted(skipped), "unmapped": sorted(unmapped),
            "text": sorted(text)}


def load_sd_checkpoint(path: str, modules, strict: bool = False) -> Dict[str, list]:
    """``torch.load`` a Stable Diffusion 1.x ``.ckpt`` into ``modules``;
    returns the key report of :func:`load_sd_state_dict`.  A directory (a
    diffusers layout or the JAX package's orbax cache) raises."""
    return load_sd_state_dict(modules, _torch_load(path), strict=strict)

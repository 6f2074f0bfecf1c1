"""Load a Stable Zero123 ``.ckpt`` into the port's guidance modules
(counterpart of ``load_zero123_checkpoint`` in
``dreammesh4d_tpu/models/guidance/zero123/convert.py``).

The modules' own ``state_dict()`` is the checkpoint's LDM layout, so loading
is by key name: ``model.diffusion_model.*`` → UNet, ``first_stage_model.*``
→ VAE, ``cc_projection.*`` → the projection, ``cond_stage_model.model.
visual.*`` → CLIP.  Every other key is ``skipped`` when it matches
``EXPECTED_SKIP`` (schedule buffers, EMA shadows, the text tower, the VAE's
loss heads) and ``unmapped`` otherwise.

The JAX package's loader also restores an orbax cache directory; the port
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


def load_ldm_state_dict(modules, sd: Dict[str, object], strict: bool = False) -> Dict[str, list]:
    """Load the LDM-layout state dict ``sd`` (tensors or numpy arrays) into
    ``modules`` (a ``Zero123Modules``) and return the report ``{"consumed",
    "skipped", "unmapped"}`` of its keys.  A key the modules need and ``sd``
    lacks raises ``KeyError``; so do unmapped keys with ``strict``.  Without
    CLIP, ``clip_proj`` is the JAX loader's mean-colour projector
    (``np.random.default_rng(0)``, N(0, 0.02²))."""
    wanted = modules.ldm_keys()
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"{len(missing)} guidance weights missing from the state dict (layout or "
                       f"config mismatch?), e.g. {missing[:5]}")
    consumed = set(wanted)
    skipped, unmapped = [], []
    for k in sd:
        if k not in consumed:
            (skipped if any(r.search(k) for r in _SKIP_RE) else unmapped).append(k)
    if strict and unmapped:
        raise KeyError("Checkpoint keys not mapped by the loader (layout mismatch?):\n  "
                       + "\n  ".join(sorted(unmapped)))
    state = {k: torch.as_tensor(np.asarray(sd[k]) if not torch.is_tensor(sd[k]) else sd[k])
             for k in wanted}
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
    if os.path.isdir(path):
        raise ValueError(f"{path!r} is a directory: the JAX package's converted (orbax) caches are "
                         "not readable by the PyTorch port; pass the torch .ckpt itself")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return load_ldm_state_dict(modules, sd, strict=strict)

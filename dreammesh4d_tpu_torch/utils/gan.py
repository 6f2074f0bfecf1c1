"""The PatchGAN discriminator and the hinge losses of Control4D (counterpart
of ``dreammesh4d_tpu/utils/gan.py``).

Functional, as the JAX package's: the parameters are a tree ``{"layers":
[{"w" (out, in, 4, 4), "b"}, …], "head": {"w", "b"}}`` (OIHW).  The
discriminator: 4×4 convolutions, stride 2 but for the last layer, each
padded (1, 2) on both image axes (top/left 1, bottom/right 2: the JAX
package's padding, not the upstream PatchGAN's symmetric 1); channels ndf
× [1, 2, 4, 8, …] (capped at 8); a GroupNorm without affine terms (eps
1e-6, the largest group count ≤ 32 that divides the channels) after every
layer but the first; LeakyReLU 0.2; then a 1-channel head.  Images are
(B, H, W, C); logits (B, h, w, 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F


@dataclass
class DiscriminatorConfig:
    input_nc: int = 3
    ndf: int = 64
    n_layers: int = 3


def init_discriminator(cfg: DiscriminatorConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Weights N(0, 0.02²) drawn from ``generator`` (layer by layer, then the
    head), biases zero; every leaf on ``device`` requires grad."""

    def normal(shape):
        w = torch.randn(shape, generator=generator, device=generator.device) * 0.02
        return w.to(device).requires_grad_(True)

    layers, c_in = [], cfg.input_nc
    for m in [1] + [min(2 ** i, 8) for i in range(1, cfg.n_layers + 1)]:
        c_out = cfg.ndf * m
        layers.append({"w": normal((c_out, c_in, 4, 4)),
                       "b": torch.zeros((c_out,), device=device, requires_grad=True)})
        c_in = c_out
    head = {"w": normal((1, c_in, 4, 4)), "b": torch.zeros((1,), device=device, requires_grad=True)}
    return {"layers": layers, "head": head}


def group_norm(x: torch.Tensor, groups: int = 32) -> torch.Tensor:
    """GroupNorm of NCHW ``x`` without affine terms, eps 1e-6, over the
    largest group count ≤ ``groups`` that divides the channels."""
    C = x.shape[1]
    g = min(groups, C)
    while C % g:
        g -= 1
    return F.group_norm(x, g, eps=1e-6)


def _conv(h: torch.Tensor, p, stride: int) -> torch.Tensor:
    return F.conv2d(F.pad(h, (1, 2, 1, 2)), p["w"], p["b"], stride=stride)


def apply_discriminator(params, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) → patch logits (B, h, w, 1)."""
    h = x.permute(0, 3, 1, 2)
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = _conv(h, layer, 2 if i < n - 1 else 1)
        if i > 0:
            h = group_norm(h)
        h = F.leaky_relu(h, 0.2)
    return _conv(h, params["head"], 1).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def generator_loss(params, reconstructions: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """−mean D(fake).  Pass detached discriminator parameters where the
    discriminator must not learn from this term."""
    x = reconstructions if cond is None else torch.cat([reconstructions, cond], -1)
    return -apply_discriminator(params, x).mean()


def discriminator_loss(params, inputs: torch.Tensor, reconstructions: torch.Tensor,
                       cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hinge on detached real and fake images: its gradient reaches the
    discriminator only."""
    real, fake = inputs.detach(), reconstructions.detach()
    if cond is not None:
        real, fake = torch.cat([real, cond], -1), torch.cat([fake, cond], -1)
    return hinge_d_loss(apply_discriminator(params, real), apply_discriminator(params, fake))

"""LPIPS-style perceptual distance on a VGG16 feature pyramid (counterpart of
``dreammesh4d_tpu/utils/perceptual.py``: ``init_perceptual`` :31,
``perceptual_loss`` :75 as ``PerceptualNet.forward``, ``load_torch_weights``
:90).

The LPIPS input scaling (``_SHIFT``/``_SCALE``), VGG16's five stages of 3×3
convolutions with ReLU and a 2×2 max-pool between them, features tapped
after each stage ([64, 128, 256, 512, 512] channels), unit-normalised per
pixel over channels, weighted by the ReLU'd linear heads, averaged over
space and summed over the stages.

Weights: ``load_torch_weights`` takes a torchvision ``vgg16`` state dict and
optional LPIPS ``lin{k}`` heads.  Without them ``init_perceptual`` draws
deterministic random features from a seeded ``torch.Generator`` — valid for
RELATIVE comparisons only.  Its draws are not the JAX package's
(``jax.random``); parity tests carry the JAX parameters across with
``convert.perceptual_params``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (out_channels, n_convs) per VGG16 stage; features tapped after each stage
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# torchvision vgg16().features indices of the convolutions of each stage
_CONV_IDS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


class PerceptualNet(nn.Module):
    """The VGG16 pyramid with the LPIPS heads.  Convolutions are OIHW;
    ``lins[k]`` is stage k's (C_k,) head."""

    def __init__(self):
        super().__init__()
        stages, c_in = [], 3
        for c_out, n_convs in _VGG_STAGES:
            convs = nn.ModuleList()
            for _ in range(n_convs):
                convs.append(nn.Conv2d(c_in, c_out, 3, padding=1))
                c_in = c_out
            stages.append(convs)
        self.stages = nn.ModuleList(stages)
        self.lins = nn.ParameterList([nn.Parameter(torch.zeros(c)) for c, _ in _VGG_STAGES])
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def features(self, x: torch.Tensor):
        """x: (B, 3, H, W) after the scaling layer → the five stage maps."""
        feats, h = [], x
        for si, convs in enumerate(self.stages):
            for conv in convs:
                h = F.relu(conv(h))
            feats.append(h)
            if si < len(self.stages) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (B, H, W, 3) in [0, 1] → (B,) distances."""
        def prep(img):
            return ((img.permute(0, 3, 1, 2) * 2 - 1) - self.shift) / self.scale

        total = 0.0
        for lin, a, b in zip(self.lins, self.features(prep(x)), self.features(prep(y))):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + (d * F.relu(lin)[None, :, None, None]).sum(1).mean((1, 2))
        return total


def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    return f * torch.rsqrt((f * f).sum(1, keepdim=True) + 1e-10)


def init_perceptual(generator: Optional[torch.Generator] = None, device="cuda") -> PerceptualNet:
    """Random features: He-normal convolutions (std sqrt(2 / (9·C_in))), zero
    biases, heads |N(0, 1)| / C, drawn on the CPU from ``generator`` (seed 0
    when None) and moved to ``device``."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    net = PerceptualNet()
    with torch.no_grad():
        for (c_out, _), convs, lin in zip(_VGG_STAGES, net.stages, net.lins):
            for conv in convs:
                c_in = conv.in_channels
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                                  * float(np.sqrt(2.0 / (9 * c_in))))
                conv.bias.zero_()
            lin.copy_(torch.randn(c_out, generator=gen).abs() / c_out)
    return net.to(device).eval().requires_grad_(False)


def from_params(params: Dict[str, Any], device="cuda") -> PerceptualNet:
    """A ``PerceptualNet`` from ``{"stages": [[{"w": OIHW, "b"}, ...], ...],
    "lins": [(C,), ...]}`` (arrays or tensors)."""
    def f32(x):
        return x.float() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, np.float32))

    net = PerceptualNet().to(device)
    with torch.no_grad():
        for convs, p_stage in zip(net.stages, params["stages"]):
            for conv, p in zip(convs, p_stage):
                conv.weight.copy_(f32(p["w"]))
                conv.bias.copy_(f32(p["b"]))
        for lin, w in zip(net.lins, params["lins"]):
            lin.copy_(f32(w).reshape(-1))
    return net.eval().requires_grad_(False)


def load_torch_weights(vgg_state: Dict[str, Any], lpips_state: Optional[Dict[str, Any]] = None,
                       device="cuda") -> PerceptualNet:
    """A ``PerceptualNet`` from torchvision ``vgg16().features.state_dict()``
    (bare ``0.weight`` keys) or ``vgg16().state_dict()`` (``features.``
    prefix), plus the optional LPIPS heads ``lin{k}.model.1.weight``; a
    missing head is uniform 1/C."""
    if any(k.startswith("features.") for k in vgg_state):
        vgg_state = {k[len("features."):]: v for k, v in vgg_state.items()
                     if k.startswith("features.")}
    params: Dict[str, Any] = {"stages": [], "lins": []}
    for si, ids in enumerate(_CONV_IDS):
        params["stages"].append([{"w": np.asarray(vgg_state[f"{i}.weight"]),
                                  "b": np.asarray(vgg_state[f"{i}.bias"])} for i in ids])
        c_out = params["stages"][-1][-1]["b"].shape[0]
        if lpips_state is not None and f"lin{si}.model.1.weight" in lpips_state:
            params["lins"].append(np.asarray(lpips_state[f"lin{si}.model.1.weight"]).reshape(-1))
        else:
            params["lins"].append(np.full((c_out,), 1.0 / c_out, np.float32))
    return from_params(params, device=device)

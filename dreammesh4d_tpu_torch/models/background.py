"""Backgrounds (counterpart of ``dreammesh4d_tpu/models/background.py``):

- ``NeuralEnvironmentMapBackground`` (``neural-environment-map-background``
  and ``gaussian-mvdream-neural-environment-map-background``): frequency-
  encoded view directions → a small ReLU MLP → ``color_activation``;
- ``SolidColorBackground`` (``solid-color-background``): a fixed or learned
  colour;
- ``TexturedBackground`` (``textured-background``): a learnable equirect
  texture, bilinear, wrapped in azimuth and clamped at the poles (the
  reference's ``grid_sample`` with reflection padding, as the JAX package
  writes it), through a sigmoid.

Each is built as ``registry.find(name)(cfg, device=...)`` (cfg a dict of
its dataclass's fields, unknown keys ignored; ``device`` defaults to
``"cuda"``) and holds its parameters in ``params``, drawn from a generator
seeded by ``cfg["seed"]`` (default 0); carry the JAX package's across with
``convert``.  With ``training`` and ``random_aug`` a call replaces the
colour by a random one with probability ``random_aug_prob``: the draws (the
colour, then the uniform that decides) come from ``generator`` or are given
as ``rand_color`` and ``u``.  No shipped system builds its background from
the registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..ops.hashgrid import frequency_encode
from ..registry import register
from ..utils.misc import get_activation
from .geometry.implicit_volume import _mlp_apply, _mlp_init
from .registry_names import _dc, _gen


def _random_aug(color: torch.Tensor, n: int, prob: float, generator, rand_color, u) -> torch.Tensor:
    """``color`` or, where the uniform ``u`` < ``prob``, the colour
    ``rand_color`` (n,) broadcast over it."""
    dev = color.device
    if rand_color is None:
        rand_color = torch.rand((n,), generator=generator, device=generator.device)
    if u is None:
        u = torch.rand((), generator=generator, device=generator.device)
    rand_color = torch.as_tensor(rand_color, dtype=torch.float32, device=dev).expand(color.shape)
    return torch.where(torch.as_tensor(u, device=dev) < prob, rand_color, color)


@dataclass
class NeuralEnvironmentMapBackgroundConfig:
    n_output_dims: int = 3
    color_activation: str = "sigmoid"
    n_frequencies: int = 6
    n_neurons: int = 16
    n_hidden_layers: int = 2
    random_aug: bool = False
    random_aug_prob: float = 0.5


@register("gaussian-mvdream-neural-environment-map-background")
@register("neural-environment-map-background")
class NeuralEnvironmentMapBackground:
    """``params``: ``layers``, a list of ``{"w" (in, out), "b"}``,
    Glorot-uniform, in = 6 · ``n_frequencies``."""

    def __init__(self, cfg: dict | None = None, device="cuda"):
        self.cfg = c = _dc(NeuralEnvironmentMapBackgroundConfig, cfg)
        dims = [6 * c.n_frequencies] + [c.n_neurons] * c.n_hidden_layers + [c.n_output_dims]
        self.params = {"layers": _mlp_init(_gen(cfg, device), dims, device)}

    def __call__(self, dirs: torch.Tensor, params=None, generator: Optional[torch.Generator] = None,
                 training: bool = False, rand_color=None, u=None) -> torch.Tensor:
        c = self.cfg
        params = self.params if params is None else params
        x = _mlp_apply(params["layers"], frequency_encode(dirs, c.n_frequencies))
        color = get_activation(c.color_activation)(x)
        if training and c.random_aug and (generator is not None or rand_color is not None):
            color = _random_aug(color, c.n_output_dims, c.random_aug_prob, generator, rand_color, u)
        return color


@dataclass
class SolidColorBackgroundConfig:
    n_output_dims: int = 3
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    learned: bool = False
    random_aug: bool = False
    random_aug_prob: float = 0.5


@register("solid-color-background")
class SolidColorBackground:
    """``params``: ``color`` (n_output_dims,) when ``learned``, else none."""

    def __init__(self, cfg: dict | None = None, device="cuda"):
        self.cfg = c = _dc(SolidColorBackgroundConfig, cfg)
        self.device = torch.device(device)
        self.params: Dict[str, torch.Tensor] = (
            {"color": torch.tensor(c.color, dtype=torch.float32, device=device)} if c.learned else {})

    def __call__(self, params=None, generator: Optional[torch.Generator] = None, training: bool = False,
                 rand_color=None, u=None) -> torch.Tensor:
        c = self.cfg
        params = self.params if params is None else params
        color = params.get("color")
        if color is None:
            color = torch.tensor(c.color, dtype=torch.float32, device=self.device)
        if training and c.random_aug and (generator is not None or rand_color is not None):
            color = _random_aug(color, c.n_output_dims, c.random_aug_prob, generator, rand_color, u)
        return color


@dataclass
class TexturedBackgroundConfig:
    n_output_dims: int = 3
    height: int = 64
    width: int = 64


@register("textured-background")
class TexturedBackground:
    """``params``: ``texture`` (height, width, n_output_dims) ~ N(0, 1)."""

    def __init__(self, cfg: dict | None = None, device="cuda"):
        self.cfg = c = _dc(TexturedBackgroundConfig, cfg)
        gen = _gen(cfg, device)
        self.params = {"texture": torch.randn((c.height, c.width, c.n_output_dims), generator=gen,
                                              device=gen.device)}

    def __call__(self, dirs: torch.Tensor, params=None, **kwargs) -> torch.Tensor:
        tex = (self.params if params is None else params)["texture"]
        H, W, _ = tex.shape
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        u = torch.atan2(torch.sqrt(x * x + y * y + 1e-12), z) / torch.pi  # polar, [0, 1]
        v = torch.remainder(torch.atan2(y, x) / (2 * torch.pi), 1.0)
        fi = torch.clamp(u * (H - 1), 0, H - 1)
        fj = v * W
        i0 = torch.floor(fi).long()
        j0 = torch.remainder(torch.floor(fj).long(), W)
        i1 = torch.clamp(i0 + 1, max=H - 1)
        j1 = torch.remainder(j0 + 1, W)
        wi = (fi - i0)[..., None]
        wj = (fj - torch.floor(fj))[..., None]
        c = ((1 - wi) * ((1 - wj) * tex[i0, j0] + wj * tex[i0, j1])
             + wi * ((1 - wj) * tex[i1, j0] + wj * tex[i1, j1]))
        return torch.sigmoid(c)

"""Materials (counterpart of ``dreammesh4d_tpu/models/materials.py``):
``NoMaterial`` (``no-material``), the pass-through of the SuGaR stages, and
``DiffuseWithPointLightMaterial`` (``diffuse-with-point-light-material``),
the lambertian + ambient shading of the static NeRF stage.  The other
materials of the JAX package are not ported yet (ROADMAP A8.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..registry import register


@register("no-material")
@dataclass
class NoMaterial:
    n_output_dims: int = 0

    def __call__(self, features: torch.Tensor, **kwargs) -> torch.Tensor:
        return features


@register("diffuse-with-point-light-material")
@dataclass
class DiffuseWithPointLightMaterial:
    ambient_light_color: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    diffuse_light_color: Tuple[float, float, float] = (0.9, 0.9, 0.9)
    ambient_only_steps: int = 1000
    diffuse_prob: float = 0.75
    textureless_prob: float = 0.5
    albedo_activation: str = "sigmoid"

    def shade(self, albedo: torch.Tensor, normals: torch.Tensor, positions: torch.Tensor,
              light_positions: torch.Tensor, ambient_ratio: Optional[float] = None,
              shading_normal_only: bool = False) -> torch.Tensor:
        """Lambertian: color = albedo · (diffuse·max(n·l, 0) + ambient).
        ``ambient_ratio`` overrides the light colours (diffuse = 1 − a,
        ambient = a)."""
        l = light_positions - positions
        l = l / (torch.linalg.norm(l, dim=-1, keepdim=True) + 1e-8)
        ndotl = torch.clamp((normals * l).sum(-1, keepdim=True), min=0.0)
        if ambient_ratio is not None:
            diffuse_c = (1.0 - ambient_ratio) * albedo.new_ones(3)
            ambient_c = ambient_ratio * albedo.new_ones(3)
        else:
            diffuse_c = albedo.new_tensor(self.diffuse_light_color)
            ambient_c = albedo.new_tensor(self.ambient_light_color)
        light = ndotl * diffuse_c + ambient_c
        if shading_normal_only:
            return torch.clamp(light, 0.0, 1.0)
        return torch.clamp(albedo * light, 0.0, 1.0)

    def __call__(self, features, positions=None, shading_normal=None, light_positions=None,
                 ambient_ratio=None, **kwargs):
        albedo = torch.sigmoid(features[..., :3])
        if shading_normal is None or light_positions is None:
            return albedo
        return self.shade(albedo, shading_normal, positions, light_positions, ambient_ratio)

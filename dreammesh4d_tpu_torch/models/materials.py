"""Materials (counterpart of ``dreammesh4d_tpu/models/materials.py``):

- ``NoMaterial`` (``no-material``), the pass-through of the SuGaR stages,
  and ``DiffuseWithPointLightMaterial``
  (``diffuse-with-point-light-material``), the lambertian + ambient shading
  of the static NeRF stage: dataclasses, as in the JAX package;
- ``PBRMaterial`` (``pbr-material``): split-sum PBR with Karis's analytic
  environment BRDF in place of the reference's FG LUT (as in the JAX
  package) and an equirect environment pyramid sampled at a
  roughness-lerped level;
- ``NeuralRadianceMaterial`` (``neural-radiance-material``): SH-encoded
  view directions and features through an MLP;
- ``HybridRGBLatentMaterial`` (``hybrid-rgb-latent-material``) and
  ``SDLatentAdapterMaterial`` (``sd-latent-adapter-material``, a 4 × 3
  latent → RGB adapter).

The last four are built as ``registry.find(name)(cfg, device=...)`` (cfg a
dict of their config dataclass's fields, unknown keys ignored; ``device``
defaults to ``"cuda"``) and hold their parameters in ``params`` (a dict of tensors,
drawn from a generator seeded by ``cfg["seed"]``, default 0, where the JAX
package draws them from a ``PRNGKey``: carry those across with
``convert``).  A call takes ``params=`` to use others.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.safe_math import safe_normalize
from ..ops.sh import eval_sh, num_sh_bases
from ..registry import register
from ..utils.misc import get_activation
from .registry_names import _dc, _gen


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


def box_blur_same(x: torch.Tensor, axis: int, taps: int = 5) -> torch.Tensor:
    """``np.convolve(row, ones(taps) / taps, "same")`` along ``axis`` (odd
    ``taps``): the centred mean of ``taps`` entries, zeros outside."""
    h = taps // 2
    n = x.shape[axis]
    pad = [0, 0] * (x.ndim - 1 - axis) + [h, h]
    xp = torch.nn.functional.pad(x, pad)
    out = xp.narrow(axis, 0, n)
    for k in range(1, taps):
        out = out + xp.narrow(axis, k, n)
    return out / taps


# ---------------------------------------------------------------------------
# pbr-material
# ---------------------------------------------------------------------------


@dataclass
class PBRMaterialConfig:
    material_activation: str = "sigmoid"
    environment_scale: float = 2.0
    min_metallic: float = 0.0
    max_metallic: float = 0.9
    min_roughness: float = 0.08
    max_roughness: float = 0.9
    use_bump: bool = True
    env_height: int = 32
    env_width: int = 64
    n_levels: int = 4
    requires_normal: bool = True


@register("pbr-material")
class PBRMaterial:
    """Split-sum PBR shading.  Features (..., 8) through a sigmoid: albedo
    (3), metallic, roughness, a tangent-space bump (3).  ``params``:
    ``env_levels`` (n_levels, H, W, 3), the environment (by default a
    latitude gradient from 1.5 at the top to 0.15 at the bottom, or
    ``envmap``) × ``environment_scale`` and its ``n_levels − 1`` successive
    5-tap box blurs along H then W."""

    def __init__(self, cfg: dict | None = None, device="cuda", envmap=None):
        self.cfg = _dc(PBRMaterialConfig, cfg)
        self.params = self.init_params(envmap, device)

    def init_params(self, envmap=None, device="cuda") -> Dict[str, torch.Tensor]:
        c = self.cfg
        H, W = c.env_height, c.env_width
        if envmap is None:
            lat = np.linspace(1.5, 0.15, H, dtype=np.float32)[:, None, None]
            envmap = np.broadcast_to(lat, (H, W, 3)).copy()
        cur = torch.tensor(np.asarray(envmap, np.float32), device=device) * c.environment_scale
        levels = [cur]
        for _ in range(c.n_levels - 1):
            cur = box_blur_same(box_blur_same(cur, 0), 1)
            levels.append(cur)
        return {"env_levels": torch.stack(levels)}

    def _sample_env(self, params, dirs: torch.Tensor, roughness: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Equirect bilinear sample (polar rows clamped, azimuth columns
        wrapped) of the levels, lerped between the two levels around
        roughness·(L − 1) (level 0 without roughness)."""
        lv = params["env_levels"]
        L, H, W, _ = lv.shape
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        u = torch.arccos(torch.clamp(z, -1, 1)) / torch.pi
        v = torch.remainder(torch.atan2(y, x) / (2 * torch.pi), 1.0)
        fi = torch.clamp(u * (H - 1), 0, H - 1)
        fj = v * W
        i0 = torch.floor(fi).long()
        j0 = torch.remainder(torch.floor(fj).long(), W)
        i1 = torch.clamp(i0 + 1, max=H - 1)
        j1 = torch.remainder(j0 + 1, W)
        wi = (fi - i0)[..., None]
        wj = (fj - torch.floor(fj))[..., None]
        if roughness is None:
            lev = torch.zeros(dirs.shape[:-1] + (1,), device=dirs.device)
        else:
            lev = torch.clamp(roughness, 0, 1) * (L - 1)
        l0 = torch.clamp(torch.floor(lev[..., 0]).long(), 0, L - 1)
        l1 = torch.clamp(l0 + 1, max=L - 1)
        wl = (lev[..., 0] - l0)[..., None]

        def bilerp(lvl):
            return ((1 - wi) * ((1 - wj) * lv[lvl, i0, j0] + wj * lv[lvl, i0, j1])
                    + wi * ((1 - wj) * lv[lvl, i1, j0] + wj * lv[lvl, i1, j1]))

        return (1 - wl) * bilerp(l0) + wl * bilerp(l1)

    @staticmethod
    def _env_brdf_approx(n_dot_v: torch.Tensor, roughness: torch.Tensor):
        """Karis's mobile approximation of the split-sum FG terms: (scale, bias)."""
        c0 = n_dot_v.new_tensor([-1.0, -0.0275, -0.572, 0.022])
        c1 = n_dot_v.new_tensor([1.0, 0.0425, 1.04, -0.04])
        r = roughness * c0 + c1
        a004 = torch.minimum(r[..., 0:1] * r[..., 0:1], torch.exp2(-9.28 * n_dot_v)) * r[..., 0:1] + r[..., 1:2]
        return -1.04 * a004 + r[..., 2:3], 1.04 * a004 + r[..., 3:4]

    def _material(self, features):
        c = self.cfg
        m = torch.sigmoid(features)
        return (m, m[..., 3:4] * (c.max_metallic - c.min_metallic) + c.min_metallic,
                m[..., 4:5] * (c.max_roughness - c.min_roughness) + c.min_roughness)

    def __call__(self, features, viewdirs=None, shading_normal=None, tangent=None, params=None, **kwargs):
        """Shaded colour (..., 3) in [0, 1]; the albedo without
        ``viewdirs`` or ``shading_normal``.  With ``use_bump`` and a
        ``tangent`` the normal is perturbed in the tangent frame."""
        params = self.params if params is None else params
        material, metallic, roughness = self._material(features)
        albedo = material[..., :3]
        if viewdirs is None or shading_normal is None:
            return albedo
        if self.cfg.use_bump and tangent is not None:
            perturb = (material[..., 5:8] * 2 - 1) + features.new_tensor([0.0, 0.0, 1.0])
            perturb = safe_normalize(torch.clamp(perturb, -1, 1))
            bitangent = safe_normalize(torch.linalg.cross(tangent, shading_normal, dim=-1))
            shading_normal = safe_normalize(tangent * perturb[..., 0:1] - bitangent * perturb[..., 1:2]
                                            + shading_normal * perturb[..., 2:3])
        v = -viewdirs
        n_dot_v = (shading_normal * v).sum(-1, keepdim=True)
        reflective = n_dot_v * shading_normal * 2 - v
        diffuse_albedo = (1 - metallic) * albedo
        fg_a, fg_b = self._env_brdf_approx(torch.clamp(n_dot_v, 0, 1), torch.clamp(roughness, 0, 1))
        f0 = (1 - metallic) * 0.04 + metallic * albedo
        specular_albedo = f0 * fg_a + fg_b
        diffuse_light = self._sample_env(params, shading_normal, torch.ones_like(roughness))
        specular_light = self._sample_env(params, reflective, roughness)
        return torch.clamp(diffuse_albedo * diffuse_light + specular_albedo * specular_light, 0.0, 1.0)

    def export(self, features, **kwargs) -> Dict[str, torch.Tensor]:
        material, metallic, roughness = self._material(features)
        return {"albedo": material[..., :3], "metallic": metallic, "roughness": roughness}


# ---------------------------------------------------------------------------
# neural-radiance-material, hybrid-rgb-latent-material, sd-latent-adapter-material
# ---------------------------------------------------------------------------


def _sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """The SH basis values (..., (deg + 1)²) at ``dirs``: ``eval_sh`` of
    identity coefficients."""
    n = num_sh_bases(deg)
    eye = torch.eye(n, device=dirs.device).expand(dirs.shape[:-1] + (n, n))
    return eval_sh(deg, eye, dirs)


@dataclass
class NeuralRadianceMaterialConfig:
    input_feature_dims: int = 8
    sh_degree: int = 3
    n_neurons: int = 16
    n_hidden_layers: int = 2


@register("neural-radiance-material")
class NeuralRadianceMaterial:
    """View-dependent colour: [features[:input_feature_dims], SH basis of
    the view direction] → MLP (ReLU) → sigmoid.  ``params``: ``mlp``, a
    list of ``{"w" (in, out), "b"}``, Glorot-uniform."""

    def __init__(self, cfg: dict | None = None, device="cuda"):
        from .geometry.implicit_volume import _mlp_init

        self.cfg = c = _dc(NeuralRadianceMaterialConfig, cfg)
        dims = [c.input_feature_dims + num_sh_bases(c.sh_degree)] + [c.n_neurons] * c.n_hidden_layers + [3]
        self.params = {"mlp": _mlp_init(_gen(cfg, device), dims, device)}

    def __call__(self, features, viewdirs=None, params=None, **kwargs):
        from .geometry.implicit_volume import _mlp_apply

        params = self.params if params is None else params
        if viewdirs is None:
            return torch.sigmoid(features[..., :3])
        c = self.cfg
        inp = torch.cat([features[..., :c.input_feature_dims], _sh_basis(c.sh_degree, viewdirs)], -1)
        return torch.sigmoid(_mlp_apply(params["mlp"], inp))


@dataclass
class HybridRGBLatentMaterialConfig:
    n_output_dims: int = 3
    color_activation: str = "sigmoid"
    requires_normal: bool = True


@register("hybrid-rgb-latent-material")
class HybridRGBLatentMaterial:
    """The first 3 feature channels through ``color_activation``, the rest
    (the latent channels) passed through."""

    def __init__(self, cfg: dict | None = None, device="cuda"):
        self.cfg = _dc(HybridRGBLatentMaterialConfig, cfg)
        self.params: Dict[str, torch.Tensor] = {}

    def __call__(self, features, **kwargs):
        rgb = get_activation(self.cfg.color_activation)(features[..., :3])
        return torch.cat([rgb, features[..., 3:]], -1)


# the reference's fixed latent -> RGB preview decode, a trainable 4 x 3 here
SD_LATENT_ADAPTER = ((0.298, 0.207, 0.208), (0.187, 0.286, 0.173), (-0.158, 0.189, 0.264),
                     (-0.184, -0.271, -0.473))


@dataclass
class SDLatentAdapterMaterialConfig:
    pass


@register("sd-latent-adapter-material")
class SDLatentAdapterMaterial:
    """4 SD latent channels → RGB: clamp((latent @ adapter + 1) / 2, 0, 1).
    ``params``: ``adapter`` (4, 3)."""

    def __init__(self, cfg: dict | None = None, device="cuda"):
        self.cfg = _dc(SDLatentAdapterMaterialConfig, cfg)
        self.params = {"adapter": torch.tensor(SD_LATENT_ADAPTER, dtype=torch.float32, device=device)}

    def __call__(self, features, params=None, **kwargs):
        params = self.params if params is None else params
        return torch.clamp((features[..., :4] @ params["adapter"] + 1.0) / 2.0, 0.0, 1.0)

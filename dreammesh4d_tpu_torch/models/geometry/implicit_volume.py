"""Implicit density volume, the hash-grid NeRF geometry of the static
Zero123 stage (counterpart of
``dreammesh4d_tpu/models/geometry/implicit_volume.py``).

A hash-grid encoding (16 levels × 2 features in the shipped config) feeds a
density MLP (ReLU, 64 × 2, one output, activated by softplus after the
``blob_magic3d`` bias) and a feature MLP (3 albedo dimensions).  Points live
in the box [-radius, radius]³; the normal is −∇σ, normalised.

Parameters are a plain tree ``{"encoding": {"tables"}, "density_mlp":
[{"w", "b"}, …], "feature_mlp": […]}`` with ``w`` stored (in, out).

**The cell layout and its gradient contract.**  With ``hashgrid.layout ==
"cell"`` every encode goes through ``ops/hashgrid_cell.py`` — the
hand-written kernels on CUDA tensors, their plain versions on CPU tensors.
That encode returns the exact gradient of the tables and *none* for the
query points.  All callers here query at samples along camera rays, which
are data.  A geometry that puts a learned warp or deformation in front of
the encoding must use ``layout="corner"``.

**The analytic normal on the cell layout** needs ∇σ inside a loss, so the
loss's gradient passes through ∇σ a second time.  The encode returns
d enc/dx beside the features; the rest of the chain rule is written out
here for the ReLU MLP, the bias and the density activation
(:func:`_density_with_grad`) in ordinary tensor operations.  Autograd
differentiates those once more like any other code, and they work without
grad mode (validation, export, the occupancy update run under
``torch.no_grad``).  The corner layout and finite differences keep the
generic routes (``torch.autograd.grad`` through ``hashgrid_encode``, six
offset queries).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.hashgrid import HashGridConfig, hashgrid_encode, init_hashgrid, init_hashgrid_cell
from ...ops.hashgrid_cell import encode_cell_with_grad
from ...ops.safe_math import safe_normalize


@dataclass
class ImplicitVolumeConfig:
    radius: float = 2.0
    n_feature_dims: int = 3
    density_activation: str = "softplus"
    density_bias: Any = "blob_magic3d"
    density_blob_scale: float = 10.0
    density_blob_std: float = 0.5
    normal_type: str = "analytic"  # analytic | finite_difference
    finite_difference_eps: float = 0.01
    hashgrid: HashGridConfig = field(default_factory=HashGridConfig)
    n_neurons: int = 64
    n_hidden_layers: int = 2


def _mlp_init(generator: Optional[torch.Generator], dims: List[int], device) -> List[Dict]:
    """Glorot-uniform weights (in, out), zero biases."""
    dev = torch.device(device)
    gen_dev = generator.device if generator is not None else dev
    params = []
    for n_in, n_out in zip(dims[:-1], dims[1:]):
        lim = float(np.sqrt(6.0 / (n_in + n_out)))
        u = torch.rand((n_in, n_out), generator=generator, dtype=torch.float32, device=gen_dev)
        params.append({"w": ((2.0 * u - 1.0) * lim).to(dev),
                       "b": torch.zeros((n_out,), dtype=torch.float32, device=dev)})
    return params


def _mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = F.relu(x)
    return x


def _encode(params, cfg: ImplicitVolumeConfig, x, level_mask):
    """Features of the contracted points under either table layout."""
    if cfg.hashgrid.layout == "cell":
        return encode_cell_with_grad(params["encoding"], cfg.hashgrid, x, level_mask,
                                     with_dfeats=False)[0]
    return hashgrid_encode(params["encoding"], cfg.hashgrid, x, level_mask)


def _encode_with_grad(params, cfg: ImplicitVolumeConfig, x, level_mask):
    """(feats, d feats / d x) of the cell layout from one pass over the rows."""
    return encode_cell_with_grad(params["encoding"], cfg.hashgrid, x, level_mask)


def init_implicit_volume(cfg: ImplicitVolumeConfig, generator: Optional[torch.Generator] = None,
                         device="cuda") -> Dict[str, Any]:
    dims = [cfg.hashgrid.out_dim] + [cfg.n_neurons] * cfg.n_hidden_layers
    init_tables = init_hashgrid_cell if cfg.hashgrid.layout == "cell" else init_hashgrid
    return {
        "encoding": init_tables(cfg.hashgrid, generator, device),
        "density_mlp": _mlp_init(generator, dims + [1], device),
        "feature_mlp": _mlp_init(generator, dims + [cfg.n_feature_dims], device),
    }


def _contract(cfg: ImplicitVolumeConfig, points: torch.Tensor) -> torch.Tensor:
    """[-radius, radius] -> [0, 1]."""
    return (points + cfg.radius) / (2 * cfg.radius)


def _bias_with_grad(cfg: ImplicitVolumeConfig, points: torch.Tensor):
    """The pre-activation bias (..., 1) and its gradient in the points
    (..., 3), or ``None`` for a constant bias."""
    if cfg.density_bias == "blob_dreamfusion":
        bias = cfg.density_blob_scale * torch.exp(
            -0.5 * (points**2).sum(-1, keepdim=True) / cfg.density_blob_std**2)
        return bias, bias * (-points / cfg.density_blob_std**2)
    if cfg.density_bias == "blob_magic3d":
        norm = torch.sqrt((points**2).sum(-1, keepdim=True) + 1e-12)
        bias = cfg.density_blob_scale * (1.0 - norm / cfg.density_blob_std)
        return bias, (-cfg.density_blob_scale / cfg.density_blob_std) * points / norm
    bias = torch.as_tensor(cfg.density_bias, dtype=torch.float32, device=points.device)
    return bias, None


def density_bias(cfg: ImplicitVolumeConfig, points: torch.Tensor) -> torch.Tensor:
    """Pre-activation density bias."""
    return _bias_with_grad(cfg, points)[0]


def _activate_density(cfg: ImplicitVolumeConfig, raw: torch.Tensor) -> torch.Tensor:
    if cfg.density_activation == "softplus":
        return F.softplus(raw)
    if cfg.density_activation == "trunc_exp":
        return torch.exp(torch.clamp(raw, -15.0, 15.0))
    if cfg.density_activation == "shifted_softplus":
        return F.softplus(raw - 1.0)
    raise ValueError(cfg.density_activation)


def _activation_slope(cfg: ImplicitVolumeConfig, raw: torch.Tensor) -> torch.Tensor:
    """d activation / d raw, in operations autograd can differentiate again."""
    if cfg.density_activation == "softplus":
        return torch.sigmoid(raw)
    if cfg.density_activation == "trunc_exp":
        inside = ((raw >= -15.0) & (raw <= 15.0)).to(raw.dtype)
        return torch.exp(torch.clamp(raw, -15.0, 15.0)) * inside
    if cfg.density_activation == "shifted_softplus":
        return torch.sigmoid(raw - 1.0)
    raise ValueError(cfg.density_activation)


def _density_with_grad(params, cfg: ImplicitVolumeConfig, enc, denc, points):
    """Density (..., 1) and ∇σ in the points (..., 3) from the encoding and
    its spatial gradient ``denc`` = d enc / d x (x the contracted points).

    The chain rule of σ = act(mlp(enc) + bias(p)), written out: with the
    ReLU masks m_i of the hidden layers,
    ``d raw / d enc = W_1 (m_1 ⊙ W_2 (m_2 ⊙ … w_out))`` per point, and
    ``∇σ = act'(z) · (d raw/d enc · denc / (2·radius) + ∇bias)``."""
    h = enc
    masks = []
    mlp = params["density_mlp"]
    for layer in mlp[:-1]:
        pre = h @ layer["w"] + layer["b"]
        masks.append((pre > 0).to(pre.dtype))
        h = F.relu(pre)
    raw = h @ mlp[-1]["w"] + mlp[-1]["b"]
    g = mlp[-1]["w"][:, 0].expand(h.shape)  # d raw / d (last hidden)
    for layer, mask in zip(reversed(mlp[:-1]), reversed(masks)):
        g = (g * mask) @ layer["w"].T
    bias, dbias = _bias_with_grad(cfg, points)
    z = raw + bias
    slope = _activation_slope(cfg, z)
    grad = torch.einsum("...f,...fd->...d", slope * g, denc) / (2.0 * cfg.radius)
    if dbias is not None:
        grad = grad + slope * dbias
    return _activate_density(cfg, z), grad


def forward_density(params, cfg: ImplicitVolumeConfig, points: torch.Tensor,
                    level_mask=None) -> torch.Tensor:
    """(..., 3) world points -> (..., 1) activated density."""
    enc = _encode(params, cfg, _contract(cfg, points), level_mask)
    raw = _mlp_apply(params["density_mlp"], enc)
    return _activate_density(cfg, raw + density_bias(cfg, points))


def forward_field(params, cfg: ImplicitVolumeConfig, points: torch.Tensor,
                  level_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (density (..., 1), features (..., n_feature_dims))."""
    enc = _encode(params, cfg, _contract(cfg, points), level_mask)
    raw = _mlp_apply(params["density_mlp"], enc)
    density = _activate_density(cfg, raw + density_bias(cfg, points))
    return density, _mlp_apply(params["feature_mlp"], enc)


def forward_with_normal(params, cfg: ImplicitVolumeConfig, points: torch.Tensor,
                        level_mask=None):
    """-> (density, features, normals), normal = −∇σ normalised, analytic
    or by finite differences."""
    if cfg.hashgrid.layout == "cell" and cfg.normal_type == "analytic":
        # one pass over the cell rows serves density, features and ∇σ
        enc, denc = _encode_with_grad(params, cfg, _contract(cfg, points), level_mask)
        density, g = _density_with_grad(params, cfg, enc, denc, points)
        features = _mlp_apply(params["feature_mlp"], enc)
        return density, features, -safe_normalize(g)
    density, features = forward_field(params, cfg, points, level_mask)
    if cfg.normal_type == "analytic":
        # corner layout: differentiate the density in the points; inside a
        # loss the graph of that gradient is kept so it can be differentiated
        # once more
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            p = points.detach().requires_grad_(True)
            total = forward_density(params, cfg, p, level_mask).sum()
            (g,) = torch.autograd.grad(total, p, create_graph=keep)
        if not keep:
            g = g.detach()
    else:
        eps = cfg.finite_difference_eps
        offsets = points.new_tensor(
            [[eps, 0, 0], [-eps, 0, 0], [0, eps, 0], [0, -eps, 0], [0, 0, eps], [0, 0, -eps]])
        d = forward_density(params, cfg, points[..., None, :] + offsets, level_mask)[..., 0]
        g = torch.stack([(d[..., 0] - d[..., 1]) / (2 * eps),
                         (d[..., 2] - d[..., 3]) / (2 * eps),
                         (d[..., 4] - d[..., 5]) / (2 * eps)], -1)
    return density, features, -safe_normalize(g)


@torch.no_grad()
def export_density_grid(params, cfg: ImplicitVolumeConfig, resolution: int,
                        chunk: int = 65536, level_mask=None) -> np.ndarray:
    """Dense (resolution³) density grid over the box, evaluated ``chunk``
    points at a time on the parameters' device — what the isosurface export
    starts from."""
    dev = params["density_mlp"][0]["w"].device
    lin = np.linspace(-cfg.radius, cfg.radius, resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    out = torch.empty((resolution**3,), dtype=torch.float32, device=dev)
    for i in range(0, len(grid), chunk):
        pts = torch.as_tensor(grid[i: i + chunk], device=dev)
        out[i: i + chunk] = forward_density(params, cfg, pts, level_mask)[..., 0]
    return out.cpu().numpy().reshape(resolution, resolution, resolution)

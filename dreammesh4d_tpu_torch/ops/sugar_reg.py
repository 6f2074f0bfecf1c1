"""SuGaR surface regularisation of the Gaussian stage (counterpart of
``dreammesh4d_tpu/ops/sugar_reg.py``), applied after ``start_sugar_reg``:

- points sampled inside the alive Gaussians (uniform over them, offsets of
  1.5 × their scales along their axes);
- the density at a sample from its source Gaussian's 16 nearest
  neighbours: Σ_j o_j exp(−½ dᵀΣ_j⁻¹d), with the neighbour table refreshed
  every ``reset_neighbors`` steps (:func:`refresh_knn`);
- β, the mean smallest scale of the alive Gaussians;
- a Gaussian's normal is the rotation column of its smallest scale;
- the density term |ρ(x) − exp(−sdf²/2β²)| with the sdf estimated along the
  source's normal, and the SDF-better-normal term.

Plain PyTorch on the tensors' device.  The sample draws come from a
``torch.Generator`` through :func:`draw_samples` (``torch.multinomial``
with replacement where the JAX package calls ``jax.random.choice`` with
``p``), and the regulariser takes them as an argument.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .knn import knn
from .quaternion import quat_to_matrix


class SugarRegState(NamedTuple):
    knn_idx: torch.Tensor  # (C, K) neighbour indices


def refresh_knn(xyz: torch.Tensor, alive: torch.Tensor, k: int = 16) -> SugarRegState:
    """The k nearest Gaussian centres of every slot (itself included), dead
    slots pushed to 1e6 so that no alive slot picks one."""
    pts = torch.where(alive[:, None], xyz.detach(), torch.full_like(xyz, 1e6))
    _, idx = knn(pts, pts, k=k, exclude_self=False)
    return SugarRegState(idx)


def smallest_axis_normals(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(N, 3): the rotation column of each Gaussian's smallest scale (the
    first of equal ones)."""
    R = quat_to_matrix(quats)  # (N, 3, 3), columns are the axes
    amin = torch.argmin(scales, dim=-1)
    return torch.gather(R, 2, amin[:, None, None].expand(-1, 3, 1))[..., 0]


def draw_samples(generator: torch.Generator, alive: torch.Tensor, n_samples: int):
    """(sources (n,) int64, standard normals (n, 3)) of
    :func:`sample_points_in_gaussians`: sources uniform over the alive slots,
    with replacement."""
    probs = alive.to(torch.float32)
    src = torch.multinomial(probs / probs.sum(), n_samples, replacement=True, generator=generator)
    normal = torch.randn((n_samples, 3), generator=generator, device=generator.device)
    return src.to(alive.device), normal.to(alive.device)


def sample_points_in_gaussians(xyz, quats, scales, src: torch.Tensor, normal: torch.Tensor,
                               scale_factor: float = 1.5):
    """x = μ + R (s · f · n) for the sources ``src`` and normals ``normal``."""
    n = normal * scales[src] * scale_factor
    offset = torch.einsum("nij,nj->ni", quat_to_matrix(quats[src]), n)
    return xyz[src] + offset


def gaussian_density(samples: torch.Tensor, neighbor_idx: torch.Tensor, xyz, quats, scales,
                     opacities) -> torch.Tensor:
    """ρ(x) = Σ_{j∈knn} o_j exp(−½ (x−μ_j)ᵀ Σ_j⁻¹ (x−μ_j)); samples (S, 3),
    neighbor_idx (S, K)."""
    mu = xyz[neighbor_idx]  # (S, K, 3)
    R = quat_to_matrix(quats[neighbor_idx])  # (S, K, 3, 3)
    inv_s = 1.0 / torch.clamp(scales[neighbor_idx], min=1e-8)
    d = samples[:, None, :] - mu
    local = torch.einsum("skji,skj->ski", R, d)  # Rᵀ d
    maha2 = ((local * inv_s) ** 2).sum(-1)
    return (opacities[neighbor_idx] * torch.exp(-0.5 * maha2)).sum(-1)


def sugar_density_regularization(reg_state: SugarRegState, xyz: torch.Tensor, quats: torch.Tensor,
                                 scales: torch.Tensor, opacities: torch.Tensor, alive: torch.Tensor,
                                 draws: Tuple[torch.Tensor, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Both regulation terms, ``density_regulation`` and
    ``normal_regulation`` (the JAX package's ``use_sdf_normal_loss`` on, as
    the stage runs it), at the samples of ``draws`` = (sources, normals), as
    :func:`draw_samples` gives them."""
    src, normal = draws
    samples = sample_points_in_gaussians(xyz, quats, scales, src, normal)
    nbr = reg_state.knn_idx[src]  # (S, K)

    density = gaussian_density(samples, nbr, xyz, quats, scales, opacities)

    normals = smallest_axis_normals(quats, scales)  # (C, 3)
    src_normals = normals[src]
    sdf_est = ((samples - xyz[src]) * src_normals).sum(-1)

    min_scale = scales.min(-1).values
    beta = torch.where(alive, min_scale, torch.zeros_like(min_scale)).sum() / torch.clamp(alive.sum(), min=1)
    target = torch.exp(-0.5 * sdf_est ** 2 / torch.clamp(beta, min=1e-6) ** 2)

    nbr_normals = normals[nbr]  # (S, K, 3)
    sign = torch.sign((nbr_normals * src_normals[:, None]).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign).detach()
    nbr_normals = nbr_normals * sign
    diff = samples[:, None] - xyz[nbr]
    nbr_min = scales[nbr].min(-1).values
    nbr_opac = (opacities[nbr] * torch.exp(
        -0.5 * ((diff ** 2).sum(-1) / torch.clamp(nbr_min ** 2, min=1e-8)))).detach()
    w = ((diff * nbr_normals).sum(-1)).abs().detach()
    min_sc = (torch.clamp(nbr_min, min=1e-6) ** 2).detach()
    w = nbr_opac * w / min_sc
    w = w / torch.clamp(w.sum(-1, keepdim=True).detach(), min=1e-6)
    blended = (w[..., None] * nbr_normals).sum(-2)
    return {"density_regulation": (density - target).abs().mean(),
            "normal_regulation": ((src_normals - blended) ** 2).sum(-1).mean()}

"""Volume renderer of the implicit NeRF geometry (counterpart of
``dreammesh4d_tpu/models/renderers/nerf_volume_renderer.py``).

Two sample estimators, both with fixed sample counts per ray:

- ``importance`` — stratified coarse samples inside the ray/box interval,
  inverse-CDF resampling from the coarse weights, one fine evaluation;
- ``occgrid`` — ``occ_candidates`` cheap occupancy-grid lookups per ray, the
  geometry evaluated at the first ``occ_samples`` occupied ones.

Front-to-back compositing gives comp_rgb / depth / opacity / z-variance and
the per-sample weights and normals the orientation loss reads.  Ray batches
are flat (R, 3).

Above ``ray_chunk_train`` rays, :func:`render_rays` renders chunk by chunk
and, in grad mode, under ``torch.utils.checkpoint``: a chunk's activations
are recomputed in the backward instead of being kept for all rays.  Every
random number a chunk needs (:func:`draw_uniform`, :func:`draw_normal`) is
drawn before the checkpointed part, so the recomputation sees the same
numbers.  The draws come from an explicit ``torch.Generator`` and are made
on the generator's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ...ops.safe_math import safe_normalize
from ..geometry.implicit_volume import ImplicitVolumeConfig, forward_field, forward_with_normal


@dataclass
class NeRFRendererConfig:
    num_samples_coarse: int = 64
    num_samples_fine: int = 64
    radius: float = 2.0
    near: float = 0.05
    randomized: bool = True
    # above this many rays render_rays goes chunk by chunk, rematerialised
    # in the backward; 0 renders all rays at once
    ray_chunk_train: int = 8192
    estimator: str = "importance"  # importance | occgrid
    grid_resolution: int = 32
    occ_candidates: int = 192
    occ_samples: int = 64
    occ_thre: float = 0.01
    grid_decay: float = 0.95
    grid_update_every: int = 16


class OccGridState(NamedTuple):
    occ: torch.Tensor  # (res³,) running occupancy (alpha estimate)
    binary: torch.Tensor  # (res³,) float32 0/1


def draw_uniform(rng: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform [0, 1) numbers from ``rng``, made on its device."""
    return torch.rand(shape, generator=rng, dtype=torch.float32, device=rng.device).to(device)


def draw_normal(rng: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal numbers from ``rng``, made on its device."""
    return torch.randn(shape, generator=rng, dtype=torch.float32, device=rng.device).to(device)


def init_occgrid(rcfg: NeRFRendererConfig, device="cuda") -> OccGridState:
    """Fully occupied: dense sampling until the first update."""
    n = rcfg.grid_resolution ** 3
    return OccGridState(torch.zeros((n,), dtype=torch.float32, device=device),
                        torch.ones((n,), dtype=torch.float32, device=device))


def make_occgrid_update(geo_cfg: ImplicitVolumeConfig, rcfg: NeRFRendererConfig, device="cuda"):
    """Occupancy update: occ <- max(occ·decay, σ·march_step) at jittered cell
    centres, binarised against min(mean, occ_thre).  Returns
    ``update(state, geo_params, rng, level_mask=None) -> OccGridState``."""
    res = rcfg.grid_resolution
    r = rcfg.radius
    cell = 2.0 * r / res
    ax = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res * 2.0 * r - r
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    centers = torch.stack([gx, gy, gz], -1).reshape(-1, 3)  # (res³, 3)
    march_step = 2.0 * math.sqrt(3.0) * r / max(rcfg.occ_candidates, 1)

    @torch.no_grad()
    def update(state: OccGridState, geo_params, rng: torch.Generator, level_mask=None):
        jitter = (draw_uniform(rng, centers.shape, centers.device) - 0.5) * cell
        sigma, _ = forward_field(geo_params, geo_cfg, centers + jitter, level_mask)
        occ = torch.maximum(state.occ * rcfg.grid_decay, sigma[:, 0] * march_step)
        thresh = torch.clamp(occ.mean(), max=rcfg.occ_thre)
        return OccGridState(occ, (occ > thresh).to(torch.float32))

    return update


def _occgrid_lookup(binary: torch.Tensor, pts: torch.Tensor, radius: float,
                    res: int) -> torch.Tensor:
    """Nearest-cell occupancy of (..., 3) points -> (...) float 0/1."""
    ijk = torch.clamp(((pts + radius) / (2.0 * radius) * res).long(), 0, res - 1)
    return binary[(ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]]


def ray_bbox_intersect(rays_o, rays_d, radius: float, near: float):
    """Slab test against the [-radius, radius]³ box -> (t_near, t_far)."""
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-8, torch.full_like(rays_d, 1e-8), rays_d)
    t0 = (-radius - rays_o) * inv_d
    t1 = (radius - rays_o) * inv_d
    t_min = torch.minimum(t0, t1).amax(-1)
    t_max = torch.maximum(t0, t1).amin(-1)
    t_near = torch.clamp(t_min, min=near)
    t_far = torch.maximum(t_max, t_near + 1e-4)
    return t_near, t_far


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               rng: Optional[torch.Generator], jitter: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Inverse-CDF sampling.  bins (R, S+1), weights (R, S) -> (R, n).
    Stratified with uniform numbers from ``rng`` (or the given ``jitter``
    (R, n)); bin centres of the strata when both are ``None``."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    R = bins.shape[0]
    steps = torch.arange(n_samples, dtype=bins.dtype, device=bins.device)
    if jitter is None and rng is not None:
        jitter = draw_uniform(rng, (R, n_samples), bins.device)
    if jitter is not None:
        u = (steps + jitter) / n_samples
    else:
        u = ((steps + 0.5) / n_samples).expand(R, n_samples)
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous()) - 1, 0,
                      weights.shape[-1] - 1)
    cdf_lo = torch.gather(cdf, -1, idx)
    cdf_hi = torch.gather(cdf, -1, idx + 1)
    bin_lo = torch.gather(bins, -1, idx)
    bin_hi = torch.gather(bins, -1, idx + 1)
    frac = torch.clamp((u - cdf_lo) / torch.clamp(cdf_hi - cdf_lo, min=1e-8), 0, 1)
    return bin_lo + frac * (bin_hi - bin_lo)


def _composite(density: torch.Tensor, dt: torch.Tensor):
    """density (R,S,1), dt (R,S) -> weights (R,S), opacity (R,1)."""
    alpha = 1.0 - torch.exp(-density[..., 0] * dt)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    weights = alpha * trans
    return weights, weights.sum(-1, keepdim=True)


def _draw_samples(rcfg: NeRFRendererConfig, rng: Optional[torch.Generator], R: int,
                  use_occ: bool, want_perturb: bool, device) -> Dict[str, torch.Tensor]:
    """Every random number one call of :func:`_render` needs for R rays:
    the sample jitter (only with ``rng`` and ``rcfg.randomized``) and the
    N(0, 1e-2) position noise of the perturbed normals (from ``rng``, or
    from a fixed seed without one)."""
    draws: Dict[str, torch.Tensor] = {}
    if rng is not None and rcfg.randomized:
        if use_occ:
            draws["jitter"] = draw_uniform(rng, (R, rcfg.occ_candidates), device)
        else:
            draws["jitter"] = draw_uniform(rng, (R, rcfg.num_samples_coarse), device)
            draws["jitter_fine"] = draw_uniform(rng, (R, rcfg.num_samples_fine), device)
    if want_perturb:
        K = rcfg.occ_samples if use_occ else rcfg.num_samples_coarse + rcfg.num_samples_fine
        gen = rng if rng is not None else torch.Generator(device=device).manual_seed(0)
        draws["perturb"] = draw_normal(gen, (R, K, 3), device) * 1e-2
    return draws


def _draws_of_rows(rcfg: NeRFRendererConfig, rng: Optional[torch.Generator], lo: int, R: int,
                   total: int, use_occ: bool, want_perturb: bool, device) -> Dict[str, torch.Tensor]:
    """The random numbers of rays [lo, lo + R) of a :func:`render_rays`
    call over ``total`` rays: every chunk's draws in that call's order, the
    rows outside kept nowhere."""
    chunk = rcfg.ray_chunk_train
    step = chunk if chunk and total > chunk else total
    parts = []
    for s in range(0, total, step):
        e = min(s + step, total)
        draws = _draw_samples(rcfg, rng, e - s, use_occ, want_perturb, device)
        a, b = max(s, lo), min(e, lo + R)
        if a < b:
            parts.append({k: v[a - s:b - s] for k, v in draws.items()})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]} if parts else {}


def _render(geo_params, geo_cfg, rcfg, rays_o, rays_d, light_positions, bg_color, draws,
            ambient_ratio, shading_normal_only, level_mask, material, occ_state):
    """All of ``rays_o``'s rays at once, with the random numbers in ``draws``."""
    R = rays_o.shape[0]
    dev = rays_o.device
    t_near, t_far = ray_bbox_intersect(rays_o, rays_d, rcfg.radius, rcfg.near)
    jitter = draws.get("jitter")

    # the strata in the rays' dtype: a float32 division by S rounds differently on the card
    # (a product with 1/S) than on the CPU, which a float64 render would carry
    if occ_state is not None:
        S, K = rcfg.occ_candidates, rcfg.occ_samples
        steps = torch.arange(S, dtype=rays_o.dtype, device=dev)
        if jitter is not None:
            su = (steps[None] + jitter) / S
        else:
            su = ((steps + 0.5) / S)[None].expand(R, S)
        t_cand = t_near[:, None] + (t_far - t_near)[:, None] * su  # (R, S)
        pts_cand = rays_o[:, None] + t_cand[..., None] * rays_d[:, None]
        occ = _occgrid_lookup(occ_state.binary, pts_cand, rcfg.radius, rcfg.grid_resolution)
        # the first K occupied candidates, in order: occupied ones keep their
        # index as sort key, the others are pushed past S (distinct keys)
        idx = torch.arange(S, device=dev)[None].expand(R, S)
        sel = torch.argsort(torch.where(occ > 0.5, idx, idx + S), dim=-1)[:, :K]
        t_all = torch.gather(t_cand, -1, sel)  # (R, K)
        occ_sel = torch.gather(occ, -1, sel)
        pts = rays_o[:, None] + t_all[..., None] * rays_d[:, None]
        density, features, normal = forward_with_normal(geo_params, geo_cfg, pts, level_mask)
        density = density * occ_sel[..., None]  # filler samples carry nothing
        dt = ((t_far - t_near) / S)[:, None].expand(t_all.shape)
        weights, opacity = _composite(density, dt)
    else:
        S1, S2 = rcfg.num_samples_coarse, rcfg.num_samples_fine
        su = (torch.arange(S1 + 1, dtype=rays_o.dtype, device=dev) / S1)[None, :]
        bins = t_near[:, None] + (t_far - t_near)[:, None] * su  # (R, S1+1)
        if jitter is not None:
            t_coarse = bins[:, :-1] + (t_far - t_near)[:, None] * (jitter.to(rays_o.dtype) / S1)
        else:
            t_coarse = 0.5 * (bins[:, :-1] + bins[:, 1:])
        with torch.no_grad():
            pts_coarse = rays_o[:, None] + t_coarse[..., None] * rays_d[:, None]
            sigma_coarse, _ = forward_field(geo_params, geo_cfg, pts_coarse, level_mask)
            w_coarse, _ = _composite(sigma_coarse, torch.diff(bins, dim=-1))
        t_fine = sample_pdf(bins, w_coarse, S2, None, jitter=draws.get("jitter_fine"))
        t_all = torch.sort(torch.cat([t_coarse, t_fine], -1), -1).values  # (R, S1+S2)
        pts = rays_o[:, None] + t_all[..., None] * rays_d[:, None]
        density, features, normal = forward_with_normal(geo_params, geo_cfg, pts, level_mask)
        dt = torch.diff(t_all, dim=-1)
        dt = torch.cat([dt, torch.full_like(dt[:, :1], 1e-3)], -1)
        weights, opacity = _composite(density, dt)

    # n_feature_dims may exceed 3: the background sets how many are shaded
    n_ch = bg_color.shape[-1] if bg_color.ndim else 3
    albedo = torch.sigmoid(features[..., :n_ch])
    if material is not None:
        rgb_samples = material.shade(albedo, normal, pts, light_positions[:, None, :],
                                     ambient_ratio=ambient_ratio,
                                     shading_normal_only=shading_normal_only)
    else:
        rgb_samples = albedo

    comp_rgb_fg = (weights[..., None] * rgb_samples).sum(-2)
    depth = (weights * t_all).sum(-1, keepdim=True)
    comp_normal = safe_normalize((weights[..., None] * normal).sum(-2))
    z_mean = depth / torch.clamp(opacity, min=1e-6)
    z_var = (weights * (t_all - z_mean) ** 2).sum(-1, keepdim=True) / torch.clamp(
        opacity[:, 0], min=1e-6)[:, None]
    comp_rgb = comp_rgb_fg + (1.0 - opacity) * bg_color.expand(comp_rgb_fg.shape)

    out = {
        "comp_rgb": comp_rgb,
        "comp_rgb_fg": comp_rgb_fg,
        "comp_normal": comp_normal * 0.5 + 0.5,
        "opacity": opacity,
        "depth": depth,
        "z_variance": z_var,
        "weights": weights,
        "normal": normal,
        "t_dirs": rays_d[:, None].expand(normal.shape),
    }
    if "perturb" in draws:
        # normals at the sample positions + noise: the target of the 3D
        # normal smoothness
        out["normal_perturb"] = forward_with_normal(
            geo_params, geo_cfg, pts + draws["perturb"], level_mask)[2]
    return out


def render_rays(
    geo_params,
    geo_cfg: ImplicitVolumeConfig,
    rcfg: NeRFRendererConfig,
    rays_o: torch.Tensor,  # (R, 3)
    rays_d: torch.Tensor,  # (R, 3) normalised
    light_positions: torch.Tensor,  # (R, 3)
    bg_color: torch.Tensor,  # (3,) or (R, 3)
    rng: Optional[torch.Generator] = None,
    ambient_ratio: Optional[float] = None,
    shading_normal_only: bool = False,
    level_mask=None,
    material=None,
    return_normal_perturb: bool = False,
    occ_state: Optional[OccGridState] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """Render flat rays.  ``rng=None`` (or ``rcfg.randomized`` off) places
    the samples at the centres of their strata.  ``rows = (offset, total)``
    says that the rays are rows [offset, offset + R) of a call over
    ``total`` rays (one data-parallel rank's share): the random numbers are
    then those that call draws, of which these rows are kept.  Returns comp_rgb,
    comp_rgb_fg, comp_normal (in [0, 1]), opacity, depth, z_variance (R, ·)
    and per-sample weights (R, K), normal and t_dirs (R, K, 3), plus
    normal_perturb with ``return_normal_perturb``."""
    R = rays_o.shape[0]
    dev = rays_o.device
    use_occ = rcfg.estimator == "occgrid" and occ_state is not None
    if not use_occ:
        occ_state = None
    common = (ambient_ratio, shading_normal_only, level_mask, material, occ_state)
    chunk = rcfg.ray_chunk_train
    all_draws = None
    if rows is not None:
        all_draws = _draws_of_rows(rcfg, rng, rows[0], R, rows[1], use_occ, return_normal_perturb,
                                   dev)
    if not chunk or R <= chunk:
        draws = all_draws if all_draws is not None else _draw_samples(
            rcfg, rng, R, use_occ, return_normal_perturb, dev)
        return _render(geo_params, geo_cfg, rcfg, rays_o, rays_d, light_positions, bg_color,
                       draws, *common)

    # chunk by chunk; in grad mode each chunk is rematerialised in the
    # backward, so the peak holds the outputs plus one chunk's activations
    per_ray_bg = bg_color.ndim == 2
    remat = torch.is_grad_enabled()
    outs = []
    for s in range(0, R, chunk):
        sl = slice(s, min(s + chunk, R))
        if all_draws is not None:
            draws = {k: v[sl] for k, v in all_draws.items()}
        else:
            draws = _draw_samples(rcfg, rng, sl.stop - sl.start, use_occ, return_normal_perturb, dev)

        def chunk_fn(ro, rd, lp, bg, draws=draws):
            return _render(geo_params, geo_cfg, rcfg, ro, rd, lp, bg, draws, *common)

        args = (rays_o[sl], rays_d[sl], light_positions[sl], bg_color[sl] if per_ray_bg else bg_color)
        if remat:
            outs.append(checkpoint(chunk_fn, *args, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(chunk_fn(*args))
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def make_image_renderer(geo_cfg, rcfg, material=None, ray_chunk: int = 16384):
    """``render_image(geo_params, rays_o (H,W,3), rays_d, light_position,
    bg_color, level_mask=None, ambient_ratio=None)`` -> comp_rgb /
    comp_normal / opacity / depth as (H, W, ·) images, rendered
    ``ray_chunk`` rays at a time without gradients (the evaluation path)."""

    @torch.no_grad()
    def render_image(geo_params, rays_o, rays_d, light_position, bg_color, level_mask=None,
                     ambient_ratio=None):
        H, W = rays_o.shape[:2]
        ro = rays_o.reshape(-1, 3)
        rd = rays_d.reshape(-1, 3)
        lp = light_position.expand(ro.shape)
        chunks = []
        for s in range(0, ro.shape[0], ray_chunk):
            sl = slice(s, s + ray_chunk)
            out = render_rays(geo_params, geo_cfg, rcfg, ro[sl], rd[sl], lp[sl], bg_color,
                              rng=None, ambient_ratio=ambient_ratio, level_mask=level_mask,
                              material=material)
            chunks.append({k: out[k] for k in ("comp_rgb", "comp_normal", "opacity", "depth")})
        return {k: torch.cat([c[k] for c in chunks], 0).reshape(H, W, -1) for k in chunks[0]}

    return render_image

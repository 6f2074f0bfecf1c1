"""Vanilla 3D Gaussian splatting geometry with adaptive density control
(counterpart of ``dreammesh4d_tpu/models/geometry/gaussian.py``), the
geometry of the Gaussian stage (``system.stage: gaussian``).

The store is a FIXED-CAPACITY buffer of ``capacity`` slots with an
``alive`` mask, as in the JAX package: densify, clone, split and prune are
masked slot rewrites, and the Adam moment surgery zeroes the moments of the
rewritten slots.

- screen-space gradient statistics accumulate every step (:func:`update_stats`);
- clone: small Gaussians whose mean screen gradient reaches the threshold
  are copied into dead slots; split: large ones are re-sampled from their
  own covariance, the antithetic second sample written into the source,
  both shrunk by 1.6;
- prune: opacity below ``min_opacity``, or world / screen size too large,
  clears ``alive``; :func:`reset_opacity` clamps the logits.

At most ``max_new_per_step`` new Gaussians per call: the sources are the
top-K by mean gradient, the destinations the first K dead slots.  Every
function is eager PyTorch on the state's device; the random draws come from
an explicit ``torch.Generator`` and can be passed in instead (a test feeds
the JAX package's draws).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ...ops.knn import dist_knn3_mean
from ...ops.quaternion import quat_apply, quat_normalize
from ...ops.sh import num_sh_bases, rgb_to_sh_dc


@dataclass(frozen=True)
class GaussianConfig:
    capacity: int = 200_000
    sh_degree: int = 3
    init_num: int = 5000
    init_radius: float = 0.5
    init_opacity: float = 0.1
    percent_dense: float = 0.01
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    max_screen_size: float = 20.0  # px; <= 0 turns the screen-size prune off
    max_world_size_ratio: float = 0.1  # × spatial extent; <= 0 turns it off
    spatial_extent: float = 3.8
    max_new_per_step: int = 8192


class GaussianState(NamedTuple):
    xyz: torch.Tensor  # (C, 3)
    sh_dc: torch.Tensor  # (C, 1, 3)
    sh_rest: torch.Tensor  # (C, B-1, 3)
    log_scales: torch.Tensor  # (C, 3)
    quats: torch.Tensor  # (C, 4) wxyz
    opacity_logits: torch.Tensor  # (C,)
    alive: torch.Tensor  # (C,) bool


class DensifyStats(NamedTuple):
    grad_accum: torch.Tensor  # (C,) float32
    denom: torch.Tensor  # (C,) float32
    max_radii: torch.Tensor  # (C,) int32


def empty_stats(capacity: int, device="cuda") -> DensifyStats:
    dev = torch.device(device)
    return DensifyStats(torch.zeros(capacity, device=dev), torch.zeros(capacity, device=dev),
                        torch.zeros(capacity, dtype=torch.int32, device=dev))


def _inverse_sigmoid(x: float) -> float:
    return float(np.log(x / (1 - x)))


def _padded_state(cfg: GaussianConfig, pts: torch.Tensor, colors: torch.Tensor) -> GaussianState:
    """Slots [0, N) from the points and colours (scales from the 3-NN mean
    distance), the rest dead: zero centre and SH, log-scales and opacity
    logits -10, identity rotation."""
    C, N, dev = cfg.capacity, pts.shape[0], pts.device
    dist2 = torch.clamp(dist_knn3_mean(pts), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    B = num_sh_bases(cfg.sh_degree)

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((C - N,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)])

    quats = torch.zeros(C, 4, device=dev)
    quats[:, 0] = 1.0
    return GaussianState(
        xyz=pad(pts),
        sh_dc=pad(rgb_to_sh_dc(colors)[:, None, :]),
        sh_rest=pad(torch.zeros(N, B - 1, 3, device=dev)),
        log_scales=pad(scales, -10.0),
        quats=quats,
        opacity_logits=pad(torch.full((N,), _inverse_sigmoid(cfg.init_opacity), device=dev), -10.0),
        alive=torch.arange(C, device=dev) < N,
    )


def init_random_sphere(cfg: GaussianConfig, generator: torch.Generator,
                       draws: Optional[Dict[str, torch.Tensor]] = None, device="cuda") -> GaussianState:
    """``init_num`` Gaussians uniform in a ball of ``init_radius`` with
    random colours.  ``draws`` replaces the generator's: ``u`` (N, 1)
    uniform radii, ``normal`` (N, 3) directions, ``colors`` (N, 3)."""
    dev = torch.device(device)
    N = cfg.init_num
    if draws is None:
        draws = {"u": torch.rand((N, 1), generator=generator, device=generator.device),
                 "normal": torch.randn((N, 3), generator=generator, device=generator.device),
                 "colors": torch.rand((N, 3), generator=generator, device=generator.device)}
    u, d, colors = (torch.as_tensor(draws[k], dtype=torch.float32).to(dev) for k in ("u", "normal", "colors"))
    r = cfg.init_radius * u ** (1 / 3)
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9)
    return _padded_state(cfg, r * d, colors)


def from_mesh_vertices(cfg: GaussianConfig, v_pos: np.ndarray, v_rgb: Optional[np.ndarray],
                       device="cuda") -> GaussianState:
    """The first ``capacity`` points of a (vertex-coloured) point set; grey
    without colours."""
    dev = torch.device(device)
    N = min(len(v_pos), cfg.capacity)
    pts = torch.as_tensor(np.asarray(v_pos[:N], np.float32), device=dev)
    colors = (torch.as_tensor(np.asarray(v_rgb[:N], np.float32), device=dev) if v_rgb is not None
              else torch.full((N, 3), 0.5, device=dev))
    return _padded_state(cfg, pts, colors)


def renderable(state: GaussianState):
    """(means, quats, scales, opacities, sh (C, 3, B)): unit quaternions,
    and dead slots at opacity 0, so that the binning culls them."""
    opac = torch.sigmoid(state.opacity_logits) * state.alive
    sh = torch.cat([state.sh_dc, state.sh_rest], 1)
    return state.xyz, quat_normalize(state.quats), torch.exp(state.log_scales), opac, sh.transpose(-1, -2)


def update_stats(stats: DensifyStats, means2d_grad: torch.Tensor, radii: torch.Tensor,
                 visibility: torch.Tensor) -> DensifyStats:
    """Accumulate ‖∂L/∂means2d‖ and the largest screen radius of the
    visible Gaussians."""
    gnorm = torch.linalg.norm(means2d_grad, dim=-1)
    vis = visibility.to(torch.float32)
    return DensifyStats(stats.grad_accum + gnorm * vis, stats.denom + vis,
                        torch.maximum(stats.max_radii, radii * visibility))


def _stable_top(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest, ties by lower index (``lax.top_k``)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


@torch.no_grad()
def densify_and_prune(state: GaussianState, stats: DensifyStats, cfg: GaussianConfig,
                      generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
                      adam_mu: Optional[Dict[str, torch.Tensor]] = None,
                      adam_nu: Optional[Dict[str, torch.Tensor]] = None):
    """One adaptive-density-control pass.  Returns ``(state, stats, mu, nu,
    info)``: new tensors (the inputs are not written), the statistics
    emptied, the Adam moment dicts (field -> tensor, or None) with every
    rewritten slot zeroed, and ``info`` with ``n_cloned``, ``n_split``,
    ``n_pruned`` and ``n_alive`` as 0-d tensors.  ``noise`` (K, 3) standard
    normal draws, K = min(``max_new_per_step``, capacity), replaces the
    generator's."""
    C = cfg.capacity
    K = min(cfg.max_new_per_step, C)
    dev = state.xyz.device
    grad_avg = stats.grad_accum / torch.clamp(stats.denom, min=1.0)
    scales = torch.exp(state.log_scales)
    max_scale = scales.max(-1).values
    thresh_size = cfg.percent_dense * cfg.spatial_extent

    wants = (grad_avg >= cfg.densify_grad_threshold) & state.alive
    want_clone = wants & (max_scale <= thresh_size)
    want_split = wants & (max_scale > thresh_size)
    want_new = want_clone | want_split

    opac = torch.sigmoid(state.opacity_logits)
    prune = opac < cfg.min_opacity
    if cfg.max_world_size_ratio > 0:
        prune = prune | (max_scale > cfg.max_world_size_ratio * cfg.spatial_extent)
    if cfg.max_screen_size > 0:
        prune = prune | (stats.max_radii > cfg.max_screen_size)
    prune = prune & ~want_split  # split sources are rewritten, not pruned
    alive = state.alive & ~prune

    minus_one = torch.full_like(grad_avg, -1.0)
    priority = torch.where(want_new & alive, grad_avg, minus_one)
    src = _stable_top(priority, K)
    src_valid = priority[src] > 0
    ramp = C - torch.arange(C, device=dev, dtype=torch.float32)
    dead_score = torch.where(alive, minus_one, torch.ones_like(minus_one)) * ramp
    dst = _stable_top(dead_score, K)
    valid = src_valid & ~alive[dst]

    is_split = want_split[src]
    if noise is None:
        noise = torch.randn((K, 3), generator=generator, device=generator.device)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(dev) * scales[src]
    offset = quat_apply(quat_normalize(state.quats[src]), noise)
    split_scale = torch.log(torch.clamp(scales[src] / 1.6, min=1e-7))
    split_col = is_split[:, None]
    new_xyz = torch.where(split_col, state.xyz[src] + offset, state.xyz[src])
    new_ls = torch.where(split_col, split_scale, state.log_scales[src])

    def scatter(arr, upd):
        out = arr.clone()
        keep = valid.reshape((-1,) + (1,) * (upd.dim() - 1))
        out[dst] = torch.where(keep, upd, arr[dst])
        return out

    new_alive = alive.clone()
    new_alive[dst] = valid | alive[dst]
    xyz = scatter(state.xyz, new_xyz)
    log_scales = scatter(state.log_scales, new_ls)
    quats = scatter(state.quats, state.quats[src])
    # a split also rewrites its SOURCE: the antithetic sample, the shrunk scale
    src_upd = valid & is_split
    offset2 = quat_apply(quat_normalize(quats[src]), -noise)
    xyz[src] = torch.where(src_upd[:, None], xyz[src] + offset2, xyz[src])
    log_scales[src] = torch.where(src_upd[:, None], split_scale, log_scales[src])
    state = GaussianState(
        xyz=xyz, sh_dc=scatter(state.sh_dc, state.sh_dc[src]),
        sh_rest=scatter(state.sh_rest, state.sh_rest[src]), log_scales=log_scales, quats=quats,
        opacity_logits=scatter(state.opacity_logits, state.opacity_logits[src]), alive=new_alive)

    if adam_mu is not None:
        # in the JAX order: a destination that is also a (filler) source takes
        # the source's flag, as ``.at[dst].set(valid).at[src].set(src_upd)`` does
        touched = torch.zeros(C, dtype=torch.bool, device=dev)
        touched[dst] = valid
        touched[src] = src_upd

        def zero_slots(moments):
            return {k: torch.where(touched.reshape((-1,) + (1,) * (m.dim() - 1)), torch.zeros_like(m), m)
                    if m.shape[:1] == (C,) else m for k, m in moments.items()}

        adam_mu, adam_nu = zero_slots(adam_mu), zero_slots(adam_nu)

    info = {"n_cloned": (valid & ~is_split).sum(), "n_split": src_upd.sum(), "n_pruned": prune.sum(),
            "n_alive": state.alive.sum()}
    return state, empty_stats(C, dev), adam_mu, adam_nu, info


def reset_opacity(state: GaussianState, max_opacity: float = 0.01) -> GaussianState:
    """Clamp the opacities down to ``max_opacity``."""
    cap = _inverse_sigmoid(max_opacity)
    return state._replace(opacity_logits=torch.clamp(state.opacity_logits, max=cap))


def prune_by_opacity(state: GaussianState, threshold: float = 0.5) -> GaussianState:
    """One-shot hard prune of the Gaussians below ``threshold`` opacity."""
    return state._replace(alive=state.alive & (torch.sigmoid(state.opacity_logits) >= threshold))

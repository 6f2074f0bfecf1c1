"""Tile binning for the Gaussian rasterizer (counterpart of
``dreammesh4d_tpu/ops/gs/binning.py``: ``_tile_cull`` :60,
``_expand_pairs_mn`` :109, ``bin_gaussians`` :140, ``bin_gaussians_pairs``
:220, ``bin_gaussians_ranks`` :293).

Every Gaussian emits up to ``max_tiles_per_gaussian`` (tile, depth, id)
pairs — its tile AABB enumerated row-major (``getRect`` clipping), each pair
kept only if the Gaussian can reach alpha ≥ 1/255 inside the tile (exact
ellipse–rectangle cull).  Two layouts of the result:

- :func:`bin_gaussians_pairs` (the ``pallas_resident`` and ``xla``
  backends): one sort over the packed key ``tile << 20 | quantized depth``
  groups the pairs by tile, front to back; per-tile segment starts and counts
  come from a binary search on the sorted keys.  Keys are int64 here (the JAX
  package packs them into int32).  The sort is unstable by contract: pairs
  with the same tile and quantized depth come out in any order.
- :func:`bin_gaussians` (the ``pallas`` backend): fixed 16-px tiles, the
  Gaussians ranked by a stable depth argsort, one sort over the packed key
  ``tile << rank_bits | depth rank``, and each tile's first ``K`` entries
  gathered into a dense ``(T, K)`` index table.  The order is exact, so the
  table equals the JAX package's entry for entry.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16  # default pixels per tile side


class TileAssignment(NamedTuple):
    """Dense per-tile index table (``bin_gaussians``)."""

    tile_gauss: torch.Tensor  # (T, K) int32 Gaussian ids, front to back; N past a tile's count
    tile_counts: torch.Tensor  # (T,) int32 per-tile counts before the cut at K (may exceed K)


class PairAssignment(NamedTuple):
    """Sorted pair array and its per-tile segments."""

    sorted_gauss: torch.Tensor  # (N*M,) int32 Gaussian ids, grouped by tile, front to back; N = invalid
    starts: torch.Tensor  # (T,) int32 segment starts
    counts: torch.Tensor  # (T,) int32 segment lengths (before any capacity cut)
    sorted_keys: torch.Tensor  # (N*M,) int64 packed tile << depth_bits | qdepth (or | rank)
    # rank mode (bin_gaussians_ranks): sorted_gauss holds DEPTH RANKS into a
    # row table in depth order; these map its rows back to Gaussians
    depth_order: Optional[torch.Tensor] = None  # (N,) int64 Gaussian id at each rank
    inv_rank: Optional[torch.Tensor] = None  # (N,) int64 rank of each Gaussian


def num_tiles(W: int, H: int, tile: int = TILE) -> tuple[int, int]:
    return (W + tile - 1) // tile, (H + tile - 1) // tile


def _tile_cull(tile_x, tile_y, mx, my, conics, opacities, tile=TILE):
    """True where the pair provably contributes alpha < 1/255 (or power <
    −4.5) on EVERY pixel of the tile.  The max of alpha over the tile rect
    is op·exp(−minQ/2) with minQ the min of the conic quadratic over the
    rect: 0 if the mean lies inside, else the min over the four edges (each
    a 1-D quadratic with a clamped closed-form argmin)."""
    ca = conics[:, 0][None, :]
    cb = conics[:, 1][None, :]
    cc = conics[:, 2][None, :]
    op = opacities[None, :]
    X0 = (tile_x * tile).to(torch.float32)
    Y0 = (tile_y * tile).to(torch.float32)
    dx0 = X0 - mx
    dx1 = X0 + (tile - 1) - mx
    dy0 = Y0 - my
    dy1 = Y0 + (tile - 1) - my
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)

    sa = torch.clamp(ca, min=1e-12)
    sc = torch.clamp(cc, min=1e-12)

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def q_edge_x(d):  # fixed dx = d, dy free in [dy0, dy1]
        t = clip(-cb * d / sc, dy0, dy1)
        return ca * d * d + 2.0 * cb * d * t + cc * t * t

    def q_edge_y(e):  # fixed dy = e, dx free in [dx0, dx1]
        t = clip(-cb * e / sa, dx0, dx1)
        return ca * t * t + 2.0 * cb * t * e + cc * e * e

    min_q = torch.minimum(
        torch.minimum(q_edge_x(dx0), q_edge_x(dx1)),
        torch.minimum(q_edge_y(dy0), q_edge_y(dy1)),
    )
    min_q = torch.where(inside, torch.zeros_like(min_q), min_q)
    bound = torch.clamp(2.0 * torch.log(torch.clamp(op, min=1e-12) * 255.0), max=9.0)
    return min_q > bound


def _expand_pairs_mn(means2d, radii, mask, tiles_x, tiles_y, M,
                     conics=None, opacities=None, tile=TILE):
    """(M, N)-layout pair expansion: AABB tile clip, span/validity, exact
    per-tile culling, sentinel tile T.  Returns (tile_ids (M,N) int64 with T
    for invalid pairs, pair_valid (M,N))."""
    T = tiles_x * tiles_y
    r = radii.to(torch.float32)
    mx, my = means2d[:, 0], means2d[:, 1]
    x0 = torch.clamp(torch.floor((mx - r) / tile), 0, tiles_x).long()
    y0 = torch.clamp(torch.floor((my - r) / tile), 0, tiles_y).long()
    x1 = torch.clamp(torch.floor((mx + r) / tile) + 1, 0, tiles_x).long()
    y1 = torch.clamp(torch.floor((my + r) / tile) + 1, 0, tiles_y).long()
    span_w = torch.clamp(x1 - x0, min=0)
    span_h = torch.clamp(y1 - y0, min=0)
    n_span = span_w * span_h
    alive = mask & (radii > 0) & (n_span > 0)

    m = torch.arange(M, device=means2d.device)[:, None]  # (M, 1)
    sw = torch.clamp(span_w, min=1)[None, :]  # (1, N)
    dx = m % sw
    dy = m // sw
    pair_valid = alive[None, :] & (m < n_span[None, :])
    tx = x0[None, :] + dx
    ty = y0[None, :] + dy
    if conics is not None and opacities is not None:
        culled = _tile_cull(tx, ty, mx[None, :], my[None, :], conics, opacities, tile=tile)
        pair_valid = pair_valid & ~culled
    tile_ids = torch.where(pair_valid, ty * tiles_x + tx, torch.full_like(tx, T))
    return tile_ids, pair_valid


def _tile_segments(sorted_keys: torch.Tensor, T: int, shift: int):
    """Per-tile (starts, counts), int64, of keys ``tile << shift | low bits``
    sorted ascending: a binary search for each tile's first key."""
    bounds = torch.searchsorted(
        sorted_keys, torch.arange(T + 1, device=sorted_keys.device, dtype=torch.int64) << shift,
        side="left")
    return bounds[:T], bounds[1:] - bounds[:-1]


def bin_gaussians_pairs(means2d: torch.Tensor, radii: torch.Tensor, depths: torch.Tensor,
                        mask: torch.Tensor, W: int, H: int,
                        max_tiles_per_gaussian: int = 16, depth_bits: int = 20,
                        conics=None, opacities=None, tile: int = TILE) -> PairAssignment:
    """Pair-array binning with quantized-depth packed keys: depth quantized
    to ``depth_bits`` levels over the visible range only orders pairs within
    a tile."""
    N = means2d.shape[0]
    tiles_x, tiles_y = num_tiles(W, H, tile)
    T = tiles_x * tiles_y
    M = max_tiles_per_gaussian
    dev = means2d.device

    alive = mask & (radii > 0)
    inf = torch.tensor(float("inf"), device=dev)
    d_lo = torch.where(alive, depths, inf).min()
    d_hi = torch.where(alive, depths, -inf).max()
    levels = (1 << depth_bits) - 1
    scale = levels / torch.clamp(d_hi - d_lo, min=1e-6)
    qdepth = torch.clamp((depths - d_lo) * scale, 0, levels).long()

    tile_ids, _ = _expand_pairs_mn(means2d, radii, mask, tiles_x, tiles_y, M,
                                   conics, opacities, tile=tile)
    keys = ((tile_ids << depth_bits) | qdepth[None, :]).reshape(-1)
    gauss = torch.arange(N, device=dev, dtype=torch.int32)[None, :].expand(M, N).reshape(-1)
    sorted_keys, order = torch.sort(keys)
    sorted_gauss = gauss[order]
    # sentinel pairs (tile T) carry gauss id N for padded reads
    sorted_gauss = torch.where(sorted_keys >= (T << depth_bits),
                               torch.full_like(sorted_gauss, N), sorted_gauss)
    starts, counts = _tile_segments(sorted_keys, T, depth_bits)
    return PairAssignment(sorted_gauss, starts.to(torch.int32), counts.to(torch.int32), sorted_keys)


def bin_gaussians(means2d: torch.Tensor, radii: torch.Tensor, depths: torch.Tensor,
                  mask: torch.Tensor, W: int, H: int, tile_capacity: int = 512,
                  max_tiles_per_gaussian: int = 16, conics=None, opacities=None) -> TileAssignment:
    """(T, K)-table binning on fixed ``TILE``-px tiles, K = ``tile_capacity``.

    The within-tile order is the exact depth rank of a STABLE argsort, as
    ``jnp.argsort`` gives it, so Gaussians of equal depth keep their index
    order.  Raises ``ValueError`` where the JAX package's int32 key would
    overflow (rank bits + tile bits > 31), so both fail on the same inputs.
    Tiles holding more than K entries keep the K nearest; ``tile_counts``
    keeps the true count."""
    N = means2d.shape[0]
    tiles_x, tiles_y = num_tiles(W, H)
    T = tiles_x * tiles_y
    M = max_tiles_per_gaussian
    K = tile_capacity
    dev = means2d.device
    rank_bits = N.bit_length()  # rank < N
    tile_bits = (T + 1).bit_length()
    if rank_bits + tile_bits > 31:
        raise ValueError(
            f"Packed binning key overflow: {N} gaussians x {T} tiles needs "
            f"{rank_bits}+{tile_bits} bits; reduce image size or gaussian count")

    tile_ids, _ = _expand_pairs_mn(means2d, radii, mask, tiles_x, tiles_y, M, conics, opacities)
    depth_order = torch.argsort(depths, stable=True)  # (N,) front to back
    rank = torch.arange(N, device=dev)[None, :]
    keys = ((tile_ids[:, depth_order] << rank_bits) | rank).reshape(-1)
    sorted_keys, _ = torch.sort(keys)
    sorted_gauss = depth_order[sorted_keys & ((1 << rank_bits) - 1)]

    starts, counts = _tile_segments(sorted_keys, T, rank_bits)
    k = torch.arange(K, device=dev)[None, :]
    idx = torch.clamp(starts[:, None] + k, 0, max(N * M - 1, 0))
    tile_gauss = torch.where(k < counts[:, None], sorted_gauss[idx], torch.full_like(idx, N))
    return TileAssignment(tile_gauss.to(torch.int32), counts.to(torch.int32))


def bin_gaussians_ranks(means2d: torch.Tensor, radii: torch.Tensor, depths: torch.Tensor,
                        mask: torch.Tensor, W: int, H: int, max_tiles_per_gaussian: int = 16,
                        conics=None, opacities=None, tile: int = TILE) -> PairAssignment:
    """Pair-array binning keyed by the exact depth rank.  ``sorted_gauss``
    holds ranks: the caller gathers its row table by ``depth_order`` and puts
    per-Gaussian outputs back by ``inv_rank`` (``blend_image_resident`` does
    both).  The rank is that of a STABLE argsort, as ``jnp.argsort`` gives
    it; sentinel pairs carry rank N (the zero row past the table).  Raises
    ``ValueError`` where the JAX package's int32 key would overflow (tile
    bits + rank bits > 31), so both fail on the same inputs."""
    N = means2d.shape[0]
    tiles_x, tiles_y = num_tiles(W, H, tile)
    T = tiles_x * tiles_y
    M = max_tiles_per_gaussian
    dev = means2d.device
    rank_bits = N.bit_length()
    tile_bits = (T + 1).bit_length()
    if tile_bits + rank_bits > 31:
        raise ValueError(f"{T} tiles x {N} gaussians overflow the JAX package's int32 key "
                         f"({tile_bits}+{rank_bits} bits)")

    depth_order = torch.argsort(depths, stable=True)  # (N,) front to back
    inv_rank = torch.empty_like(depth_order)
    inv_rank[depth_order] = torch.arange(N, device=dev)
    # the pairs' tiles in rank space: the projection's outputs permuted once
    tile_ids, pair_valid = _expand_pairs_mn(
        means2d[depth_order], radii[depth_order], mask[depth_order], tiles_x, tiles_y, M,
        None if conics is None else conics[depth_order],
        None if opacities is None else opacities[depth_order], tile=tile)
    rank = torch.arange(N, device=dev)[None, :].expand(M, N)
    rank = torch.where(pair_valid, rank, torch.full_like(rank, N))
    keys = ((tile_ids << rank_bits) | rank).reshape(-1)
    sorted_keys, _ = torch.sort(keys)
    sorted_rank = (sorted_keys & ((1 << rank_bits) - 1)).to(torch.int32)
    starts, counts = _tile_segments(sorted_keys, T, rank_bits)
    return PairAssignment(sorted_rank, starts.to(torch.int32), counts.to(torch.int32), sorted_keys,
                          depth_order=depth_order, inv_rank=inv_rank)

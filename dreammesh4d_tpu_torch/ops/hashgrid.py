"""Multi-resolution hash-grid encodings (counterpart of
``dreammesh4d_tpu/ops/hashgrid.py``), plain PyTorch.

Two table layouts:

- ``corner`` — instant-NGP tables ``(L, T, F)``: eight hashed corner reads
  per (point, level), trilinearly blended (:func:`hashgrid_encode`);
- ``cell`` — cell-packed tables ``(L, T, 8·F)``: the eight corner feature
  vectors of a cell lie in one row, so a (point, level) costs one row read.
  The row of a cell is its dense id where ``res³ ≤ T`` and a spatial hash of
  the cell coordinate otherwise.  Corners are not shared between
  neighbouring cells, so the field is discontinuous at cell faces.
  :func:`hashgrid_encode_cell` is the plain version of the hand-written
  kernels behind ``ops/hashgrid_cell.py``; the tests and CPU tensors use it.

The spatial hash is instant-NGP's, in uint32 wrap-around arithmetic.  The
second prime exceeds 2³¹, so it is computed in int64 and masked to 32 bits
before the xor.  Also here: :func:`progressive_level_mask` and the NeRF
sin/cos :func:`frequency_encode`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclass
class HashGridConfig:
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.447269237440378
    # progressive band: start_level levels first, one more every update_steps
    progressive: bool = False
    start_level: int = 4
    start_step: int = 0
    update_steps: int = 1000
    # "corner" tables are (T, F); "cell" tables are (T, 8F) and
    # log2_hashmap_size counts cell rows (the shipped config uses 16:
    # 2^16 x 16 floats per level, as many as 2^19 x 2)
    layout: str = "corner"

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def level_resolutions(self) -> List[int]:
        return [
            int(np.floor(self.base_resolution * self.per_level_scale**l))
            for l in range(self.n_levels)
        ]


def _init_tables(shape, generator, device) -> Dict[str, torch.Tensor]:
    dev = torch.device(device)
    gen_dev = generator.device if generator is not None else dev
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=gen_dev).to(dev)
    return {"tables": (2.0 * u - 1.0) * 1e-4}


def init_hashgrid(cfg: HashGridConfig, generator: Optional[torch.Generator] = None,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Corner tables (L, T, F), uniform in ±1e-4."""
    T = 1 << cfg.log2_hashmap_size
    return _init_tables((cfg.n_levels, T, cfg.n_features_per_level), generator, device)


def init_hashgrid_cell(cfg: HashGridConfig, generator: Optional[torch.Generator] = None,
                       device="cuda") -> Dict[str, torch.Tensor]:
    """Cell tables (L, T, 8F), uniform in ±1e-4."""
    T = 1 << cfg.log2_hashmap_size
    return _init_tables((cfg.n_levels, T, 8 * cfg.n_features_per_level), generator, device)


def _spatial_hash(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
                  table_size: int) -> torch.Tensor:
    """uint32 wrap-around hash of non-negative int64 coordinates, masked to
    the (power-of-two) table size."""
    h = ((ix * _PRIMES[0]) & _U32) ^ ((iy * _PRIMES[1]) & _U32) ^ ((iz * _PRIMES[2]) & _U32)
    return h & (table_size - 1)


def _hash_corner(ix, iy, iz, res: int, table_size: int) -> torch.Tensor:
    """Corner coordinates in [0, res] (int64) -> table entry (int64)."""
    if (res + 1) ** 3 <= table_size:
        return (ix * (res + 1) + iy) * (res + 1) + iz
    return _spatial_hash(ix, iy, iz, table_size)


def _corner_level(x: torch.Tensor, res: int, table_size: int):
    """One level's 8 corner rows (N, 8) int64, trilinear weights (N, 8) and
    their d/d fraction (N, 8, 3), corner order dx | dy<<1 | dz<<2."""
    xs = x * res
    x0f = torch.clamp(torch.floor(xs), 0, res - 1).detach()
    f = xs - x0f
    x0 = x0f.long()
    idx, w, dw = [], [], []
    for corner in range(8):
        d = (corner & 1, (corner >> 1) & 1, (corner >> 2) & 1)
        idx.append(_hash_corner(x0[:, 0] + d[0], x0[:, 1] + d[1], x0[:, 2] + d[2], res, table_size))
        fa = [f[:, a] if d[a] else 1 - f[:, a] for a in range(3)]
        s = [1.0 if d[a] else -1.0 for a in range(3)]
        w.append(fa[0] * fa[1] * fa[2])
        dw.append(torch.stack([s[0] * fa[1] * fa[2], fa[0] * s[1] * fa[2], fa[0] * fa[1] * s[2]], -1))
    return torch.stack(idx, 1), torch.stack(w, 1), torch.stack(dw, 1)


class _CornerEncode(torch.autograd.Function):
    """The corner encode, keeping only the points and the tables for its
    backward and recomputing the corner rows and weights there: a query
    costs its inputs and output, not the ~3 KB of 16 levels × 8 corners of
    gathers and products that autograd would keep (a NeuS step at full
    width queries ~15 M points).  The table gradients are ``index_add``
    (atomics on CUDA, where indexing's backward would sort).  The backward
    is written in differentiable operations, so a double backward (an
    analytic normal inside a loss) works."""

    @staticmethod
    def forward(ctx, tables, x, level_mask, levels):
        T, F = tables.shape[1], tables.shape[2]
        cols = []
        for l, res in enumerate(levels):
            idx, w, _ = _corner_level(x, res, T)
            rows = tables[l][idx] * w[..., None]  # (N, 8, F)
            acc = rows[:, 0]
            for c in range(1, 8):  # the corners summed in order, as the JAX package sums them
                acc = acc + rows[:, c]
            cols.append(acc if level_mask is None else acc * level_mask[l])
        ctx.save_for_backward(tables, x, level_mask)
        ctx.levels = levels
        return torch.cat(cols, -1)

    @staticmethod
    def backward(ctx, g):
        tables, x, level_mask = ctx.saved_tensors
        want_tables, want_x = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        _, T, F = tables.shape
        d_tables, d_x = [], torch.zeros_like(x) if want_x else None
        for l, res in enumerate(ctx.levels):
            g_l = g[:, l * F:(l + 1) * F]
            if level_mask is not None:
                g_l = g_l * level_mask[l]
            idx, w, dw = _corner_level(x, res, T)
            if want_tables:
                d_tables.append(torch.zeros((T, F), dtype=tables.dtype, device=tables.device).index_add(
                    0, idx.reshape(-1), (w[..., None] * g_l[:, None, :]).reshape(-1, F).to(tables.dtype)))
            if want_x:
                rows_g = (tables[l][idx] * g_l[:, None, :]).sum(-1, keepdim=True)  # (N, 8, 1)
                d_x = d_x + (dw * rows_g).sum(1).to(x.dtype) * res
        return torch.stack(d_tables) if want_tables else None, d_x, None, None


def hashgrid_encode(params: Dict[str, torch.Tensor], cfg: HashGridConfig, x: torch.Tensor,
                    level_mask=None) -> torch.Tensor:
    """Corner layout.  x: (..., 3) in [0, 1] -> (..., L·F); ``level_mask``
    (L,) multiplies each level's features.  Differentiable in the tables
    and, through the trilinear weights, in ``x``, to the second order
    (:class:`_CornerEncode`)."""
    shape = x.shape[:-1]
    lm = None if level_mask is None else torch.as_tensor(level_mask, dtype=x.dtype, device=x.device)
    out = _CornerEncode.apply(params["tables"], x.reshape(-1, 3), lm, tuple(cfg.level_resolutions()))
    return out.reshape(shape + (cfg.out_dim,))


def progressive_level_mask(cfg: HashGridConfig, step: int) -> np.ndarray:
    """start_level levels enabled, one more every update_steps after
    start_step; all ones when the config is not progressive."""
    if not cfg.progressive:
        return np.ones(cfg.n_levels, np.float32)
    current = min(cfg.start_level + max(step - cfg.start_step, 0) // cfg.update_steps,
                  cfg.n_levels)
    mask = np.zeros(cfg.n_levels, np.float32)
    mask[:current] = 1.0
    return mask


def frequency_encode(x: torch.Tensor, n_frequencies: int = 6) -> torch.Tensor:
    """NeRF positional encoding: [sin(2^k πx), cos(2^k πx)]."""
    freqs = 2.0 ** torch.arange(n_frequencies, dtype=torch.float32, device=x.device) * math.pi
    ang = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    return enc.reshape(x.shape[:-1] + (-1,))


# ---------------------------------------------------------------------------
# cell-packed layout
# ---------------------------------------------------------------------------


def _cell_index(x0: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    """x0: (..., 3) int64 cell coordinates in [0, res-1] -> (...,) int64 row."""
    ix, iy, iz = x0[..., 0], x0[..., 1], x0[..., 2]
    if res ** 3 <= table_size:
        return (ix * res + iy) * res + iz
    return _spatial_hash(ix, iy, iz, table_size)


def _cell_coords(xf: torch.Tensor, res: int):
    """(N, 3) in [0, 1] -> (cell coordinates int64 (N, 3), fractions (N, 3))."""
    xs = xf * res
    x0 = torch.clamp(torch.floor(xs), 0, res - 1)
    return x0.long(), xs - x0


def cell_indices(cfg: HashGridConfig, x: torch.Tensor) -> torch.Tensor:
    """(N, 3) in [0, 1] -> (L, N) int64 row of every point at every level."""
    T = 1 << cfg.log2_hashmap_size
    xf = x.reshape(-1, 3)
    return torch.stack([_cell_index(_cell_coords(xf, res)[0], res, T)
                        for res in cfg.level_resolutions()], 0)


def _corner_weights(u: torch.Tensor):
    """u: (..., 3) fractions -> the 8 trilinear weights and their d/du per
    axis, corner order c = dx | dy<<1 | dz<<2 (the row's slot order)."""
    w, dw = [], []
    for c in range(8):
        dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        fx = u[..., 0] if dx else 1.0 - u[..., 0]
        fy = u[..., 1] if dy else 1.0 - u[..., 1]
        fz = u[..., 2] if dz else 1.0 - u[..., 2]
        sx = 1.0 if dx else -1.0
        sy = 1.0 if dy else -1.0
        sz = 1.0 if dz else -1.0
        w.append(fx * fy * fz)
        dw.append((sx * fy * fz, fx * sy * fz, fx * fy * sz))
    return w, dw


def hashgrid_encode_cell(params, cfg: HashGridConfig, x: torch.Tensor, level_mask=None,
                         with_grad: bool = False):
    """Cell layout.  x: (..., 3) in [0, 1] -> feats (..., L·F) and, with
    ``with_grad``, dfeats (..., L·F, 3) = d feats / d x (callers scale by
    the Jacobian of their own contraction).  Plain tensor operations, so
    autograd differentiates it in the tables and in ``x``."""
    tables = params["tables"]
    F = cfg.n_features_per_level
    T = tables.shape[1]
    shape = x.shape[:-1]
    xf = x.reshape(-1, 3)
    feats_cols, grad_cols = [], []
    for l, res in enumerate(cfg.level_resolutions()):
        x0, u = _cell_coords(xf, res)
        rows = tables[l][_cell_index(x0, res, T)]  # (N, 8F)
        w, dw = _corner_weights(u)
        m = 1.0 if level_mask is None else level_mask[l]
        for f in range(F):
            acc = 0.0
            for c in range(8):
                acc = acc + w[c] * rows[:, c * F + f]
            feats_cols.append(acc * m)
        if with_grad:
            for f in range(F):
                for d in range(3):
                    g = 0.0
                    for c in range(8):
                        g = g + dw[c][d] * rows[:, c * F + f]
                    grad_cols.append(g * (res * 1.0) * m)
    feats = torch.stack(feats_cols, -1).reshape(shape + (cfg.out_dim,))
    if not with_grad:
        return feats
    # level-major, then feature, then axis -> (N, L·F, 3)
    dfeats = torch.stack(grad_cols, -1).reshape(-1, cfg.n_levels * F, 3)
    return feats, dfeats.reshape(shape + (cfg.out_dim, 3))

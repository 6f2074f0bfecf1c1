"""Cell-packed hash-grid encode with its analytic spatial gradient, forward
and backward — the counterpart of ``dreammesh4d_tpu/ops/hashgrid_pallas.py``.

One pass over the cell rows returns, for points ``x`` (N, 3) in [0, 1] and
tables ``(L, T, 16)`` (8 corners × 2 features per row),

    feats  (N, 2L)     trilinear features, level-major / feature-minor
    dfeats (N, 2L, 3)  d feats / d x, scaled by each level's resolution

so that a density field's analytic normal needs no second encode.

- :func:`encode_cell_fwd_plain` / :func:`encode_cell_bwd_plain` — the plain
  PyTorch versions (the forward is ``ops.hashgrid.hashgrid_encode_cell``);
- :func:`encode_cell_fwd_cuda` / :func:`encode_cell_bwd_cuda` — the wrappers
  of the hand-written Hopper kernels in ``csrc/hashgrid_cell.cu`` (entries
  ``hashgrid_cell_fwd``, replacing ``hashgrid_pallas.py::_fwd_kernel``, and
  ``hashgrid_cell_bwd``, replacing ``::_bwd_kernel``).  The kernels hash
  each point's cell themselves, so no index array is built;
- :func:`encode_cell_with_grad` — the differentiable entry: CUDA tensors
  launch the kernels (or raise), CPU tensors take the plain versions.

**The gradient contract.**  The backward returns the exact gradient of the
tables from both cotangents (of ``feats`` and of ``dfeats``), and **no
gradient for the query points**: ``x.grad`` stays ``None`` (the JAX kernel
returns zeros there).  Every consumer in the repository queries the field at
points that are data — samples along camera rays — so that gradient would
be discarded anyway.  A geometry whose query points carry parameters (a
learned warp or deformation in front of the encoding) must not use the cell
layout: use ``layout="corner"``, whose ``hashgrid_encode`` is differentiable
in ``x``.  The plain version inside the same ``autograd.Function`` keeps the
contract, so kernel and plain version agree.

The table gradient is a float32 sum over all points that fall into a cell,
taken by the kernel with atomics in an order that changes from run to run
and by the plain version with ``index_add_``: compare with a tolerance
relative to each level's largest gradient, never bitwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .hashgrid import (HashGridConfig, _cell_coords, _cell_index, _corner_weights,
                       hashgrid_encode_cell)

ROW = 16  # 8 corners x 2 features
MAX_LEVELS = 32  # the kernels take the level resolutions by value

# kernel launches, counted by the wrapper where it launches (and nowhere
# else); plain_counts counts the passes through the plain versions
launch_counts = {"hashgrid_cell_fwd": 0, "hashgrid_cell_bwd": 0}
plain_counts = {"hashgrid_cell_fwd": 0, "hashgrid_cell_bwd": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, plain_counts):
        for k in counts:
            counts[k] = 0


class _Levels(ctypes.Structure):
    _fields_ = [("res", ctypes.c_int * MAX_LEVELS)]


# both entries: four pointers, N, L, T, the level resolutions, the stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _Levels,
                                     ctypes.c_void_p]


def _check_cfg(cfg: HashGridConfig, tables: torch.Tensor) -> None:
    if cfg.n_features_per_level != 2:
        raise ValueError("the cell layout needs n_features_per_level == 2 (one 16-float row)")
    if not 1 <= cfg.n_levels <= MAX_LEVELS:
        raise ValueError(f"n_levels must be in [1, {MAX_LEVELS}], got {cfg.n_levels}")
    want = (cfg.n_levels, 1 << cfg.log2_hashmap_size, ROW)
    if tuple(tables.shape) != want:
        raise ValueError(f"tables must be {want}, got {tuple(tables.shape)}")


def encode_cell_fwd_plain(tables: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig,
                          with_dfeats: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain forward: (feats, dfeats or None)."""
    _check_cfg(cfg, tables)
    plain_counts["hashgrid_cell_fwd"] += 1
    out = hashgrid_encode_cell({"tables": tables}, cfg, x, with_grad=with_dfeats)
    return out if with_dfeats else (out, None)


def encode_cell_bwd_plain(x: torch.Tensor, cfg: HashGridConfig,
                          g_feats: Optional[torch.Tensor],
                          g_dfeats: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain backward: the gradient of the tables (L, T, 16).  Per (point,
    level, corner c, feature f) it adds ``w_c·g_f + res·(dw_c · g_df)``
    into the cell's row with ``index_add_``, so rows that many points share
    accumulate.  Either cotangent may be ``None`` (zero)."""
    plain_counts["hashgrid_cell_bwd"] += 1
    L, T = cfg.n_levels, 1 << cfg.log2_hashmap_size
    N = x.shape[0]
    d_tables = x.new_zeros((L, T, ROW))
    for l, res in enumerate(cfg.level_resolutions()):
        x0, u = _cell_coords(x, res)
        w, dw = _corner_weights(u)
        w = torch.stack(w, -1)  # (N, 8)
        coeff = x.new_zeros((N, 8, 2))
        if g_feats is not None:
            coeff = coeff + w[:, :, None] * g_feats[:, None, 2 * l:2 * l + 2]
        if g_dfeats is not None:
            dw = torch.stack([torch.stack(d, -1) for d in dw], 1)  # (N, 8, 3)
            coeff = coeff + float(res) * torch.einsum("ncd,nfd->ncf", dw,
                                                      g_dfeats[:, 2 * l:2 * l + 2, :])
        d_tables[l].index_add_(0, _cell_index(x0, res, T), coeff.reshape(N, ROW))
    return d_tables


def _check_cuda(name: str, t: torch.Tensor, shape, dev) -> None:
    if (t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: need a contiguous {tuple(shape)} float32 tensor on {dev}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


@functools.lru_cache(maxsize=16)
def _levels_of(n_levels: int, base_resolution: int, per_level_scale: float) -> _Levels:
    cfg = HashGridConfig(n_levels=n_levels, base_resolution=base_resolution,
                         per_level_scale=per_level_scale)
    lv = _Levels()
    for l, res in enumerate(cfg.level_resolutions()):
        lv.res[l] = res
    return lv


def _levels(cfg: HashGridConfig) -> _Levels:
    """The level resolutions as the kernels take them (kept per config: the
    wrappers run once per ray chunk)."""
    return _levels_of(cfg.n_levels, cfg.base_resolution, cfg.per_level_scale)


def encode_cell_fwd_cuda(tables: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig,
                         with_dfeats: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``hashgrid_cell_fwd`` on the current stream.  Same contract as
    :func:`encode_cell_fwd_plain`; raises on a tensor it does not take or a
    launch that fails."""
    from .. import cuda_build

    _check_cfg(cfg, tables)
    dev = tables.device
    if dev.type != "cuda":
        raise ValueError(f"the hash-grid kernels need CUDA tensors, got {dev}")
    N, L, T = x.shape[0], cfg.n_levels, tables.shape[1]
    _check_cuda("tables", tables, (L, T, ROW), dev)
    _check_cuda("x", x, (N, 3), dev)
    fn = cuda_build.entry("hashgrid_cell", "hashgrid_cell_fwd", _ARGTYPES)
    feats = torch.empty((N, 2 * L), dtype=torch.float32, device=dev)
    dfeats = torch.empty((N, 2 * L, 3), dtype=torch.float32, device=dev) if with_dfeats else None
    if N == 0:
        return feats, dfeats
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(tables.data_ptr(), x.data_ptr(), feats.data_ptr(),
                    dfeats.data_ptr() if with_dfeats else None, N, L, T, _levels(cfg), stream)
    if status != 0:
        raise RuntimeError(f"hashgrid_cell_fwd launch failed with CUDA error {status}")
    launch_counts["hashgrid_cell_fwd"] += 1
    return feats, dfeats


def encode_cell_bwd_cuda(x: torch.Tensor, cfg: HashGridConfig,
                         g_feats: Optional[torch.Tensor],
                         g_dfeats: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch ``hashgrid_cell_bwd`` on the current stream: float32 atomic
    adds into a zeroed (L, T, 16) table.  Same contract as
    :func:`encode_cell_bwd_plain`."""
    from .. import cuda_build

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the hash-grid kernels need CUDA tensors, got {dev}")
    N, L, T = x.shape[0], cfg.n_levels, 1 << cfg.log2_hashmap_size
    if cfg.n_features_per_level != 2 or not 1 <= L <= MAX_LEVELS:
        raise ValueError("the cell layout needs 2 features per level and at most "
                         f"{MAX_LEVELS} levels")
    _check_cuda("x", x, (N, 3), dev)
    if g_feats is not None:
        g_feats = g_feats.contiguous()
        _check_cuda("g_feats", g_feats, (N, 2 * L), dev)
    if g_dfeats is not None:
        g_dfeats = g_dfeats.contiguous()
        _check_cuda("g_dfeats", g_dfeats, (N, 2 * L, 3), dev)
    fn = cuda_build.entry("hashgrid_cell", "hashgrid_cell_bwd", _ARGTYPES)
    with torch.cuda.device(dev):
        # zeroed on the launch's stream: blocks run in no order and add into it
        d_tables = torch.zeros((L, T, ROW), dtype=torch.float32, device=dev)
        if N == 0 or (g_feats is None and g_dfeats is None):
            return d_tables
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(x.data_ptr(), g_feats.data_ptr() if g_feats is not None else None,
                    g_dfeats.data_ptr() if g_dfeats is not None else None,
                    d_tables.data_ptr(), N, L, T, _levels(cfg), stream)
    if status != 0:
        raise RuntimeError(f"hashgrid_cell_bwd launch failed with CUDA error {status}")
    launch_counts["hashgrid_cell_bwd"] += 1
    return d_tables


class _EncodeCell(torch.autograd.Function):
    """(tables, x) -> (feats, dfeats); the backward returns the gradient of
    the tables and none for ``x`` (see the module docstring)."""

    @staticmethod
    def forward(ctx, tables, x, cfg, with_dfeats, plain):
        fwd = encode_cell_fwd_plain if plain else encode_cell_fwd_cuda
        feats, dfeats = fwd(tables, x, cfg, with_dfeats)
        ctx.save_for_backward(x)
        ctx.cfg, ctx.plain = cfg, plain
        ctx.set_materialize_grads(False)
        if dfeats is None:
            return feats, None
        return feats, dfeats

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_feats, g_dfeats):
        (x,) = ctx.saved_tensors
        bwd = encode_cell_bwd_plain if ctx.plain else encode_cell_bwd_cuda
        return bwd(x, ctx.cfg, g_feats, g_dfeats), None, None, None, None


def encode_cell_with_grad(params, cfg: HashGridConfig, x: torch.Tensor, level_mask=None,
                          with_dfeats: bool = True, plain: bool = False):
    """(..., 3) in [0, 1] -> (feats (..., 2L), dfeats (..., 2L, 3)); with
    ``with_dfeats=False`` the spatial gradient is neither computed nor
    written and ``dfeats`` is ``None``.  ``level_mask`` (L,) multiplies each
    level's features and gradients, outside the kernel.  CUDA tensors go
    through the kernels or raise; CPU tensors, or ``plain=True``, take the
    plain versions.  Differentiable in the tables only."""
    tables = params["tables"]
    if tables.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no hash-grid path for device {tables.device}")
    shape = x.shape[:-1]
    xf = x.detach().reshape(-1, 3).contiguous()
    feats, dfeats = _EncodeCell.apply(tables, xf, cfg, with_dfeats,
                                      plain or tables.device.type == "cpu")
    if level_mask is not None:
        m = torch.repeat_interleave(
            torch.as_tensor(level_mask, dtype=torch.float32, device=feats.device), 2)
        feats = feats * m[None, :]
        if dfeats is not None:
            dfeats = dfeats * m[None, :, None]
    feats = feats.reshape(shape + (cfg.out_dim,))
    if dfeats is not None:
        dfeats = dfeats.reshape(shape + (cfg.out_dim, 3))
    return feats, dfeats

"""Per-tile alpha compositing over a dense ``(T, K)`` index table, forward and
backward — the counterpart of ``dreammesh4d_tpu/ops/gs/pallas_blend.py``
(``_fwd_kernel`` :286, ``_bwd_kernel`` :316 with the per-Gaussian
scatter-add of ``_blend_bwd_rule`` :458, ``blend_image_pallas`` :497), the
compositing of ``backend: pallas``.

Tiles are fixed at 16 px (``binning.TILE``): tile t composites the first
``min(counts[t], K)`` entries of row t of ``tile_gauss`` front to back, with
the same per-pixel math, the same group-wise ``T_EPS`` exit and the same
replay backward as the pair path of ``resident_blend.py`` (whose row
packing, constants and image finish this module shares).

- :func:`blend_table_plain` / :func:`blend_table_bwd_plain` — the plain
  PyTorch versions: the table read as pair segments (tile t's segment starts
  at t·K), through ``resident_blend``'s plain compositing and replay
  backward; the backward sums the rows per Gaussian (``index_add_``), as
  ``_blend_bwd_rule``'s scatter does;
- :func:`blend_table_cuda` / :func:`blend_table_bwd_cuda` — the wrappers of
  the hand-written Hopper kernels B6 (entry ``table_fwd`` of
  ``csrc/resident_fwd.cu``) and B7 (``table_bwd`` of ``csrc/resident_bwd.cu``,
  which adds each Gaussian's row with atomics into a zeroed (N+1, 16)
  table): the bodies of B1 and B2 over the same reading of the table as
  segments, one CTA per 16-px tile;
- :func:`blend_table` — the differentiable entry: CUDA tensors launch the
  kernels (or raise), CPU tensors take the plain versions;
- :func:`blend_image_table` — depth as an extra channel (C = C_user + 1 ≤ 9),
  then the (T, C+1, 256) block as images with alpha = 1 − T and the
  background composited in plain PyTorch, so that autograd forms the folded
  transmittance cotangent the backward reads.

Known gap to the TPU kernels, as for ``resident_blend.py``: they form a
group's transmittance from a bf16 triangular matmul (and optionally bf16
colour dots); the port composites in exact float32.  The JAX tests bound the
gap at 3e-3 rgb/alpha and 6e-3 depth against the XLA blend.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .binning import TILE
from .resident_blend import (
    GROUP,
    OP_COL,
    ROW,
    _check_group,
    _pack_rows,
    _walked_ptr,
    blend_pairs_bwd_plain,
    blend_pairs_plain,
    finish_image,
)

P = TILE * TILE  # pixels per tile

# kernel launches, counted by the wrapper where it launches (and nowhere else)
launch_counts = {"table_fwd": 0, "table_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _segments(tile_gauss: torch.Tensor, counts: torch.Tensor):
    """The table as pair segments: row t of K entries is the segment that
    starts at t·K; its length is min(count, K)."""
    T, K = tile_gauss.shape
    starts = torch.arange(T, device=tile_gauss.device, dtype=torch.int64) * K
    return tile_gauss.reshape(-1), starts, torch.clamp(counts.long(), max=K)


def blend_table_plain(rows: torch.Tensor, tile_gauss: torch.Tensor, counts: torch.Tensor,
                      tiles_x: int, group: int, n_channels: int,
                      stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch compositing of every tile: (T, C+1, 256).  ``stats``
    receives ``pairs_read``, ``walked_per_tile`` and ``live_pixels`` (the
    work the kernel does)."""
    pairs, starts, count = _segments(tile_gauss, counts)
    return blend_pairs_plain(rows, pairs, starts, count, tiles_x, TILE, tile_gauss.shape[1],
                             group, n_channels, stats=stats)


def blend_table_bwd_plain(rows: torch.Tensor, tile_gauss: torch.Tensor, counts: torch.Tensor,
                          out: torch.Tensor, cot: torch.Tensor, tiles_x: int, group: int,
                          n_channels: int, stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch replay backward: the gradient of ``rows``, (N+1, 16),
    summed per Gaussian.  ``out`` is the forward's output and ``cot`` its
    cotangent, both (T, C+1, 256)."""
    pairs, starts, count = _segments(tile_gauss, counts)
    return blend_pairs_bwd_plain(rows, pairs, starts, count, out, cot, tiles_x, TILE,
                                 tile_gauss.shape[1], group, n_channels, stats=stats)


def _check_cuda_inputs(rows, tile_gauss, counts, group: int, n_channels: int) -> None:
    """What both kernel wrappers need of the row table and the index table."""
    _check_group(group, TILE)
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the compositing kernels need CUDA tensors, got {dev}")
    if not 1 <= n_channels <= OP_COL - 5:
        raise ValueError(f"n_channels must be in [1, {OP_COL - 5}], got {n_channels}")
    for name, x, dtype, ndim in (("rows", rows, torch.float32, 2),
                                 ("tile_gauss", tile_gauss, torch.int32, 2),
                                 ("counts", counts, torch.int32, 1)):
        if x.device != dev or x.dtype != dtype or x.ndim != ndim or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {ndim}-D {dtype} tensor on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if rows.shape[1] != ROW:
        raise ValueError(f"rows must be (N+1, {ROW}), got {tuple(rows.shape)}")
    if rows.data_ptr() % 16:
        raise ValueError("rows: the kernels copy 16-byte pieces of it, need a 16-byte aligned start")
    if counts.shape[0] != tile_gauss.shape[0]:
        raise ValueError("tile_gauss and counts must have one row per tile")


def blend_table_cuda(rows: torch.Tensor, tile_gauss: torch.Tensor, counts: torch.Tensor,
                     tiles_x: int, group: int, n_channels: int,
                     walked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch B6 (entry ``table_fwd`` of ``csrc/resident_fwd.cu``) on the
    current stream.  Same contract as :func:`blend_table_plain`; raises on a
    tensor it does not take or a launch that fails.  ``walked``, a (2, T, 4)
    int32 tensor, receives in column 0 each tile's walked entries (plane 0),
    which must equal the plain version's ``walked_per_tile``, and in plane 1
    the rows it composited of those: all of them, since B6 does not cull
    (the binning already did, per 16-px tile)."""
    from ... import cuda_build

    _check_cuda_inputs(rows, tile_gauss, counts, group, n_channels)
    (T, K), C, dev = tile_gauss.shape, n_channels, rows.device
    fn = cuda_build.entry("resident_fwd", "table_fwd",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    walked_ptr = _walked_ptr(walked, T, dev)
    out = torch.empty((T, C + 1, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(rows.data_ptr(), tile_gauss.data_ptr(), counts.data_ptr(), out.data_ptr(),
                    walked_ptr, T, K, tiles_x, group, C, stream)
    if status != 0:
        raise RuntimeError(f"table_fwd launch failed with CUDA error {status}")
    launch_counts["table_fwd"] += 1
    return out


def blend_table_bwd_cuda(rows: torch.Tensor, tile_gauss: torch.Tensor, counts: torch.Tensor,
                         out: torch.Tensor, cot: torch.Tensor, tiles_x: int, group: int,
                         n_channels: int, walked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch B7 (entry ``table_bwd`` of ``csrc/resident_bwd.cu``) on the
    current stream: the gradient of ``rows`` summed per Gaussian with
    atomics, (N+1, 16).  Same contract as :func:`blend_table_bwd_plain`;
    raises on a tensor it does not take or a launch that fails; ``walked`` as
    in :func:`blend_table_cuda`."""
    from ... import cuda_build

    _check_cuda_inputs(rows, tile_gauss, counts, group, n_channels)
    (T, K), C, dev = tile_gauss.shape, n_channels, rows.device
    cot = cot.contiguous()  # it comes back through the untiling's permute
    for name, x in (("out", out), ("cot", cot)):
        if (x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != (T, C + 1, P)
                or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {(T, C + 1, P)} float32 tensor on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    fn = cuda_build.entry("resident_bwd", "table_bwd",
                          [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    walked_ptr = _walked_ptr(walked, T, dev)
    with torch.cuda.device(dev):
        # zeroed on the launch's stream: blocks run in no order and add into it
        grads = torch.zeros((rows.shape[0], ROW), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(rows.data_ptr(), tile_gauss.data_ptr(), counts.data_ptr(), out.data_ptr(),
                    cot.data_ptr(), grads.data_ptr(), walked_ptr, T, K, tiles_x, group, C, stream)
    if status != 0:
        raise RuntimeError(f"table_bwd launch failed with CUDA error {status}")
    launch_counts["table_bwd"] += 1
    return grads


class _BlendTable(torch.autograd.Function):
    """Table compositing with the replay backward: the forward saves (rows,
    tile_gauss, counts, out), the backward returns the gradient of ``rows``.
    ``plain`` (CPU tensors) takes the plain versions, else B6/B7."""

    @staticmethod
    def forward(ctx, rows, tile_gauss, counts, tiles_x, group, n_channels, plain):
        fwd = blend_table_plain if plain else blend_table_cuda
        out = fwd(rows, tile_gauss, counts, tiles_x, group, n_channels)
        ctx.save_for_backward(rows, tile_gauss, counts, out)
        ctx.args = (tiles_x, group, n_channels)
        ctx.plain = plain
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cot):
        rows, tile_gauss, counts, out = ctx.saved_tensors
        bwd = blend_table_bwd_plain if ctx.plain else blend_table_bwd_cuda
        return (bwd(rows, tile_gauss, counts, out, cot, *ctx.args),) + (None,) * 6


def blend_table(rows, tile_gauss, counts, tiles_x: int, group: int,
                n_channels: int) -> torch.Tensor:
    """Differentiable table compositing (gradient to ``rows`` only): the
    device alone picks the path — CUDA tensors go through B6 and, in the
    backward, B7 (or raise); CPU tensors take the plain versions."""
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compositing path for device {rows.device}")
    return _BlendTable.apply(rows, tile_gauss, counts, tiles_x, group, n_channels,
                             rows.device.type == "cpu")


def blend_image_table(tile_gauss: torch.Tensor, tile_counts: torch.Tensor,
                      means2d: torch.Tensor, conics: torch.Tensor, colors: torch.Tensor,
                      opacities: torch.Tensor, depths: torch.Tensor, W: int, H: int,
                      background: torch.Tensor,
                      group: int = GROUP) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-image blend over the (T, K) table of ``bin_gaussians``: returns
    (rgb (H,W,C) with the background added, alpha (H,W,1) = 1 − T, depth
    (H,W,1)).  ``tile_counts`` are clipped to K by the caller.
    Differentiable in means2d, conics, colors, opacities, depths and the
    background."""
    C_user = colors.shape[-1]
    colors_aug = torch.cat([colors, depths[:, None]], -1)
    rows = _pack_rows(means2d, conics, colors_aug, opacities)
    out = blend_table(rows, tile_gauss.to(torch.int32).contiguous(),
                      tile_counts.to(torch.int32).contiguous(), (W + TILE - 1) // TILE, group,
                      C_user + 1)
    return finish_image(out, C_user, W, H, TILE, background)

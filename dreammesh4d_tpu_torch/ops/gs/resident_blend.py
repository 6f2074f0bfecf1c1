"""Per-tile alpha compositing over depth-sorted pair segments — the
counterpart of ``dreammesh4d_tpu/ops/gs/pallas_resident.py`` (forward) and
of the math it shares with ``pallas_blend.py``.

- :func:`_pack_rows` — per-Gaussian ``(N+1, 16)`` rows
  ``[mx, my, ca, cb, cc, c_0..c_{C-1}, 0.., op@14, 0]`` plus a zero sentinel
  row (``pallas_blend.py:393``), so C ≤ 9;
- :func:`blend_pairs_plain` — the plain PyTorch version;
- :func:`blend_pairs_cuda` — the wrapper of the hand-written Hopper kernel
  ``csrc/resident_fwd.cu`` (replaces ``pallas_resident.py::_fwd_kernel``);
- :func:`blend_pairs` — dispatch on the tensors' device: CUDA → the kernel
  (or an exception), CPU → the plain version;
- :func:`blend_image_resident` — depth as an extra channel, background,
  untiling (``pallas_resident.py:628``).

Both versions compute, for each tile and each pixel, a front-to-back walk
over the first ``min(count, cap)`` pairs of the tile's segment with

    power = −0.5(ca·dx² + cc·dy²) − cb·dx·dy,  dx = mx − px  (px = tile origin + x)
    α = min(0.99, op·exp(power)),  live iff −4.5 ≤ power ≤ 0 and α ≥ 1/255
    acc += α·T·c,  T *= 1 − α

and stop a tile, before each group of ``group`` pairs, once every pixel's
T ≤ 1e-4.  Known gap to the TPU kernel: it forms T_excl from a bf16
triangular matmul of log1p(−α) (and with ``bf16_matmuls`` a bf16 colour
dot); both versions here use exact float32 products and ignore
``bf16_matmuls``.  The JAX tests bound that gap (3e-3 rgb/alpha, 6e-3 depth
against its XLA blend).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .binning import TILE, PairAssignment

GROUP = 32  # default group size
ROW = 16  # packed row width
OP_COL = 14  # opacity column in the packed row
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
MAX_GROUP = 512  # the kernel stages a group of rows in shared memory

# kernel launches, counted by the wrapper where it launches (and nowhere else)
launch_counts = {"resident_fwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _pack_rows(means2d: torch.Tensor, conics: torch.Tensor, colors: torch.Tensor,
               opacities: torch.Tensor) -> torch.Tensor:
    """(N,2),(N,3),(N,C),(N,) -> (N+1, ROW) with a zero sentinel row."""
    N, C = colors.shape
    if 5 + C > OP_COL:
        raise ValueError(f"the packed row holds at most {OP_COL - 5} blended channels, got {C}")
    rows = means2d.new_zeros((N + 1, ROW))
    rows[:N, 0:2] = means2d
    rows[:N, 2:5] = conics
    rows[:N, 5:5 + C] = colors
    rows[:N, OP_COL] = opacities
    return rows


def _check_group(group: int, tile: int) -> None:
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"group must be in [1, {MAX_GROUP}], got {group}")
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile² must be in [1, 1024], got tile={tile}")


def blend_pairs_plain(rows: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor, tiles_x: int, tile: int, cap: int,
                      group: int, n_channels: int,
                      stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch compositing, all tiles at once, one group of pairs per
    step (a (T, group, tile²) working set; never a (T, cap, tile²) one).

    ``stats``, when given, receives the work the kernel does on these
    inputs: ``pairs_read``, the pair slots the tiles walked, and
    ``live_pixels``, the (pair, pixel) evaluations that composited."""
    _check_group(group, tile)
    dev = rows.device
    T = starts.shape[0]
    P = tile * tile
    C = n_channels
    N = rows.shape[0] - 1
    p = torch.arange(P, device=dev)
    t_ids = torch.arange(T, device=dev)
    px = ((t_ids % tiles_x) * tile)[:, None, None].float() + (p % tile).float()[None, None, :]
    py = ((t_ids // tiles_x) * tile)[:, None, None].float() + (p // tile).float()[None, None, :]
    count = torch.clamp(counts.long(), max=cap)
    starts = starts.long()
    trans = rows.new_ones((T, 1, P))
    acc = rows.new_zeros((T, C, P))
    slots = torch.arange(group, device=dev)
    n_groups = (int(count.max()) + group - 1) // group if T else 0
    pairs_read = live_pixels = 0
    for g in range(n_groups):
        g0 = g * group
        active = (g0 < count) & (trans.amax(dim=(1, 2)) > T_EPS)  # (T,)
        if not bool(active.any()):
            break
        slot = g0 + slots  # (G,)
        valid = active[:, None] & (slot[None, :] < count[:, None])  # (T, G)
        if stats is not None:
            pairs_read += int(valid.sum())
        pos = torch.clamp(starts[:, None] + slot[None, :], max=max(pairs.shape[0] - 1, 0))
        idx = torch.where(valid, pairs[pos].long(), torch.full_like(pos, N))
        r = rows[idx]  # (T, G, ROW)
        dx = r[..., 0:1] - px  # (T, G, P)
        dy = r[..., 1:2] - py
        power = -0.5 * (r[..., 2:3] * dx * dx + r[..., 4:5] * dy * dy) - r[..., 3:4] * dx * dy
        alpha = torch.clamp(r[..., OP_COL:OP_COL + 1] * torch.exp(power), max=ALPHA_MAX)
        live = (power <= 0.0) & (power >= -4.5) & (alpha >= ALPHA_MIN) & valid[..., None]
        if stats is not None:
            live_pixels += int(live.sum())
        alpha = torch.where(live, alpha, torch.zeros_like(alpha))
        incl = torch.cumprod(1.0 - alpha, dim=1)  # (T, G, P)
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
        w = alpha * excl * trans
        acc = acc + torch.einsum("tgc,tgp->tcp", r[..., 5:5 + C], w)
        trans = trans * incl[:, -1:]
    if stats is not None:
        stats.update(pairs_read=pairs_read, live_pixels=live_pixels)
    return torch.cat([acc, trans], 1)


def blend_pairs_cuda(rows: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
                     counts: torch.Tensor, tiles_x: int, tile: int, cap: int,
                     group: int, n_channels: int) -> torch.Tensor:
    """Launch the Hopper kernel ``csrc/resident_fwd.cu`` on the current
    stream.  Same contract as :func:`blend_pairs_plain`; raises on a tensor
    it does not take or a launch that fails."""
    from ... import cuda_build

    _check_group(group, tile)
    dev = rows.device
    T = starts.shape[0]
    C = n_channels
    if dev.type != "cuda":
        raise ValueError(f"blend_pairs_cuda needs CUDA tensors, got {dev}")
    if not 1 <= C <= OP_COL - 5:
        raise ValueError(f"n_channels must be in [1, {OP_COL - 5}], got {C}")
    for name, x, dtype, ndim in (("rows", rows, torch.float32, 2), ("pairs", pairs, torch.int32, 1),
                                 ("starts", starts, torch.int32, 1),
                                 ("counts", counts, torch.int32, 1)):
        if x.device != dev or x.dtype != dtype or x.ndim != ndim or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {ndim}-D {dtype} tensor on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if rows.shape[1] != ROW:
        raise ValueError(f"rows must be (N+1, {ROW}), got {tuple(rows.shape)}")
    if counts.shape[0] != T:
        raise ValueError("starts and counts must have the same length")

    lib = cuda_build.load("resident_fwd")
    fn = lib.resident_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((T, C + 1, tile * tile), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(rows.data_ptr(), pairs.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                    out.data_ptr(), T, tiles_x, tile, cap, group, C, stream)
    if status != 0:
        raise RuntimeError(f"resident_fwd launch failed with CUDA error {status}")
    launch_counts["resident_fwd"] += 1
    return out


def blend_pairs(rows, pairs, starts, counts, tiles_x, tile, cap, group, n_channels,
                plain: bool = False) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors (or
    when the caller asks for it with ``plain=True``)."""
    if plain or rows.device.type == "cpu":
        return blend_pairs_plain(rows, pairs, starts, counts, tiles_x, tile, cap, group,
                                 n_channels)
    if rows.device.type == "cuda":
        return blend_pairs_cuda(rows, pairs, starts, counts, tiles_x, tile, cap, group,
                                n_channels)
    raise ValueError(f"no compositing path for device {rows.device}")


def blend_image_resident(pa: PairAssignment, means2d: torch.Tensor, conics: torch.Tensor,
                         colors: torch.Tensor, opacities: torch.Tensor, depths: torch.Tensor,
                         W: int, H: int, background: torch.Tensor, cap: int = 1024,
                         group: int = GROUP, tile: int = TILE,
                         plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-image blend: returns (rgb (H,W,C) with the background added,
    alpha (H,W,1) = 1 − T, depth (H,W,1))."""
    C_user = colors.shape[-1]
    colors_aug = torch.cat([colors, depths[:, None]], -1)
    C = C_user + 1
    tiles_x = (W + tile - 1) // tile
    tiles_y = (H + tile - 1) // tile
    rows = _pack_rows(means2d, conics, colors_aug, opacities)
    out = blend_pairs(rows, pa.sorted_gauss.to(torch.int32).contiguous(),
                      pa.starts.to(torch.int32).contiguous(),
                      pa.counts.to(torch.int32).contiguous(),
                      tiles_x, tile, cap, group, C, plain=plain)

    def untile(flat, ch):
        img = flat.reshape(tiles_y, tiles_x, ch, tile, tile)
        img = img.permute(0, 3, 1, 4, 2).reshape(tiles_y * tile, tiles_x * tile, ch)
        return img[:H, :W]

    colors_img = untile(out[:, :C_user], C_user)
    depth_img = untile(out[:, C_user:C], 1)
    trans_img = untile(out[:, C:C + 1], 1)
    rgb = colors_img + trans_img * background[None, None, :]
    return rgb, 1.0 - trans_img, depth_img

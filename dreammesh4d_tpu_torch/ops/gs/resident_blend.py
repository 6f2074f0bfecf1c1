"""Per-tile alpha compositing over depth-sorted pair segments, forward and
backward — the counterpart of ``dreammesh4d_tpu/ops/gs/pallas_resident.py``
and of the math it shares with ``pallas_blend.py``.

- :func:`_pack_rows` — per-Gaussian ``(N+1, 16)`` rows
  ``[mx, my, ca, cb, cc, c_0..c_{C-1}, 0.., op@14, 0]`` plus a zero sentinel
  row (``pallas_blend.py:393``), so C ≤ 9;
- :func:`blend_pairs_plain` / :func:`blend_pairs_bwd_plain` — the plain
  PyTorch versions of the forward and of the replay backward;
- :func:`quadrant_keep_plain` — the kernels' per-quadrant row cull written
  in PyTorch (a 32-px tile is four 16×16 quadrant CTAs, :func:`quadrant_bounds`),
  and :func:`quadrant_kept_plain`, the rows it keeps per tile and quadrant;
- :func:`blend_pairs_cuda` — the wrapper of the hand-written Hopper kernel
  ``csrc/resident_fwd.cu`` (replaces ``pallas_resident.py::_fwd_kernel``);
- :func:`blend_pairs_bwd_cuda` — the wrapper of ``csrc/resident_bwd.cu``:
  entry ``resident_bwd_accum`` (replaces ``::_bwd_kernel_accum``, gradients
  summed per Gaussian) or ``resident_bwd_pairs`` (replaces ``::_bwd_kernel``,
  gradients per pair slot; :func:`reduce_pair_grads` sums them per Gaussian);
- :func:`blend_pairs` — the differentiable entry: CUDA tensors launch the
  kernels (or raise), CPU tensors take the plain versions;
- :func:`blend_image_resident` — depth as an extra channel, background,
  untiling (``pallas_resident.py:628``; :func:`finish_image`, shared with
  ``table_blend.py``).  Row packing, untiling and the
  background stay plain PyTorch, so autograd carries the rows' gradient on
  to means2d, conics, colours, depths, opacities and the background.

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

The backward replays the same walk from the forward's output ``out`` and its
cotangent ``g`` (``pallas_resident.py:291-365``, ``pallas_blend.py:67-96``):

    S = Σ_c out[c]·g[c] + g[C]·out[C];  w_i = α_i·T_excl;  gdotc_i = c_i·g
    prefix_i = Σ_{j≤i} gdotc_j·w_j
    dα_i = T_excl·gdotc_i − (S − prefix_i)/max(1 − α_i, 1e-6)   (0 where α_i = 0)
    d_power = (op·exp(power) > 0.99 ? 0 : dα_i)·α_i

summed over the tile's pixels into the pair's row ``[d_mx, d_my, d_ca, d_cb,
d_cc, d_c.., 0.., d_op@14, 0]``, with the forward's tile-wide exit at the
same pair.  Sums across tiles use float32 atomics (``index_add_`` in the
plain version), whose order changes from run to run: compare with a
tolerance, never bitwise.
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
QUAD = 16  # the kernels cut a tile of side > 16 into four 16x16 quadrant CTAs
MAX_QUADS = 4  # columns of the kernels' ``walked`` counts
# the quadrant cull (csrc/cluster_blend.cuh row_box): the box of
# power >= -4.5 inflated by 5 %, rows of a conic with det <= 1e-4 ca cc kept
CULL_POWER = 9.45
CULL_DET_REL = 1e-4

# kernel launches, counted by the wrapper where it launches (and nowhere else)
launch_counts = {"resident_fwd": 0, "resident_bwd_accum": 0, "resident_bwd_pairs": 0}


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


def _pixel_grid(T: int, tiles_x: int, tile: int, device):
    """Pixel coordinates (T, 1, tile²) of every tile (no +0.5)."""
    p = torch.arange(tile * tile, device=device)
    t_ids = torch.arange(T, device=device)
    px = ((t_ids % tiles_x) * tile)[:, None, None].float() + (p % tile).float()[None, None, :]
    py = ((t_ids // tiles_x) * tile)[:, None, None].float() + (p // tile).float()[None, None, :]
    return px, py


def _group_index(pairs, starts, count, active, g0: int, group: int, sentinel: int):
    """Row ids (T, G) of the pairs ``g0 .. g0+group`` of every tile (the
    sentinel row past a tile's count or in a tile that has exited) and
    their validity."""
    slot = g0 + torch.arange(group, device=pairs.device)  # (G,)
    valid = active[:, None] & (slot[None, :] < count[:, None])  # (T, G)
    pos = torch.clamp(starts[:, None] + slot[None, :], max=max(pairs.shape[0] - 1, 0))
    return torch.where(valid, pairs[pos].long(), torch.full_like(pos, sentinel)), valid


def _group_geometry(r, px, py, valid):
    """Shared forward/backward math of one group of rows r (T, G, ROW):
    returns (alpha, live, clamped, dx, dy), each (T, G, P); alpha is 0 where
    the pair is not live."""
    dx = r[..., 0:1] - px
    dy = r[..., 1:2] - py
    power = -0.5 * (r[..., 2:3] * dx * dx + r[..., 4:5] * dy * dy) - r[..., 3:4] * dx * dy
    raw = r[..., OP_COL:OP_COL + 1] * torch.exp(power)
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    live = (power <= 0.0) & (power >= -4.5) & (alpha >= ALPHA_MIN) & valid[..., None]
    return torch.where(live, alpha, torch.zeros_like(alpha)), live, raw > ALPHA_MAX, dx, dy


def quadrant_bounds(T: int, tiles_x: int, tile: int, device=None):
    """The pixel-coordinate box of every quadrant CTA of every tile:
    (x0, x1, y0, y1), each (T, nq) float32, first and last pixel included;
    nq = 4 quadrants (x-major) for tile > 16, else 1 covering the tile."""
    t = torch.arange(T, device=device)
    ox, oy = (t % tiles_x) * tile, (t // tiles_x) * tile
    q = torch.arange(MAX_QUADS if tile > QUAD else 1, device=device)
    qx, qy = (q & 1) * QUAD, (q >> 1) * QUAD
    x0, y0 = ox[:, None] + qx[None], oy[:, None] + qy[None]
    x1 = ox[:, None] + torch.clamp(qx + QUAD, max=tile)[None] - 1
    y1 = oy[:, None] + torch.clamp(qy + QUAD, max=tile)[None] - 1
    return tuple(v.float() for v in (x0, x1, y0, y1))


def quadrant_keep_plain(r: torch.Tensor, x0, x1, y0, y1) -> torch.Tensor:
    """Whether rows r (..., ROW) can be live at a pixel of the box
    [x0, x1] × [y0, y1] (broadcast against r's leading shape): the cull of
    the kernels (``row_box`` + ``box_meets`` in ``csrc/cluster_blend.cuh``,
    applied to each CTA's 16×16 quadrant), in the same float32 operations
    and order.  False only for an opacity < 1/255 (α = min(0.99,
    op·exp(power)) ≤ op where power ≤ 0) or a finite conic with ca, cc > 0
    and det = ca·cc − cb² > 1e-4·ca·cc whose box of power ≥ −4.5 —
    half-widths √(9·cc/det), √(9·ca/det), with 9 raised by 5 % and one pixel
    added against the rounding of the power — misses the box.  Conservative:
    a dropped row is dead at every pixel of the box, so culling changes no
    output bit."""
    mx, my, ca, cb, cc, op = (r[..., i] for i in (0, 1, 2, 3, 4, OP_COL))
    finite = (torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(ca) & torch.isfinite(cb)
              & torch.isfinite(cc))
    det = ca * cc - cb * cb
    definite = finite & (ca > 0.0) & (cc > 0.0) & (det > CULL_DET_REL * ca * cc)
    hx = torch.sqrt(CULL_POWER * cc / det) + 1.0
    hy = torch.sqrt(CULL_POWER * ca / det) + 1.0
    meets = (mx + hx >= x0) & (mx - hx <= x1) & (my + hy >= y0) & (my - hy <= y1)
    return ~(op < ALPHA_MIN) & (~definite | meets)


def quadrant_kept_plain(rows: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
                        walked_per_tile: torch.Tensor, tiles_x: int, tile: int) -> torch.Tensor:
    """How many of the pair slots each tile walked (``walked_per_tile`` of
    the plain versions' ``stats``) :func:`quadrant_keep_plain` keeps in each
    quadrant CTA: (T, nq) int64, what the kernels count in plane 1 of their
    ``walked``."""
    T = starts.shape[0]
    nq = MAX_QUADS if tile > QUAD else 1
    walked = walked_per_tile.to(rows.device)
    if T == 0 or int(walked.max()) == 0:
        return torch.zeros((T, nq), dtype=torch.long, device=rows.device)
    slot = torch.arange(int(walked.max()), device=rows.device)
    valid = slot[None] < walked[:, None]  # (T, S)
    pos = torch.clamp(starts.long()[:, None] + slot[None], max=pairs.numel() - 1)
    r = rows[pairs[pos].long()][:, :, None, :]  # (T, S, 1, ROW)
    x0, x1, y0, y1 = (b[:, None] for b in quadrant_bounds(T, tiles_x, tile, rows.device))
    return (quadrant_keep_plain(r, x0, x1, y0, y1) & valid[..., None]).sum(1)


def blend_pairs_plain(rows: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor, tiles_x: int, tile: int, cap: int,
                      group: int, n_channels: int,
                      stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch compositing, all tiles at once, one group of pairs per
    step (a (T, group, tile²) working set; never a (T, cap, tile²) one).

    ``stats``, when given, receives the work the kernel does on these
    inputs: ``pairs_read``, the pair slots the tiles walked,
    ``walked_per_tile``, the same per tile ((T,) int64, summing to
    ``pairs_read``: what every quadrant CTA of the kernel walks), and
    ``live_pixels``, the (pair, pixel) evaluations that composited."""
    _check_group(group, tile)
    T = starts.shape[0]
    P = tile * tile
    C = n_channels
    px, py = _pixel_grid(T, tiles_x, tile, rows.device)
    count = torch.clamp(counts.long(), max=cap)
    starts = starts.long()
    trans = rows.new_ones((T, 1, P))
    acc = rows.new_zeros((T, C, P))
    n_groups = (int(count.max()) + group - 1) // group if T else 0
    live_pixels = 0
    walked = torch.zeros(T, dtype=torch.long, device=rows.device)
    for g in range(n_groups):
        active = (g * group < count) & (trans.amax(dim=(1, 2)) > T_EPS)  # (T,)
        if not bool(active.any()):
            break
        idx, valid = _group_index(pairs, starts, count, active, g * group, group, rows.shape[0] - 1)
        r = rows[idx]  # (T, G, ROW)
        alpha, live, _, _, _ = _group_geometry(r, px, py, valid)
        if stats is not None:
            walked += valid.sum(1)
            live_pixels += int(live.sum())
        incl = torch.cumprod(1.0 - alpha, dim=1)  # (T, G, P)
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
        w = alpha * excl * trans
        acc = acc + torch.einsum("tgc,tgp->tcp", r[..., 5:5 + C], w)
        trans = trans * incl[:, -1:]
    if stats is not None:
        stats.update(pairs_read=int(walked.sum()), walked_per_tile=walked,
                     live_pixels=live_pixels)
    return torch.cat([acc, trans], 1)


def _check_cuda_inputs(rows, pairs, starts, counts, n_channels: int) -> None:
    """What every kernel wrapper needs of the row table and the segments."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the compositing kernels need CUDA tensors, got {dev}")
    if not 1 <= n_channels <= OP_COL - 5:
        raise ValueError(f"n_channels must be in [1, {OP_COL - 5}], got {n_channels}")
    for name, x, dtype, ndim in (("rows", rows, torch.float32, 2), ("pairs", pairs, torch.int32, 1),
                                 ("starts", starts, torch.int32, 1),
                                 ("counts", counts, torch.int32, 1)):
        if x.device != dev or x.dtype != dtype or x.ndim != ndim or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {ndim}-D {dtype} tensor on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if rows.shape[1] != ROW:
        raise ValueError(f"rows must be (N+1, {ROW}), got {tuple(rows.shape)}")
    if rows.data_ptr() % 16:
        raise ValueError("rows: the kernels copy 16-byte pieces of it, need a 16-byte aligned start")
    if counts.shape[0] != starts.shape[0]:
        raise ValueError("starts and counts must have the same length")


def _walked_ptr(walked: Optional[torch.Tensor], T: int, dev) -> int:
    """The pointer the kernels write their per-quadrant counts to (0 for
    none): a contiguous (2, T, 4) int32 tensor on the kernels' device."""
    if walked is None:
        return 0
    shape = (2, T, MAX_QUADS)
    if (walked.device != dev or walked.dtype != torch.int32 or tuple(walked.shape) != shape
            or not walked.is_contiguous()):
        raise ValueError(f"walked: need a contiguous {shape} int32 tensor on {dev}, "
                         f"got {tuple(walked.shape)} {walked.dtype} on {walked.device}")
    return walked.data_ptr()


def blend_pairs_cuda(rows: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
                     counts: torch.Tensor, tiles_x: int, tile: int, cap: int,
                     group: int, n_channels: int,
                     walked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Hopper kernel ``csrc/resident_fwd.cu`` on the current
    stream: one cluster of four 16×16 quadrant CTAs per tile (one CTA for
    tile ≤ 16).  Same contract as :func:`blend_pairs_plain`; raises on a
    tensor it does not take or a launch that fails (a refused cluster launch
    too).  ``walked``, a (2, T, 4) int32 tensor, receives per quadrant CTA
    (column 0 only for tile ≤ 16) the pair slots it stepped through, which
    must equal the plain version's ``walked_per_tile``, and how many of
    those rows its cull kept, which must equal :func:`quadrant_kept_plain`."""
    from ... import cuda_build

    _check_group(group, tile)
    T, C = starts.shape[0], n_channels
    _check_cuda_inputs(rows, pairs, starts, counts, C)
    dev = rows.device

    fn = cuda_build.entry("resident_fwd", "resident_fwd",
                          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    walked_ptr = _walked_ptr(walked, T, dev)
    out = torch.empty((T, C + 1, tile * tile), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(rows.data_ptr(), pairs.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                    out.data_ptr(), walked_ptr, T, tiles_x, tile, cap, group, C, stream)
    if status != 0:
        raise RuntimeError(f"resident_fwd launch failed with CUDA error {status}")
    launch_counts["resident_fwd"] += 1
    return out


def blend_pairs_bwd_plain(rows: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
                          counts: torch.Tensor, out: torch.Tensor, cot: torch.Tensor,
                          tiles_x: int, tile: int, cap: int, group: int, n_channels: int,
                          per_pair: bool = False, stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch replay backward, group by group like
    :func:`blend_pairs_plain` (a (T, group, tile²) working set).  ``out`` is
    the forward's output and ``cot`` its cotangent, both (T, C+1, tile²).
    Returns the gradient of ``rows``: (N+1, 16) summed per Gaussian, or with
    ``per_pair`` the (T, cap, 16) rows per pair slot, zero past
    ``min(count, cap)`` and past a tile's exit.

    ``stats`` receives ``pairs_read``, ``walked_per_tile`` and
    ``live_pixels`` as in the forward."""
    _check_group(group, tile)
    T = starts.shape[0]
    P = tile * tile
    C = n_channels
    N = rows.shape[0] - 1
    px, py = _pixel_grid(T, tiles_x, tile, rows.device)
    count = torch.clamp(counts.long(), max=cap)
    starts = starts.long()
    g_col = cot[:, :C]  # (T, C, P)
    s_tot = (out[:, :C] * g_col).sum(1, keepdim=True) + cot[:, C:C + 1] * out[:, C:C + 1]
    trans = rows.new_ones((T, 1, P))
    gpre = rows.new_zeros((T, 1, P))
    n_groups = (int(count.max()) + group - 1) // group if T else 0
    if per_pair:
        grads = rows.new_zeros((T, n_groups * group, ROW))
    else:
        grads = rows.new_zeros((N + 1, ROW))
    live_pixels = 0
    walked = torch.zeros(T, dtype=torch.long, device=rows.device)
    for g in range(n_groups):
        active = (g * group < count) & (trans.amax(dim=(1, 2)) > T_EPS)
        if not bool(active.any()):
            break
        idx, valid = _group_index(pairs, starts, count, active, g * group, group, N)
        r = rows[idx]  # (T, G, ROW)
        alpha, live, clamped, dx, dy = _group_geometry(r, px, py, valid)
        if stats is not None:
            walked += valid.sum(1)
            live_pixels += int(live.sum())
        incl = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1) * trans
        w = alpha * t_excl
        gdotc = torch.einsum("tgc,tcp->tgp", r[..., 5:5 + C], g_col)
        prefix = gpre + torch.cumsum(gdotc * w, dim=1)
        one_m = torch.clamp(1.0 - alpha, min=1e-6)
        d_alpha = t_excl * gdotc - (s_tot - prefix) / one_m
        d_alpha = torch.where(alpha > 0.0, d_alpha, torch.zeros_like(d_alpha))
        d_power = torch.where(clamped, torch.zeros_like(d_alpha), d_alpha) * alpha
        t1 = d_power * dx
        t2 = d_power * dy
        s0 = d_power.sum(-1)
        sx = t1.sum(-1)
        sy = t2.sum(-1)
        ca, cb, cc = r[..., 2], r[..., 3], r[..., 4]
        g_rows = rows.new_zeros((T, group, ROW))
        g_rows[..., 0] = -(ca * sx + cb * sy)
        g_rows[..., 1] = -(cc * sy + cb * sx)
        g_rows[..., 2] = -0.5 * (t1 * dx).sum(-1)
        g_rows[..., 3] = -(t1 * dy).sum(-1)
        g_rows[..., 4] = -0.5 * (t2 * dy).sum(-1)
        g_rows[..., 5:5 + C] = torch.einsum("tgp,tcp->tgc", w, g_col)
        g_rows[..., OP_COL] = s0 / torch.clamp(r[..., OP_COL], min=1e-12)
        if per_pair:
            grads[:, g * group:(g + 1) * group] = g_rows
        else:
            # rows past a tile's count or exit land on the sentinel row, as zeros
            grads.index_add_(0, idx.reshape(-1), g_rows.reshape(-1, ROW))
        trans = trans * incl[:, -1:]
        gpre = prefix[:, -1:]
    if stats is not None:
        stats.update(pairs_read=int(walked.sum()), walked_per_tile=walked,
                     live_pixels=live_pixels)
    if per_pair:
        grads = grads[:, :cap]
        if grads.shape[1] < cap:
            grads = torch.cat([grads, rows.new_zeros((T, cap - grads.shape[1], ROW))], 1)
    return grads


def reduce_pair_grads(tile_grads: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Sum the per-pair rows (T, cap, 16) per Gaussian into (n_rows, 16):
    slot s of tile t belongs to ``pairs[starts[t] + s]`` while s <
    ``min(count, cap)``; the slots past it go to the sentinel (last) row."""
    T, cap, _ = tile_grads.shape
    slot = torch.arange(cap, device=pairs.device)
    valid = slot[None, :] < torch.clamp(counts.long(), max=cap)[:, None]
    pos = torch.clamp(starts.long()[:, None] + slot[None, :], max=max(pairs.shape[0] - 1, 0))
    idx = torch.where(valid, pairs[pos].long(), torch.full_like(pos, n_rows - 1))
    grads = tile_grads.new_zeros((n_rows, ROW))
    return grads.index_add_(0, idx.reshape(-1), tile_grads.reshape(-1, ROW))


def blend_pairs_bwd_cuda(rows: torch.Tensor, pairs: torch.Tensor, starts: torch.Tensor,
                         counts: torch.Tensor, out: torch.Tensor, cot: torch.Tensor,
                         tiles_x: int, tile: int, cap: int, group: int, n_channels: int,
                         per_pair: bool = False,
                         walked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Hopper kernel ``csrc/resident_bwd.cu`` on the current
    stream, in clusters as :func:`blend_pairs_cuda`: entry
    ``resident_bwd_accum`` (gradients summed per Gaussian with atomics,
    (N+1, 16)) or, with ``per_pair``, ``resident_bwd_pairs`` (rows per pair
    slot, (T, cap, 16)).  Same contract as :func:`blend_pairs_bwd_plain`;
    raises on a tensor it does not take or a launch that fails; ``walked``
    as in :func:`blend_pairs_cuda`."""
    from ... import cuda_build

    _check_group(group, tile)
    T, C, P = starts.shape[0], n_channels, tile * tile
    _check_cuda_inputs(rows, pairs, starts, counts, C)
    dev = rows.device
    cot = cot.contiguous()  # it comes back through untile's permute
    for name, x in (("out", out), ("cot", cot)):
        if (x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != (T, C + 1, P)
                or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {(T, C + 1, P)} float32 tensor on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    name = "resident_bwd_pairs" if per_pair else "resident_bwd_accum"
    fn = cuda_build.entry("resident_bwd", name,
                          [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    walked_ptr = _walked_ptr(walked, T, dev)
    with torch.cuda.device(dev):
        # zeroed on the launch's stream: blocks run in no order and add into it
        shape = (T, cap, ROW) if per_pair else (rows.shape[0], ROW)
        grads = torch.zeros(shape, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(rows.data_ptr(), pairs.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                    out.data_ptr(), cot.data_ptr(), grads.data_ptr(), walked_ptr, T, tiles_x,
                    tile, cap, group, C, stream)
    if status != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {status}")
    launch_counts[name] += 1
    return grads


class _BlendPairs(torch.autograd.Function):
    """Compositing with the replay backward: the forward saves (rows, pairs,
    starts, counts, out), the backward returns the gradient of ``rows``.
    CUDA tensors launch the kernels; CPU tensors, or ``plain``, take the
    plain versions."""

    @staticmethod
    def forward(ctx, rows, pairs, starts, counts, tiles_x, tile, cap, group, n_channels,
                bwd_accum, plain):
        fwd = blend_pairs_plain if plain else blend_pairs_cuda
        out = fwd(rows, pairs, starts, counts, tiles_x, tile, cap, group, n_channels)
        ctx.save_for_backward(rows, pairs, starts, counts, out)
        ctx.args = (tiles_x, tile, cap, group, n_channels)
        ctx.bwd_accum, ctx.plain = bwd_accum, plain
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cot):
        rows, pairs, starts, counts, out = ctx.saved_tensors
        bwd = blend_pairs_bwd_plain if ctx.plain else blend_pairs_bwd_cuda
        grads = bwd(rows, pairs, starts, counts, out, cot, *ctx.args,
                    per_pair=not ctx.bwd_accum)
        if not ctx.bwd_accum:
            grads = reduce_pair_grads(grads, pairs, starts, counts, rows.shape[0])
        return (grads,) + (None,) * 10


def blend_pairs(rows, pairs, starts, counts, tiles_x, tile, cap, group, n_channels,
                plain: bool = False, bwd_accum: bool = True) -> torch.Tensor:
    """Differentiable compositing (gradient to ``rows`` only).  CUDA tensors
    go through the kernels — ``resident_fwd`` forward and, in the backward,
    ``resident_bwd_accum`` (``bwd_accum``) or ``resident_bwd_pairs`` plus
    :func:`reduce_pair_grads` — or raise; CPU tensors, or ``plain=True``,
    take :func:`blend_pairs_plain` and :func:`blend_pairs_bwd_plain`."""
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compositing path for device {rows.device}")
    return _BlendPairs.apply(rows, pairs, starts, counts, tiles_x, tile, cap, group,
                             n_channels, bwd_accum, plain or rows.device.type == "cpu")


def blend_image_resident(pa: PairAssignment, means2d: torch.Tensor, conics: torch.Tensor,
                         colors: torch.Tensor, opacities: torch.Tensor, depths: torch.Tensor,
                         W: int, H: int, background: torch.Tensor, cap: int = 1024,
                         group: int = GROUP, tile: int = TILE, plain: bool = False,
                         bwd_accum: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-image blend: returns (rgb (H,W,C) with the background added,
    alpha (H,W,1) = 1 − T, depth (H,W,1)).  Differentiable in means2d,
    conics, colors, opacities, depths and the background; ``bwd_accum``
    picks the backward kernel (per-Gaussian sums or per-pair rows)."""
    C_user = colors.shape[-1]
    colors_aug = torch.cat([colors, depths[:, None]], -1)
    C = C_user + 1
    tiles_x = (W + tile - 1) // tile
    rows = _pack_rows(means2d, conics, colors_aug, opacities)
    out = blend_pairs(rows, pa.sorted_gauss.to(torch.int32).contiguous(),
                      pa.starts.to(torch.int32).contiguous(),
                      pa.counts.to(torch.int32).contiguous(),
                      tiles_x, tile, cap, group, C, plain=plain, bwd_accum=bwd_accum)
    return finish_image(out, C_user, W, H, tile, background)


def finish_image(out: torch.Tensor, C_user: int, W: int, H: int, tile: int,
                 background: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The blocks (T, C_user + 2, tile²) of colours, depth and transmittance
    as images: (rgb (H,W,C_user) with the background added, alpha = 1 − T,
    depth).  Plain PyTorch, so autograd folds the alpha and background
    cotangents into the transmittance row the backward kernels read."""
    tiles_x = (W + tile - 1) // tile
    tiles_y = (H + tile - 1) // tile
    C = C_user + 1

    def untile(flat, ch):
        img = flat.reshape(tiles_y, tiles_x, ch, tile, tile)
        img = img.permute(0, 3, 1, 4, 2).reshape(tiles_y * tile, tiles_x * tile, ch)
        return img[:H, :W]

    colors_img = untile(out[:, :C_user], C_user)
    depth_img = untile(out[:, C_user:C], 1)
    trans_img = untile(out[:, C:C + 1], 1)
    rgb = colors_img + trans_img * background[None, None, :]
    return rgb, 1.0 - trans_img, depth_img

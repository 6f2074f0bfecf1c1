"""The per-tile counts of the table read as segments, on the CPU.

B6 and B7 (entries ``table_fwd`` / ``table_bwd`` of ``csrc/resident_fwd.cu``
/ ``resident_bwd.cu``) run B1's and B2's bodies over the (T, K) table of
``backend: pallas`` read as pair segments: tile t's segment starts at t·K,
its cap is K and its tile is one 16×16 CTA.  They composite every entry
they walk, without B1's box cull, because ``bin_gaussians`` already drops
every pair that composites no pixel of its 16-px tile.  On the card each
writes, per tile, the entries it walked, which must equal the plain
versions' ``walked_per_tile``; B1 run over the same segments (the cull
measured on the card) writes the rows its cull kept, which must equal
``resident_blend.quadrant_kept_plain`` over them.  Here those two oracles
are held to counts made independently:

- ``quadrant_kept_plain`` over the segments of a seeded ``bin_gaussians``
  table at 16-px tiles equals a count made tile by tile with the resident
  cull test's helpers, and lies between the live rows and the walked
  entries; it keeps nearly every walked entry, which is why B6/B7 do not
  cull;
- on the cases of ``test_torch_table_blend.py`` (over capacity, empty
  tiles, first-group exit, sentinel, whole image) the forward's and the
  replay's ``walked_per_tile`` are equal and equal a numpy count of the
  groups walked before the exit.
"""

import math

import numpy as np
import pytest
import torch

from dreammesh4d_tpu_torch.ops.gs import resident_blend as rb
from dreammesh4d_tpu_torch.ops.gs import table_blend as tb
from dreammesh4d_tpu_torch.ops.gs.binning import TILE, bin_gaussians
from test_torch_resident_cull import _conic, _keep_by_quadrant, _live_by_quadrant, _walk_count, _wall_inputs
from test_torch_table_blend import _table_case

W = 64
TILES_X = W // TILE
K = 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _splats():
    """400 rotated, anisotropic splats over 64² (aspect up to 8, opacity
    0.01–0.95), as ``_wall_inputs`` returns them."""
    rng = np.random.default_rng(21)
    n = 400
    sa = np.exp(rng.uniform(np.log(1.0), np.log(8.0), n))
    sb = sa / rng.uniform(1.0, 8.0, n)
    conics = np.array([_conic(a, b, th) for a, b, th in zip(sa, sb, rng.uniform(0, math.pi, n))])
    radii = np.ceil(3.0 * sa).astype(np.int32)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (f32(rng.uniform(-4, 68, (n, 2))), f32(conics), f32(rng.random((n, 3))),
            f32(rng.uniform(0.01, 0.95, n)), f32(rng.uniform(1, 3, n)), radii)


def _table_inputs(scene):
    """A seeded scene binned by ``bin_gaussians`` at 16-px tiles (K = 256,
    16 tiles a Gaussian, the exact per-tile cull on): (rows, tile_gauss,
    counts, tiles_x, group, C)."""
    inputs = _splats() if scene == "splats" else _wall_inputs(scene == "quadrant_wall")
    means, conics, colors, op, depths, radii = (torch.as_tensor(x) for x in inputs)
    n = op.shape[0]
    assign = bin_gaussians(means, radii, depths, torch.ones(n, dtype=torch.bool), W, W, K, 16,
                           conics=conics, opacities=op)
    rows = rb._pack_rows(means, conics, torch.cat([colors, depths[:, None]], -1), op)
    return rows, assign.tile_gauss, assign.tile_counts, TILES_X, 32, 4


@pytest.mark.parametrize("scene", ["splats", "wall", "quadrant_wall"])
def test_table_quadrant_kept_plain(scene):
    """The rows B1's box cull keeps over the table's segments:
    ``quadrant_kept_plain`` equals a tile-by-tile count over the walked
    entries, between the live rows and the walked entries."""
    args = _table_inputs(scene)
    rows, tile_gauss, counts = args[:3]
    stats = {}
    tb.blend_table_plain(*args, stats=stats)
    walked = stats["walked_per_tile"]
    pairs, starts, _ = tb._segments(tile_gauss, counts)
    kept = rb.quadrant_kept_plain(rows, pairs, starts, walked, TILES_X, TILE)
    assert kept.shape == (TILES_X * TILES_X, 1) and kept.dtype == torch.int64
    for t in range(TILES_X * TILES_X):
        w = int(walked[t])
        r = rows[tile_gauss[t, :w].long()]
        keep = _keep_by_quadrant(r, torch.tensor([t]), TILE, TILES_X)[0]  # (w, 1)
        live = _live_by_quadrant(r, torch.tensor([t]), TILE, TILES_X)[0]
        assert kept[t].tolist() == keep.sum(0).tolist()
        assert int(live.sum()) <= int(kept[t, 0]) <= w
    assert int(walked.sum()) > 200
    # bin_gaussians culled every pair exactly per tile: the box cull keeps ~all
    assert int(kept.sum()) >= 0.99 * int(walked.sum())


@pytest.mark.parametrize("case", ["over_capacity", "empty_tiles", "first_group_exit", "sentinel",
                                  "whole_image"])
def test_table_walked_per_tile(case):
    """B6/B7's counts: the forward's and the replay's
    ``walked_per_tile`` agree, sum to ``pairs_read`` and equal a numpy count
    of the groups walked before each tile's exit."""
    means, conics, colors, op, tile_gauss, counts, width, group = _table_case(case, np.random.default_rng(3))
    t = torch.as_tensor
    rows = rb._pack_rows(t(means), t(conics), t(colors), t(op))
    tiles_x, C, cap = width // TILE, colors.shape[1], tile_gauss.shape[1]
    args = (rows, t(tile_gauss), t(counts), tiles_x, group, C)
    fwd, bwd = {}, {}
    out = tb.blend_table_plain(*args, stats=fwd)
    cot = t(np.random.default_rng(4).normal(size=out.shape).astype(np.float32))
    tb.blend_table_bwd_plain(*args[:3], out, cot, *args[3:], stats=bwd)
    for stats in (fwd, bwd):
        assert int(stats["walked_per_tile"].sum()) == stats["pairs_read"]
    assert torch.equal(fwd["walked_per_tile"], bwd["walked_per_tile"])
    starts = np.arange(len(counts)) * cap
    ref = _walk_count(rows.numpy(), tile_gauss.reshape(-1), starts, counts, TILE, cap, group,
                      tiles_x=tiles_x)
    np.testing.assert_array_equal(fwd["walked_per_tile"].numpy(), ref)
    full = np.minimum(counts, cap)
    if case == "first_group_exit":
        assert (ref < full).any()  # a tile stopped before the end of its entries
    else:
        np.testing.assert_array_equal(ref, full)

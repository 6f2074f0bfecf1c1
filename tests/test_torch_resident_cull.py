"""The resident compositing kernels' per-quadrant row cull and per-tile walked
counts, on the CPU.

The Hopper kernels B1–B3 (``csrc/resident_fwd.cu``, ``csrc/resident_bwd.cu``)
split a 32-px tile into four 16×16 quadrant CTAs and composite in each only
the staged rows that ``quadrant_keep`` keeps.  That is exact only if the cull
is conservative: every row that is live (the plain live test,
``resident_blend._group_geometry``) at some pixel of a quadrant must be kept
for that quadrant.  Here its PyTorch twin ``quadrant_keep_plain`` (the same
float32 operations in the same order) is held to that:

- a hypothesis property test over random, thin and rotated, nearly singular,
  faint (op around 1/255) and edge-placed rows (the power = −4.5 contour
  ending within a pixel of a quadrant's edge), plus non-finite and
  indefinite conics;
- the rows of a small icosphere scene at 64², tile 32, through the port's
  projection and pair binning.

``quadrant_kept_plain``, the rows the cull keeps per tile and quadrant
(which each quadrant CTA's own count must equal on the card), agrees with a
count made here tile by tile.  The plain versions' ``walked_per_tile`` (which
every quadrant CTA's ``walked`` count must equal on the card) sums to
``pairs_read``, agrees
between the forward and the replay, and on an opaque wall equals a count made
here pair by pair; a wall over one quadrant stops no tile.  On the wall the
plain forward stays within the JAX resident kernel's bands of
``tests/test_torch_raster.py`` (rgb/alpha 3e-3, depth 6e-3).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dreammesh4d_tpu.ops.cameras import camera_position_from_spherical, get_cam_info_gaussian, look_at_c2w
from dreammesh4d_tpu.ops.gs.binning import bin_gaussians_pairs as j_bin_pairs
from dreammesh4d_tpu.ops.gs.pallas_resident import blend_image_resident as j_blend_resident
from dreammesh4d_tpu_torch.ops.gs import resident_blend as rb
from dreammesh4d_tpu_torch.ops.gs.binning import PairAssignment, bin_gaussians_pairs
from dreammesh4d_tpu_torch.ops.gs.projection import project_gaussians_sq
from dreammesh4d_tpu_torch.utils.procedural import make_icosphere


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: with several test workers on the cores, torch's intra-op
    pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W = 64
TILE = 32
TILES_X = W // TILE
CAP = 512


def _live_by_quadrant(r, tiles, tile=TILE, tiles_x=TILES_X):
    """(T, G, nq) whether each row r (G, ROW) is live at some pixel of each
    quadrant of the tiles ``tiles`` (the plain live test)."""
    T = len(tiles)
    px, py = rb._pixel_grid(tiles_x * tiles_x, tiles_x, tile, r.device)
    px, py = px[tiles], py[tiles]
    rr = r[None].expand(T, -1, -1)
    valid = torch.ones(rr.shape[:2], dtype=torch.bool)
    _, live, _, _, _ = rb._group_geometry(rr, px, py, valid)  # (T, G, P)
    live = live.reshape(T, -1, tile // rb.QUAD, rb.QUAD, tile // rb.QUAD, rb.QUAD)
    return live.any(dim=(3, 5)).reshape(T, r.shape[0], -1)  # quadrants x-major


def _keep_by_quadrant(r, tiles, tile=TILE, tiles_x=TILES_X):
    x0, x1, y0, y1 = (b[tiles][:, None, :] for b in rb.quadrant_bounds(tiles_x * tiles_x, tiles_x, tile))
    return rb.quadrant_keep_plain(r[None, :, None, :], x0, x1, y0, y1)


def _assert_conservative(r):
    tiles = torch.arange(TILES_X * TILES_X)
    live = _live_by_quadrant(r, tiles)
    keep = _keep_by_quadrant(r, tiles)
    lost = live & ~keep
    assert not bool(lost.any()), f"culled live rows: {r[lost.any(-1).any(0)].tolist()}"
    return live, keep


def _row(mx, my, ca, cb, cc, op):
    r = np.zeros(rb.ROW, np.float32)
    r[[0, 1, 2, 3, 4, rb.OP_COL]] = [mx, my, ca, cb, cc, op]
    return r


def _conic(sa, sb, theta):
    """The conic (inverse covariance) of an ellipse with standard deviations
    sa, sb along the axes turned by theta."""
    c, s = math.cos(theta), math.sin(theta)
    ia, ib = 1.0 / (sa * sa), 1.0 / (sb * sb)
    return c * c * ia + s * s * ib, c * s * (ia - ib), s * s * ia + c * c * ib


coord = st.floats(-20.0, 84.0)
log_sigma = st.floats(math.log(0.2), math.log(40.0))
theta = st.floats(0.0, math.pi)
opacity = st.one_of(st.floats(0.001, 1.0),
                    st.floats(1.0 / 255.0 * (1 - 1e-4), 1.0 / 255.0 * (1 + 1e-4)))


@st.composite
def rows_strategy(draw):
    kind = draw(st.sampled_from(["random", "thin", "singular", "faint", "edge", "odd"]))
    op = draw(opacity)
    if kind == "random":
        ca, cb, cc = _conic(math.exp(draw(log_sigma)), math.exp(draw(log_sigma)), draw(theta))
        return _row(draw(coord), draw(coord), ca, cb, cc, op)
    if kind == "thin":  # thin and rotated: aspect up to 300
        sa = math.exp(draw(st.floats(math.log(2.0), math.log(40.0))))
        ca, cb, cc = _conic(sa, sa / draw(st.floats(5.0, 300.0)), draw(theta))
        return _row(draw(coord), draw(coord), ca, cb, cc, op)
    if kind == "singular":  # cb² → ca·cc
        ca, cc = draw(st.floats(1e-3, 4.0)), draw(st.floats(1e-3, 4.0))
        eps = 10.0 ** draw(st.floats(-8.0, -1.0))
        cb = draw(st.sampled_from([-1.0, 1.0])) * math.sqrt(ca * cc) * (1.0 - eps)
        return _row(draw(coord), draw(coord), ca, cb, cc, op)
    if kind == "faint":  # op around 1/255, the centre near a pixel
        ca, cb, cc = _conic(math.exp(draw(log_sigma)), math.exp(draw(log_sigma)), draw(theta))
        op = 1.0 / 255.0 * (1.0 + draw(st.floats(-1e-3, 1e-2)))
        return _row(draw(coord), draw(coord), ca, cb, cc, op)
    if kind == "edge":  # the power = -4.5 box ends within a pixel of a quadrant edge
        sa = math.exp(draw(st.floats(math.log(0.5), math.log(20.0))))
        sb = sa / draw(st.floats(1.0, 50.0))
        ca, cb, cc = _conic(sa, sb, draw(theta))
        det = ca * cc - cb * cb
        hx, hy = 3.0 * math.sqrt(cc / det), 3.0 * math.sqrt(ca / det)
        edge = draw(st.sampled_from([15.0, 16.0, 31.0, 32.0, 47.0, 48.0]))
        delta = draw(st.floats(-1.5, 1.5))
        other = draw(coord)
        if draw(st.booleans()):
            mx = edge - hx + delta if draw(st.booleans()) else edge + hx + delta
            return _row(mx, other, ca, cb, cc, op)
        my = edge - hy + delta if draw(st.booleans()) else edge + hy + delta
        return _row(other, my, ca, cb, cc, op)
    # "odd": indefinite, negative or non-finite entries
    vals = st.one_of(st.floats(-2.0, 2.0), st.sampled_from([0.0, math.inf, -math.inf, math.nan]))
    return _row(draw(coord), draw(st.one_of(coord, st.just(math.nan))), draw(vals), draw(vals),
                draw(vals), op)


@settings(max_examples=150, deadline=None)
@given(st.lists(rows_strategy(), min_size=1, max_size=24))
def test_quadrant_keep_is_conservative(rows):
    _assert_conservative(torch.as_tensor(np.stack(rows)))


def test_quadrant_keep_culls_far_rows():
    """The cull is not vacuous: a small splat in one quadrant is dropped by
    every other quadrant of the image, and a faint row by all of them."""
    r = torch.as_tensor(np.stack([_row(5.0, 5.0, 0.5, 0.0, 0.5, 0.8),
                                  _row(40.0, 40.0, 0.01, 0.0, 0.01, 0.5 / 255.0)]))
    live, keep = _assert_conservative(r)
    assert int(keep[:, 0].sum()) == 1 and bool(keep[0, 0, 0])
    assert int(live[:, 0].sum()) == 1
    assert not bool(keep[:, 1].any())


def test_quadrant_bounds():
    x0, x1, y0, y1 = rb.quadrant_bounds(4, 2, 32)
    assert x0.shape == (4, 4)
    assert x0[3].tolist() == [32.0, 48.0, 32.0, 48.0] and x1[3].tolist() == [47.0, 63.0, 47.0, 63.0]
    assert y0[1].tolist() == [0.0, 0.0, 16.0, 16.0] and y1[1].tolist() == [15.0, 15.0, 31.0, 31.0]
    x0, x1, y0, y1 = rb.quadrant_bounds(3, 3, 20)  # 16 < tile < 32: ragged quadrants
    assert x1[2].tolist() == [55.0, 59.0, 55.0, 59.0] and y1[2].tolist() == [15.0, 15.0, 19.0, 19.0]
    x0, x1, y0, y1 = rb.quadrant_bounds(4, 2, 16)  # one CTA covers the tile
    assert x0.shape == (4, 1) and x1[1].tolist() == [31.0] and y1[3].tolist() == [31.0]


def _icosphere_rows():
    mesh = make_icosphere(2, 0.6)
    v = np.asarray(mesh.v_pos, np.float32)
    f = np.asarray(mesh.t_pos_idx)
    rng = np.random.default_rng(3)
    n = len(f)
    means = torch.as_tensor(v[f].mean(1))
    q = rng.normal(size=(n, 4)).astype(np.float32)
    quats = torch.as_tensor(q / np.linalg.norm(q, axis=-1, keepdims=True))
    scales = torch.as_tensor(np.exp(np.log(0.04) + 0.6 * rng.normal(size=(n, 3))).astype(np.float32))
    scales[:, 2] *= 0.05  # flat, as SuGaR's Gaussians
    opac = torch.as_tensor(rng.uniform(0.02, 0.95, n).astype(np.float32))
    pos = camera_position_from_spherical(jnp.asarray(10.0), jnp.asarray(30.0), jnp.asarray(2.2))
    cam = get_cam_info_gaussian(look_at_c2w(pos), 0.8, 0.8, 0.01, 100.0)
    t = float(np.tan(0.4))
    proj = project_gaussians_sq(means, scales, quats, torch.as_tensor(np.array(cam.world_view_transform)),
                                torch.as_tensor(np.array(cam.full_proj_transform)), t, t, W, W)
    pa = bin_gaussians_pairs(proj.means2d, proj.radii, proj.depths, proj.mask, W, W, 6,
                             conics=proj.conics, opacities=opac, tile=TILE)
    colors = torch.cat([torch.as_tensor(rng.random((n, 3)).astype(np.float32)), proj.depths[:, None]], -1)
    return rb._pack_rows(proj.means2d, proj.conics, colors, opac), pa


def test_quadrant_keep_on_icosphere_scene():
    rows, pa = _icosphere_rows()
    n_kept = n_live = n_eval = 0
    for t in range(TILES_X * TILES_X):
        a, c = int(pa.starts[t]), int(pa.counts[t])
        if c == 0:
            continue
        r = rows[pa.sorted_gauss[a:a + c].long()]
        live = _live_by_quadrant(r, torch.tensor([t]))
        keep = _keep_by_quadrant(r, torch.tensor([t]))
        assert not bool((live & ~keep).any()), f"tile {t}: a live row was culled"
        n_kept, n_live, n_eval = n_kept + int(keep.sum()), n_live + int(live.sum()), n_eval + keep.numel()
    assert n_eval > 1000
    assert n_live <= n_kept < n_eval  # some (pair, quadrant) evaluations are culled


def _wall_inputs(quadrant_only):
    """An opaque wall on a 64² image, tile 32, group 32, cap 512, before 300
    faint splats: 800 splats over the whole image, or (with
    ``quadrant_only``) five over the top-left quadrant of tile 0 only, as
    sharp disks (op 50: α = 0.99 out to power −3.9, nothing past −4.5)."""
    rng = np.random.default_rng(11)
    if quadrant_only:
        wall_means = np.full((5, 2), 7.5)
        wall_conic, wall_op, wall_radius = [0.0685, 0.0, 0.0685], 50.0, 12
    else:
        wall_means = rng.uniform(0, 64, (800, 2))
        wall_conic, wall_op, wall_radius = [0.02, 0.0, 0.02], 0.99, 22
    nw, nf = len(wall_means), 300
    means = np.concatenate([wall_means, rng.uniform(0, 64, (nf, 2))])
    conics = np.concatenate([np.tile(wall_conic, (nw, 1)), np.tile([0.3, 0.0, 0.3], (nf, 1))])
    op = np.concatenate([np.full(nw, wall_op), np.full(nf, 0.05)])
    depths = np.concatenate([np.linspace(0.5, 0.6, nw), rng.uniform(1, 3, nf)])
    colors = rng.random((nw + nf, 3))
    radii = np.concatenate([np.full(nw, wall_radius), np.full(nf, 6)])
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(means), f32(conics), f32(colors), f32(op), f32(depths), radii.astype(np.int32)


def _walk_count(rows, pairs, starts, counts, tile, cap, group, tiles_x=TILES_X):
    """Pair slots per tile before the first group at whose start every
    pixel's transmittance is <= 1e-4, counted pair by pair (numpy)."""
    T, P = len(starts), tile * tile
    p = np.arange(P)
    walked = np.zeros(T, np.int64)
    for t in range(T):
        px = np.float32((t % tiles_x) * tile) + (p % tile).astype(np.float32)
        py = np.float32((t // tiles_x) * tile) + (p // tile).astype(np.float32)
        trans = np.ones(P, np.float32)
        count = min(int(counts[t]), cap)
        for g0 in range(0, count, group):
            if trans.max() <= rb.T_EPS:
                break
            walked[t] += min(group, count - g0)
            for j in range(g0, min(g0 + group, count)):
                r = rows[pairs[starts[t] + j]]
                dx, dy = r[0] - px, r[1] - py
                power = np.float32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
                alpha = np.minimum(np.float32(rb.ALPHA_MAX), r[rb.OP_COL] * np.exp(power))
                live = (power <= 0) & (power >= -4.5) & (alpha >= np.float32(rb.ALPHA_MIN))
                trans = trans * (1 - np.where(live, alpha, np.float32(0)))
    return walked


def _blend_args(inputs):
    means, conics, colors, op, depths, radii = (torch.as_tensor(x) for x in inputs)
    n = len(op)
    pa = bin_gaussians_pairs(means, radii, depths, torch.ones(n, dtype=torch.bool), W, W, 6,
                             conics=conics, opacities=op, tile=TILE)
    rows = rb._pack_rows(means, conics, torch.cat([colors, depths[:, None]], -1), op)
    return (rows, pa.sorted_gauss, pa.starts, pa.counts, TILES_X, TILE, CAP, 32, 4), pa


@pytest.mark.parametrize("quadrant_only", [False, True], ids=["wall", "quadrant_wall"])
def test_walked_per_tile(quadrant_only):
    args, pa = _blend_args(_wall_inputs(quadrant_only))
    fwd_stats, bwd_stats = {}, {}
    out = rb.blend_pairs_plain(*args, stats=fwd_stats)
    cot = torch.as_tensor(np.random.default_rng(4).normal(size=out.shape).astype(np.float32))
    rb.blend_pairs_bwd_plain(*args[:4], out, cot, *args[4:], stats=bwd_stats)
    for stats in (fwd_stats, bwd_stats):
        walked = stats["walked_per_tile"]
        assert walked.shape == (4,) and walked.dtype == torch.int64
        assert int(walked.sum()) == stats["pairs_read"]
    assert torch.equal(fwd_stats["walked_per_tile"], bwd_stats["walked_per_tile"])
    ref = _walk_count(args[0].numpy(), pa.sorted_gauss.numpy(), pa.starts.numpy(), pa.counts.numpy(),
                      TILE, CAP, 32)
    np.testing.assert_array_equal(fwd_stats["walked_per_tile"].numpy(), ref)
    full = np.minimum(pa.counts.numpy(), CAP)
    assert full[0] > 64  # tile 0 holds several groups
    trans0 = out[0, 4].reshape(TILE, TILE)
    if quadrant_only:
        # the wall's quadrant is opaque after the first group, the others are
        # not, and the tile walks its whole segment
        assert float(trans0[:16, :16].max()) <= rb.T_EPS
        assert float(trans0[16:, 16:].max()) > 0.1
        assert ref[0] == full[0]
    else:
        assert (ref < full).all()  # every tile stopped early


@pytest.mark.parametrize("scene", ["wall", "quadrant_wall", "icosphere"])
def test_quadrant_kept_plain(scene):
    """The kept rows per tile and quadrant (plane 1 of the kernels' walked
    counts) equal a count made here tile by tile over the walked slots, and
    lie between the live rows and the walked slots."""
    if scene == "icosphere":
        rows, pa = _icosphere_rows()
        args = (rows, pa.sorted_gauss, pa.starts, pa.counts, TILES_X, TILE, CAP, 32, 4)
    else:
        args, pa = _blend_args(_wall_inputs(scene == "quadrant_wall"))
    stats = {}
    rb.blend_pairs_plain(*args, stats=stats)
    walked = stats["walked_per_tile"]
    kept = rb.quadrant_kept_plain(args[0], args[1], args[2], walked, TILES_X, TILE)
    assert kept.shape == (TILES_X * TILES_X, 4) and kept.dtype == torch.int64
    for t in range(TILES_X * TILES_X):
        a, w = int(pa.starts[t]), int(walked[t])
        r = args[0][pa.sorted_gauss[a:a + w].long()]
        keep = _keep_by_quadrant(r, torch.tensor([t]))[0]  # (w, 4)
        live = _live_by_quadrant(r, torch.tensor([t]))[0]
        assert kept[t].tolist() == keep.sum(0).tolist()
        assert (live.sum(0) <= kept[t]).all() and (kept[t] <= w).all()
    assert 0 < int(kept.sum()) < 4 * int(walked.sum())


@pytest.mark.parametrize("quadrant_only", [False, True], ids=["wall", "quadrant_wall"])
def test_plain_blend_on_walls_matches_jax_resident_kernel(quadrant_only):
    means, conics, colors, op, depths, radii = _wall_inputs(quadrant_only)
    n = len(op)
    bg = np.float32([0.3, 0.2, 0.1])

    @jax.jit  # the JAX binning and kernel in one program: eagerly every op compiles on first use
    def j_render(means, radii, depths, conics, colors, op, bg):
        jpa = j_bin_pairs(means, radii, depths, jnp.ones(n, bool), W, W, 6, need_origpos=False,
                          conics=conics, opacities=op, tile=TILE)
        return jpa, j_blend_resident(jpa, means, conics, colors, op, depths, W, W, bg, cap=CAP,
                                     interpret=True, group=32, mm_bf16=False, stream_rows=False,
                                     tile=TILE)

    jpa, ref = j_render(*(jnp.asarray(x) for x in (means, radii, depths, conics, colors, op, bg)))
    pa = PairAssignment(*(torch.as_tensor(np.asarray(x)) for x in (jpa.sorted_gauss, jpa.starts, jpa.counts)),
                        None)
    t = torch.as_tensor
    got = rb.blend_image_resident(pa, t(means), t(conics), t(colors), t(op), t(depths), W, W, t(bg),
                                  cap=CAP, group=32, tile=TILE)
    for port, r, atol in zip(got, ref, (3e-3, 3e-3, 6e-3)):
        np.testing.assert_allclose(port.numpy(), np.asarray(r), atol=atol)
    assert float(got[1].max()) > 0.99  # the wall is opaque

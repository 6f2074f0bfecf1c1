"""PyTorch port vs the JAX package: projection, pair binning, the resident
blend and ``rasterize`` end to end, on the CPU.

- ``project_gaussians_sq`` and the cov3d path (``compute_cov3d`` +
  ``project_gaussians``): rtol 1e-5 (atol 1e-5 of each output's scale);
  radii equal except at most 0.1 % off by one (ceil at float noise).
- Binning gets the SAME projected arrays (JAX's) on both sides; each tile's
  pairs compare as a set and the quantized depth keys must not decrease
  inside a segment (the sort is unstable by contract).
- The plain blend (the oracle of the Hopper kernel) vs the JAX resident
  kernel in interpret mode with f32 matmuls, on the same binned inputs:
  rgb/alpha atol 3e-3, depth 6e-3 — the JAX kernel forms transmittance from
  a bf16 triangular matmul, the port from exact f32 products; the bands are
  the JAX package's own resident-vs-XLA bands.
- The plain blend vs a pair-by-pair sequential walk (the kernel's loop
  written out in numpy) on adversarial segments: atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreammesh4d_tpu.ops.cameras import camera_position_from_spherical, get_cam_info_gaussian, look_at_c2w
from dreammesh4d_tpu.ops.gs import RasterizerConfig as JRasterizerConfig
from dreammesh4d_tpu.ops.gs import rasterize as j_rasterize
from dreammesh4d_tpu.ops.gs.binning import bin_gaussians_pairs as j_bin_pairs
from dreammesh4d_tpu.ops.gs.pallas_resident import blend_image_resident as j_blend_resident
from dreammesh4d_tpu.ops.gs.projection import compute_cov3d as j_cov3d
from dreammesh4d_tpu.ops.gs.projection import project_gaussians as j_project
from dreammesh4d_tpu.ops.gs.projection import project_gaussians_sq as j_project_sq
from dreammesh4d_tpu_torch.ops.gs import resident_blend as rb
from dreammesh4d_tpu_torch.ops.gs.binning import PairAssignment, bin_gaussians_pairs
from dreammesh4d_tpu_torch.ops.gs.projection import compute_cov3d, project_gaussians, project_gaussians_sq
from dreammesh4d_tpu_torch.ops.gs.rasterize import RasterizerConfig, rasterize


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: with several test workers on the cores, torch's intra-op
    pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FOV = 0.8
W = 64


def _t(x):
    return torch.as_tensor(np.array(x))


def make_scene(N=400, seed=0, n_colors=6):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    return dict(
        means=(rng.normal(size=(N, 3)) * 0.4).astype(np.float32),
        quats=q / np.linalg.norm(q, axis=-1, keepdims=True),
        scales=np.exp(np.log(0.05) + 0.3 * rng.normal(size=(N, 3))).astype(np.float32),
        colors=rng.random((N, n_colors)).astype(np.float32),
        opac=rng.uniform(0.3, 0.95, N).astype(np.float32),
    )


def camera():
    pos = camera_position_from_spherical(jnp.asarray(15.0), jnp.asarray(30.0), jnp.asarray(2.5))
    return get_cam_info_gaussian(look_at_c2w(pos), FOV, FOV, 0.01, 100.0)


def j_projected(scene, cam):
    """The JAX projection, jitted (eagerly every op compiles on first use)."""
    t = float(np.tan(FOV / 2))
    return jax.jit(lambda m, s, q, wv, fp: j_project_sq(m, s, q, wv, fp, t, t, W, W))(
        jnp.asarray(scene["means"]), jnp.asarray(scene["scales"]), jnp.asarray(scene["quats"]),
        cam.world_view_transform, cam.full_proj_transform)


@pytest.mark.parametrize("path", ["scales_quats", "cov3d"])
def test_project_gaussians(path):
    scene, cam = make_scene(), camera()
    t = float(np.tan(FOV / 2))
    wv, fp = _t(cam.world_view_transform), _t(cam.full_proj_transform)
    if path == "scales_quats":
        jp = j_projected(scene, cam)
        tp = project_gaussians_sq(_t(scene["means"]), _t(scene["scales"]), _t(scene["quats"]),
                                  wv, fp, t, t, W, W)
    else:
        cov, jp = jax.jit(lambda s, q, m, wv, fp: (lambda c: (c, j_project(m, c, wv, fp, t, t, W, W)))(
            j_cov3d(s, q)))(jnp.asarray(scene["scales"]), jnp.asarray(scene["quats"]),
                            jnp.asarray(scene["means"]), cam.world_view_transform, cam.full_proj_transform)
        tcov = compute_cov3d(_t(scene["scales"]), _t(scene["quats"]))
        np.testing.assert_allclose(tcov.numpy(), np.asarray(cov), atol=1e-7, rtol=1e-5)
        tp = project_gaussians(_t(scene["means"]), tcov, wv, fp, t, t, W, W)
    for name in ("means2d", "depths", "conics"):
        ref = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(getattr(tp, name).numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    dr = np.abs(tp.radii.numpy().astype(np.int64) - np.asarray(jp.radii))
    assert dr.max() <= 1 and (dr > 0).mean() <= 1e-3


def _segments(sorted_gauss, starts, counts):
    g, s, c = (np.asarray(x) for x in (sorted_gauss, starts, counts))
    return [g[a:a + n] for a, n in zip(s, c)]


@pytest.mark.parametrize("tile", [16, 32])
def test_bin_gaussians_pairs(tile):
    scene, cam = make_scene(), camera()
    jp = j_projected(scene, cam)
    jpa = jax.jit(lambda jp, op: j_bin_pairs(jp.means2d, jp.radii, jp.depths, jp.mask, W, W, 6,
                                             need_origpos=False, conics=jp.conics, opacities=op,
                                             tile=tile))(jp, jnp.asarray(scene["opac"]))
    tpa = bin_gaussians_pairs(_t(jp.means2d), _t(jp.radii), _t(jp.depths), _t(jp.mask), W, W, 6,
                              conics=_t(jp.conics), opacities=_t(scene["opac"]), tile=tile)
    np.testing.assert_array_equal(tpa.counts.numpy(), np.asarray(jpa.counts))
    np.testing.assert_array_equal(tpa.starts.numpy(), np.asarray(jpa.starts))
    assert int(tpa.counts.sum()) > 0
    qdepth = np.zeros(len(scene["opac"]), np.int64)
    keys = tpa.sorted_keys.numpy()
    valid = tpa.sorted_gauss.numpy() < len(qdepth)
    qdepth[tpa.sorted_gauss.numpy()[valid]] = keys[valid] & ((1 << 20) - 1)
    for seg_t, seg_j in zip(_segments(tpa.sorted_gauss, tpa.starts, tpa.counts),
                            _segments(jpa.sorted_gauss, jpa.starts, jpa.counts)):
        assert sorted(seg_t.tolist()) == sorted(seg_j.tolist())
        for seg in (seg_t, seg_j):
            assert (np.diff(qdepth[seg]) >= 0).all()


@pytest.mark.parametrize("tile", [32, 16])
def test_plain_blend_matches_jax_resident_kernel(tile):
    scene, cam = make_scene(), camera()
    jp = j_projected(scene, cam)
    op = jnp.asarray(scene["opac"])
    bg = np.float32([0.3, 0.2, 0.1, 0.0, 0.0, 0.0])

    @jax.jit  # the JAX binning and kernel in one program
    def j_render(jp, colors, op, bg):
        jpa = j_bin_pairs(jp.means2d, jp.radii, jp.depths, jp.mask, W, W, 6, need_origpos=False,
                          conics=jp.conics, opacities=op, tile=tile)
        return jpa, j_blend_resident(jpa, jp.means2d, jp.conics, colors, op, jp.depths, W, W, bg,
                                     cap=256, interpret=True, group=32, mm_bf16=False,
                                     stream_rows=False, tile=tile)

    jpa, ref = j_render(jp, jnp.asarray(scene["colors"]), op, jnp.asarray(bg))
    pa = PairAssignment(_t(jpa.sorted_gauss), _t(jpa.starts), _t(jpa.counts), None)
    out = rb.blend_image_resident(pa, _t(jp.means2d), _t(jp.conics), _t(scene["colors"]),
                                  _t(scene["opac"]), _t(jp.depths), W, W, _t(bg), cap=256,
                                  group=32, tile=tile)
    for port, r, atol in zip(out, ref, (3e-3, 3e-3, 6e-3)):
        np.testing.assert_allclose(port.numpy(), np.asarray(r), atol=atol)
    assert float(out[1].max()) > 0.5  # the scene is not empty


def sequential_walk(rows, pairs, starts, counts, tiles_x, tile, cap, group, C):
    """The Hopper kernel's loop written out pair by pair (numpy, float32)."""
    T, P = len(starts), tile * tile
    out = np.zeros((T, C + 1, P), np.float32)
    p = np.arange(P)
    for t in range(T):
        px = np.float32((t % tiles_x) * tile) + (p % tile).astype(np.float32)
        py = np.float32((t // tiles_x) * tile) + (p // tile).astype(np.float32)
        trans = np.ones(P, np.float32)
        acc = np.zeros((C, P), np.float32)
        count = min(int(counts[t]), cap)
        for g0 in range(0, count, group):
            if trans.max() <= rb.T_EPS:
                break
            for j in range(g0, min(g0 + group, count)):
                r = rows[pairs[starts[t] + j]]
                dx, dy = r[0] - px, r[1] - py
                power = np.float32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
                alpha = np.minimum(np.float32(rb.ALPHA_MAX), r[rb.OP_COL] * np.exp(power))
                live = (power <= 0) & (power >= -4.5) & (alpha >= np.float32(rb.ALPHA_MIN))
                alpha = np.where(live, alpha, np.float32(0))
                acc += r[5:5 + C, None] * (alpha * trans)[None]
                trans = trans * (1 - alpha)
        out[t, :C], out[t, C] = acc, trans
    return out


def _adversarial_rows(case, rng):
    """Synthetic (means2d, conics, colors, opacities) on a 32x32 image."""
    if case == "saturated":  # one tile holds more pairs than the capacity
        n = 300
        means = rng.uniform(2, 14, size=(n, 2))
        op = np.full(n, 0.004)
    elif case == "opaque_wall":  # tiles exit early, mid-segment
        n = 200
        means = rng.uniform(0, 32, size=(n, 2))
        op = np.full(n, 0.99)
    else:  # "empty_tiles": small splats, all in one corner tile
        n = 40
        means = rng.uniform(21, 28, size=(n, 2))
        op = rng.uniform(0.2, 0.9, n)
    spread = 0.5 if case == "empty_tiles" else 0.02
    conics = np.stack([np.full(n, spread), rng.uniform(-0.005, 0.005, n), np.full(n, spread)], -1)
    colors = rng.random((n, 3))
    depths = rng.uniform(1, 3, n)
    radii = np.full(n, 4 if case == "empty_tiles" else 12)
    return [torch.as_tensor(np.asarray(x, np.float32)) for x in (means, conics, colors, op, depths)] + [
        torch.as_tensor(radii, dtype=torch.int32)]


@pytest.mark.parametrize("case", ["saturated", "opaque_wall", "empty_tiles"])
def test_plain_blend_matches_sequential_walk(case):
    means, conics, colors, op, depths, radii = _adversarial_rows(case, np.random.default_rng(7))
    n, tile, cap, group = len(op), 16, 128, 32
    pa = bin_gaussians_pairs(means, radii, depths, torch.ones(n, dtype=torch.bool), 32, 32, 16,
                             conics=conics, opacities=op, tile=tile)
    counts = pa.counts.numpy()
    if case == "saturated":
        assert counts.max() > cap
    if case == "empty_tiles":
        assert (counts == 0).sum() >= 2
    rows = rb._pack_rows(means, conics, torch.cat([colors, depths[:, None]], -1), op)
    args = (rows, pa.sorted_gauss, pa.starts, pa.counts, 2, tile, cap, group, 4)
    stats = {}
    plain = rb.blend_pairs_plain(*args, stats=stats)
    ref = sequential_walk(rows.numpy(), pa.sorted_gauss.numpy(), pa.starts.numpy(), counts,
                          2, tile, cap, group, 4)
    np.testing.assert_allclose(plain.numpy(), ref, atol=1e-5)
    assert 0 < stats["pairs_read"] <= int(np.minimum(counts, cap).sum())
    if case == "opaque_wall":
        assert stats["pairs_read"] < int(np.minimum(counts, cap).sum())  # exited early
    if case == "empty_tiles":
        empty = counts == 0
        np.testing.assert_array_equal(plain.numpy()[empty, 4], 1.0)
        np.testing.assert_array_equal(plain.numpy()[empty, :4], 0.0)


def test_blend_dispatch_on_cpu():
    """CPU tensors take the plain version and launch nothing; the kernel
    wrapper refuses CPU tensors."""
    means, conics, colors, op, depths, radii = _adversarial_rows("empty_tiles", np.random.default_rng(8))
    rows = rb._pack_rows(means, conics, colors, op)
    pa = bin_gaussians_pairs(means, radii, depths,
                             torch.ones(len(op), dtype=torch.bool), 32, 32, 16, tile=16)
    before = dict(rb.launch_counts)
    args = (rows, pa.sorted_gauss, pa.starts, pa.counts, 2, 16, 64, 32, 3)
    torch.testing.assert_close(rb.blend_pairs(*args), rb.blend_pairs_plain(*args))
    assert rb.launch_counts == before
    with pytest.raises(ValueError):
        rb.blend_pairs_cuda(*args)


@pytest.mark.parametrize("tile", [32, 16])
def test_rasterize_matches_jax_xla(tile):
    scene, cam = make_scene(N=300, seed=1, n_colors=3), camera()
    t = float(np.tan(FOV / 2))
    base = dict(width=W, height=W, tan_fovx=t, tan_fovy=t, tile_capacity=256,
                max_tiles_per_gaussian=8)
    bg = np.float32([0.3, 0.2, 0.1])
    ref = jax.jit(lambda m, o, c, s, q: j_rasterize(m, o, cam, JRasterizerConfig(**base, backend="xla"),
                                                    jnp.asarray(bg), colors=c, scales=s, quats=q))(
        *(jnp.asarray(scene[k]) for k in ("means", "opac", "colors", "scales", "quats")))
    cam_t = tuple(np.asarray(x) for x in cam)
    out = rasterize(scene["means"], scene["opac"], cam_t,
                    RasterizerConfig(**base, backend="pallas_resident", tile_px=tile), bg,
                    colors=scene["colors"], scales=scene["scales"], quats=scene["quats"],
                    device="cpu")
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), atol=3e-3)
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(ref.alpha), atol=3e-3)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth), atol=6e-3)
    assert float(out.alpha.max()) > 0.5

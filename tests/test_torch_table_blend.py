"""The port's ``backend: pallas`` — the (T, K) table binning and the table
compositing that B6/B7 implement on the card — against the JAX package on
the CPU.

- ``bin_gaussians`` equals the JAX one entry for entry (``tile_gauss``,
  ``tile_counts``, and ``tile_valid``, which is the first ``counts`` slots of
  each row): the order inside a tile is the exact,
  stable depth rank on both sides.  Also on a scene whose tiles overflow K,
  and both refuse the same packed-key overflow with ``ValueError``.
- The plain table compositing and its replay backward (the oracles of B6 and
  B7) against ``pallas_blend.blend_tiles_pallas`` in interpret mode, forward
  and ``jax.vjp``, on adversarial tables: tiles over capacity, empty tiles, a
  tile that exits in its first group, one Gaussian over the whole image, a
  count that ends inside a group.  The JAX kernel's transmittance matmuls
  (``_matmul_bf16``, a TPU choice) run in float32 here, so the two must
  agree to float32 rounding: 1e-5 forward, 1e-4 of each column group's max
  backward.
- ``rasterize(backend="pallas")`` against the unmodified JAX kernel
  (``interpret=True``, bf16 transmittance): rgb/alpha within 3e-3, depth
  6e-3 (the JAX package's own pallas-vs-XLA bands), and the gradients of
  means, quats, scales, colours and opacities within 1e-2 of each leaf's max.
- The port's ``pallas`` (16-px tiles) against its ``pallas_resident`` (32-px
  tiles) on one scene: within 7e-4, the band of the tile exit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import _cheap_xla  # noqa: F401

import dreammesh4d_tpu.ops.gs.pallas_blend as jblend
from dreammesh4d_tpu.ops.cameras import camera_position_from_spherical, get_cam_info_gaussian, look_at_c2w
from dreammesh4d_tpu.ops.gs import RasterizerConfig as JRasterizerConfig
from dreammesh4d_tpu.ops.gs import rasterize as j_rasterize
from dreammesh4d_tpu.ops.gs.binning import bin_gaussians as j_bin_gaussians
from dreammesh4d_tpu.ops.gs.projection import project_gaussians_sq as j_project_sq
from dreammesh4d_tpu_torch.ops.gs import resident_blend as rb
from dreammesh4d_tpu_torch.ops.gs import table_blend as tb
from dreammesh4d_tpu_torch.ops.gs.binning import bin_gaussians
from dreammesh4d_tpu_torch.ops.gs.rasterize import RasterizerConfig, rasterize

FOV = 0.8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: with several test workers on the cores, torch's intra-op
    pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_scene(N, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    return dict(
        means=(rng.normal(size=(N, 3)) * 0.4).astype(np.float32),
        quats=q / np.linalg.norm(q, axis=-1, keepdims=True),
        scales=np.exp(np.log(0.05) + 0.3 * rng.normal(size=(N, 3))).astype(np.float32),
        colors=rng.random((N, 3)).astype(np.float32),
        opac=rng.uniform(0.3, 0.95, N).astype(np.float32),
    )


def camera():
    pos = camera_position_from_spherical(jnp.asarray(15.0), jnp.asarray(30.0), jnp.asarray(2.5))
    return get_cam_info_gaussian(look_at_c2w(pos), FOV, FOV, 0.01, 100.0)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("W,K,M", [(64, 256, 16), (48, 24, 8)], ids=["seeded", "over_capacity"])
def test_bin_gaussians_matches_jax(W, K, M):
    scene, cam = make_scene(200, 0), camera()
    t = float(np.tan(FOV / 2))
    # the JAX side jitted: eagerly every op compiles on first use
    proj = jax.jit(lambda m, s, q: j_project_sq(m, s, q, cam.world_view_transform,
                                                cam.full_proj_transform, t, t, W, W))(
        jnp.asarray(scene["means"]), jnp.asarray(scene["scales"]), jnp.asarray(scene["quats"]))
    # equal depths in both packages: the stable order keeps their index order
    depths = proj.depths.at[10:20].set(proj.depths[5])
    op = jnp.asarray(scene["opac"])
    ref = jax.jit(lambda *a: j_bin_gaussians(*a[:4], W, W, K, M, conics=a[4], opacities=a[5]))(
        proj.means2d, proj.radii, depths, proj.mask, proj.conics, op)
    got = bin_gaussians(_t(proj.means2d), _t(proj.radii), _t(depths), _t(proj.mask), W, W, K, M,
                        conics=_t(proj.conics), opacities=_t(op))
    np.testing.assert_array_equal(got.tile_gauss.numpy(), np.asarray(ref.tile_gauss))
    np.testing.assert_array_equal(got.tile_counts.numpy(), np.asarray(ref.tile_counts))
    valid = torch.arange(K)[None, :] < got.tile_counts[:, None]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref.tile_valid))
    assert got.tile_gauss.dtype == torch.int32 and got.tile_gauss.shape == (((W + 15) // 16) ** 2, K)
    counts = got.tile_counts.numpy()
    assert counts.sum() > 0
    if K == 24:
        assert (counts > K).any()  # the cut keeps the K nearest on both sides


@pytest.mark.parametrize("n,side,raises", [(5000, 8192, True), (4095, 8192, False)])
def test_bin_gaussians_key_overflow(n, side, raises):
    """rank bits + tile bits > 31 is refused by both packages (4095
    Gaussians x 262,144 tiles needs exactly 31 bits, 5000 needs 32)."""
    rng = np.random.default_rng(1)
    args = [rng.uniform(0, side, (n, 2)).astype(np.float32), np.full(n, 3, np.int32),
            rng.uniform(1, 3, n).astype(np.float32), np.ones(n, bool)]
    outcomes = []
    j_bin = jax.jit(lambda *a: j_bin_gaussians(*a, side, side, 1, 1))
    for fn, conv in ((j_bin, jnp.asarray), (lambda *a: bin_gaussians(*a, side, side, 1, 1), _t)):
        try:
            out = fn(*(conv(a) for a in args))
            outcomes.append(int(np.asarray(out.tile_counts).sum()))
        except ValueError as e:
            assert "overflow" in str(e)
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] == "ValueError") == raises


def _matmul_f32(a, b):
    """``pallas_blend._matmul_bf16`` with float32 inputs."""
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)


def _table_case(case, rng):
    """(means2d, conics, colours (N, C), opacities, tile_gauss, counts, W,
    group) at 32²: 4 tiles of 16 px, K = 40."""
    K, W = 40, 32
    if case == "whole_image":  # one wide Gaussian in every tile, over a few small ones
        n = 30
        means = np.concatenate([[[16.0, 16.0]], rng.uniform(0, 32, (n - 1, 2))])
        conics = np.concatenate([[[0.004, 0.0, 0.004]],
                                 np.tile([[0.3, 0.0, 0.3]], (n - 1, 1))])
        op = np.concatenate([[0.6], rng.uniform(0.2, 0.9, n - 1)])
    else:
        n = 120
        means = rng.uniform(0, 32, (n, 2))
        spread = 0.01 if case == "first_group_exit" else 0.05
        conics = np.stack([np.full(n, spread), rng.uniform(-0.003, 0.003, n), np.full(n, spread)], -1)
        op = np.full(n, 0.99) if case == "first_group_exit" else rng.uniform(0.2, 0.9, n)
    colors = np.concatenate([rng.random((n, 3)), rng.uniform(1, 3, (n, 1))], -1)  # rgb + depth
    # the table: per tile, Gaussians in index order (front to back), sentinel n past the count
    counts = {"over_capacity": [55, 40, 17, 3], "empty_tiles": [0, 12, 0, 9],
              "first_group_exit": [40, 40, 33, 40], "sentinel": [13, 5, 27, 1],
              "whole_image": [30, 30, 30, 30]}[case]
    tile_gauss = np.full((4, K), n, np.int32)
    for t, c in enumerate(counts):
        ids = rng.permutation(n)[:min(c, K)] if case != "whole_image" else np.arange(n)
        tile_gauss[t, :len(ids)] = np.sort(ids)
    group = 8
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(means), f32(conics), f32(colors), f32(op), tile_gauss, np.int32(counts), W, group


@pytest.mark.parametrize("case", ["over_capacity", "empty_tiles", "first_group_exit", "sentinel",
                                  "whole_image"])
def test_table_blend_matches_jax_kernel(case, monkeypatch):
    means, conics, colors, op, tile_gauss, counts, W, group = _table_case(
        case, np.random.default_rng(3))
    K, C = tile_gauss.shape[1], colors.shape[1]
    monkeypatch.setattr(jblend, "_matmul_bf16", _matmul_f32)
    clipped = np.minimum(counts, K)

    def j_blend(m, cc, o):
        return jblend.blend_tiles_pallas(jnp.asarray(tile_gauss), jnp.asarray(clipped), m, cc, o,
                                         W, W, C, True, group)

    rows = rb._pack_rows(_t(means), _t(conics), _t(colors), _t(op))
    stats = {}
    out = tb.blend_table_plain(rows, _t(tile_gauss), _t(counts), 2, group, C, stats=stats)
    cot = np.random.default_rng(4).normal(size=out.shape).astype(np.float32)

    @jax.jit  # the JAX forward and its vjp in one program: eagerly every op compiles on first use
    def j_blend_vjp(m, cc, o, g):
        ref, vjp = jax.vjp(j_blend, m, cc, o)
        return ref, vjp(g)

    ref, (d_means, (d_conics, d_colors), d_op) = j_blend_vjp(
        jnp.asarray(means), (jnp.asarray(conics), jnp.asarray(colors)), jnp.asarray(op), jnp.asarray(cot))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    if case == "empty_tiles":
        np.testing.assert_array_equal(out.numpy()[counts == 0, C], 1.0)
    if case == "first_group_exit":
        assert stats["pairs_read"] < clipped.sum()  # some tile stopped early
    assert stats["pairs_read"] <= clipped.sum()

    grads = tb.blend_table_bwd_plain(rows, _t(tile_gauss), _t(counts), out, _t(cot), 2, group, C)
    assert float(grads[-1].abs().max()) == 0.0  # the sentinel row
    for name, got, want in (("means", grads[:-1, 0:2], d_means), ("conics", grads[:-1, 2:5], d_conics),
                            ("colours", grads[:-1, 5:5 + C], d_colors),
                            ("opacity", grads[:-1, rb.OP_COL], d_op)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), err_msg=name)


def _configs(**kw):
    """The JAX config (the Pallas kernel in interpret mode) and the port's."""
    t = float(np.tan(FOV / 2))
    return (JRasterizerConfig(tan_fovx=t, tan_fovy=t, backend="pallas", interpret=True, **kw),
            RasterizerConfig(tan_fovx=t, tan_fovy=t, backend="pallas", **kw))


def test_rasterize_pallas_matches_jax():
    scene, cam = make_scene(200, 1), camera()
    jcfg, tcfg = _configs(width=64, height=64, tile_capacity=256)
    bg = np.float32([0.3, 0.2, 0.1])
    ref = jax.jit(lambda m, o, c, s, q: j_rasterize(m, o, cam, jcfg, jnp.asarray(bg), colors=c, scales=s,
                                                    quats=q))(
        *(jnp.asarray(scene[k]) for k in ("means", "opac", "colors", "scales", "quats")))
    out = rasterize(scene["means"], scene["opac"], tuple(np.asarray(x) for x in cam), tcfg, bg,
                    colors=scene["colors"], scales=scene["scales"], quats=scene["quats"],
                    device="cpu")
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), atol=3e-3)
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(ref.alpha), atol=3e-3)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth), atol=6e-3)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    assert float(out.alpha.max()) > 0.5


def test_rasterize_pallas_gradients_match_jax():
    scene, cam = make_scene(60, 2), camera()
    W = 32
    jcfg, tcfg = _configs(width=W, height=W, tile_capacity=256)
    target = np.random.default_rng(5).random((W, W, 3)).astype(np.float32)

    def j_loss(p):
        out = j_rasterize(p["means"], p["opac"], cam, jcfg, jnp.ones(3), colors=p["colors"],
                          scales=p["scales"], quats=p["quats"])
        return ((out.rgb - target) ** 2).mean() + 0.1 * out.depth.mean() + 0.05 * out.alpha.mean()

    keys = ("means", "quats", "scales", "colors", "opac")
    jgrads = jax.jit(jax.grad(j_loss))({k: jnp.asarray(scene[k]) for k in keys})
    leaves = {k: torch.tensor(scene[k], requires_grad=True) for k in keys}
    out = rasterize(leaves["means"], leaves["opac"], tuple(np.asarray(x) for x in cam), tcfg,
                    torch.ones(3), colors=leaves["colors"], scales=leaves["scales"],
                    quats=leaves["quats"], device="cpu")
    loss = ((out.rgb - torch.as_tensor(target)) ** 2).mean() + 0.1 * out.depth.mean() \
        + 0.05 * out.alpha.mean()
    loss.backward()
    for k in keys:
        want, got = np.asarray(jgrads[k]), leaves[k].grad.numpy()
        assert np.isfinite(got).all() and np.abs(want).max() > 0, k
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), k


def test_pallas_matches_resident():
    scene, cam = make_scene(300, 3), camera()
    t = float(np.tan(FOV / 2))
    outs = {}
    for backend, tile in (("pallas", 16), ("pallas_resident", 32)):
        cfg = RasterizerConfig(64, 64, t, t, tile_capacity=512, backend=backend, tile_px=tile)
        outs[backend] = rasterize(scene["means"], scene["opac"], tuple(np.asarray(x) for x in cam),
                                  cfg, np.float32([1.0, 1.0, 1.0]), colors=scene["colors"],
                                  scales=scene["scales"], quats=scene["quats"], device="cpu")
    a, b = outs["pallas"], outs["pallas_resident"]
    for name in ("rgb", "alpha", "depth"):
        assert float((getattr(a, name) - getattr(b, name)).abs().max()) <= 7e-4, name
    assert float(a.alpha.max()) > 0.5


def test_table_dispatch_on_cpu():
    """CPU tensors take the plain versions and launch nothing; the kernel
    wrappers refuse CPU tensors."""
    means, conics, colors, op, tile_gauss, counts, W, group = _table_case(
        "sentinel", np.random.default_rng(6))
    rows = rb._pack_rows(_t(means), _t(conics), _t(colors), _t(op)).requires_grad_(True)
    args = (_t(tile_gauss), _t(counts), 2, group, colors.shape[1])
    before = dict(tb.launch_counts)
    out = tb.blend_table(rows, *args)
    torch.testing.assert_close(out, tb.blend_table_plain(rows.detach(), *args))
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    (out * cot).sum().backward()
    torch.testing.assert_close(rows.grad, tb.blend_table_bwd_plain(rows.detach(), *args[:2], out.detach(),
                                                                   cot, *args[2:]))
    assert tb.launch_counts == before
    with pytest.raises(ValueError):
        tb.blend_table_cuda(rows.detach(), *args)
    with pytest.raises(ValueError):
        tb.blend_table_bwd_cuda(rows.detach(), *args[:2], out.detach(), cot, *args[2:])

"""Gradients of the port's rasterizer on the CPU, where the compositing
backward is ``blend_pairs_bwd_plain`` (the plain version of the Hopper
kernels ``resident_bwd_accum`` / ``resident_bwd_pairs``).

Against the JAX package, same numpy scene (N = 60, 32², capacity 256) through
``jax.grad`` of its ``rasterize`` and ``.backward()`` of the port's, per leaf
(means3d, quats, log-scales, colour logits, opacity logits), |Δ| / max|g_jax|:

- ``pallas_resident`` in interpret mode, ``bwd_accum`` true and false:
  ≤ 5e-3 — the TPU kernel forms transmittance from a bf16 triangular matmul,
  the port from exact float32 products (the JAX package's own band against
  its XLA blend is 3e-3); measured here ≤ 2.3e-3 (means3d; the other
  leaves ≤ 7e-4);
- ``xla`` (exact float32, 16-px tiles, no tile exit): ≤ 1e-3; measured
  ≤ 4e-7.

Port only:
- ``blend_pairs_bwd_plain`` against autograd through ``blend_pairs_plain``,
  a second and independent statement of the same gradient: ≤ 1e-5 of the
  largest entry, on a saturated tile (count > capacity), an empty tile, an
  opaque wall whose tiles exit early, at C = 4 and C = 7;
- the per-pair output reduced with ``reduce_pair_grads`` against the
  accumulated output (≤ 1e-6 of max: float32 sums in another order);
- a clamped alpha (op·exp(power) > 0.99) has zero gradient;
- pairs behind a tile's exit get zero gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import _cheap_xla  # noqa: F401

from dreammesh4d_tpu.ops.cameras import camera_position_from_spherical, get_cam_info_gaussian, look_at_c2w
from dreammesh4d_tpu.ops.gs import RasterizerConfig as JRasterizerConfig
from dreammesh4d_tpu.ops.gs import rasterize as j_rasterize
from dreammesh4d_tpu_torch.ops.gs import resident_blend as rb
from dreammesh4d_tpu_torch.ops.gs.binning import bin_gaussians_pairs
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
W = 32
LEAVES = ("p", "q", "ls", "c", "ol")


def make_scene(N=60, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    colors = rng.uniform(0.05, 0.95, size=(N, 3))
    return {
        "p": (rng.normal(size=(N, 3)) * 0.4).astype(np.float32),
        "q": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "ls": (np.log(0.05) + 0.3 * rng.normal(size=(N, 3))).astype(np.float32),
        "c": np.log(colors / (1 - colors)).astype(np.float32),
        "ol": np.full((N,), 0.5, np.float32),
    }


def camera():
    pos = camera_position_from_spherical(jnp.asarray(15.0), jnp.asarray(30.0), jnp.asarray(2.5))
    return get_cam_info_gaussian(look_at_c2w(pos), FOV, FOV, 0.01, 100.0)


def base_cfg():
    t = float(np.tan(FOV / 2))
    return dict(width=W, height=W, tan_fovx=t, tan_fovy=t, tile_capacity=256, chunk=32)


def jax_grads(scene, cam, cfg):
    bg = jnp.ones(3)

    def loss(pr):
        out = j_rasterize(pr["p"], jax.nn.sigmoid(pr["ol"]), cam, cfg, bg,
                          colors=jax.nn.sigmoid(pr["c"]), scales=jnp.exp(pr["ls"]), quats=pr["q"])
        return (out.rgb ** 2).mean() + 0.1 * out.depth.mean() + 0.05 * out.alpha.mean()

    grads = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in scene.items()})
    return {k: np.asarray(v) for k, v in grads.items()}


def torch_grads(scene, cam, cfg):
    pr = {k: torch.tensor(v, requires_grad=True) for k, v in scene.items()}
    out = rasterize(pr["p"], torch.sigmoid(pr["ol"]), tuple(np.asarray(x) for x in cam), cfg,
                    np.ones(3, np.float32), colors=torch.sigmoid(pr["c"]),
                    scales=torch.exp(pr["ls"]), quats=pr["q"], device="cpu")
    loss = (out.rgb ** 2).mean() + 0.1 * out.depth.mean() + 0.05 * out.alpha.mean()
    loss.backward()
    return {k: v.grad.numpy() for k, v in pr.items()}


@pytest.fixture(scope="module")
def port_grads():
    scene, cam = make_scene(), camera()
    return scene, cam, {
        accum: torch_grads(scene, cam, RasterizerConfig(**base_cfg(), backend="pallas_resident",
                                                        bwd_accum=accum))
        for accum in (True, False)}


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("ref", ["resident_accum", "resident_pairs", "xla"])
def test_rasterize_gradients_match_jax(port_grads, ref, leaf):
    scene, cam, port = port_grads
    if ref == "xla":
        jcfg, accum, tol = JRasterizerConfig(**base_cfg(), backend="xla"), True, 1e-3
    else:
        accum = ref == "resident_accum"
        jcfg = JRasterizerConfig(**base_cfg(), backend="pallas_resident", interpret=True,
                                 bwd_accum=accum)
        tol = 5e-3
    key = ("jax", ref)
    if key not in port:
        port[key] = jax_grads(scene, cam, jcfg)
    a, b = port[key][leaf], port[accum][leaf]
    assert np.isfinite(b).all()
    assert np.abs(a).max() > 0
    assert np.abs(a - b).max() / np.abs(a).max() <= tol


def _segments(case, C, seed=7):
    """Synthetic compositing inputs on a 32² image, 16-px tiles, cap 128."""
    rng = np.random.default_rng(seed)
    if case == "saturated":  # one tile holds more pairs than the capacity
        n, means, op, spread, rad = 300, rng.uniform(2, 14, size=(300, 2)), np.full(300, 0.004), 0.02, 12
    elif case == "opaque_wall":  # tiles exit early, mid-segment
        n, means, op, spread, rad = 200, rng.uniform(0, 32, size=(200, 2)), np.full(200, 0.9), 0.02, 12
    else:  # "empty_tiles": small splats, all in one corner tile
        n, means, op, spread, rad = 40, rng.uniform(21, 28, size=(40, 2)), rng.uniform(0.2, 0.9, 40), 0.5, 4
    conics = np.stack([np.full(n, spread), rng.uniform(-0.005, 0.005, n), np.full(n, spread)], -1)
    depths = rng.uniform(1, 3, n)
    colors = np.concatenate([rng.random((n, C - 1)), depths[:, None]], -1)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    means, conics, colors, op, depths = map(f32, (means, conics, colors, op, depths))
    pa = bin_gaussians_pairs(means, torch.full((n,), rad, dtype=torch.int32), depths,
                             torch.ones(n, dtype=torch.bool), 32, 32, 16, conics=conics,
                             opacities=op, tile=16)
    rows = rb._pack_rows(means, conics, colors, op)
    return rows, (pa.sorted_gauss, pa.starts, pa.counts), (2, 16, 128, 32, C)


def _cot(shape, seed=3):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("C", [4, 7])
@pytest.mark.parametrize("case", ["saturated", "opaque_wall", "empty_tiles"])
def test_plain_backward_matches_autograd(case, C):
    rows, seg, args = _segments(case, C)
    counts = seg[2].numpy()
    if case == "saturated":
        assert counts.max() > args[2]
    if case == "empty_tiles":
        assert (counts == 0).sum() >= 2
    rows_ad = rows.clone().requires_grad_(True)
    stats = {}
    out = rb.blend_pairs_plain(rows_ad, *seg, *args, stats=stats)
    if case == "opaque_wall":
        assert stats["pairs_read"] < int(np.minimum(counts, args[2]).sum())  # exited early
    cot = _cot(out.shape)
    (ref,) = torch.autograd.grad(out, rows_ad, cot)
    got = rb.blend_pairs_bwd_plain(rows, *seg, out.detach(), cot, *args)
    assert got.shape == rows.shape
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert float(got[-1].abs().max()) == 0.0  # the sentinel row receives nothing
    assert float(got[:, 5 + C:rb.OP_COL].abs().max()) == 0.0 and float(got[:, 15].abs().max()) == 0.0

    # the per-pair rows, reduced per Gaussian, are the accumulated rows
    per_pair = rb.blend_pairs_bwd_plain(rows, *seg, out.detach(), cot, *args, per_pair=True)
    assert per_pair.shape == (len(counts), args[2], rb.ROW)
    red = rb.reduce_pair_grads(per_pair, *seg, rows.shape[0])
    assert float((red - got).abs().max()) <= 1e-6 * scale
    past = torch.arange(args[2])[None, :] >= torch.clamp(seg[2], max=args[2])[:, None]
    assert float(per_pair[past].abs().sum()) == 0.0

    # the differentiable entry point gives the same through .backward()
    for accum in (True, False):
        r = rows.clone().requires_grad_(True)
        rb.blend_pairs(r, *seg, *args, bwd_accum=accum).backward(cot)
        assert float((r.grad - got).abs().max()) <= 1e-6 * scale


def test_pairs_behind_the_exit_get_no_gradient():
    rows, seg, args = _segments("opaque_wall", 4)
    out = rb.blend_pairs_plain(rows, *seg, *args)
    per_pair = rb.blend_pairs_bwd_plain(rows, *seg, out, _cot(out.shape), *args, per_pair=True)
    group = args[3]
    exited = 0
    for t in range(len(seg[1])):
        count = min(int(seg[2][t]), args[2])
        nz = torch.nonzero(per_pair[t].abs().sum(-1))[:, 0]
        last_group_end = (int(nz.max()) // group + 1) * group if len(nz) else 0
        if last_group_end < count:  # the tile stopped before its segment ended
            exited += 1
            assert float(out[t, 4].max()) <= rb.T_EPS
            assert float(per_pair[t, last_group_end:].abs().max()) == 0.0
    assert exited >= 1


def test_clamped_alpha_has_zero_gradient():
    # one splat whose centre pixels clamp (op·exp(power) > 0.99), one that does not
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    means, conics = f32([[8.0, 8.0]]), f32([[1e-4, 0.0, 1e-4]])
    rows = rb._pack_rows(means, conics, f32([[0.3, 0.6, 0.9, 2.0]]), f32([0.999]))
    seg = (torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
           torch.ones(1, dtype=torch.int32))
    args = (1, 16, 8, 8, 4)
    out = rb.blend_pairs_plain(rows, *seg, *args)
    assert float(out[0, 4].max()) <= 1.0 - 0.99 + 1e-6  # every pixel clamped
    g = rb.blend_pairs_bwd_plain(rows, *seg, out, _cot(out.shape), *args)
    assert float(g[0, :5].abs().max()) == 0.0 and float(g[0, rb.OP_COL].abs()) == 0.0
    assert float(g[0, 5:9].abs().max()) > 0.0  # the colours still get theirs
    rows[0, rb.OP_COL] = 0.5
    out = rb.blend_pairs_plain(rows, *seg, *args)
    g = rb.blend_pairs_bwd_plain(rows, *seg, out, _cot(out.shape), *args)
    assert float(g[0, rb.OP_COL].abs()) > 0.0 and float(g[0, :5].abs().max()) > 0.0

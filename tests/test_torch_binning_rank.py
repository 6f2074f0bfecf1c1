"""``binning: rank`` of the port against the JAX package and against the
port's own pair binning (CPU).

- ``bin_gaussians_ranks`` equals the JAX package's exactly (``sorted_gauss``,
  ``starts``, ``counts``, ``depth_order``, ``inv_rank``) on seeded projected
  arrays, with distinct depths and with many equal ones (the stable argsort
  keeps index order on ties in both), on 16- and 32-px tiles; both raise
  ``ValueError`` on the same input whose int32 key would overflow.
- ``rasterize`` with ``backend: pallas_resident, binning: rank`` against the
  port's pairs mode on the scene of ``tests/test_pallas_blend.py``'s
  rank-vs-pairs test (N = 70, seed 7, 32²): rgb, alpha and depth within
  1e-5, the gradient of every leaf within 1e-4 of its max |g| — the bands the
  JAX test holds between its own two modes.  The same render against the
  JAX package's plain ``xla`` path: rgb/alpha 3e-3, depth 6e-3 (the bands of
  ``test_torch_raster.py``).  The JAX rank mode itself runs only in the JAX
  package's own test, in interpret mode; its binning is held exactly here.
- Rank mode with ``bwd_accum: false`` raises ``ValueError``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_blend import FOV
from test_pallas_blend import make_scene as j_make_scene

from dreammesh4d_tpu.ops.gs import RasterizerConfig as JRasterizerConfig
from dreammesh4d_tpu.ops.gs import rasterize as j_rasterize
from dreammesh4d_tpu.ops.gs.binning import bin_gaussians_ranks as j_bin_ranks
from dreammesh4d_tpu_torch.ops.gs.binning import bin_gaussians_ranks
from dreammesh4d_tpu_torch.ops.gs.rasterize import RasterizerConfig, rasterize

W = 64
trast = importlib.import_module("dreammesh4d_tpu_torch.ops.gs.rasterize")  # the module, not the function


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def projected(N=300, ties=False, seed=0):
    """Seeded projected arrays over a W² image: means partly off screen,
    some masked or zero-radius, conics of random SPD 2x2 covariances."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(-8, W + 8, (N, 2)).astype(np.float32)
    radii = rng.integers(0, 14, N).astype(np.int32)
    depths = rng.uniform(0.5, 3.0, N).astype(np.float32)
    if ties:  # eight depth levels: every tile holds equal depths
        depths = (np.round(depths * 3.0) / 3.0).astype(np.float32)
    mask = rng.random(N) < 0.9
    a = rng.normal(size=(N, 2, 2)) * 2.0
    cov = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(2)
    inv = np.linalg.inv(cov)
    conics = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1).astype(np.float32)
    opac = rng.uniform(0.01, 0.95, N).astype(np.float32)
    return means2d, radii, depths, mask, conics, opac


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("ties", [False, True])
def test_bin_gaussians_ranks_equals_jax(ties, tile):
    m, r, d, mask, conics, opac = projected(ties=ties)
    if ties:
        assert len(np.unique(d)) <= 8
    jpa = jax.jit(lambda *a: j_bin_ranks(*a[:4], W, W, 6, conics=a[4], opacities=a[5], tile=tile))(
        *(jnp.asarray(x) for x in (m, r, d, mask, conics, opac)))
    tpa = bin_gaussians_ranks(*(torch.as_tensor(x) for x in (m, r, d, mask)), W, W, 6,
                              conics=torch.as_tensor(conics), opacities=torch.as_tensor(opac), tile=tile)
    for name in ("sorted_gauss", "starts", "counts", "depth_order", "inv_rank"):
        np.testing.assert_array_equal(getattr(tpa, name).numpy(), np.asarray(getattr(jpa, name)),
                                      err_msg=name)
    assert int(tpa.counts.sum()) > 100 and tpa.sorted_gauss.dtype == torch.int32
    # sentinel pairs past the segments carry rank N
    n_pairs = int(tpa.counts.sum())
    assert bool((tpa.sorted_gauss[n_pairs:] == m.shape[0]).all())


def test_rank_key_overflow_raises_in_both():
    """16,384 Gaussians (15 rank bits) on 4096² in 16-px tiles (65,537 tile
    ids, 17 bits): 32 bits, past the JAX package's int32 key."""
    N, side = 16384, 4096
    m, r, d, mask = (np.zeros((N, 2), np.float32), np.ones(N, np.int32), np.ones(N, np.float32),
                     np.ones(N, bool))
    with pytest.raises(ValueError):
        j_bin_ranks(jnp.asarray(m), jnp.asarray(r), jnp.asarray(d), jnp.asarray(mask), side, side)
    with pytest.raises(ValueError, match="overflow"):
        bin_gaussians_ranks(torch.as_tensor(m), torch.as_tensor(r), torch.as_tensor(d),
                            torch.as_tensor(mask), side, side)
    # 8,191 Gaussians (13 bits) fit
    pa = bin_gaussians_ranks(*(torch.as_tensor(x[:N // 2 - 1]) for x in (m, r, d, mask)), side, side)
    assert int(pa.counts.sum()) == N // 2 - 1


@pytest.fixture(scope="module")
def scene():
    # jitted: eagerly every op of the JAX scene compiles on first use
    p, quats, scales, colors, opac, cam = jax.jit(lambda: j_make_scene(N=70, seed=7))()
    t = float(np.tan(FOV / 2))
    base = dict(width=32, height=32, tan_fovx=t, tan_fovy=t, tile_capacity=256, chunk=32)
    arrays = {k: np.asarray(v) for k, v in dict(p=p, q=quats, s=scales, c=colors, o=opac).items()}
    return arrays, tuple(np.asarray(x) for x in cam), base, cam


def _render(scene, binning, params=None, **over):
    arrays, cam, base, _ = scene
    cfg = RasterizerConfig(**base, backend="pallas_resident", binning=binning, **over)
    bg = np.float32([0.1, 0.1, 0.1])
    if params is None:
        return rasterize(arrays["p"], arrays["o"], cam, cfg, bg, colors=arrays["c"],
                         scales=arrays["s"], quats=arrays["q"], device="cpu")
    return rasterize(params["p"], torch.sigmoid(params["ol"]), cam, cfg, bg,
                     colors=torch.sigmoid(params["c"]), scales=torch.exp(params["ls"]),
                     quats=params["q"], device="cpu")


def test_rank_matches_pairs_forward_and_gradients(scene, monkeypatch):
    calls = []
    real = trast.bin_gaussians_ranks
    monkeypatch.setattr(trast, "bin_gaussians_ranks", lambda *a, **k: calls.append(1) or real(*a, **k))
    out_p, out_r = _render(scene, "pairs"), _render(scene, "rank")
    assert len(calls) == 1
    for name in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(getattr(out_r, name).numpy(), getattr(out_p, name).numpy(),
                                   atol=1e-5, err_msg=name)
    assert float(out_r.alpha.max()) > 0.5

    arrays = scene[0]
    target = torch.full((32, 32, 3), 0.3)
    grads = {}
    for binning in ("pairs", "rank"):
        params = {"p": torch.tensor(arrays["p"]), "q": torch.tensor(arrays["q"]),
                  "ls": torch.log(torch.tensor(arrays["s"])),
                  "c": torch.log(torch.tensor(arrays["c"]) / (1 - torch.tensor(arrays["c"]) + 1e-6)),
                  "ol": torch.full((70,), 0.5)}
        for v in params.values():
            v.requires_grad_(True)
        out = _render(scene, binning, params)
        loss = ((out.rgb - target) ** 2).mean() + 0.1 * out.depth.mean()
        loss.backward()
        grads[binning] = {k: v.grad.numpy() for k, v in params.items()}
    for k, a in grads["pairs"].items():
        b = grads["rank"][k]
        assert np.abs(a).max() > 0 and np.isfinite(b).all(), k
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=1e-4, err_msg=k)


def test_rank_matches_jax_plain_path(scene):
    arrays, _, base, jcam = scene
    out = _render(scene, "rank")
    ref = jax.jit(lambda: j_rasterize(
        jnp.asarray(arrays["p"]), jnp.asarray(arrays["o"]), jcam, JRasterizerConfig(**base, backend="xla"),
        jnp.asarray([0.1, 0.1, 0.1]), colors=jnp.asarray(arrays["c"]), scales=jnp.asarray(arrays["s"]),
        quats=jnp.asarray(arrays["q"])))()
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), atol=3e-3)
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(ref.alpha), atol=3e-3)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth), atol=6e-3)
    assert float(out.alpha.max()) > 0.5


def test_rank_without_bwd_accum_raises(scene):
    with pytest.raises(ValueError, match="bwd_accum"):
        _render(scene, "rank", bwd_accum=False)

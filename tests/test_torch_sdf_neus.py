"""The port's implicit SDF, NeuS renderer and volume grid
(``models/geometry/implicit_sdf.py``, ``models/renderers/neus_volume_renderer.py``,
``models/geometry/volume_grid.py``) against the JAX package's (CPU).

- ``forward_sdf`` / ``forward_field_sdf`` and ``sdf_gradient`` in both
  normal types (``analytic`` and ``finite_difference``) within 1e-5, and
  ``sdf_normal`` within 5e-5 (normalising a central difference divides the
  SDF's float32 rounding by its change over 2·eps; the volume grid's
  normal likewise);
- ``neus_alphas`` within 1e-6;
- ``render_rays_neus`` with the JAX draws (the coarse jitter of the first
  half of the split key, the fine strata of the second), in both normal
  types (the analytic one differentiates ∇sdf a second time): the
  composited outputs (rgb, normal, opacity, depth) and the eikonal term
  within 1e-5 of their max; the per-sample weights, normals and SDF within
  5e-4: the importance samples' positions carry the CDF's float32 rounding
  times the bin width over the CDF step (~1e-5 here; XLA's cumulative sum
  is not torch's); the gradients of a weighted sum of the outputs with
  respect to the hash tables, both MLPs and ``log_s`` within 1e-3 of each
  leaf's max;
- ``export_sdf_grid`` within 1e-5;
- the volume grid's ``forward_field`` and ``export_density_grid`` within
  1e-6, ``forward_normal`` within 1e-5;
- ``registry.find`` builds ``implicit-sdf``, ``neus-volume-renderer`` and
  ``volume-grid`` on the CPU.

Parameters and inputs come from numpy seeds and the JAX inits, carried with
``convert.geometry_params``; each JAX reference runs under one ``jax.jit``
with XLA's cheaper passes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import jit_fast as _jit

from dreammesh4d_tpu.models.geometry import implicit_sdf as jsdf
from dreammesh4d_tpu.models.geometry import volume_grid as jvg
from dreammesh4d_tpu.models.renderers import neus_volume_renderer as jneus
from dreammesh4d_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.geometry import implicit_sdf as psdf
from dreammesh4d_tpu_torch.models.geometry import volume_grid as pvg
from dreammesh4d_tpu_torch.models.renderers import neus_volume_renderer as pneus
from dreammesh4d_tpu_torch.registry import find
from dreammesh4d_tpu_torch.utils.tree import tree_leaves

HG = JHashGridConfig(n_levels=2, log2_hashmap_size=10, base_resolution=4, per_level_scale=3.0)
R = 48  # rays


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    print(f"{what}: {err:.3g} (band {rel:g})")
    assert err <= rel, (what, err)


def _cfg(normal_type):
    return jsdf.ImplicitSDFConfig(radius=1.0, hashgrid=HG, n_neurons=16, n_hidden_layers=1,
                                  normal_type=normal_type)


@pytest.fixture(scope="module")
def scene():
    cfg = _cfg("finite_difference")
    params = _jit(lambda k: jsdf.init_implicit_sdf(cfg, k))(jax.random.PRNGKey(3))
    # larger tables than the init's ±1e-4, so the network's residual matters
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, params)
    params["encoding"]["tables"] = rng.uniform(-0.1, 0.1, params["encoding"]["tables"].shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, params)
    pts = rng.uniform(-0.9, 0.9, (64, 3)).astype(np.float32)
    cam = rng.normal(size=(R, 3)).astype(np.float32)
    rays_o = (2.2 * cam / np.linalg.norm(cam, axis=-1, keepdims=True)).astype(np.float32)
    target = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    rays_d = target - rays_o
    rays_d = (rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)).astype(np.float32)
    return {"params": params, "pts": pts, "rays_o": rays_o, "rays_d": rays_d,
            "bg": np.float32([0.2, 0.4, 0.9]), "w": {k: rng.normal(size=s).astype(np.float32) for k, s in
                                                     (("rgb", (R, 3)), ("normal", (R, 3)), ("opacity", (R, 1)),
                                                      ("depth", (R, 1)))}}


@pytest.mark.parametrize("normal_type", ["finite_difference", "analytic"])
def test_sdf_and_gradient_match_jax(scene, normal_type):
    cfg = _cfg(normal_type)
    p = scene["params"]
    want_sdf, want_feat, want_grad, want_n = _jit(lambda pr, x: (
        *jsdf.forward_field_sdf(pr, cfg, x), jsdf.sdf_gradient(pr, cfg, x), jsdf.sdf_normal(pr, cfg, x)))(
        p, scene["pts"])
    pc = convert.geometry_config(cfg)
    tp = convert.geometry_params(p, "cpu")
    x = torch.as_tensor(scene["pts"])
    sdf, feat = psdf.forward_field_sdf(tp, pc, x)
    _close(sdf, want_sdf, 1e-5, "sdf")
    _close(psdf.forward_sdf(tp, pc, x), want_sdf, 1e-5, "forward_sdf")
    _close(feat, want_feat, 1e-5, "features")
    _close(psdf.sdf_gradient(tp, pc, x), want_grad, 1e-5, "sdf_gradient")
    # the normal of a central difference: the SDF's float32 rounding divided by 2·eps
    _close(psdf.sdf_normal(tp, pc, x), want_n, 5e-5, "sdf_normal")


def test_neus_alphas_match_jax():
    rng = np.random.default_rng(7)
    sdf = rng.normal(scale=0.3, size=(16, 12)).astype(np.float32)
    sdf[0] = np.linspace(0.5, -0.5, 12)
    for inv_s in (3.3, 20.0, 80.0):
        want = jneus.neus_alphas(jnp.asarray(sdf), jnp.asarray(inv_s))
        _close(pneus.neus_alphas(torch.as_tensor(sdf), torch.tensor(inv_s)), want, 1e-6, f"alphas {inv_s}")


def _weighted(out, w, xp):
    return ((out["comp_rgb"] * w["rgb"]).sum() + (out["comp_normal"] * w["normal"]).sum()
            + (out["opacity"] * w["opacity"]).sum() + (out["depth"] * w["depth"]).sum()
            + 3.0 * out["eikonal"])


@pytest.mark.parametrize("normal_type", ["finite_difference", "analytic"])
def test_render_rays_neus_and_gradients_match_jax(scene, normal_type):
    cfg = _cfg(normal_type)
    rcfg = jneus.NeuSRendererConfig(num_samples_coarse=8, num_samples_fine=8, radius=1.0, near=0.05)
    var = {"log_s": np.float32(np.log(1.0 / 0.3) + 0.4)}
    key = jax.random.PRNGKey(11)
    ro, rd, bg, w = scene["rays_o"], scene["rays_d"], scene["bg"], scene["w"]

    def loss(pr, v):
        out = jneus.render_rays_neus(pr, v, cfg, rcfg, ro, rd, bg, key)
        return _weighted(out, w, jnp), out

    (_, want_out), (g_geo, g_var) = _jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        scene["params"], var)
    k1, k2 = jax.random.split(key)
    jitter = np.asarray(jax.random.uniform(k1, (R, rcfg.num_samples_coarse)))
    jitter_fine = np.asarray(jax.random.uniform(k2, (R, rcfg.num_samples_fine)))

    tp = convert.geometry_params(scene["params"], "cpu")
    tv = convert.geometry_params(var, "cpu")
    for leaf in tree_leaves(tp) + tree_leaves(tv):
        leaf.requires_grad_(True)
    out = pneus.render_rays_neus(tp, tv, convert.geometry_config(cfg), convert.geometry_config(rcfg),
                                 torch.as_tensor(ro), torch.as_tensor(rd), torch.as_tensor(bg),
                                 jitter=torch.from_numpy(jitter.copy()),
                                 jitter_fine=torch.from_numpy(jitter_fine.copy()))
    for k in ("comp_rgb", "comp_normal", "opacity", "depth", "eikonal"):
        _close(out[k], want_out[k], 1e-5, k)
    for k in ("weights", "normal", "sdf"):
        _close(out[k], want_out[k], 5e-4, k)
    assert float(out["opacity"].detach().max()) > 0.3  # the rays hit the sphere
    _weighted(out, {k: torch.as_tensor(v) for k, v in w.items()}, torch).backward()
    want_leaves = jax.tree_util.tree_leaves(g_geo) + [g_var["log_s"]]
    got_leaves = tree_leaves(tp) + tree_leaves(tv)
    assert len(want_leaves) == len(got_leaves)
    for i, (got, want) in enumerate(zip(got_leaves, want_leaves)):
        assert np.abs(np.asarray(want)).max() > 0, i
        _close(got.grad, want, 1e-3, f"grad leaf {i}")


def test_export_sdf_grid_matches_jax(scene):
    cfg = _cfg("finite_difference")
    want = jsdf.export_sdf_grid(scene["params"], cfg, 12, chunk=700)
    got = psdf.export_sdf_grid(convert.geometry_params(scene["params"], "cpu"), convert.geometry_config(cfg),
                               12, chunk=700)
    assert got.shape == (12, 12, 12) and got.dtype == np.float32
    _close(got, want, 1e-5, "sdf grid")
    assert got.max() > 0 > got.min()  # inside positive


def test_volume_grid_matches_jax():
    rng = np.random.default_rng(9)
    for cfg in (jvg.VolumeGridConfig(radius=1.5, grid_size=(6, 7, 5)),
                jvg.VolumeGridConfig(grid_size=(5, 5, 5), density_bias=-0.5, density_activation="trunc_exp",
                                     n_feature_dims=2)):
        grid = rng.normal(scale=0.5, size=(1 + cfg.n_feature_dims,) + cfg.grid_size).astype(np.float32)
        pts = rng.uniform(-cfg.radius * 1.1, cfg.radius * 1.1, (40, 3)).astype(np.float32)
        want = _jit(lambda g, x: (*jvg.forward_field({"grid": g}, cfg, x), jvg.forward_normal({"grid": g}, cfg, x),
                                  jvg.export_density_grid({"grid": g}, cfg, 6)))(grid, pts)
        pc = pvg.VolumeGridConfig(**dataclasses.asdict(cfg))
        tg = {"grid": torch.as_tensor(grid)}
        x = torch.as_tensor(pts)
        got = (*pvg.forward_field(tg, pc, x), pvg.forward_normal(tg, pc, x), pvg.export_density_grid(tg, pc, 6))
        for name, g, w, band in zip(("density", "features", "normal", "export"), got, want,
                                    (1e-6, 1e-6, 1e-5, 1e-6)):
            _close(g, w, band, name)
        assert convert.geometry_config(cfg) == pc


def test_registry_builds_sdf_names():
    sdf = find("implicit-sdf")({"radius": 1.0, "hashgrid": {"n_levels": 2, "log2_hashmap_size": 8},
                                "n_neurons": 8}, device="cpu")
    assert sdf.state["encoding"]["tables"].shape == (2, 256, 2) and sdf.cfg.hashgrid.n_levels == 2
    x = torch.zeros((1, 3))
    assert float(sdf.forward_sdf(x)[0, 0]) < 0 and sdf.sdf_normal(x + 0.5).shape == (1, 3)
    neus = find("neus-volume-renderer")({"num_samples_coarse": 4, "num_samples_fine": 4,
                                         "geometry": {"radius": 1.0, "hashgrid": {"n_levels": 2,
                                                                                  "log2_hashmap_size": 8},
                                                      "n_neurons": 8}}, device="cpu")
    assert abs(float(neus.state["log_s"]) - np.log(1 / 0.3)) < 1e-6
    ro = torch.tensor([[0.0, 0.0, 2.5]])
    out = neus.render_rays(sdf.state, ro, -ro / 2.5, torch.ones(3))
    assert out["comp_rgb"].shape == (1, 3) and torch.isfinite(out["comp_rgb"]).all()
    vg = find("volume-grid")({"grid_size": [4, 5, 6], "n_feature_dims": 2}, device="cpu")
    assert vg.state["grid"].shape == (3, 4, 5, 6)
    assert vg.forward_field(torch.zeros((2, 3)))[1].shape == (2, 2)

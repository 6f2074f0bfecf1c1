"""The port's stage-1 (zero123-system) train step against the JAX package's
(CPU).

One jitted JAX step, at a tiny size: 2 hash levels of 2⁸ cell rows, MLPs of
width 8, a 4×4 reference view and one 4×4 random view, the occupancy-grid
estimator with 8 candidates / 4 samples on a 4³ grid.  Weights, rays, the
occupancy state and the reference image come from a seeded numpy RNG and
reach the port through ``convert``.  ``randomized`` is off, so samples sit at
the centres of their strata; the position noise of the 3D normal smoothness
is handed to both sides as the same numpy numbers.  Every loss term is
switched on (depth, relative depth and normal supervision included).

- every ``metrics`` key within 1e-4 relative (1e-6 absolute floor);
- the gradient of every leaf within 1e-3 of that leaf's max |g| (the JAX
  gradients are read through an optax transformation whose state keeps
  them);
- the parameters after Adam's first step against ``optax.adam(0.01, b1=0.9,
  b2=0.99, eps=1e-8)`` on the JAX gradients, where |g| ≥ 5 % of the leaf's
  max (the first step is ±lr wherever |g| ≫ eps, so only entries whose sign
  the gradient band cannot flip are compared);
- optax Adam's moments carried over by ``convert.nerf_train_state`` give the
  same second step.

Port only: the step carves a density that fits a circular silhouette; the
``guidance_fn`` hook is called with ``(guidance_state, generator, rgb
(B,H,W,3), batch)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dreammesh4d_tpu.models.geometry.implicit_volume as jiv
import dreammesh4d_tpu.models.renderers.nerf_volume_renderer as jnr
import dreammesh4d_tpu.systems.zero123_system as jsys
from dreammesh4d_tpu.models.materials import DiffuseWithPointLightMaterial as JMaterial
from dreammesh4d_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.geometry.implicit_volume import (ImplicitVolumeConfig,
                                                                    init_implicit_volume)
from dreammesh4d_tpu_torch.models.materials import DiffuseWithPointLightMaterial
from dreammesh4d_tpu_torch.models.renderers import nerf_volume_renderer as tnr
from dreammesh4d_tpu_torch.ops import cameras as tcam
from dreammesh4d_tpu_torch.ops.hashgrid import HashGridConfig
from dreammesh4d_tpu_torch.systems.zero123_system import (Zero123Losses, init_nerf_state,
                                                          make_zero123_train_step)
from dreammesh4d_tpu_torch.utils.tree import tree_leaves

JHG = JHashGridConfig(n_levels=2, n_features_per_level=2, log2_hashmap_size=8, base_resolution=4,
                      per_level_scale=2.0, layout="cell")
JGEO = jiv.ImplicitVolumeConfig(radius=1.0, hashgrid=JHG, n_neurons=8, n_hidden_layers=2,
                                density_blob_std=0.6)
JRCFG = jnr.NeRFRendererConfig(radius=1.0, randomized=False, estimator="occgrid",
                               grid_resolution=4, occ_candidates=8, occ_samples=4)
LOSSES = dict(lambda_sds=0.0, lambda_rgb=[0, 500.0, 1000.0, 10], lambda_mask=50.0,
              lambda_depth=0.05, lambda_depth_rel=0.05, lambda_normal=0.05,
              lambda_normal_smooth=[0, 7.0, 5.0, 8, 10.0, 12], lambda_3d_normal_smooth=5.0,
              lambda_orient=1.0, lambda_sparsity=0.5, lambda_opaque=0.5)
HW = 4
LR = 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    out = [tree["encoding"]["tables"]]
    for name in ("density_mlp", "feature_mlp"):
        for layer in tree[name]:
            out += [layer["w"], layer["b"]]
    return out


def _view_rays(elevation, azimuth, distance=2.4, fovy_deg=40.0):
    c2w = torch.tensor(tcam.make_c2w_numpy(elevation, azimuth, distance))
    dirs = tcam.get_ray_directions(HW, HW, 0.5 * HW / np.tan(np.radians(fovy_deg) / 2), device="cpu")
    ro, rd = tcam.get_rays(dirs, c2w, keepdim=True)
    return ro.numpy(), rd.numpy()


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    dims = [JHG.out_dim, 8, 8]

    def mlp(dims):
        return [{"w": (rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / (a + b))).astype(np.float32),
                 "b": (0.1 * rng.normal(size=(b,))).astype(np.float32)}
                for a, b in zip(dims[:-1], dims[1:])]

    params = {"encoding": {"tables": rng.uniform(-0.1, 0.1, (2, 256, 16)).astype(np.float32)},
              "density_mlp": mlp(dims + [1]), "feature_mlp": mlp(dims + [3])}
    ref_o, ref_d = _view_rays(5.0, 0.0)
    rand_o, rand_d = _view_rays(30.0, 70.0)
    R = HW * HW
    batch = {
        "ref_rays_o": ref_o.reshape(R, 3), "ref_rays_d": ref_d.reshape(R, 3),
        "ref_rgb": rng.uniform(0, 1, (R, 3)).astype(np.float32),
        "ref_mask": (rng.uniform(size=(R, 1)) > 0.4).astype(np.float32),
        "ref_depth": rng.uniform(1.5, 3.0, (R, 1)).astype(np.float32),
        "ref_normal": rng.uniform(0, 1, (R, 3)).astype(np.float32),
        "ref_light": np.float32([0.0, 0.0, 3.0]),
        "rand_rays_o": rand_o[None], "rand_rays_d": rand_d[None],
        "light_positions": np.float32([[1.0, 2.0, 3.0]]),
    }
    binary = (rng.uniform(size=64) > 0.3).astype(np.float32)
    occ = {"occ": np.zeros(64, np.float32), "binary": binary}
    noise = rng.normal(size=(R, JRCFG.occ_samples, 3)).astype(np.float32)
    return dict(params=params, batch=batch, occ=occ, noise=noise,
                level_mask=np.ones(2, np.float32))


def _grad_keeper():
    """An optax transformation that changes nothing and whose state is the
    gradient the step computed."""
    zeros = lambda tree: jax.tree.map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, state, params=None: (zeros(g), g))


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_one_step_matches_jax(scene, monkeypatch):
    noise = scene["noise"]
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(noise))
    monkeypatch.setattr(tnr, "draw_normal", lambda rng, shape, device: torch.tensor(noise))
    jlosses = jsys.Zero123Losses(**LOSSES)
    keeper = _grad_keeper()
    jstep = jsys.make_zero123_train_step(JGEO, JRCFG, keeper, jlosses, JMaterial())
    jparams = jax.tree.map(jnp.asarray, scene["params"])
    jstate = jsys.init_nerf_state(jparams, keeper)._replace(step=jnp.asarray(5, jnp.int32))
    jocc = jnr.OccGridState(**jax.tree.map(jnp.asarray, scene["occ"]))
    jstate1, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, scene["batch"]),
                              jax.random.PRNGKey(0), jnp.asarray(scene["level_mask"]), 0.7,
                              None, jocc)
    jgrads = jstate1.opt_state
    adam = optax.adam(LR, b1=0.9, b2=0.99, eps=1e-8)
    adam_state = adam.init(jparams)
    updates, adam_state1 = adam.update(jgrads, adam_state, jparams)
    jnew = optax.apply_updates(jparams, updates)

    tstep = make_zero123_train_step(
        convert.implicit_volume_config(JGEO), convert.nerf_renderer_config(JRCFG),
        convert.zero123_losses(jlosses), DiffuseWithPointLightMaterial(), device="cpu")
    state = convert.nerf_train_state({"geo_params": scene["params"], "step": 5}, lr=LR, device="cpu")
    state1, metrics = tstep(state, _torch_batch(scene["batch"]), torch.Generator().manual_seed(0),
                            scene["level_mask"], 0.7, None, convert.occgrid_state(scene["occ"], "cpu"))
    assert state1.step == 6 and int(jstate1.step) == 6

    assert set(metrics) == set(jmetrics)
    assert {"loss_depth", "loss_depth_rel", "loss_normal", "loss_3d_normal_smooth",
            "loss_orient"} <= set(metrics) and "loss_sds" not in metrics
    for k in sorted(metrics):
        ref, got = float(jmetrics[k]), float(metrics[k])
        assert abs(got - ref) <= max(1e-4 * abs(ref), 1e-6), (k, got, ref)
    assert float(metrics["loss_total"]) > 0

    t_leaves = _leaves(state1.geo_params)
    assert len(t_leaves) == 13
    n_checked = 0
    for leaf, jg, jn in zip(t_leaves, _leaves(jgrads), _leaves(jnew)):
        jg, jn = np.asarray(jg), np.asarray(jn)
        g = leaf.grad.numpy()
        assert g.shape == jg.shape and np.isfinite(g).all()
        assert np.abs(jg).max() > 0
        assert np.abs(g - jg).max() <= 1e-3 * np.abs(jg).max()
        sure = np.abs(jg) >= 0.05 * np.abs(jg).max()
        n_checked += int(sure.sum())
        np.testing.assert_allclose(leaf.detach().numpy()[sure], jn[sure], atol=1e-6)
    assert n_checked > 100

    # Adam's moments cross over: the second step from the converted state
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    carried = convert.nerf_train_state(
        {"geo_params": np_tree(jnew), "step": 6, "opt_state": np_tree(adam_state1)}, lr=LR,
        device="cpu")
    moments = [carried.opt_state.state[p] for p in _leaves(carried.geo_params)]
    for st, mu, nu in zip(moments, _leaves(adam_state1[0].mu), _leaves(adam_state1[0].nu)):
        assert float(st["step"]) == 1.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(mu))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(nu))
    for p, jg in zip(_leaves(carried.geo_params), _leaves(jgrads)):
        p.grad = torch.tensor(np.asarray(jg))
    carried.opt_state.step()
    updates2, _ = adam.update(jgrads, adam_state1, jnew)
    for p, jn2 in zip(_leaves(carried.geo_params), _leaves(optax.apply_updates(jnew, updates2))):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jn2), atol=2e-6)


def test_zero123_train_step_fits_silhouette():
    """The step carves density to match a circular mask (corner layout,
    importance estimator, analytic normals through autograd)."""
    hg = HashGridConfig(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
                        base_resolution=4, per_level_scale=2.0)
    geo = ImplicitVolumeConfig(radius=1.0, hashgrid=hg, n_neurons=32, n_hidden_layers=1,
                               density_blob_std=0.7)
    rcfg = tnr.NeRFRendererConfig(num_samples_coarse=16, num_samples_fine=16, radius=1.0)
    H = W = 16
    c2w = tcam.look_at_c2w(torch.tensor([0.0, -2.5, 0.0]))
    dirs = tcam.get_ray_directions(H, W, 0.5 * H / np.tan(0.35), device="cpu")
    ro, rd = tcam.get_rays(dirs, c2w)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    mask = ((xs - W / 2 + 0.5) ** 2 + (ys - H / 2 + 0.5) ** 2) < (0.3 * W) ** 2
    gt_mask = torch.tensor(mask.reshape(-1, 1).astype(np.float32))
    losses = Zero123Losses(lambda_sds=0.0, lambda_rgb=500.0, lambda_mask=50.0,
                           lambda_normal_smooth=0.0, lambda_orient=0.1, lambda_sparsity=0.1,
                           lambda_opaque=0.1)
    train_step = make_zero123_train_step(geo, rcfg, losses, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = init_nerf_state(init_implicit_volume(geo, gen, device="cpu"), lr=5e-3,
                            betas=(0.9, 0.999), device="cpu")
    batch = {
        "ref_rays_o": ro, "ref_rays_d": rd, "ref_rgb": torch.ones((H * W, 3)), "ref_mask": gt_mask,
        "ref_light": torch.tensor([0.0, -3.0, 0.0]),
        "rand_rays_o": ro.reshape(1, H, W, 3), "rand_rays_d": rd.reshape(1, H, W, 3),
        "light_positions": torch.tensor([[0.0, -3.0, 0.0]]),
    }
    lm = np.ones(hg.n_levels, np.float32)
    state, m0 = train_step(state, batch, gen, lm, 1.0)
    first = float(m0["loss_mask"])
    for _ in range(40):
        state, m = train_step(state, batch, gen, lm, 1.0)
    final = float(m["loss_mask"])
    assert np.isfinite(final) and state.step == 41
    assert final < 0.5 * first, (first, final)
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.geo_params))


def test_guidance_hook(scene):
    calls = []

    def guidance_fn(gstate, generator, rgb, batch):
        calls.append((gstate, generator, tuple(rgb.shape), batch["step"], sorted(batch)))
        return gstate["scale"] * rgb.mean()

    losses = Zero123Losses(**{**LOSSES, "lambda_sds": 0.25, "lambda_3d_normal_smooth": 0.0,
                              "lambda_depth": 0.0, "lambda_depth_rel": 0.0, "lambda_normal": 0.0})
    gen = torch.Generator().manual_seed(0)
    totals = {}
    for name, fn in (("with", guidance_fn), ("without", None)):
        tstep = make_zero123_train_step(
            convert.implicit_volume_config(JGEO), convert.nerf_renderer_config(JRCFG), losses,
            DiffuseWithPointLightMaterial(), guidance_fn=fn, device="cpu")
        state = convert.nerf_train_state({"geo_params": scene["params"], "step": 3}, device="cpu")
        _, totals[name] = tstep(state, _torch_batch(scene["batch"]), gen, scene["level_mask"], 1.0,
                                {"scale": 2.0}, convert.occgrid_state(scene["occ"], "cpu"))
    assert len(calls) == 1
    gstate, generator, shape, step, keys = calls[0]
    assert gstate == {"scale": 2.0} and generator is gen and shape == (1, HW, HW, 3) and step == 3
    assert "rand_rays_o" in keys and "step" in keys
    assert "loss_sds" in totals["with"] and "loss_sds" not in totals["without"]
    assert "loss_3d_normal_smooth" not in totals["with"] and "loss_depth" not in totals["with"]
    sds = float(totals["with"]["loss_sds"])
    assert sds > 0
    delta = float(totals["with"]["loss_total"]) - float(totals["without"]["loss_total"])
    assert abs(delta - 0.25 * sds) <= 1e-4 * abs(float(totals["with"]["loss_total"]))


def test_init_nerf_state_defaults():
    geo = convert.implicit_volume_config(JGEO)
    params = init_implicit_volume(geo, torch.Generator().manual_seed(1), device="cpu")
    assert params["encoding"]["tables"].shape == (2, 256, 16)
    assert [tuple(l["w"].shape) for l in params["density_mlp"]] == [(4, 8), (8, 8), (8, 1)]
    assert [tuple(l["w"].shape) for l in params["feature_mlp"]] == [(4, 8), (8, 8), (8, 3)]
    assert float(params["density_mlp"][0]["w"].abs().max()) <= np.sqrt(6.0 / 12) + 1e-6
    state = init_nerf_state(params, device="cpu")
    group = state.opt_state.param_groups[0]
    assert (group["lr"], tuple(group["betas"]), group["eps"]) == (0.01, (0.9, 0.99), 1e-8)
    leaf = state.geo_params["encoding"]["tables"]
    assert leaf.requires_grad and leaf.is_leaf and state.step == 0
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            init_nerf_state(params)

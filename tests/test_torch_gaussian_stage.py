"""The port's Gaussian stage (``system.stage: gaussian``) against the JAX
package's, module by module (CPU).

- ``knn`` / ``dist_knn3_mean`` (chunked brute force, chunk 32) on points
  with exact duplicates (a clone copies its source's centre): indices equal,
  ties in the JAX order (the lower index first), squared distances within
  1e-6; ``exclude_self`` both ways (``tests/test_knn_meshio.py``'s cases).
- ``init_random_sphere`` with the JAX draws fed in: every slot within 1e-6.
- ``densify_and_prune`` with the JAX draws fed in (``noise`` =
  ``jax.random.normal(rng, (K, 3))``), on ``tests/test_gaussian_densify.py``'s
  cases (clone, split, prune, moment surgery) and a mixed one that clones,
  splits and prunes at once, where low slots pruned in the same pass are
  both destinations and the top-K's filler sources: ``alive``, ``info`` and
  every slot exact in which source fills which destination; every float
  field and the zeroed Adam moments within 1e-6.  ``reset_opacity`` /
  ``prune_by_opacity`` and ``update_stats`` exact.
- ``refresh_knn`` equal on the alive slots (the dead ones sit together at
  1e6, where the distance expansion cancels to rounding noise in both
  packages and no alive slot picks them); ``sugar_density_regularization``
  with the JAX sample sources and normals fed in: both terms within 1e-5
  relative, their gradients with respect to centres, scales, rotations and
  opacities within 1e-4 of each leaf's max |g|.
- ``make_gaussian_train_step``: capacity 512 with 128 alive, 1 reference +
  2 random views at 32², the ``xla`` backend on both sides (float32, 16-px
  tiles; the port's exit leaves these images within 5e-7 of the JAX blend),
  every term on (the SuGaR terms at step ≥ ``sugar_reg_start``), a guidance
  stand-in in the SDS slot, one weight and one learning rate scheduled; the
  JAX draws (background inversion, regulariser samples) fed in.  Two steps
  from the same start: the first from the initial state, the second from the
  JAX state after the first carried across by ``convert.gaussian_train_state``
  (moments, count, statistics).  Each: every metric within 1e-4 relative
  (1e-5 absolute floor), every leaf's gradient within 1e-4 of its max |g|,
  the accumulated ``grad_accum`` within 1e-4 of its max, ``denom`` and
  ``max_radii`` exact, and the parameters after Adam (b2 0.999, eps 1e-15)
  within 1e-6 where |g| ≥ 1e-3 of the leaf's max (the static step's bands).
  The density control step of both packages then agrees exactly on
  ``alive`` / ``info`` and within 1e-6 on every field and moment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dreammesh4d_tpu.models.geometry.gaussian as jg
import dreammesh4d_tpu.ops.sugar_reg as jreg
import dreammesh4d_tpu.systems.gaussian_stage as jgs
from dreammesh4d_tpu.data.uncond import RandomCameraConfig, RandomCameraSampler
from dreammesh4d_tpu.ops.gs import RasterizerConfig as JRasterizerConfig
from dreammesh4d_tpu.ops.knn import dist_knn3_mean as j_dist_knn3_mean
from dreammesh4d_tpu.ops.knn import knn as j_knn
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.geometry import gaussian as tg
from dreammesh4d_tpu_torch.ops import sugar_reg as treg
from dreammesh4d_tpu_torch.ops.knn import dist_knn3_mean, knn
from dreammesh4d_tpu_torch.systems import gaussian_stage as tgs

CFG = jg.GaussianConfig(capacity=256, init_num=64, max_new_per_step=32, spatial_extent=1.0,
                        percent_dense=0.1)
SPLIT_CFG = jg.GaussianConfig(capacity=256, init_num=64, max_new_per_step=32, spatial_extent=1.0,
                              percent_dense=0.1, max_world_size_ratio=0.0, max_screen_size=0.0)
FIELDS = jgs.GaussianParams._fields


def _np(tree):
    return jax.tree.map(np.array, tree)


def _sphere(cfg):
    """``init_random_sphere`` at PRNGKey(0), jitted (eager dispatch compiles op by op)."""
    return jax.jit(jg.init_random_sphere, static_argnums=0)(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def sphere():
    return _sphere(CFG)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- knn ---------------------------------------------------------------------


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_matches_jax(exclude_self):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    pts[250:270] = pts[10:30]  # exact duplicates: ties at distance 0 and beyond
    qs = pts if exclude_self else np.concatenate([rng.uniform(-0.5, 0.5, (57, 3)), pts[:20]]).astype(np.float32)
    jd, ji = j_knn(jnp.asarray(qs), jnp.asarray(pts), k=5, chunk=32, exclude_self=exclude_self)
    d, i = knn(torch.as_tensor(qs), torch.as_tensor(pts), k=5, chunk=32, exclude_self=exclude_self)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    if exclude_self:
        assert (i.numpy() != np.arange(300)[:, None]).all()
        np.testing.assert_array_equal(i.numpy()[10:30, 0], np.arange(250, 270))
    else:
        # a query on a duplicated point: the point, then its copy (lower index first)
        np.testing.assert_array_equal(i.numpy()[67:, :2], np.stack([np.arange(10, 20), np.arange(250, 260)], 1))
    seg = np.float32([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]])
    np.testing.assert_allclose(dist_knn3_mean(torch.as_tensor(seg), chunk=4)[0].item(), 14 / 3, rtol=1e-6)
    np.testing.assert_allclose(dist_knn3_mean(torch.as_tensor(pts), chunk=64).numpy(),
                               np.asarray(j_dist_knn3_mean(jnp.asarray(pts), chunk=64)), rtol=0, atol=1e-6)


# --- density control -------------------------------------------------------------


def _case(name, st):
    """(cfg, JAX state, stats) of one densify case from the initial state ``st``."""
    stats = jg.empty_stats(256)
    if name == "clone":
        st = st._replace(log_scales=jnp.full_like(st.log_scales, np.log(0.01)))
        stats = stats._replace(grad_accum=jnp.zeros(256).at[:8].set(1.0), denom=jnp.ones(256))
    elif name == "split":
        st = st._replace(log_scales=jnp.full_like(st.log_scales, np.log(0.5)))
        stats = stats._replace(grad_accum=jnp.zeros(256).at[:4].set(1.0), denom=jnp.ones(256))
        return SPLIT_CFG, st, stats
    elif name == "prune":
        st = st._replace(opacity_logits=st.opacity_logits.at[:10].set(-12.0))
    elif name == "moments":
        st = st._replace(log_scales=jnp.full_like(st.log_scales, np.log(0.01)))
        stats = stats._replace(grad_accum=jnp.zeros(256).at[:2].set(1.0), denom=jnp.ones(256))
    elif name == "mixed":
        rng = np.random.default_rng(3)
        ls = np.log(rng.choice([0.02, 0.3], size=(256, 3))).astype(np.float32)
        logits = np.asarray(st.opacity_logits).copy()
        logits[:6] = -12.0  # pruned low slots: destinations and filler sources at once
        st = st._replace(log_scales=jnp.asarray(ls), opacity_logits=jnp.asarray(logits),
                         quats=jnp.asarray(rng.normal(size=(256, 4)), jnp.float32))
        grads = rng.uniform(0, 1e-3, 256) * (rng.random(256) < 0.3)
        stats = stats._replace(grad_accum=jnp.asarray(grads, jnp.float32),
                               denom=jnp.asarray(rng.integers(0, 3, 256), jnp.float32),
                               max_radii=jnp.asarray(rng.integers(0, 30, 256), jnp.int32))
        return jg.GaussianConfig(**{**CFG.__dict__, "densify_grad_threshold": 1e-4}), st, stats
    return CFG, st, stats


@pytest.mark.parametrize("name", ["clone", "split", "prune", "moments", "mixed"])
def test_densify_and_prune_matches_jax(name, sphere):
    cfg, st, stats = _case(name, sphere)
    rng = np.random.default_rng(7)
    mu = {f: jnp.asarray(rng.normal(size=getattr(st, f).shape), jnp.float32) for f in FIELDS}
    nu = {f: jnp.asarray(rng.uniform(size=getattr(st, f).shape), jnp.float32) for f in FIELDS}
    key = jax.random.PRNGKey(1)
    jst, jstats, jmu, jnu, jinfo = _np(jg.densify_and_prune(st, stats, key, cfg, mu, nu))
    K = min(cfg.max_new_per_step, cfg.capacity)
    tst, tstats, tmu, tnu, info = tg.densify_and_prune(
        convert.gaussian_state_params(_np(st), "cpu"), tg.DensifyStats(*(torch.as_tensor(np.asarray(x))
                                                                        for x in stats)),
        tg.GaussianConfig(**cfg.__dict__), noise=np.asarray(jax.random.normal(key, (K, 3))),
        adam_mu={f: torch.as_tensor(np.asarray(v)) for f, v in mu.items()},
        adam_nu={f: torch.as_tensor(np.asarray(v)) for f, v in nu.items()})
    assert {k: int(v) for k, v in info.items()} == {k: int(v) for k, v in jinfo.items()}
    np.testing.assert_array_equal(tst.alive.numpy(), jst.alive)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tst, f).numpy(), getattr(jst, f), rtol=0, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(tmu[f].numpy(), jmu[f], rtol=0, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(tnu[f].numpy(), jnu[f], rtol=0, atol=1e-6, err_msg=f)
    for a, b in zip(tstats, jstats):
        assert not a.any() and not b.any()
    n_new = int(jinfo["n_cloned"]) + int(jinfo["n_split"])
    want = {"clone": (8, 0), "split": (0, 4), "moments": (2, 0)}.get(name)
    if want is not None:
        assert (int(info["n_cloned"]), int(info["n_split"])) == want
    if name == "split":
        np.testing.assert_allclose(np.exp(tst.log_scales.numpy()[:4]), 0.5 / 1.6, rtol=1e-5)
    if name == "prune":
        assert int(info["n_pruned"]) >= 10 and not bool(tst.alive[0])
    if name == "moments":
        assert float(tmu["xyz"][64].abs().sum()) == 0 and float(tnu["xyz"][65].abs().sum()) == 0
        assert float(tmu["xyz"][10].abs().sum()) > 0
    if name == "mixed":
        assert int(jinfo["n_cloned"]) > 0 and int(jinfo["n_split"]) > 0 and int(jinfo["n_pruned"]) > 6
        touched_kept = [i for i in range(6) if tst.alive[i] and tmu["xyz"][i].abs().sum() > 0]
        assert n_new > 0 and touched_kept, "no destination kept its moments (the filler-source case)"


def test_init_random_sphere_matches_jax(sphere):
    """The JAX draws fed in: every slot within 1e-6, ``alive`` exact, dead
    slots at the JAX fill values."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    N = CFG.init_num
    draws = {"u": np.asarray(jax.random.uniform(k1, (N, 1))), "normal": np.asarray(jax.random.normal(k2, (N, 3))),
             "colors": np.asarray(jax.random.uniform(k3, (N, 3)))}
    st = tg.init_random_sphere(tg.GaussianConfig(**CFG.__dict__), None, draws=draws, device="cpu")
    ref = _np(sphere)
    np.testing.assert_array_equal(st.alive.numpy(), ref.alive)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(ref, f), rtol=0, atol=1e-6, err_msg=f)
    assert float(st.opacity_logits[N:].max()) == -10.0 and float(st.quats[N:, 0].min()) == 1.0


def test_reset_prune_and_stats_match_jax(sphere):
    st0 = sphere
    st = jg.reset_opacity(st0, 0.01)
    st = st._replace(opacity_logits=st.opacity_logits.at[:32].set(5.0))
    tst = tg.reset_opacity(convert.gaussian_state_params(_np(st0), "cpu"), 0.01)
    assert float(torch.sigmoid(tst.opacity_logits[tst.alive]).max()) <= 0.0101
    tst.opacity_logits[:32] = 5.0
    np.testing.assert_array_equal(tst.opacity_logits.numpy(), np.asarray(st.opacity_logits))
    np.testing.assert_array_equal(tg.prune_by_opacity(tst, 0.5).alive.numpy(),
                                  np.asarray(jg.prune_by_opacity(st, 0.5).alive))
    assert int(tg.prune_by_opacity(tst, 0.5).alive.sum()) == 32

    rng = np.random.default_rng(2)
    g = rng.normal(size=(256, 2)).astype(np.float32)
    radii = rng.integers(0, 20, 256).astype(np.int32)
    vis = rng.random(256) < 0.6
    base = jg.empty_stats(256)._replace(grad_accum=jnp.asarray(rng.random(256), jnp.float32),
                                       denom=jnp.ones(256), max_radii=jnp.full((256,), 7, jnp.int32))
    ref = _np(jg.update_stats(base, jnp.asarray(g), jnp.asarray(radii), jnp.asarray(vis)))
    got = tg.update_stats(tg.DensifyStats(*(torch.as_tensor(np.asarray(x)) for x in base)),
                          torch.as_tensor(g), torch.as_tensor(radii), torch.as_tensor(vis))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b)


# --- the SuGaR regulariser ------------------------------------------------------


def _jax_draws(key, alive, n):
    """The sources and normals ``sample_points_in_gaussians`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    probs = alive.astype(jnp.float32)
    src = jax.random.choice(k1, alive.shape[0], (n,), p=probs / probs.sum())
    return np.asarray(src), np.asarray(jax.random.normal(k2, (n, 3)))


def test_sugar_regularization_matches_jax():
    rng = np.random.default_rng(4)
    C = 256
    alive = rng.random(C) < 0.8
    xyz = rng.uniform(-0.5, 0.5, (C, 3)).astype(np.float32)
    xyz[200:210] = xyz[:10]  # clones
    quats = rng.normal(size=(C, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(0.1), (C, 3))).astype(np.float32)
    opac = (rng.uniform(0.05, 0.95, C) * alive).astype(np.float32)

    jstate = jreg.refresh_knn(jnp.asarray(xyz), jnp.asarray(alive))
    tstate = treg.refresh_knn(torch.as_tensor(xyz), torch.as_tensor(alive))
    np.testing.assert_array_equal(tstate.knn_idx.numpy()[alive], np.asarray(jstate.knn_idx)[alive])
    assert tstate.knn_idx.shape == (C, 16)

    key = jax.random.PRNGKey(3)

    def jterms(x, q, s, o):
        out = jreg.sugar_density_regularization(key, jstate, x, q, s, o, jnp.asarray(alive), n_samples=200)
        return out["density_regulation"] + out["normal_regulation"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jterms, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(a) for a in (xyz, quats, scales, opac)))
    src, normal = _jax_draws(key, jnp.asarray(alive), 200)
    leaves = [torch.tensor(a, requires_grad=True) for a in (xyz, quats, scales, opac)]
    out = treg.sugar_density_regularization(tstate, *leaves, torch.as_tensor(alive),
                                            (torch.as_tensor(src), torch.as_tensor(normal)))
    (out["density_regulation"] + out["normal_regulation"]).backward()
    for k in ("density_regulation", "normal_regulation"):
        ref = float(jout[k])
        got = float(out[k].detach())
        assert ref > 0 and abs(got - ref) <= 1e-5 * ref, (k, got, ref)
    for name, leaf, jgrad in zip(("xyz", "quats", "scales", "opacities"), leaves, jgrads):
        jgrad = np.asarray(jgrad)
        assert np.abs(jgrad).max() > 0, name
        assert np.abs(leaf.grad.numpy() - jgrad).max() <= 1e-4 * np.abs(jgrad).max(), name


# --- the train step ---------------------------------------------------------------

STEP = 5
TRAIN_CFG = jg.GaussianConfig(capacity=512, init_num=128, max_new_per_step=64, spatial_extent=1.0,
                              init_radius=0.6, densify_grad_threshold=1e-6, max_world_size_ratio=0.0,
                              max_screen_size=0.0)
OPTIMIZER = dict(position_lr=[0, 2e-3, 1e-3, 100], feature_lr=0.02, opacity_lr=0.05, scaling_lr=0.005,
                 rotation_lr=0.001, spatial_lr_scale=2.0)
LOSSES = dict(lambda_sds=0.5, lambda_rgb=1000.0, lambda_mask=[0, 50.0, 100.0, 10],
              lambda_opacity_binary=1.0, lambda_sugar_density_reg=1.0, lambda_sugar_sdf_normal_reg=1.0,
              lambda_rgb_tv=1.0)
N_SDF = 128


def _guidance(gstate, rng, rgb, batch):
    return ((rgb - 0.5) ** 2).mean()


def _grad_keeper():
    """An optax transformation that passes the gradient on and keeps it as its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    st = _sphere(TRAIN_CFG)
    # every field off its init: anisotropic scales (a smallest axis), turned
    # rotations, SH detail, varied opacities; the dead slots keep theirs
    n = TRAIN_CFG.init_num
    st = st._replace(
        log_scales=st.log_scales.at[:n].add(jnp.asarray(0.3 * rng.normal(size=(n, 3)), jnp.float32)),
        quats=st.quats.at[:n].add(jnp.asarray(0.3 * rng.normal(size=(n, 4)), jnp.float32)),
        opacity_logits=st.opacity_logits.at[:n].add(jnp.asarray(rng.uniform(0, 2.5, n), jnp.float32)),
        sh_rest=st.sh_rest.at[:n].set(jnp.asarray(0.1 * rng.normal(size=(n, 15, 3)), jnp.float32)))
    t = float(np.tan(np.radians(40.0) / 2))
    raster = JRasterizerConfig(32, 32, t, t, tile_capacity=512, backend="xla")
    sampler = RandomCameraSampler(RandomCameraConfig(
        height=32, width=32, batch_size=2, camera_distance_range=(2.0, 2.0), fovy_range=(40.0, 40.0),
        eval_fovy_deg=40.0, eval_camera_distance=2.0), 0)
    ys, xs = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    mask = (((xs - 15.5) ** 2 + (ys - 15.5) ** 2) < 100).astype(np.float32)[None, ..., None]
    color = np.stack([xs / 31.0, ys / 31.0, np.full_like(xs, 0.5, dtype=np.float64)], -1)[None]
    batch = {"ref_cameras": _np(sampler.orbit(n_views=1, height=32, width=32)["rand_cameras"]),
             "ref_rgb": (color * mask).astype(np.float32), "ref_mask": mask,
             "rand_cameras": _np(sampler.sample()["rand_cameras"])}
    return dict(state=st, raster=raster, batch=batch)


def _draws(key, alive):
    """The JAX step's draws: the background uniform and the regulariser's samples."""
    rng_bg, _, rng_reg = jax.random.split(key, 3)
    return float(jax.random.uniform(rng_bg)), _jax_draws(rng_reg, alive, N_SDF)


@pytest.fixture(scope="module")
def jax_steps(scene):
    """Two JAX steps (5 and 6) from the scene's state, then its density
    control; the gradients kept in the optimizer's first state."""
    jopt = optax.chain(_grad_keeper(), jgs.gaussian_optimizer(**OPTIMIZER))
    jstep, jdensity = jgs.make_gaussian_train_step(
        TRAIN_CFG, scene["raster"], jopt, jgs.GaussianStageLosses(**LOSSES), _guidance,
        invert_bg_prob=1.0, sugar_reg_start=STEP, n_sdf_samples=N_SDF)
    state0 = jgs.init_gaussian_train_state(scene["state"], jopt)._replace(step=jnp.asarray(STEP, jnp.int32))
    reg = jgs.make_reg_state(state0)
    batch = jax.tree.map(jnp.asarray, scene["batch"])
    keys = [jax.random.PRNGKey(10), jax.random.PRNGKey(11)]
    state1, m1 = jstep(state0, batch, reg, keys[0])
    state2, m2 = jstep(state1, batch, reg, keys[1])
    # the density control reads GaussianAdamState: give it the Adam half
    state3, info = jdensity(state2._replace(opt_state=state2.opt_state[1]), jax.random.PRNGKey(12))
    return dict(states=[_np(s) for s in (state0, state1, state2, state3)], metrics=[_np(m1), _np(m2)],
                info=_np(info), reg=_np(reg), keys=keys)


def _carry(jstate):
    """A JAX GaussianTrainState (grad keeper chained in front) as the port's."""
    return convert.gaussian_train_state({"gaussians": jstate.gaussians, "opt_state": jstate.opt_state[1],
                                         "stats": jstate.stats, "step": jstate.step}, OPTIMIZER, device="cpu")


def _torch_batch(batch):
    out = {k: torch.tensor(v) for k, v in batch.items() if not k.endswith("cameras")}
    for k in ("ref_cameras", "rand_cameras"):
        out[k] = convert.camera_batch(batch[k], "cpu")
    return out


def _check_step(state, metrics, jprev, jnext, jmetrics):
    assert set(metrics) == set(jmetrics) and "loss_sds" in metrics
    for k in sorted(metrics):
        ref, got = float(jmetrics[k]), float(metrics[k])
        assert abs(got - ref) <= max(1e-4 * abs(ref), 1e-5), (k, got, ref)
    assert float(metrics["loss_opacity_binary"]) > 0 and float(metrics["loss_sugar_density_reg"]) > 0
    jgrads = jnext.opt_state[0]
    n_checked = 0
    for f in FIELDS:
        leaf = getattr(state.gaussians, f)
        jg_, g = getattr(jgrads, f), leaf.grad.numpy()
        assert np.abs(jg_).max() > 0, f
        assert np.abs(g - jg_).max() <= 1e-4 * np.abs(jg_).max(), f
        sure = np.abs(jg_) >= 1e-3 * np.abs(jg_).max()
        n_checked += int(sure.sum())
        np.testing.assert_allclose(leaf.detach().numpy()[sure], getattr(jnext.gaussians, f)[sure],
                                   rtol=0, atol=1e-6, err_msg=f)
    assert n_checked > 2000
    js = jnext.stats
    assert np.abs(state.stats.grad_accum.numpy() - js.grad_accum).max() <= 1e-4 * np.abs(js.grad_accum).max()
    np.testing.assert_array_equal(state.stats.denom.numpy(), js.denom)
    np.testing.assert_array_equal(state.stats.max_radii.numpy(), js.max_radii)
    assert js.denom[jnext.gaussians.alive].min() > 0  # (dead slots project too: opacity 0, radii > 0)


def test_train_steps_match_jax(scene, jax_steps, monkeypatch):
    states, metrics, keys = jax_steps["states"], jax_steps["metrics"], jax_steps["keys"]
    train_step, density_step = tgs.make_gaussian_train_step(
        tg.GaussianConfig(**TRAIN_CFG.__dict__), convert.config(scene["raster"]._replace(tile_px=16)),
        tgs.GaussianStageLosses(**LOSSES), _guidance, invert_bg_prob=1.0, sugar_reg_start=STEP,
        n_sdf_samples=N_SDF, device="cpu")
    reg = treg.SugarRegState(torch.as_tensor(jax_steps["reg"].knn_idx))
    batch = _torch_batch(scene["batch"])
    alive = jnp.asarray(states[0].gaussians.alive)
    state = tgs.init_gaussian_train_state(convert.gaussian_state_params(states[0].gaussians, "cpu"),
                                          OPTIMIZER, step=STEP, device="cpu")
    for i in range(2):
        u, (src, normal) = _draws(keys[i], alive)
        monkeypatch.setattr(tgs, "draw_uniform", lambda generator, device, u=u: torch.tensor(u))
        monkeypatch.setattr(tgs, "draw_samples", lambda generator, alive, n, d=(src, normal): (
            torch.as_tensor(d[0]), torch.as_tensor(d[1])))
        if i == 1:  # the second step from the JAX state carried across
            state = _carry(states[1])
            assert state.step == STEP + 1 and float(state.opt_state.state[state.gaussians.xyz]["step"]) == 1
        state, m = train_step(state, batch, reg, torch.Generator().manual_seed(0))
        assert state.step == STEP + 1 + i
        _check_step(state, m, states[i], states[i + 1], metrics[i])

    # the density control from the carried JAX state after both steps
    K = TRAIN_CFG.max_new_per_step
    state = _carry(states[2])
    state, info = density_step(state, None, noise=np.asarray(jax.random.normal(jax.random.PRNGKey(12), (K, 3))))
    jinfo, j3 = jax_steps["info"], states[3]
    assert {k: int(v) for k, v in info.items()} == {k: int(v) for k, v in jinfo.items()}
    assert int(info["n_cloned"]) + int(info["n_split"]) > 0
    np.testing.assert_array_equal(state.gaussians.alive.numpy(), j3.gaussians.alive)
    opt = state.opt_state
    for f in FIELDS:
        leaf = getattr(state.gaussians, f)
        np.testing.assert_allclose(leaf.detach().numpy(), getattr(j3.gaussians, f), rtol=0, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(opt.state[leaf]["exp_avg"].numpy(), getattr(j3.opt_state.mu, f), rtol=0,
                                   atol=1e-6, err_msg=f)
        np.testing.assert_allclose(opt.state[leaf]["exp_avg_sq"].numpy(), getattr(j3.opt_state.nu, f), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert not state.stats.denom.any()

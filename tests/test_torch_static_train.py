"""The port's static SuGaR refine step (stage 4) against the JAX package's
(CPU).

Scene: icosphere(1) at radius 0.7 with 6 Gaussians per face (480, SH 3),
every field moved off its init (anisotropic in-plane scales, so that the
in-plane rotation has a gradient), one reference view and two random views
at 32², ``backend: pallas`` on both sides — the JAX step with
``interpret=True``, the port with the plain PyTorch versions of B6/B7.  The
reference image is rendered once (XLA backend) from a perturbed copy of the
parameters; every loss weight is on, one weight and one learning rate
scheduled, and a guidance stand-in (mean squared distance of the random
views from mid-grey) takes the SDS slot on both sides.

The JAX kernel forms a group's transmittance and its backward prefix sums
with bf16 matmuls (``pallas_blend._matmul_bf16``), a TPU choice the port
does not carry over.  On this scene of thin, overlapping Gaussians that
rounding alone moves the JAX kernel's own gradients up to 1.7 % of a leaf's
max away from its float32 XLA blend (the in-plane rotation's most), so here
the JAX step runs that one matmul in float32, and the port must then match
the JAX kernel's function to float32 rounding; the bf16 bands (3e-3 / 6e-3
images, 1e-2 gradients) are held against the unmodified kernel in
``test_torch_table_blend.py``.

One step from the same parameters and batch at step 5, ``invert_bg_prob`` 1:
- every ``metrics`` key within 1e-4 relative, with a 1e-5 absolute floor
  for the terms formed by cancellation (1 − cos, 1 − Pearson);
- the gradient of every ``SuGaRParams`` leaf within 1e-4 of that leaf's max
  |g| (measured ≤ 5e-6; the sums run in another order) — the JAX gradients
  are the ones its step computed: an optax transformation in front of
  ``sugar_optimizer`` keeps them in its state;
- the parameters after the update of ``sugar_optimizer`` (Adam, b2 0.999,
  eps 1e-15, scheduled lrs) within 1e-6, where |g| ≥ 1e-3 of the leaf's max
  (the first update is ±lr wherever |g| ≫ eps, so the sign of a vanishing
  gradient decides it).
``convert.static_train_state`` carries the JAX state after that step over —
params, every field's Adam moments and count equal — and a second port step
from it matches the JAX package's second step, which reads those moments and
the lr schedules at count 1, within the same bands.

Port only: ``depth_to_normal`` against JAX's (``torch.gradient``'s edge rule
is ``jnp.gradient``'s); the background inversion is the draw of
``draw_uniform``; 16 steps fit the reference colours back.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax_compile import FAST_COMPILE

import dreammesh4d_tpu.models.geometry.sugar as jsugar
import dreammesh4d_tpu.ops.gs.pallas_blend as jblend
import dreammesh4d_tpu.systems.sugar_static as jsys
from dreammesh4d_tpu.data.uncond import RandomCameraConfig, RandomCameraSampler
from dreammesh4d_tpu.models.renderers.sugar_rasterizer import depth_to_normal as j_depth_to_normal
from dreammesh4d_tpu.models.renderers.sugar_rasterizer import render_batch as j_render_batch
from dreammesh4d_tpu.ops.gs import RasterizerConfig as JRasterizerConfig
from dreammesh4d_tpu.ops.meshops import face_normals
from dreammesh4d_tpu.systems.optim import sugar_optimizer as j_sugar_optimizer
from dreammesh4d_tpu.utils.procedural import make_icosphere
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.renderers.sugar_rasterizer import depth_to_normal
from dreammesh4d_tpu_torch.systems import sugar_static as tsys


W = 32
STEP = 5
OPTIMIZER = dict(position_lr=[0, 2e-3, 1e-3, 100], scaling_lr=0.005, feature_lr=0.01,
                 opacity_lr=0.02, rotation_lr=0.001, spatial_lr_scale=2.0)
LOSSES = dict(lambda_sds=0.5, lambda_rgb=1000.0, lambda_mask=[0, 50.0, 100.0, 10],
              lambda_normal_consistency=10.0, lambda_laplacian_smoothing=1.0,
              lambda_opacity_max=0.5, lambda_rgb_tv=1.0, lambda_normal_tv=1.0,
              lambda_depth_tv=1.0, lambda_depth=1.0, lambda_depth_rel=0.5, lambda_normal=0.5,
              lambda_normal_depth_consistency=0.5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _guidance(gstate, rng, rgb, batch):
    return ((rgb - 0.5) ** 2).mean()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: with several test workers on the cores, torch's intra-op
    pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    # a turned sphere: no mirror plane of the mesh holds the camera axis, so no
    # two overlapping Gaussians tie in depth (ties order by index, and a
    # last-bit difference of the two projections would reorder them)
    mesh = make_icosphere(1, radius=0.7)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    mesh.v_pos = (mesh.v_pos @ rot.T).astype(np.float32)
    jp, js = jsugar.create_sugar(jsugar.SuGaRConfig(n_gaussians_per_surface_triangle=6), mesh)
    # every field away from its init, so that each leaf gets a gradient (the
    # in-plane rotation matters only where the two in-plane scales differ)
    jp = jp._replace(log_scales=jp.log_scales + jnp.asarray(
                         0.4 * rng.normal(size=jp.log_scales.shape), jnp.float32),
                     sh_rest=jnp.asarray(0.1 * rng.normal(size=jp.sh_rest.shape), jnp.float32),
                     complex_rot=jp.complex_rot + jnp.asarray(
                         0.2 * rng.normal(size=jp.complex_rot.shape), jnp.float32),
                     density_logits=jnp.asarray(rng.uniform(-1.0, 2.0, jp.density_logits.shape),
                                                jnp.float32))
    t = float(np.tan(np.radians(40.0) / 2))
    raster = JRasterizerConfig(W, W, t, t, tile_capacity=256, backend="pallas", interpret=True)
    sampler = RandomCameraSampler(RandomCameraConfig(
        height=W, width=W, batch_size=2, camera_distance_range=(2.5, 2.5), fovy_range=(40.0, 40.0),
        eval_fovy_deg=40.0, eval_camera_distance=2.5), seed=0)
    ref_cams = sampler.orbit(n_views=1, height=W, width=W)["rand_cameras"]
    target = jp._replace(
        points=jp.points * 1.05,
        sh_dc=jnp.asarray(0.5 * rng.normal(size=jp.sh_dc.shape), jnp.float32))
    def render_target():  # jitted: eager dispatch compiles each op on first use
        attrs = jsugar.gaussian_attributes(target, js)
        normals = jnp.repeat(face_normals(target.points, js.faces), js.n_per_face, axis=0)
        return j_render_batch(attrs.means3d, attrs.quats, attrs.scales, attrs.opacities, attrs.sh,
                              js.sh_degree, normals, ref_cams, jnp.ones(3), raster._replace(backend="xla"))

    gt = jax.jit(render_target)()
    rand = sampler.sample()
    batch = {
        "ref_cameras": _np(ref_cams),
        "ref_rgb": np.asarray(gt["comp_rgb"]),
        "ref_mask": (np.asarray(gt["comp_mask"]) > 0.5).astype(np.float32),
        "ref_depth": np.asarray(gt["comp_depth"]) * 1.1 + 0.05,
        "ref_normal": np.asarray(1.0 - gt["comp_normal"]),
        "rand_cameras": _np(rand["rand_cameras"]),
        "rand_rays_o": np.asarray(rand["rays_o"]),
        "rand_rays_d": np.asarray(rand["rays_d"]),
    }
    return dict(jp=jp, js=js, raster=raster, batch=batch, sampler=sampler)


def _torch_batch(batch):
    out = {k: torch.tensor(v) for k, v in batch.items() if not k.endswith("cameras")}
    for k in ("ref_cameras", "rand_cameras"):
        out[k] = convert.camera_batch(batch[k], "cpu")
    return out


def _matmul_f32(a, b):
    """``pallas_blend._matmul_bf16`` with float32 inputs."""
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)


def _grad_keeper():
    """An optax transformation that passes the gradient on and keeps it as
    its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


@pytest.fixture(scope="module")
def jax_steps(scene):
    """Two JAX steps (steps 5 and 6) from the scene's parameters, the
    kernel's transmittance matmuls in float32."""
    jopt = optax.chain(_grad_keeper(), j_sugar_optimizer(**OPTIMIZER))
    with pytest.MonkeyPatch.context() as mp:  # the step compiled with XLA's cheaper passes
        mp.setattr(jsys, "tpu_jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
        jstep = jsys.make_train_step(scene["js"], scene["raster"], jopt,
                                     jsys.SugarStaticLosses(**LOSSES), guidance_fn=_guidance,
                                     invert_bg_prob=1.0)
    jbatch = jax.tree.map(jnp.asarray, scene["batch"])
    state0 = jsys.init_state(scene["jp"], jopt)._replace(step=jnp.asarray(STEP, jnp.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jblend, "_matmul_bf16", _matmul_f32)
        state1, m1 = jstep(state0, jbatch, jax.random.PRNGKey(0))
        state2, m2 = jstep(state1, jbatch, jax.random.PRNGKey(1))
    return (_np(state1), _np(m1)), (_np(state2), _np(m2))


def _torch_step(scene, **kw):
    return tsys.make_static_train_step(
        convert.sugar_static(_np(scene["js"]), "cpu"), convert.config(scene["raster"]),
        convert.sugar_static_losses(jsys.SugarStaticLosses(**LOSSES)), guidance_fn=_guidance,
        device="cpu", **kw)


def _check_metrics(metrics, jmetrics):
    assert set(metrics) == set(jmetrics)
    for k in sorted(metrics):
        ref, got = float(jmetrics[k]), float(metrics[k])
        assert abs(got - ref) <= max(1e-4 * abs(ref), 1e-5), (k, got, ref)


def _check_update(state, jgrads, jnew):
    """Gradients within 1e-4 of each leaf's max; the updated parameters
    where the gradient does not vanish."""
    n_checked = 0
    for field, leaf in zip(state.params._fields, state.params):
        jg, jn = np.asarray(getattr(jgrads, field)), np.asarray(getattr(jnew, field))
        g = leaf.grad.numpy()
        assert g.shape == jg.shape and np.isfinite(g).all(), field
        assert np.abs(jg).max() > 0, field
        assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max(), field
        sure = np.abs(jg) >= 1e-3 * np.abs(jg).max()
        n_checked += int(sure.sum())
        np.testing.assert_allclose(leaf.detach().numpy()[sure], jn[sure], atol=1e-6,
                                   err_msg=field)
    assert n_checked > 5000


def test_one_step_matches_jax(scene, jax_steps):
    (jstate1, jmetrics), _ = jax_steps
    state = tsys.init_static_state(convert.sugar_params(_np(scene["jp"]), "cpu"), OPTIMIZER,
                                   step=STEP, device="cpu")
    state1, metrics = _torch_step(scene)(state, _torch_batch(scene["batch"]),
                                         torch.Generator().manual_seed(0))
    assert state1.step == STEP + 1 == int(jstate1.step)
    assert "loss_sds" in metrics and "loss_normal_depth_consistency" in metrics
    _check_metrics(metrics, jmetrics)
    _check_update(state1, jstate1.opt_state[0], jstate1.params)


def test_static_train_state_round_trip(scene, jax_steps):
    (jstate1, _), (jstate2, jmetrics2) = jax_steps
    src = {"params": jstate1.params, "opt_state": jstate1.opt_state[1], "step": jstate1.step}
    state = convert.static_train_state(src, OPTIMIZER, device="cpu")
    assert state.step == STEP + 1
    inner = jstate1.opt_state[1].inner_states
    for field, leaf in zip(state.params._fields, state.params):
        np.testing.assert_array_equal(leaf.detach().numpy(), getattr(jstate1.params, field))
        adam = inner[field].inner_state[0]
        st = state.opt_state.state[leaf]
        assert float(st["step"]) == float(adam.count) == 1.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), getattr(adam.mu, field))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), getattr(adam.nu, field))
    # the second step continues the moments and reads the schedules at count 1
    state2, metrics = _torch_step(scene)(state, _torch_batch(scene["batch"]),
                                         torch.Generator().manual_seed(1))
    assert state2.step == STEP + 2
    _check_metrics(metrics, jmetrics2)
    _check_update(state2, jstate2.opt_state[0], jstate2.params)


def test_depth_to_normal_matches_jax():
    rng = np.random.default_rng(3)
    depth = rng.uniform(1.0, 3.0, (2, 5, 7, 1)).astype(np.float32)
    rays_o = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    rays_d = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    alpha = rng.uniform(0.0, 1.0, (2, 5, 7, 1)).astype(np.float32)
    ref = np.asarray(j_depth_to_normal(*(jnp.asarray(x) for x in (depth, rays_o, rays_d, alpha))))
    got = depth_to_normal(*(torch.as_tensor(x) for x in (depth, rays_o, rays_d, alpha))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # the edge rows and columns are the one-sided differences
    assert np.abs(got[:, [0, -1]] - ref[:, [0, -1]]).max() <= 1e-6
    assert np.abs(got[:, :, [0, -1]] - ref[:, :, [0, -1]]).max() <= 1e-6


def test_background_inversion_is_the_draw(scene, monkeypatch):
    seen = []

    def guidance(gstate, generator, rgb, batch):
        seen.append(float(rgb.detach()[:, 0, 0].mean()))  # a corner pixel: background only
        return rgb.mean()

    batch = _torch_batch(scene["batch"])
    for draw, want in ((0.7, 0.0), (0.3, 1.0)):
        monkeypatch.setattr(tsys, "draw_uniform", lambda generator, device, u=draw: torch.tensor(u))
        step = tsys.make_static_train_step(
            convert.sugar_static(_np(scene["js"]), "cpu"), convert.config(scene["raster"]),
            tsys.SugarStaticLosses(), guidance_fn=guidance, invert_bg_prob=0.5, device="cpu")
        state = tsys.init_static_state(convert.sugar_params(_np(scene["jp"]), "cpu"), device="cpu")
        step(state, batch, torch.Generator().manual_seed(0))
        assert seen[-1] == want, (draw, seen)


def test_static_step_fits_reference_colours(scene):
    """16 steps from grey colours bring loss_rgb below a quarter of its first
    value."""
    params = convert.sugar_params(_np(scene["jp"]), "cpu")
    params = params._replace(sh_dc=torch.zeros_like(params.sh_dc))
    losses = tsys.SugarStaticLosses(lambda_sds=0.0, lambda_rgb_tv=0.0, lambda_normal_tv=0.0,
                                    lambda_depth_tv=0.0)
    step = tsys.make_static_train_step(convert.sugar_static(_np(scene["js"]), "cpu"),
                                       convert.config(scene["raster"]), losses, device="cpu")
    state = tsys.init_static_state(params, dict(feature_lr=0.05, position_lr=0.0001), device="cpu")
    batch = _torch_batch(scene["batch"])
    gen = torch.Generator().manual_seed(0)
    history = []
    for _ in range(16):
        state, m = step(state, batch, gen)
        history.append(float(m["loss_rgb"]))
    assert np.isfinite(history).all() and state.step == 16
    assert history[-1] < 0.25 * history[0], history

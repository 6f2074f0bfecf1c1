"""The port's dynamic-stage train step against the JAX package's (CPU).

Scene of ``tests/test_train_4dgen.py::setup``: icosphere(1), one Gaussian per
face, 16 graph nodes, hybrid skinning, HexPlane [16,16,16,8] × [1,2], 48²,
2 frames per step, 4 inter-frame timestamps.  The zero-init heads and the
time planes are filled from a seeded numpy RNG so every leaf gets a gradient.
The JAX step runs ``backend="pallas_resident", interpret=True``; the port's
the plain PyTorch versions of the kernels.  Cameras come from the JAX sampler
through ``convert.camera_batch``.

One step from the same parameters and batch, ``invert_bg_prob`` 0 and 1
(the JAX step jitted once, at 0.5, with a key per case whose background
draw gives the same inversion; compiled with XLA's cheaper passes):
- every ``metrics`` key within 2e-3 relative, with a 5e-3 absolute floor for
  the image terms (rgb, mask, psnr) — the TPU kernel's bf16 transmittance;
- the gradient of every deformation leaf within 1e-2 of that leaf's max |g|
  (the JAX gradients are those its step computes: an optax transformation
  whose state keeps them);
- the parameters after Adam's first step, against ``optax.adam(lr, b1=0.9,
  b2=0.99)`` on the JAX gradients, where |g| ≥ 5 % of the leaf's max |g|:
  the first step is ±lr wherever |g| ≫ eps, so only entries whose sign the
  gradient band cannot flip are compared.

Port only: 60 steps on a rigidly translating target bring ``loss_rgb +
loss_mask`` below half its first value; a ``guidance_fn`` stand-in is called
with ``(guidance_state, generator, rgb, batch)`` and enters ``loss_total``
with ``lambda_sds_zero123``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax_compile import FAST_COMPILE, _cheap_xla  # noqa: F401

import dreammesh4d_tpu.models.geometry.deformation as jdef
import dreammesh4d_tpu.models.geometry.dynamic_sugar as jdyn
import dreammesh4d_tpu.models.geometry.sugar as jsugar
import dreammesh4d_tpu.systems.sugar_4dgen as jsys
from dreammesh4d_tpu.data.uncond import RandomCameraConfig, RandomCameraSampler
from dreammesh4d_tpu.models.renderers.sugar_rasterizer import render_batch as j_render_batch
from dreammesh4d_tpu.ops.gs import RasterizerConfig as JRasterizerConfig
from dreammesh4d_tpu.ops.meshops import build_one_ring, cotangent_weights, face_normals
from dreammesh4d_tpu.utils.procedural import make_icosphere
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.ops import meshops as tmesh
from dreammesh4d_tpu_torch.systems.sugar_4dgen import (
    Sugar4DGenLosses,
    init_dyn_state,
    make_dynamic_train_step,
)
from dreammesh4d_tpu_torch.utils.tree import tree_leaves

W = 48
T = 2
LR = 2e-3
DEF_CFG = jdef.DeformationConfig(base_resolution=(16, 16, 16, 8), multires=(1, 2))
LOSSES = dict(lambda_rgb=5000.0, lambda_mask=[0, 500.0, 1000.0, 10],
              lambda_normal_consistency=1.0, lambda_laplacian_smoothing=0.5,
              lambda_arap_reg_key_frame=0.1, lambda_arap_reg_inter_frame=0.1,
              lambda_ref_xyz=1.0, lambda_obj_centric=0.5, lambda_rgb_tv=1.0, lambda_depth_tv=0.1,
              lambda_plane_tv=0.0001, lambda_time_smoothness=0.001)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init_deformation():
    """The JAX ``init_deformation`` at PRNGKey(0), jitted (eagerly every op
    compiles on first use)."""
    return jax.jit(lambda k: jdef.init_deformation(DEF_CFG, k))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and when several test workers share the
    cores torch's intra-op pool oversubscribes them: the 61-step loop then
    takes 30x longer than with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    mesh = make_icosphere(1, radius=0.7)
    jp, js = jsugar.create_sugar(jsugar.SuGaRConfig(n_gaussians_per_surface_triangle=1), mesh)
    cfg = jdyn.DynamicSuGaRConfig(n_dg_nodes=16, dg_node_connectivity=4, skinning_method="hybrid",
                                  deformation=DEF_CFG, dist_mode="eucdisc")
    jst = jdyn.build_dynamic_static(cfg, js, np.asarray(jp.points))
    dparams = _np(_init_deformation())
    rng = np.random.default_rng(0)
    for name in ("head_dx", "head_dstrain", "head_drot", "head_dopacity"):
        for layer in ("res", "out"):
            for k in ("w", "b"):
                shape = dparams[name][layer][k].shape
                dparams[name][layer][k] = (0.02 * rng.normal(size=shape)).astype(np.float32)
    for planes in dparams["grids"]:
        for i, (a, b) in enumerate(jdef._COMBS):
            if 3 in (a, b):
                planes[i] = (planes[i] + 0.3 * rng.normal(size=planes[i].shape)).astype(np.float32)
    t = float(np.tan(np.radians(40.0) / 2))
    raster = JRasterizerConfig(W, W, t, t, tile_capacity=512, chunk=32, backend="pallas_resident",
                               interpret=True)
    sampler = RandomCameraSampler(RandomCameraConfig(
        height=W, width=W, batch_size=2, camera_distance_range=(2.5, 2.5), fovy_range=(40.0, 40.0),
        eval_fovy_deg=40.0, eval_camera_distance=2.5), seed=0)
    ring = build_one_ring(np.asarray(js.faces), len(jp.points))
    arap_w = cotangent_weights(np.asarray(jp.points), np.asarray(js.faces), ring)
    np.testing.assert_allclose(
        tmesh.cotangent_weights(np.asarray(jp.points), np.asarray(js.faces),
                                tmesh.build_one_ring(np.asarray(js.faces), len(jp.points))), arap_w)

    # target: the sphere rigidly translated along +z over time
    ts = np.float32([0.2, 0.8])
    ref_cams = sampler.orbit(n_views=T, height=W, width=W)["rand_cameras"]
    def render_target():  # jitted: eager dispatch compiles each op on first use
        attrs = jsugar.gaussian_attributes(jp, js)
        normals = jnp.repeat(face_normals(jp.points, js.faces), js.n_per_face, axis=0)
        offsets = jnp.stack([jnp.asarray([0.0, 0.0, 0.35 * float(x)]) for x in ts])
        bcast = lambda x: jnp.broadcast_to(x, (T,) + x.shape)  # noqa: E731
        return j_render_batch(attrs.means3d, attrs.quats, attrs.scales, attrs.opacities, attrs.sh,
                              js.sh_degree, None, ref_cams, jnp.ones(3), raster._replace(backend="xla"),
                              timed_attrs=(attrs.means3d[None] + offsets[:, None, :], bcast(attrs.quats),
                                           bcast(attrs.scales), bcast(normals)))

    gt = jax.jit(render_target)()
    batch = {
        "timestamps": ts,
        "frame_indices": np.arange(T, dtype=np.int32),
        "ref_cameras": _np(ref_cams),
        "ref_rgb": np.asarray(gt["comp_rgb"]),
        "ref_mask": (np.asarray(gt["comp_mask"]) > 0.5).astype(np.float32),
        "rand_cameras": _np(sampler.sample(batch_size=T)["rand_cameras"]),
        "inter_timestamps": np.linspace(0.2, 0.4, 4).astype(np.float32),
    }
    return dict(jp=jp, jst=jst, cfg=cfg, dparams=dparams, raster=raster, arap_w=arap_w,
                batch=batch, sampler=sampler)


def _torch_batch(batch):
    out = {k: torch.tensor(v) for k, v in batch.items() if not k.endswith("cameras")}
    out["frame_indices"] = out["frame_indices"].long()
    for k in ("ref_cameras", "rand_cameras"):
        out[k] = convert.camera_batch(batch[k], "cpu")
    return out


def _torch_step(scene, losses, **kw):
    return make_dynamic_train_step(
        convert.sugar_params(_np(scene["jp"]), "cpu"), convert.dynamic_static(_np(scene["jst"]), "cpu"),
        convert.config(scene["cfg"].deformation), convert.config(scene["raster"]), losses,
        scene["arap_w"], device="cpu", **kw)


def _grad_keeper():
    """An optax transformation that changes nothing and whose state is the
    gradient the step computed."""
    zeros = lambda tree: jax.tree.map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, state, params=None: (zeros(g), g))


@pytest.fixture(scope="module")
def jax_step(scene):
    """ONE jitted JAX step serves both cases: built with invert_bg_prob 0.5
    (the probability only sets the threshold of the background draw, the
    step's one use of its key without a guidance), and a key per case whose
    draw inverts the background (the port's 1.0) or does not (0.0)."""
    keeper = _grad_keeper()
    real_attrs = jsys.gaussian_attributes
    with pytest.MonkeyPatch.context() as mp:  # its eager setup jitted
        mp.setattr(jsys, "gaussian_attributes",
                   lambda params, static: jax.jit(lambda p: real_attrs(p, static))(params))
        # the step compiled with XLA's cheaper passes (a third of the compile time)
        mp.setattr(jsys, "tpu_jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
        jstep = jsys.make_dynamic_train_step(
            scene["jp"], scene["jst"], scene["cfg"].deformation, scene["raster"], keeper,
            jsys.Sugar4DGenLosses(**LOSSES), jnp.asarray(scene["arap_w"]), guidance_fn=None,
            invert_bg_prob=0.5)
    keys = {}
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        keys.setdefault(float(jax.random.uniform(jax.random.split(key)[0])) > 0.5, key)
    return jstep, keeper, {0.0: keys[False], 1.0: keys[True]}


@pytest.mark.parametrize("invert_bg_prob", [0.0, 1.0])
def test_one_step_matches_jax(scene, jax_step, invert_bg_prob):
    jlosses = jsys.Sugar4DGenLosses(**LOSSES)
    jstep, keeper, keys = jax_step
    jparams = jax.tree.map(jnp.asarray, scene["dparams"])
    jbatch = jax.tree.map(jnp.asarray, scene["batch"])
    jstate = jsys.init_dyn_state(jparams, keeper)
    jstate = jstate._replace(step=jnp.asarray(5, jnp.int32))  # inside lambda_mask's ramp
    jstate1, jmetrics = jstep(jstate, jbatch, keys[invert_bg_prob])
    jgrads = jstate1.opt_state
    adam = optax.adam(LR, b1=0.9, b2=0.99)
    jnew = jax.jit(lambda g, p: optax.apply_updates(p, adam.update(g, adam.init(p), p)[0]))(
        jgrads, jparams)

    tstep = _torch_step(scene, convert.losses(jlosses), invert_bg_prob=invert_bg_prob)
    state = convert.dyn_train_state({"deform_params": scene["dparams"], "step": 5}, lr=LR,
                                    device="cpu")
    state1, metrics = tstep(state, _torch_batch(scene["batch"]), torch.Generator().manual_seed(0))
    assert state1.step == 6 and int(jstate1.step) == 6

    assert set(metrics) == set(jmetrics)
    for k in sorted(metrics):
        ref, got = float(jmetrics[k]), float(metrics[k])
        floor = 5e-3 if k in ("loss_rgb", "loss_mask", "psnr") else 1e-7
        assert abs(got - ref) <= max(2e-3 * abs(ref), floor), (k, got, ref)
    assert float(metrics["loss_total"]) > 0

    t_leaves = tree_leaves(state1.deform_params)
    j_leaves = jax.tree.leaves(jgrads)
    jnew_leaves = jax.tree.leaves(jnew)
    assert len(t_leaves) == len(j_leaves) == 12 + 2 + 4 * 4
    n_checked = 0
    for leaf, jg, jn in zip(t_leaves, j_leaves, jnew_leaves):
        jg, jn = np.asarray(jg), np.asarray(jn)
        g = leaf.grad.numpy()
        assert g.shape == jg.shape and np.isfinite(g).all()
        assert np.abs(jg).max() > 0
        assert np.abs(g - jg).max() <= 1e-2 * np.abs(jg).max()
        sure = np.abs(jg) >= 0.05 * np.abs(jg).max()
        n_checked += int(sure.sum())
        np.testing.assert_allclose(leaf.detach().numpy()[sure], jn[sure], atol=1e-6)
    assert n_checked > 300


def _pair_loss(m):
    return float(m["loss_rgb"] + m["loss_mask"])


def test_dynamic_train_step_learns_motion(scene):
    losses = Sugar4DGenLosses(
        lambda_rgb=5000.0, lambda_mask=1000.0, lambda_normal_consistency=1.0,
        lambda_arap_reg_key_frame=0.1, lambda_arap_reg_inter_frame=0.1,
        lambda_plane_tv=0.0001, lambda_time_smoothness=0.001)
    tstep = _torch_step(scene, losses, invert_bg_prob=0.0)
    fresh = _np(_init_deformation())
    state = init_dyn_state(convert.deformation_params(fresh, "cpu"), lr=LR, betas=(0.9, 0.999),
                           device="cpu")
    batch = _torch_batch(scene["batch"])
    gen = torch.Generator().manual_seed(0)
    state, m0 = tstep(state, batch, gen)
    first = _pair_loss(m0)
    for _ in range(60):
        cams = scene["sampler"].sample(batch_size=T)["rand_cameras"]
        batch["rand_cameras"] = convert.camera_batch(_np(cams), "cpu")
        state, metrics = tstep(state, batch, gen)
    final = _pair_loss(metrics)
    assert np.isfinite(final)
    assert final < 0.5 * first, (first, final)
    assert state.step == 61
    for leaf in tree_leaves(state.deform_params):
        assert torch.isfinite(leaf).all()


def test_guidance_hook(scene):
    calls = []

    def guidance_fn(gstate, generator, rgb, batch):
        calls.append((gstate, generator, tuple(rgb.shape), batch["step"], sorted(batch)))
        return gstate["scale"] * rgb.mean()

    losses = Sugar4DGenLosses(lambda_sds_zero123=0.25)
    batch = _torch_batch(scene["batch"])
    gen = torch.Generator().manual_seed(0)
    totals = {}
    for name, fn in (("with", guidance_fn), ("without", None)):
        tstep = _torch_step(scene, losses, guidance_fn=fn, invert_bg_prob=0.0)
        state = init_dyn_state(convert.deformation_params(scene["dparams"], "cpu"), device="cpu")
        state = state._replace(step=3)
        _, totals[name] = tstep(state, batch, gen, {"scale": 2.0})
    assert len(calls) == 1
    gstate, generator, shape, step, keys = calls[0]
    assert gstate == {"scale": 2.0} and generator is gen and shape == (T, W, W, 3) and step == 3
    assert "rand_cameras" in keys and "step" in keys
    assert "loss_sds_zero123" in totals["with"] and "loss_sds_zero123" not in totals["without"]
    sds = float(totals["with"]["loss_sds_zero123"])
    assert sds > 0
    delta = float(totals["with"]["loss_total"]) - float(totals["without"]["loss_total"])
    assert abs(delta - 0.25 * sds) <= 1e-4 * abs(float(totals["with"]["loss_total"]))

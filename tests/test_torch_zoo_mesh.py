"""The port's DMTet train steps (``systems/threestudio_zoo2.py``:
``make_fantasia3d_train_step`` in its geometry and texture phases and
``make_magic3d_refine_train_step``) and its textmesh step
(``make_textmesh_train_step``, a NeuS render of the implicit SDF) against
the JAX package's (CPU).

One step of each from the same carried parameters (a perturbed sphere on a
12³ tet grid, a view at 24²), with the same deterministic guidance
callable on both sides (a weighted squared distance of the image the step
hands it to a fixed target; no UNet):

- the metrics (``loss_sds``, ``loss_normal_consistency``, ``loss_total``)
  within 1e-4 relative;
- the gradients of every leaf within 1e-3 of its max (the JAX step's Adam
  keeps its gradient in a first state);
- Adam within 1e-6: the port's Adam applied to the JAX gradients against
  the JAX step's parameters;
- no NaN reaches any gradient from the masked zero-area faces, and
  ``_dmtet_normal_consistency`` alone gives them a zero gradient.

The textmesh step starts from carried parameters ``{"geo", "var"}`` (a
2-level hash grid, 16² rays of one view, 8 + 8 samples, the default
finite-difference normals; ``test_torch_sdf_neus.py`` holds the analytic
ones), with the JAX renderer's draws handed to the port's (the coarse
jitter and the fine strata of the render key's halves), and is held to the
same bands.

Each JAX step is compiled with XLA's cheaper passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax_compile import fast_jit, jit_fast

from dreammesh4d_tpu.models.geometry import dmtet as jdm
from dreammesh4d_tpu.models.geometry import implicit_sdf as jsdf
from dreammesh4d_tpu.models.renderers import neus_volume_renderer as jneus
from dreammesh4d_tpu.ops import cameras as jcam
from dreammesh4d_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from dreammesh4d_tpu.systems import threestudio_zoo as jzoo
from dreammesh4d_tpu.systems import threestudio_zoo2 as jz2
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.renderers import neus_volume_renderer as pneus
from dreammesh4d_tpu_torch.ops.cameras import GSCameraInfo
from dreammesh4d_tpu_torch.systems import threestudio_zoo as pzoo
from dreammesh4d_tpu_torch.systems import threestudio_zoo2 as pz2
from dreammesh4d_tpu_torch.utils.tree import tree_leaves

HW = 24
TEXTMESH_HW = 16
LR, BETAS, EPS = 1e-2, (0.9, 0.99), 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rel, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    print(f"{what}: {err:.3g} (band {rel:g})")
    assert err <= rel, (what, err)


def grad_keeper():
    """An optax transformation that passes the gradient on and keeps it as
    its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


def jax_optimizer():
    return optax.chain(grad_keeper(), optax.adam(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS))


def sorted_leaves(tree):
    """The leaves in jax's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [g for k in sorted(tree) for g in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [g for v in tree for g in sorted_leaves(v)]
    return [tree]


def compare_step(jstate, jmetrics, pstate, metrics, params0, names=None):
    """Metrics, gradients (the JAX Adam's first state) and Adam: the port's
    Adam of a fresh state at ``params0`` applied to the JAX gradients, held
    to the JAX step's parameters (the step's own update is not compared: at
    |g| near eps Adam's g / (|g| + eps) magnifies the gradients' rounding)."""
    for k, v in jmetrics.items():
        close(metrics[k], v, 1e-4, k)
    jgrads = jax.tree_util.tree_leaves(jstate.opt_state[0])
    jparams = jax.tree_util.tree_leaves(jstate.geo_params)
    leaves = sorted_leaves(pstate.geo_params)
    assert len(leaves) == len(jgrads) == len(jparams)
    for i, (leaf, g) in enumerate(zip(leaves, jgrads)):
        name = names[i] if names else str(i)
        g = np.asarray(g)
        if leaf.grad is None:
            assert not g.any(), name
            continue
        assert torch.isfinite(leaf.grad).all(), name
        if np.abs(g).max() > 0:
            close(leaf.grad, g, 1e-3, f"d / d {name}")
        else:
            assert not leaf.grad.any(), name
    fresh = pzoo.init_scene_state(convert.geometry_params(params0, "cpu"), lr=LR, betas=BETAS, eps=EPS,
                                  device="cpu")
    for leaf, g in zip(sorted_leaves(fresh.geo_params), jgrads):
        leaf.grad = torch.tensor(np.asarray(g))
    fresh.opt_state.step()
    for i, (leaf, p) in enumerate(zip(sorted_leaves(fresh.geo_params), jparams)):
        close(leaf, p, 1e-6, f"{names[i] if names else i} after Adam")


def guidance_pair(shape, seed):
    rng = np.random.default_rng(seed)
    target = rng.uniform(size=shape).astype(np.float32)
    wts = rng.uniform(0.5, 1.5, size=shape).astype(np.float32)

    def jax_fn(key, img, batch):
        return ((img - target) ** 2 * wts).mean()

    def port_fn(generator, img, batch):
        return ((img - torch.as_tensor(target)) ** 2 * torch.as_tensor(wts)).mean()

    return jax_fn, port_fn


def cameras():
    def view(elev, azim, dist):
        p = jcam.camera_position_from_spherical(jnp.asarray(elev), jnp.asarray(azim), jnp.asarray(dist))
        return jcam.get_cam_info_gaussian(jcam.look_at_c2w(p), 0.8, 0.8, 0.01, 100.0), p

    jcams, pcams, pos = [], [], []
    for elev, azim, dist in [(15.0, 30.0, 2.0)]:
        c, p = jax.jit(view)(elev, azim, dist)
        jcams.append(c)
        pcams.append(GSCameraInfo(*(torch.as_tensor(np.asarray(x)) for x in c)))
        pos.append(np.asarray(p))
    pos = np.stack(pos).astype(np.float32)
    return ({"cameras": jcams, "camera_positions": jnp.asarray(pos)},
            {"cameras": pcams, "camera_positions": torch.as_tensor(pos)})


@pytest.fixture(scope="module")
def tet():
    cfg = jdm.TetSDFGridConfig(isosurface_resolution=12, n_neurons=8,
                               hashgrid=JHashGridConfig(n_levels=2, log2_hashmap_size=8, base_resolution=4))
    p = jax.tree.map(np.asarray, jax.jit(lambda k: jdm.init_tet_sdf_grid(cfg, k))(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    p["sdf"] = (p["sdf"] + rng.normal(scale=0.05, size=p["sdf"].shape)).astype(np.float32)
    p["deform"] = rng.normal(scale=0.5, size=p["deform"].shape).astype(np.float32)
    p["encoding"]["tables"] = rng.uniform(-1, 1, p["encoding"]["tables"].shape).astype(np.float32)
    return cfg, p


@pytest.mark.parametrize("phase", ["fantasia3d-geometry", "fantasia3d-texture", "magic3d-refine"])
def test_dmtet_step_matches_jax(tet, phase):
    cfg, params = tet
    jbatch, pbatch = cameras()
    channels = 4 if phase == "fantasia3d-geometry" else 3
    jg, pg = guidance_pair((1, HW, HW, channels), 3)
    pc = convert.geometry_config(cfg)
    opt = jax_optimizer()
    with fast_jit():
        if phase == "magic3d-refine":
            jstep = jz2.make_magic3d_refine_train_step(cfg, opt, jz2.Magic3DLosses(), jg, H=HW, W=HW)
        else:
            jstep = jz2.make_fantasia3d_train_step(cfg, opt, jz2.Fantasia3DLosses(), jg,
                                                   texture=phase.endswith("texture"), H=HW, W=HW)
    jstate, jmetrics = jstep(jzoo.init_scene_state(jax.tree.map(jnp.asarray, params), opt), jbatch,
                             jax.random.PRNGKey(0))
    if phase == "magic3d-refine":
        step = pz2.make_magic3d_refine_train_step(pc, pz2.Magic3DLosses(), pg, H=HW, W=HW, device="cpu")
    else:
        step = pz2.make_fantasia3d_train_step(pc, pz2.Fantasia3DLosses(), pg, texture=phase.endswith("texture"),
                                              H=HW, W=HW, device="cpu")
    state = pzoo.init_scene_state(convert.geometry_params(params, "cpu"), lr=LR, betas=BETAS, eps=EPS,
                                  device="cpu")
    state, metrics = step(state, pbatch, torch.Generator().manual_seed(0))
    assert state.step == 1 and float(metrics["loss_normal_consistency"]) > 0
    names = [f"{k}{i}" for k in sorted(params) for i in range(len(jax.tree_util.tree_leaves(params[k])))]
    compare_step(jstate, jmetrics, state, metrics, params, names)
    feature_grads = [leaf.grad for leaf in tree_leaves(state.geo_params["feature_mlp"])]
    assert all(g is None for g in feature_grads) == (phase == "fantasia3d-geometry")


def test_normal_consistency_masked_faces_get_zero_gradient(tet):
    cfg, params = tet
    surf, want = jit_fast(lambda p: (lambda s: (s, jz2._dmtet_normal_consistency(s.verts, s.faces, s.face_mask)))(
        jdm.isosurface(p, cfg)))(jax.tree.map(jnp.asarray, params))
    verts = torch.tensor(np.asarray(surf.verts), requires_grad=True)
    fmask = torch.as_tensor(np.asarray(surf.face_mask))
    faces = torch.as_tensor(np.asarray(surf.faces)).long()
    loss = pz2._dmtet_normal_consistency(verts, faces, fmask)
    close(loss, want, 1e-6, "normal consistency")
    loss.backward()
    assert torch.isfinite(verts.grad).all()
    used = torch.zeros(len(verts), dtype=torch.bool)
    used[faces[fmask].reshape(-1)] = True
    assert not verts.grad[~used].any() and verts.grad[used].abs().sum() > 0


def test_textmesh_step_matches_jax(monkeypatch):
    cfg = jsdf.ImplicitSDFConfig(radius=1.0, n_neurons=16, n_hidden_layers=1,
                                 hashgrid=JHashGridConfig(n_levels=2, log2_hashmap_size=9, base_resolution=4,
                                                          per_level_scale=3.0))
    rcfg = jneus.NeuSRendererConfig(num_samples_coarse=8, num_samples_fine=8, radius=1.0)
    geo = jax.tree.map(np.asarray, jax.jit(lambda k: jsdf.init_implicit_sdf(cfg, k))(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(5)
    geo["encoding"]["tables"] = rng.uniform(-0.1, 0.1, geo["encoding"]["tables"].shape).astype(np.float32)
    params = {"geo": geo, "var": {"log_s": np.float32(np.log(1 / 0.3))}}

    def rays():
        pos = jcam.camera_position_from_spherical(jnp.asarray(20.0), jnp.asarray(60.0), jnp.asarray(2.2))
        return jcam.get_rays(jcam.get_ray_directions(TEXTMESH_HW, TEXTMESH_HW, 18.0), jcam.look_at_c2w(pos))

    ro, rd = (np.asarray(x).reshape(1, TEXTMESH_HW, TEXTMESH_HW, 3) for x in jax.jit(rays)())
    jg, pg = guidance_pair((1, TEXTMESH_HW, TEXTMESH_HW, 3), 7)
    losses = jz2.TextMeshLosses(lambda_orient=2.0, lambda_opaque=0.5)
    opt = jax_optimizer()
    with fast_jit():
        jstep = jz2.make_textmesh_train_step(cfg, rcfg, opt, losses, jg)
    key = jax.random.PRNGKey(9)
    jstate, jmetrics = jstep(jzoo.init_scene_state(jax.tree.map(jnp.asarray, params), opt),
                             {"rays_o": jnp.asarray(ro), "rays_d": jnp.asarray(rd)}, key)

    def render_draws(k):  # the step's render key, split as the renderer splits it
        n = TEXTMESH_HW * TEXTMESH_HW
        return [jax.random.uniform(kk, (n, 8)) for kk in jax.random.split(jax.random.split(k)[0])]

    draws = [torch.tensor(np.asarray(d)) for d in jax.jit(render_draws)(key)]
    monkeypatch.setattr(pneus, "draw_uniform", lambda generator, shape, device: draws.pop(0))
    step = pz2.make_textmesh_train_step(convert.geometry_config(cfg), convert.geometry_config(rcfg),
                                        pz2.TextMeshLosses(lambda_orient=2.0, lambda_opaque=0.5), pg, device="cpu")
    state = pzoo.init_scene_state(convert.geometry_params(params, "cpu"), lr=LR, betas=BETAS, eps=EPS,
                                  device="cpu")
    state, metrics = step(state, {"rays_o": torch.as_tensor(ro), "rays_d": torch.as_tensor(rd)},
                          torch.Generator().manual_seed(0))
    assert not draws and float(metrics["loss_eikonal"]) > 0 and float(metrics["loss_sparsity"]) > 0
    assert sorted(metrics) == sorted(jmetrics)
    compare_step(jstate, jmetrics, state, metrics, params)

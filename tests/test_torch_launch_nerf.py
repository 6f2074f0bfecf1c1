"""The port's stage 1 run from its YAML against the JAX package's (CPU).

``configs/stable-zero123.yaml`` with the guidance off, through both
packages' config loaders, at a tiny size: a 48² RGBA reference read at 16²,
2 random views at 8², 2 hash levels of 2⁸ cell rows (base 4, scale 2), the
YAML's MLPs (64 × 2), the occupancy grid at 4³ with 8 candidates and 4
samples a ray, Adam with the YAML's ``optimizer.args`` and ``eps`` set to
1e-6 (stage 1 reads it), ``ambient_only_steps`` 0 (the ambient ratio is
drawn from the global numpy stream, seeded alike on both sides).

- The data module: the reference batch (image and mask bit-equal, rays
  within 1e-6) and the first train batch's random rays (1e-5).
- The initial state: the JAX experiment's ``NeRFTrainState`` through
  ``convert.zero123_checkpoint`` into the port experiment's ``load_state``
  equals it leaf by leaf; Adam with lr 0.01, betas (0.9, 0.99), eps 1e-6,
  zero moments; the geometry and renderer configs equal the JAX ones.
- ``train_step(0)``, which also runs the occupancy update, from the same
  state: the random draws (the grid's jitter, the samples' jitter, the
  perturbed normals' noise) handed to both sides as the same numpy numbers
  (``jax.random.uniform`` / ``normal`` and the port's ``draw_uniform`` /
  ``draw_normal`` monkeypatched, as ``test_torch_nerf_train.py`` does); the
  bands of ``test_torch_nerf_train.py``: every metric within 1e-4 relative
  (1e-6 absolute floor), every leaf's gradient within 1e-3 of its max |g|,
  the parameters after Adam within 1e-6 where |g| ≥ 5 % of the leaf's max;
  the occupancy grids after the update equal.
- ``export()`` from the same parameters: the port's 24³ density grid within
  1e-5 of ``max(1, max |grid|)`` of the JAX one; the JAX extractor on the
  port's grid gives the port's mesh exactly; the vertex colours within 1e-5
  of sigmoid(JAX ``forward_field``); ``model.obj`` byte-equal to the JAX
  ``save_obj`` of the same mesh.
- Port only: ``validate`` writes ``it{step}-nerf.png`` (4 orbit views side
  by side), the checkpoint round trip, and ``--train`` / ``--export
  resume=LAST`` through the port's launcher with the README's stage-2
  dotlist.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dreammesh4d_tpu.models.geometry.implicit_volume as jiv
from dreammesh4d_tpu.config import load_config as j_load_config
from dreammesh4d_tpu.export import isosurface as jiso
from dreammesh4d_tpu.export import mesh_io as jmesh_io
from dreammesh4d_tpu.systems import assembly as jasm
from dreammesh4d_tpu_torch import convert, launch
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.data.png import read_png, write_png
from dreammesh4d_tpu_torch.export.mesh_io import load_obj
from dreammesh4d_tpu_torch.models.renderers import nerf_volume_renderer as tnr
from dreammesh4d_tpu_torch.systems import assembly
from dreammesh4d_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "stable-zero123.yaml")
STAGE2 = ["system.exporter_type=mesh-exporter", "system.exporter.fmt=obj",
          "system.geometry.isosurface_method=mc-cpu", "system.geometry.isosurface_resolution=256"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    out = [tree["encoding"]["tables"]]
    for name in ("density_mlp", "feature_mlp"):
        for layer in tree[name]:
            out += [layer["w"], layer["b"]]
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dotlist(tmp_path_factory):
    d = tmp_path_factory.mktemp("nerf_assets")
    yy, xx = np.mgrid[0:48, 0:48]
    inside = (xx - 23.5) ** 2 + (yy - 23.5) ** 2 < 13.0 ** 2
    rgba = np.stack([xx * 5, yy * 5, (xx + yy) * 2, inside * 255], -1).astype(np.uint8)
    write_png(str(d / "ref_rgba.png"), rgba)
    return [
        "system.guidance.pretrained_model_name_or_path=none",
        f"data.image_path={d}/ref_rgba.png", "data.height=16", "data.width=16",
        "data.random_camera.height=8", "data.random_camera.width=8",
        "data.random_camera.batch_size=2", "data.random_camera.eval_height=16",
        "data.random_camera.eval_width=16",
        "system.geometry.pos_encoding_config.n_levels=2",
        "system.geometry.pos_encoding_config.log2_hashmap_size=8",
        "system.geometry.pos_encoding_config.base_resolution=4",
        "system.geometry.pos_encoding_config.per_level_scale=2.0",
        "system.renderer.grid_resolution=4", "system.renderer.occ_candidates=8",
        "system.renderer.occ_samples=4", "system.exporter.isosurface_resolution=24",
        "system.material.ambient_only_steps=0", "system.optimizer.args.eps=1e-6",
        f"exp_root_dir={d}/out", "use_timestamp=false", "tag=nerf",
    ]


def _grad_keeper():
    """An optax transformation that passes the gradient on and keeps it as
    its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


@pytest.fixture(scope="module")
def experiments(dotlist):
    """Both packages' experiments from the same YAML and dotlist; the JAX
    one's Adam keeps each step's gradients in its first state."""
    real = optax.adam

    def keeping(*a, **kw):
        return optax.chain(_grad_keeper(), real(*a, **kw))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "adam", keeping)
        jexp = jasm.build_experiment(j_load_config(YAML, cli_args=dotlist))
    exp = assembly.build_experiment(load_config(YAML, cli_args=dotlist), device="cpu")
    exp.load_state(convert.zero123_checkpoint(_jax_state(jexp), eps=1e-6))
    return jexp, exp


def _jax_state(jexp):
    """The JAX experiment's state as numpy, its Adam state without the
    gradient keeper in front."""
    s = _np(jexp.state)
    return {"geo_params": s.geo_params, "step": s.step, "opt_state": s.opt_state[1]}


def test_data_module_matches_jax(dotlist):
    cfg, jcfg = load_config(YAML, cli_args=dotlist), j_load_config(YAML, cli_args=dotlist)
    dm = assembly.make_single_image_datamodule(cfg.data, cfg.seed, device="cpu")
    jdm = jasm.make_single_image_datamodule(jcfg.data, jcfg.seed)
    ref, jref = dm.ref_batch(), jdm.ref_batch()
    for k in ("ref_rgb", "ref_mask"):
        np.testing.assert_array_equal(ref[k].numpy(), np.asarray(jref[k]), err_msg=k)
    assert ref["ref_rgb"].shape == (1, 16, 16, 3) and 0.2 < float(ref["ref_mask"].mean()) < 0.8
    for k in ("ref_rays_o", "ref_rays_d"):
        np.testing.assert_allclose(ref[k].numpy(), np.asarray(jref[k]), atol=1e-6, err_msg=k)
    batch, jbatch = dm.train_batch(0), jdm.train_batch(0)
    for k in ("rays_o", "rays_d", "light_positions"):
        assert batch[k].shape == jbatch[k].shape
        np.testing.assert_allclose(batch[k].numpy(), np.asarray(jbatch[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_initial_state_matches_jax(experiments):
    jexp, exp = experiments
    assert exp.state.step == int(jexp.state.step) == 0
    for got, ref in zip(_leaves(exp.state.geo_params), _leaves(_np(jexp.state.geo_params))):
        np.testing.assert_array_equal(got.detach().numpy(), ref)
    assert tuple(exp.state.geo_params["encoding"]["tables"].shape) == (2, 256, 16)
    assert [tuple(l["w"].shape) for l in exp.state.geo_params["density_mlp"]] == [(4, 64), (64, 64),
                                                                                 (64, 1)]
    group = exp.state.opt_state.param_groups[0]
    assert (group["lr"], tuple(group["betas"]), group["eps"]) == (0.01, (0.9, 0.99), 1e-6)
    assert all(not s or float(s["exp_avg"].abs().max()) == 0 for s in exp.state.opt_state.state.values())
    assert exp.geo_cfg == convert.implicit_volume_config(jexp.geo_cfg)
    assert exp.rcfg == convert.nerf_renderer_config(jexp.rcfg)
    assert exp.rcfg.estimator == "occgrid" and exp.ambient_only_steps == 0
    np.testing.assert_array_equal(exp.occ_state.binary.numpy(), np.asarray(jexp.occ_state.binary))


def _same_draws(monkeypatch):
    """``jax.random.uniform`` / ``normal`` and the port's draws return the
    same numbers for the same shape (each call of a shape the same ones)."""
    tables = {}

    def numbers(kind, shape):
        key = (kind, tuple(int(s) for s in shape))
        if key not in tables:
            rng = np.random.default_rng(len(tables) + 11)
            tables[key] = (rng.uniform(size=key[1]) if kind == "u"
                           else rng.normal(size=key[1])).astype(np.float32)
        return tables[key]

    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(numbers("u", shape)))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), *a, **k: jnp.asarray(numbers("n", shape)))
    monkeypatch.setattr(tnr, "draw_uniform", lambda rng, shape, device: torch.tensor(numbers("u", shape)))
    monkeypatch.setattr(tnr, "draw_normal", lambda rng, shape, device: torch.tensor(numbers("n", shape)))
    return tables


def test_one_step_matches_jax(experiments, monkeypatch):
    jexp, exp = experiments
    tables = _same_draws(monkeypatch)
    np.random.seed(7)
    jmetrics = _np(jexp.train_step(0))
    np.random.seed(7)
    metrics = exp.train_step(0)
    # the occupancy jitter (4³, 3), the samples' jitter of both views, the
    # perturbed normals' noise
    assert {k[1] for k in tables} >= {(64, 3), (256, 8), (128, 8), (128, 4, 3)}
    assert exp.state.step == int(jexp.state.step) == 1
    np.testing.assert_array_equal(exp.occ_state.binary.numpy(), np.asarray(jexp.occ_state.binary))
    np.testing.assert_allclose(exp.occ_state.occ.numpy(), np.asarray(jexp.occ_state.occ), rtol=1e-5,
                               atol=1e-7)
    assert 0 < float(exp.occ_state.binary.mean()) < 1
    assert set(metrics) == set(jmetrics) and "loss_sds" not in metrics
    assert "loss_3d_normal_smooth" in metrics
    for k in sorted(metrics):
        ref, got = float(jmetrics[k]), float(metrics[k])
        assert abs(got - ref) <= max(1e-4 * abs(ref), 1e-6), (k, got, ref)
    jgrads, jnew = _np(jexp.state.opt_state[0]), _np(jexp.state.geo_params)
    n_checked = 0
    for leaf, jg, jn in zip(_leaves(exp.state.geo_params), _leaves(jgrads), _leaves(jnew)):
        g = leaf.grad.numpy()
        assert np.abs(jg).max() > 0
        assert np.abs(g - jg).max() <= 1e-3 * np.abs(jg).max()
        sure = np.abs(jg) >= 0.05 * np.abs(jg).max()
        n_checked += int(sure.sum())
        np.testing.assert_allclose(leaf.detach().numpy()[sure], jn[sure], atol=1e-6)
    assert n_checked > 100


def test_export_matches_jax(experiments, monkeypatch, tmp_path):
    jexp, exp = experiments
    rng = np.random.default_rng(3)
    jparams = jax.tree.map(lambda x: x + 0.05 * rng.normal(size=x.shape).astype(np.float32),
                           _np(jexp.state.geo_params))
    exp.load_state(convert.zero123_checkpoint({"geo_params": jparams, "step": 4}))
    seen = {}
    real_grid, real_save = assembly.export_density_grid, assembly.save_obj

    def grid_spy(*a, **kw):
        seen["grid"] = real_grid(*a, **kw)
        return seen["grid"]

    def save_spy(path, mesh, *a, **kw):
        seen["mesh"], seen["path"] = mesh, path
        return real_save(path, mesh, *a, **kw)

    monkeypatch.setattr(assembly, "export_density_grid", grid_spy)
    monkeypatch.setattr(assembly, "save_obj", save_spy)
    exp.export()
    grid, mesh = seen["grid"], seen["mesh"]
    assert seen["path"] == os.path.join(exp.cfg.trial_dir, "save", "model.obj")
    jgeo = jexp.geo_cfg
    jgrid = jiv.export_density_grid(jax.tree.map(jnp.asarray, jparams), jgeo, 24)
    assert grid.shape == jgrid.shape == (24, 24, 24)
    assert np.abs(grid - jgrid).max() <= 1e-5 * max(1.0, float(np.abs(jgrid).max()))
    r = jgeo.radius
    jmesh = jiso.extract_isosurface(grid, None, (-r,) * 3, (r,) * 3)
    assert mesh.n_faces > 100
    np.testing.assert_array_equal(mesh.v_pos, jmesh.v_pos)
    np.testing.assert_array_equal(mesh.t_pos_idx, jmesh.t_pos_idx)
    _, feats = jiv.forward_field(jax.tree.map(jnp.asarray, jparams), jgeo, jnp.asarray(mesh.v_pos))
    jrgb = np.asarray(jax.nn.sigmoid(feats))
    assert mesh.v_rgb.shape == jrgb.shape and np.abs(mesh.v_rgb - jrgb).max() <= 1e-5
    assert mesh.v_rgb.min() >= 0 and mesh.v_rgb.max() <= 1
    jmesh_io.save_obj(str(tmp_path / "jax.obj"), jmesh_io.MeshData(v_pos=mesh.v_pos, t_pos_idx=mesh.t_pos_idx,
                                                                   v_rgb=mesh.v_rgb))
    with open(seen["path"], "rb") as a, open(tmp_path / "jax.obj", "rb") as b:
        assert a.read() == b.read()


def test_validate_writes_the_orbit(experiments):
    """Port only (the JAX validation's jitted renderer alone costs ~10 s
    here): 4 orbit views at min(eval_height, 128)² side by side."""
    jexp, exp = experiments
    exp.load_state(convert.zero123_checkpoint(_jax_state(jexp)))
    exp.validate(3)
    img = read_png(os.path.join(exp.cfg.trial_dir, "save", "it3-nerf.png")).astype(int)
    assert img.shape == (16, 64, 3)
    views = [img[:, 16 * i:16 * (i + 1)] for i in range(4)]
    assert all((v < 250).any() for v in views)  # the blob is in every view
    assert np.abs(views[0] - views[1]).max() > 0


def test_checkpoint_round_trip_and_launcher(dotlist, tmp_path):
    """Port only: ``state_for_checkpoint`` / ``load_state`` keep the
    parameters, Adam's moments and the step, not the occupancy grid (a
    restored experiment starts fully occupied); then ``--train`` for 3 steps
    and ``--export resume=LAST`` with the README's stage-2 dotlist through
    the port's launcher write ``model.obj`` with vertex colours."""
    extras = dotlist + [f"exp_root_dir={tmp_path}", "trainer.max_steps=3", "trainer.val_check_interval=2",
                        "checkpoint.every_n_train_steps=3"]
    cfg = load_config(YAML, cli_args=extras)
    exp = assembly.build_experiment(cfg, device="cpu")
    for step in range(2):
        exp.train_step(step)
    saved = exp.state_for_checkpoint()
    assert saved["step"] == 2 and set(saved) == {"geo_params", "opt_state", "step"}
    other = assembly.build_experiment(cfg, device="cpu")
    other.load_state(saved)
    for a, b in zip(tree_leaves(other.state.geo_params), tree_leaves(exp.state.geo_params)):
        assert torch.equal(a, b) and a.requires_grad and a.is_leaf
    for a, b in zip(tree_leaves(other.state.geo_params), tree_leaves(exp.state.geo_params)):
        sa, sb = other.state.opt_state.state[a], exp.state.opt_state.state[b]
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"]) and float(sa["step"]) == 2.0
    assert other.state.step == 2 and float(other.occ_state.binary.min()) == 1.0
    assert float(exp.occ_state.binary.min()) == 0.0

    launch.main(launch.make_args(YAML, "train", device="cpu"), extras)
    launch.main(launch.make_args(YAML, "export", device="cpu"), extras + STAGE2 + ["resume=LAST"])
    save = os.path.join(cfg.trial_dir, "save")
    assert sorted(os.listdir(save)) == ["it2-nerf.png", "it3-nerf.png", "model.obj"]
    assert sorted(os.listdir(os.path.join(cfg.trial_dir, "ckpts"))) == ["step_00000003"]
    mesh = load_obj(os.path.join(save, "model.obj"))
    assert mesh.n_faces > 100 and mesh.v_rgb is not None and mesh.v_rgb.shape == mesh.v_pos.shape
    assert np.abs(mesh.v_pos).max() <= 2.0

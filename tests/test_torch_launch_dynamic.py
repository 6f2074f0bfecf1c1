"""The port's dynamic stage run from its YAML against the JAX package's, and
the port's launcher end to end (CPU).

``configs/sugar_dynamic_dg.yaml`` with the guidance off at the tiny size of
``tests/test_launch_dynamic.py``: 8 RGBA frames of a moving square at 48²
read at 32², an icosphere(1) bind mesh (1 Gaussian per face), 16 graph nodes
(eucdisc), HexPlane [8,8,8,4] × [1,2], 2 frames and 2 random views per step,
``backend: pallas_resident`` (the JAX kernel in interpret mode), the YAML's
``bf16_matmuls`` off (a TPU choice the port ignores).  ``system.weights`` is
a static checkpoint of the bind mesh's parameters moved off their init, in
each package's own format.

Against the JAX package:
- the data module: ``frames_at`` bit-equal, the first train batch's frame
  indices, timestamps and random cameras, the inter-frame window,
  ``eval_batches`` and ``predict_batch`` (cameras within 1e-5);
- the experiment's initial state: the transferred ``SuGaRParams``, the
  deformation graph built from them (node positions, neighbours, binding
  weights), the deterministic parts of the deformation tree (zero heads and
  biases, unit time planes; the uniform draws within their ranges), Adam
  with lr 0.0016, betas (0.9, 0.99) and eps 1e-8 (the YAML's ``1.e-15`` not
  read), step 0;
- ``train_step(0)`` from the same deformation parameters (heads and time
  planes filled from a seeded RNG, loaded through ``load_state``): the bands
  of ``test_torch_train.py`` — metrics 2e-3 relative (5e-3 absolute for the
  image terms, the TPU kernel's bf16 transmittance), gradients 1e-2 of each
  leaf's max, the updated parameters within 1e-6 where |g| ≥ 5 % of its max.

The port's launcher (``dreammesh4d_tpu_torch.launch.main``, ``--device cpu``):
static ``--train`` for 2 steps gives ``ckpts/step_00000002``; dynamic
``--train`` with ``system.weights`` of it gives ``ckpts/step_00000002``;
``resume=LAST`` with ``max_steps=3`` continues at step 2 from the saved state;
``--validate`` / ``--test`` write their images; ``Viewer4D.from_trial``
renders what the experiment renders of that state; ``--export`` writes one
textured OBJ per frame with its ``timed_all`` vertices; the shipped guidance path (not on disk)
raises ``FileNotFoundError``; ``system.weights`` of another mesh raises
``ValueError``; ``dynamic_mode: discrete`` trains; a JAX trial (orbax
checkpoints) is refused with an error that says so.
"""

import csv
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax_compile import _cheap_xla  # noqa: F401

import dreammesh4d_tpu.models.geometry.deformation as jdef
import dreammesh4d_tpu.systems.sugar_4dgen as jsys
from dreammesh4d_tpu.config import load_config as j_load_config
from dreammesh4d_tpu.export.mesh_io import MeshData, save_ply_mesh
from dreammesh4d_tpu.models.geometry import sugar as jsugar
from dreammesh4d_tpu.systems import assembly as jasm
from dreammesh4d_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from dreammesh4d_tpu.utils.procedural import make_icosphere
from dreammesh4d_tpu_torch import convert, launch
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.data.png import read_png, write_png
from dreammesh4d_tpu_torch.data.temporal_image import frame_timestamps
from dreammesh4d_tpu_torch.export.mesh_io import load_obj
from dreammesh4d_tpu_torch.models.geometry.dynamic_sugar import build_dynamic_static, timed_all
from dreammesh4d_tpu_torch.serving import Viewer4D
from dreammesh4d_tpu_torch.systems import assembly
from dreammesh4d_tpu_torch.utils.checkpoint import load_filtered, restore_checkpoint, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "sugar_dynamic_dg.yaml")
STATIC_YAML = os.path.join(REPO, "configs", "sugar_static_refine.yaml")
LR = 0.0016


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_assets(d, subdivisions=1):
    frames = d / "frames"
    frames.mkdir(exist_ok=True)
    for i in range(8):
        rgba = np.zeros((48, 48, 4), np.uint8)
        cx = 24 + int(6 * np.sin(2 * np.pi * i / 8))
        rgba[16:32, cx - 8:cx + 8] = [200, 80, 60, 255]
        write_png(str(frames / f"{i:03d}_rgba.png"), rgba)
    m = make_icosphere(subdivisions, radius=0.6)
    mesh = d / f"mesh{subdivisions}.ply"
    save_ply_mesh(str(mesh), MeshData(v_pos=m.v_pos, t_pos_idx=m.t_pos_idx, v_rgb=m.v_rgb))
    return str(frames), str(mesh)


def _dotlist(frames, mesh, out, tag):
    return [
        "system.guidance.pretrained_model_name_or_path=none",
        f"data.video_frames_dir={frames}", f"system.geometry.surface_mesh_to_bind_path={mesh}",
        "data.height=32", "data.width=32", "data.num_frames=2", "data.video_length=8",
        "data.random_camera.height=32", "data.random_camera.width=32",
        "data.random_camera.batch_size=2",
        "system.geometry.n_gaussians_per_surface_triangle=1",
        "system.geometry.n_dg_nodes=16", "system.geometry.dist_mode=eucdisc",
        "system.geometry.deformation.base_resolution=[8,8,8,4]",
        "system.geometry.deformation.multires=[1,2]",
        "system.geometry.deformation.net_width=16", "system.geometry.deformation.grid_channels=8",
        "system.renderer.tile_capacity=256", "system.renderer.bf16_matmuls=false",
        f"exp_root_dir={out}", "use_timestamp=false", f"tag={tag}",
    ]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    d = tmp_path_factory.mktemp("dyn_parity")
    frames, mesh = _write_assets(d)
    # the static stage's result: the bind mesh's parameters, moved
    jp, _ = jsugar.create_sugar(jsugar.SuGaRConfig(n_gaussians_per_surface_triangle=1),
                                make_icosphere(1, radius=0.6))
    rng = np.random.default_rng(3)
    refined = {f: np.asarray(v) for f, v in jp._asdict().items()}
    refined["points"] = (refined["points"] * (1 + 0.05 * rng.normal(size=(len(refined["points"]), 1)))
                         ).astype(np.float32)
    refined["sh_dc"] = (refined["sh_dc"] + 0.3 * rng.normal(size=refined["sh_dc"].shape)).astype(np.float32)
    jweights = j_save_checkpoint(str(d / "jax_static" / "ckpts"), 7, {"params": refined})
    tweights = save_checkpoint(str(d / "torch_static" / "ckpts"), 7,
                               {"params": {k: torch.tensor(v) for k, v in refined.items()}})
    base = _dotlist(frames, mesh, d / "out", "dyn") + ["system.renderer.interpret=true"]
    real, made = optax.adam, []

    def keeping(*a, **kw):
        made.append(optax.chain(_grad_keeper(), real(*a, **kw)))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "adam", keeping)
        # the JAX experiment's eager setup jitted: eager dispatch compiles each op
        real_init, real_attrs = jdef.init_deformation, jsys.gaussian_attributes
        mp.setattr(jdef, "init_deformation",
                   lambda cfg, key: jax.jit(lambda k: real_init(cfg, k))(key))
        mp.setattr(jsys, "gaussian_attributes",
                   lambda params, static: jax.jit(lambda p: real_attrs(p, static))(params))
        jexp = jasm.build_experiment(j_load_config(YAML, cli_args=base + [f"system.weights={jweights}"]))
    exp = assembly.build_experiment(load_config(YAML, cli_args=base + [f"system.weights={tweights}"]),
                                    device="cpu")
    return dict(jexp=jexp, exp=exp, jopt=made[0], refined=refined, base=base)


def _grad_keeper():
    """An optax transformation that passes the gradient on and keeps it as
    its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


def _close_cams(cams, jcams, tol=1e-5):
    for a, b in zip(cams, jcams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)


def test_data_module_matches_jax(parity):
    cfg, jcfg = (load_config(YAML, cli_args=parity["base"], makedirs=False),
                 j_load_config(YAML, cli_args=parity["base"], makedirs=False))
    dm = assembly.make_temporal_datamodule(cfg.data, cfg.seed, device="cpu")
    jdm = jasm.make_temporal_datamodule(jcfg.data, jcfg.seed)
    for a, b in zip(dm.frames_at(32, 32), jdm.frames_at(32, 32)):
        np.testing.assert_array_equal(a, b)
    assert dm.video_length == jdm.video_length == 8
    batch, jbatch = dm.train_batch(0), jdm.train_batch(0)
    np.testing.assert_array_equal(batch["frame_indices"].numpy(), np.asarray(jbatch["frame_indices"]))
    np.testing.assert_array_equal(batch["timestamps"].numpy(), np.asarray(jbatch["timestamps"]))
    np.testing.assert_array_equal(batch["ref_rgb"], jbatch["ref_rgb"])
    _close_cams(batch["ref_cameras"], jbatch["ref_cameras"])
    _close_cams(batch["rand_cameras"], jbatch["rand_cameras"])
    np.testing.assert_allclose(dm.inter_frame_timestamps(10, 0.2).numpy(),
                               np.asarray(jdm.inter_frame_timestamps(10, 0.2)), atol=1e-7)
    evals, jevals = list(dm.eval_batches()), list(jdm.eval_batches())
    assert [e["azimuth"] for e in evals] == [e["azimuth"] for e in jevals] == [0, -75, 15, 105, 195]
    for e, je in zip(evals, jevals):
        np.testing.assert_array_equal(e["timestamps"].numpy(), np.asarray(je["timestamps"]))
        np.testing.assert_array_equal(e["frame_indices"].numpy(), np.asarray(je["frame_indices"]))
        _close_cams(e["cameras"], je["cameras"])
    pred, jpred = dm.predict_batch(), jdm.predict_batch()
    assert (pred["height"], pred["width"]) == (jpred["height"], jpred["width"]) == (1024, 1024)
    _close_cams(pred["cameras"], jpred["cameras"])
    np.testing.assert_allclose(pred["azimuth"].numpy(), np.asarray(jpred["azimuth"]))


def test_initial_state_matches_jax(parity):
    jexp, exp = parity["jexp"], parity["exp"]
    for f, v in parity["refined"].items():
        np.testing.assert_array_equal(getattr(exp.sugar_params, f).numpy(), v, err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(jexp.sugar_params, f)), v, err_msg=f)
    jst = convert.dynamic_static(_np(jexp.static), "cpu")
    np.testing.assert_allclose(exp.static.node_xyz.numpy(), jst.node_xyz.numpy(), atol=1e-6)
    for f in ("nbr_idx", "gs_vert_idx"):
        np.testing.assert_array_equal(getattr(exp.static, f).numpy(), getattr(jst, f).numpy())
    for f in ("nbr_w", "gs_bary_w"):
        np.testing.assert_allclose(getattr(exp.static, f).numpy(), getattr(jst, f).numpy(), atol=1e-6)
    assert (exp.static.skinning_method, exp.static.num_frames) == ("hybrid", 8)
    # the graph was built from the transferred points, not the mesh's own
    raw = build_dynamic_static(exp.dyn_cfg, exp.static.sugar,
                               make_icosphere(1, radius=0.6).v_pos, device="cpu")
    assert np.abs(raw.node_xyz.numpy() - exp.static.node_xyz.numpy()).max() > 1e-3
    tree, jtree = _flat(exp.state.deform_params), _flat(_np(jexp.state.deform_params))
    assert set(tree) == set(jtree)
    for k, v in tree.items():
        v, jv = v.detach().numpy(), jtree[k]
        assert v.shape == jv.shape, k
        if np.all(jv == jv.flat[0]):  # zero heads and biases, unit time planes
            np.testing.assert_array_equal(v, jv, err_msg=k)
        else:  # the uniform draws: plane values in [0.1, 0.5], xavier weights
            assert v.min() >= jv.min() - 0.05 and v.max() <= jv.max() + 0.05, k
    assert exp.state.step == int(jexp.state.step) == 0
    (group,) = exp.state.opt_state.param_groups
    assert (group["lr"], group["betas"], group["eps"]) == (LR, (0.9, 0.99), 1e-8)


def test_one_step_matches_jax(parity):
    jexp, exp = parity["jexp"], parity["exp"]
    filled = _np(jexp.state.deform_params)
    rng = np.random.default_rng(0)
    for name in ("head_dx", "head_dstrain", "head_drot", "head_dopacity"):
        for layer in ("res", "out"):
            for k in ("w", "b"):
                shape = filled[name][layer][k].shape
                filled[name][layer][k] = (0.02 * rng.normal(size=shape)).astype(np.float32)
    for planes in filled["grids"]:
        for i, (a, b) in enumerate(jdef._COMBS):
            if 3 in (a, b):
                planes[i] = (planes[i] + 0.3 * rng.normal(size=planes[i].shape)).astype(np.float32)
    jexp.load_state(jsys.init_dyn_state(jax.tree.map(jnp.asarray, filled), parity["jopt"]))
    exp.load_state({"deform_params": convert.deformation_params(filled, "cpu"),
                    "opt_state": {"state": {}}, "step": 0})
    jmetrics = _np(jexp.train_step(0))
    metrics = exp.train_step(0)
    assert exp.state.step == int(jexp.state.step) == 1
    assert set(metrics) == set(jmetrics) and "loss_sds_zero123" not in metrics
    for k in sorted(metrics):
        ref, got = float(jmetrics[k]), float(metrics[k])
        floor = 5e-3 if k in ("loss_rgb", "loss_mask", "psnr") else 1e-7
        assert abs(got - ref) <= max(2e-3 * abs(ref), floor), (k, got, ref)
    grads = _flat(_np(jexp.state.opt_state[0]))
    new = _flat(_np(jexp.state.deform_params))
    leaves = _flat(exp.state.deform_params)
    assert set(leaves) == set(grads)
    n_checked = 0
    for k, leaf in leaves.items():
        jg, g = grads[k], leaf.grad.numpy()
        assert np.abs(jg).max() > 0, k
        assert np.abs(g - jg).max() <= 1e-2 * np.abs(jg).max(), k
        sure = np.abs(jg) >= 0.05 * np.abs(jg).max()
        n_checked += int(sure.sum())
        np.testing.assert_allclose(leaf.detach().numpy()[sure], new[k][sure], atol=1e-6, err_msg=k)
    assert n_checked > 300


# ---------------------------------------------------------------------------
# the port's launcher, end to end
# ---------------------------------------------------------------------------


def _launch(config, verb, extras):
    launch.main(launch.make_args(config, verb, device="cpu"), extras)


@pytest.fixture(scope="module")
def trials(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    frames, mesh = _write_assets(d)
    out = d / "out"
    _launch(STATIC_YAML, "train", [
        "system.guidance.pretrained_model_name_or_path=none",
        f"data.image_path={frames}/000_rgba.png", f"system.geometry.surface_mesh_to_bind_path={mesh}",
        "system.geometry.n_gaussians_per_surface_triangle=1",
        "data.height=32", "data.width=32", "data.random_camera.height=32",
        "data.random_camera.width=32", "data.random_camera.batch_size=2",
        "data.random_camera.n_test_views=3", "system.renderer.tile_capacity=256",
        "trainer.max_steps=2", f"exp_root_dir={out}", "use_timestamp=false", "tag=st"])
    static_ckpt = out / "sugar-refine" / "st" / "ckpts" / "step_00000002"
    dyn = _dotlist(frames, mesh, out, "dyn") + [f"system.weights={static_ckpt}"]
    _launch(YAML, "train", dyn + ["trainer.max_steps=2"])
    trial = out / "sugar-dynamic" / "dyn"
    saved = restore_checkpoint(str(trial / "ckpts" / "step_00000002"))
    _launch(YAML, "train", dyn + ["trainer.max_steps=3", "resume=LAST"])
    return dict(d=d, frames=frames, mesh=mesh, out=out, static=out / "sugar-refine" / "st",
                static_ckpt=static_ckpt, trial=trial, dyn=dyn, saved=saved)


def test_launch_train_writes_the_trial_layout(trials):
    st, trial = trials["static"], trials["trial"]
    assert sorted(os.listdir(st / "ckpts")) == ["step_00000002"]
    assert os.listdir(trials["static_ckpt"]) == ["state.pt"]
    for t in (st, trial):
        for name in ("configs/parsed.yaml", "cmd.txt", "metrics.csv", "progress",
                     "train_summary.json"):
            assert os.path.exists(t / name), (t, name)
    assert sorted(os.listdir(st / "save" / "it2-test")) == ["0000.png", "0001.png", "0002.png"]
    saved = restore_checkpoint(str(trials["static_ckpt"]))
    assert saved["step"] == 2 and set(saved) == {"params", "opt_state", "step"}
    # Adam's moments are part of the state: one entry per SuGaRParams field
    assert len(saved["opt_state"]["state"]) == 6
    assert all(float(s["step"]) == 2 for s in saved["opt_state"]["state"].values())
    # --train ends in the test pass: 5 azimuths x 8 frames
    for az in (0, -75, 15, 105, 195):
        assert len(os.listdir(trial / "save" / f"it2-az{az}")) == 8


def test_resume_continues_from_the_saved_state(trials):
    trial = trials["trial"]
    assert sorted(os.listdir(trial / "ckpts")) == ["step_00000002", "step_00000003"]
    with open(trial / "metrics.csv") as f:
        steps = [int(r["step"]) for r in csv.DictReader(f)]
    assert steps == [0, 1, 2]  # the resumed run took one step, step 2
    assert restore_checkpoint(str(trial / "ckpts" / "LAST"))["step"] == 3
    # the restored state is the saved one
    saved = trials["saved"]
    exp = assembly.build_experiment(load_config(YAML, cli_args=trials["dyn"]), device="cpu")
    exp.load_state(saved)
    again = exp.state_for_checkpoint()
    assert again["step"] == saved["step"] == 2
    for k, v in _flat(saved["deform_params"]).items():
        torch.testing.assert_close(_flat(again["deform_params"])[k], v, rtol=0, atol=0)
    assert len(again["opt_state"]["state"]) == len(saved["opt_state"]["state"]) > 0
    for i, s in saved["opt_state"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(again["opt_state"]["state"][i][key], s[key], rtol=0, atol=0)


def test_validate_and_test_write_their_files(trials):
    save = trials["trial"] / "save"
    shutil.rmtree(save)
    _launch(YAML, "validate", trials["dyn"] + ["trainer.max_steps=3", "resume=LAST"])
    assert len(os.listdir(save / "it3-az0")) == 8 and not os.path.exists(save / "it3-az15")
    _launch(YAML, "test", trials["dyn"] + ["trainer.max_steps=5", "resume=LAST"])
    for az in (0, -75, 15, 105, 195):
        assert len(os.listdir(save / f"it5-az{az}")) == 8


def test_from_trial_renders_the_experiments_state(trials):
    viewer = Viewer4D.from_trial(str(trials["trial"]), height=32, width=32, device="cpu")
    frame = viewer.render(elevation_deg=10.0, azimuth_deg=30.0, distance=3.8, t=0.4)
    exp = assembly.build_experiment(load_config(YAML, cli_args=trials["dyn"]), device="cpu")
    exp.load_state(restore_checkpoint(str(trials["trial"] / "ckpts" / "LAST")))
    ts = torch.tensor([0.4])
    ref = exp.render(viewer._cameras(10.0, 30.0, 3.8), ts, viewer._frame_indices(ts))["comp_rgb"][0]
    assert frame.shape == (32, 32, 3) and float(np.abs(frame - 1.0).max()) > 0.05
    np.testing.assert_array_equal(frame, ref)


def test_export_is_not_ported(trials):
    """``--export resume=LAST``: one textured OBJ per timestamp sharing one
    material, each frame's vertices those of ``timed_all`` at its timestamp
    (small predict orbit and texture: 4 views at 32², 32² texels).  The name
    is the one the test had while ``--export`` still raised."""
    _launch(YAML, "export", trials["dyn"] + ["resume=LAST", "data.n_predict_views=4",
                                             "data.predict_height=32", "data.predict_width=32",
                                             "system.exporter.texture_size=32"])
    out = trials["trial"] / "save" / "4d_export"
    names = [f"frame_{i:03d}.obj" for i in range(8)]
    assert sorted(os.listdir(out)) == names + ["material0.mtl", "material0.png"]
    assert read_png(str(out / "material0.png")).shape == (32, 32, 3)
    exp = assembly.build_experiment(load_config(YAML, cli_args=trials["dyn"]), device="cpu")
    exp.load_state(restore_checkpoint(str(trials["trial"] / "ckpts" / "LAST")))
    L = exp.data.video_length
    with torch.no_grad():
        _, vert = timed_all(exp.sugar_params, exp.state.deform_params, exp.dyn_cfg.deformation,
                            exp.static, torch.as_tensor(frame_timestamps(L)),
                            frame_indices=torch.arange(L))
    for i, name in enumerate(names):
        mesh = load_obj(str(out / name))
        np.testing.assert_array_equal(mesh.t_pos_idx, exp.static.sugar.faces.numpy())
        np.testing.assert_allclose(mesh.v_pos, vert.xyz[i].numpy(), rtol=0, atol=1e-6)
        assert mesh.v_tex.shape == (3 * len(mesh.t_pos_idx), 2)


def test_missing_guidance_checkpoint_raises(trials):
    dyn = [x for x in trials["dyn"] if "pretrained_model_name_or_path" not in x]
    with pytest.raises(FileNotFoundError, match="stable_zero123.ckpt"):
        _launch(YAML, "train", dyn + ["tag=noguide"])


def test_weights_of_another_mesh_raise(trials):
    _, other_mesh = _write_assets(trials["d"], subdivisions=2)
    dyn = [x for x in trials["dyn"] if "surface_mesh_to_bind_path" not in x]
    with pytest.raises(ValueError, match="shape mismatch"):
        _launch(YAML, "train", dyn + [f"system.geometry.surface_mesh_to_bind_path={other_mesh}",
                                      "tag=other"])
    bad = save_checkpoint(str(trials["d"] / "bad" / "ckpts"), 1, {"step": 1})
    with pytest.raises(ValueError, match="not a static SuGaR checkpoint"):
        _launch(YAML, "train", trials["dyn"] + [f"system.weights={bad}", "tag=bad"])


def test_discrete_mode_trains(trials):
    """``dynamic_mode: discrete``: per-frame node tables instead of the
    HexPlane, and no plane regularizers."""
    cfg = load_config(YAML, cli_args=trials["dyn"] + ["system.geometry.dynamic_mode=discrete",
                                                      "tag=discrete"])
    exp = assembly.build_experiment(cfg, device="cpu")
    assert set(exp.state.deform_params) == {"trans", "rots", "strain", "blendw"}
    assert exp.state.deform_params["trans"].shape == (8, 16, 3)
    metrics = exp.train_step(0)
    assert "loss_plane_tv" not in metrics and np.isfinite(float(metrics["loss_total"]))
    assert float(exp.state.deform_params["trans"].detach().abs().max()) > 0


def test_jax_trials_are_refused(trials):
    """A trial of the JAX package holds orbax checkpoints: the port says so."""
    fake = trials["d"] / "jax_trial"
    shutil.copytree(trials["trial"] / "configs", fake / "configs")
    j_save_checkpoint(str(fake / "ckpts"), 1, {"deform_params": {"x": np.zeros(3, np.float32)}})
    with pytest.raises(ValueError, match="orbax"):
        Viewer4D.from_trial(str(fake), device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        restore_checkpoint(str(fake / "ckpts" / "LAST"))
    params = load_filtered(str(trials["static_ckpt"]), "params")
    assert set(params) == {"points", "log_scales", "complex_rot", "sh_dc", "sh_rest", "density_logits"}


class _Counting:
    """The smallest experiment the trainer drives: it records the steps it is
    asked for and the state it is given."""

    device = torch.device("cpu")

    def __init__(self):
        self.steps, self.loaded, self.state = [], None, None

    def train_step(self, step):
        self.steps.append(step)
        return {"loss_total": torch.tensor(1.0)}

    def validate(self, step, test=False):
        pass

    def state_for_checkpoint(self):
        return {"step": torch.tensor(len(self.steps))}

    def load_state(self, state):
        self.loaded = state


@pytest.mark.parametrize("resume", ["LAST", "dir/LAST", "dir/step_00000002"])
def test_fit_resumes_at_the_resolved_step(tmp_path, resume):
    """``resume`` as ``LAST``, ``<ckpts>/LAST`` or a step directory: the loop
    continues from the step of the checkpoint it restored."""
    from dreammesh4d_tpu_torch.trainer import Trainer, TrainerConfig

    ckpts = tmp_path / "ckpts"
    for step in (1, 2):
        save_checkpoint(str(ckpts), step, {"step": torch.tensor(step)})
    exp = _Counting()
    trainer = Trainer(TrainerConfig(max_steps=4, checkpoint_every=100), str(tmp_path))
    trainer.fit(exp, resume=resume.replace("dir", str(ckpts)))
    assert int(exp.loaded["step"]) == 2 and exp.steps == [2, 3]
    assert sorted(os.listdir(ckpts)) == ["step_00000001", "step_00000002", "step_00000004"]

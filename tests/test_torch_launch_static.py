"""The port's static refine stage run from its YAML against the JAX package's
(CPU).

``configs/sugar_static_refine.yaml`` with the guidance off, through both
packages' config loaders, at a tiny size: a 48² RGBA reference read at 32²
(a non-integer ``INTER_AREA`` factor), an icosphere(1) bind mesh turned by a
seeded rotation (6 Gaussians per face: 480), 2 random views at 32²,
``backend: pallas`` with 16 tiles per Gaussian — the JAX kernel in interpret
mode with its transmittance matmuls in float32, as in
``test_torch_static_train.py``, whose bands hold here, and the YAML's
``bf16_matmuls`` off (a TPU choice the port ignores: it composites in
float32).

- The data module: the reference batch (image and mask bit-equal, rays and
  camera within 1e-6) and the first train batch's random cameras.
- The experiment's initial state equals the JAX experiment's (through
  ``convert``): every ``SuGaRParams`` leaf, the static topology, Adam
  ``sugar_optimizer`` (betas 0.9 / 0.999, eps 1e-15, the YAML's ``optimizer.args``
  not read) with zero moments, step 0.
- ``train_step(0)`` of both experiments from the same parameters (moved off
  their init, loaded through ``load_state``): every metric within 1e-4 relative
  (1e-5 absolute floor), every leaf's gradient within 1e-4 of its max |g|
  (the JAX gradients kept by an optax transformation in front of
  ``sugar_optimizer``), the updated parameters within 1e-6 where |g| ≥ 1e-3
  of the leaf's max.

``--export resume=LAST`` writes ``refined_mesh.obj`` and ``gaussians.ply``
from the checkpoint's parameters (the JAX comparison of both files is in
``test_torch_export.py``).

The guidance paths (off, missing, ``allow_missing``, random weights and a
checkpoint); more than one device outside the launcher's process group
raises (``tests/test_torch_launch_multidevice.py`` runs it through the
launcher); ``zero123-system`` and the Gaussian stage build since they run
from their YAML.  The launcher takes the JAX launcher's ``--gpu``,
``--verbose`` and ``--typecheck`` and keeps them out of the dotlist.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dreammesh4d_tpu.ops.gs.pallas_blend as jblend
import dreammesh4d_tpu.systems.optim as joptim
import dreammesh4d_tpu.systems.sugar_static as jsys
from dreammesh4d_tpu.config import load_config as j_load_config
from dreammesh4d_tpu.export.mesh_io import MeshData, save_ply_mesh
from dreammesh4d_tpu.systems import assembly as jasm
from dreammesh4d_tpu.utils.procedural import make_icosphere
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.data.png import write_png
from dreammesh4d_tpu_torch.models.geometry.sugar import SuGaRParams
from dreammesh4d_tpu_torch.models.guidance.zero123.guidance import StableZero123Guidance
from dreammesh4d_tpu_torch.systems import assembly

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "sugar_static_refine.yaml")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dotlist(tmp_path_factory):
    d = tmp_path_factory.mktemp("static_assets")
    rng = np.random.default_rng(0)
    mesh = make_icosphere(1, radius=0.7)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    save_ply_mesh(str(d / "mesh.ply"), MeshData(v_pos=(mesh.v_pos @ rot.T).astype(np.float32),
                                                t_pos_idx=mesh.t_pos_idx, v_rgb=mesh.v_rgb))
    yy, xx = np.mgrid[0:48, 0:48]
    inside = (xx - 23.5) ** 2 + (yy - 23.5) ** 2 < 15.0 ** 2
    rgba = np.stack([xx * 5, yy * 5, (xx + yy) * 2, inside * 255], -1).astype(np.uint8)
    write_png(str(d / "ref_rgba.png"), rgba)
    return [
        "system.guidance.pretrained_model_name_or_path=none",
        f"data.image_path={d}/ref_rgba.png",
        f"system.geometry.surface_mesh_to_bind_path={d}/mesh.ply",
        "data.height=32", "data.width=32",
        "data.random_camera.height=32", "data.random_camera.width=32",
        "data.random_camera.batch_size=2",
        "system.renderer.backend=pallas", "system.renderer.interpret=true",
        "system.renderer.max_tiles_per_gaussian=16", "system.renderer.tile_capacity=256",
        "system.renderer.bf16_matmuls=false",
        f"exp_root_dir={d}/out", "use_timestamp=false", "tag=st",
    ]


def _grad_keeper():
    """An optax transformation that passes the gradient on and keeps it as
    its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


def _matmul_f32(a, b):
    """``pallas_blend._matmul_bf16`` with float32 inputs."""
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)


@pytest.fixture(scope="module")
def experiments(dotlist):
    """Both packages' experiments from the same YAML and dotlist; the JAX
    one's optimizer keeps each step's gradients in its first state."""
    real, made = joptim.sugar_optimizer, []

    def keeping(**kw):
        made.append(optax.chain(_grad_keeper(), real(**kw)))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(joptim, "sugar_optimizer", keeping)
        jexp = jasm.build_experiment(j_load_config(YAML, cli_args=dotlist))
    exp = assembly.build_experiment(load_config(YAML, cli_args=dotlist), device="cpu")
    return jexp, exp, made[0]


def test_data_module_matches_jax(dotlist):
    cfg, jcfg = load_config(YAML, cli_args=dotlist), j_load_config(YAML, cli_args=dotlist)
    dm = assembly.make_single_image_datamodule(cfg.data, cfg.seed, device="cpu")
    jdm = jasm.make_single_image_datamodule(jcfg.data, jcfg.seed)
    ref, jref = dm.ref_batch(), jdm.ref_batch()
    assert set(jref) == set(ref)
    for k in ("ref_rgb", "ref_mask"):
        np.testing.assert_array_equal(ref[k].numpy(), np.asarray(jref[k]), err_msg=k)
    assert 0.2 < float(ref["ref_mask"].mean()) < 0.8
    for k in ("ref_rays_o", "ref_rays_d", "ref_elevation", "ref_azimuth", "ref_distance"):
        np.testing.assert_allclose(ref[k].numpy(), np.asarray(jref[k]), atol=1e-6, err_msg=k)
    for a, b in zip(ref["ref_cameras"], jref["ref_cameras"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    batch, jbatch = dm.train_batch(0), jdm.train_batch(0)
    for a, b in zip(batch["rand_cameras"], jbatch["rand_cameras"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for k in ("elevation", "azimuth", "camera_distances"):
        np.testing.assert_allclose(batch[k].numpy(), np.asarray(jbatch[k]), rtol=1e-6, err_msg=k)


def test_initial_state_matches_jax(experiments):
    jexp, exp, _ = experiments
    assert exp.state.step == int(jexp.state.step) == 0
    for f in SuGaRParams._fields:
        np.testing.assert_allclose(getattr(exp.state.params, f).detach().numpy(),
                                   np.asarray(getattr(jexp.state.params, f)), atol=1e-6, err_msg=f)
    jstatic = convert.sugar_static(_np(jexp.static), "cpu")
    for f in ("faces", "edge_face_pairs", "ring_idx", "ring_mask"):
        np.testing.assert_array_equal(getattr(exp.static, f).numpy(), getattr(jstatic, f).numpy())
    assert (exp.static.n_per_face, exp.static.sh_degree) == (6, 3) == (jstatic.n_per_face,
                                                                         jstatic.sh_degree)
    groups = exp.state.opt_state.param_groups
    assert [g["name"] for g in groups] == list(SuGaRParams._fields)
    assert all(g["betas"] == (0.9, 0.999) and g["eps"] == 1e-15 for g in groups)
    assert [g["lr"] for g in groups] == pytest.approx(
        [0.00048, 0.005, 0.001, 0.001, 0.001 / 20, 0.02])
    assert exp.state.opt_state.state == {}
    assert exp.raster_cfg == convert.config(jexp.raster_cfg)


def test_one_step_matches_jax(experiments):
    """From parameters moved off their init (at init the in-plane scales are
    equal and the in-plane rotation has no gradient), loaded into both
    experiments through their checkpoint protocol."""
    jexp, exp, jopt = experiments
    rng = np.random.default_rng(1)
    jp = jexp.state.params
    jp = jp._replace(
        log_scales=jp.log_scales + jnp.asarray(0.4 * rng.normal(size=jp.log_scales.shape), jnp.float32),
        sh_rest=jnp.asarray(0.1 * rng.normal(size=jp.sh_rest.shape), jnp.float32),
        complex_rot=jp.complex_rot + jnp.asarray(0.2 * rng.normal(size=jp.complex_rot.shape),
                                                 jnp.float32),
        density_logits=jnp.asarray(rng.uniform(-1.0, 2.0, jp.density_logits.shape), jnp.float32))
    jexp.load_state(jsys.init_state(jp, jopt))
    exp.load_state({"params": convert.sugar_params(_np(jp), "cpu")._asdict(),
                    "opt_state": {"state": {}}, "step": 0})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jblend, "_matmul_bf16", _matmul_f32)
        jmetrics = _np(jexp.train_step(0))
    metrics = exp.train_step(0)
    assert exp.state.step == int(jexp.state.step) == 1
    assert set(metrics) == set(jmetrics) and "loss_sds" not in metrics
    for k in sorted(metrics):
        ref, got = float(jmetrics[k]), float(metrics[k])
        assert abs(got - ref) <= max(1e-4 * abs(ref), 1e-5), (k, got, ref)
    jgrads, jnew = _np(jexp.state.opt_state[0]), _np(jexp.state.params)
    n_checked = 0
    for f, leaf in zip(SuGaRParams._fields, exp.state.params):
        jg, g = getattr(jgrads, f), leaf.grad.numpy()
        assert np.abs(jg).max() > 0, f
        assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max(), f
        sure = np.abs(jg) >= 1e-3 * np.abs(jg).max()
        n_checked += int(sure.sum())
        np.testing.assert_allclose(leaf.detach().numpy()[sure], getattr(jnew, f)[sure], atol=1e-6,
                                   err_msg=f)
    assert n_checked > 2000


def test_guidance_paths(tmp_path, caplog):
    """``pretrained_model_name_or_path``: ``""`` / ``none`` off; a missing
    path raises, or warns and is off with ``allow_missing``; ``random``,
    ``random:3`` and an existing checkpoint (a tiny one in the LDM layout)
    build the guidance (at tiny widths here)."""
    for path in ("", "none", "None"):
        assert assembly.maybe_build_guidance({"guidance": {"pretrained_model_name_or_path": path}}) is None
    missing = {"pretrained_model_name_or_path": str(tmp_path / "zero123.ckpt")}
    with pytest.raises(FileNotFoundError, match="zero123.ckpt"):
        assembly.maybe_build_guidance({"guidance": missing})
    assert assembly.maybe_build_guidance({"guidance": {**missing, "allow_missing": True}}) is None
    assert "allow_missing" in caplog.text
    tiny = {"model_channels": 8, "channel_mult": [1], "num_res_blocks": 1, "num_heads": 2,
            "context_dim": 8, "vae_ch": 8, "vae_ch_mult": [1], "vae_num_res_blocks": 1,
            "image_size": 8, "use_clip": False}
    random3 = assembly.maybe_build_guidance(
        {"guidance": {**tiny, "pretrained_model_name_or_path": "random:3"}}, device="cpu")
    sd = {k: v for k, v in random3.modules.state_dict().items() if k != "clip_proj"}
    torch.save({"state_dict": sd}, str(tmp_path / "real.ckpt"))
    for path in ("random", "random:3", str(tmp_path / "real.ckpt")):
        guidance = assembly.maybe_build_guidance(
            {"guidance": {**tiny, "pretrained_model_name_or_path": path}}, device="cpu")
        assert isinstance(guidance, StableZero123Guidance)
        w = guidance.modules.state_dict()["model.diffusion_model.input_blocks.0.0.weight"]
        assert torch.equal(w, sd["model.diffusion_model.input_blocks.0.0.weight"]) == (path != "random")


def test_unported_systems_and_devices_raise(dotlist, tmp_path):
    """Since ``zero123-system`` runs from its YAML it builds (from the
    YAML's full width, guidance off), and so does the Gaussian stage
    (``system.stage=gaussian``, at 512 slots on the CPU); more than one
    device runs one process per rank, so outside the launcher's process
    group it raises, saying to run through the launcher; one device makes
    no process group."""
    zero123 = load_config(os.path.join(REPO, "configs", "stable-zero123.yaml"), makedirs=False,
                          cli_args=["data.image_path=/x/a_rgba.png", "use_timestamp=false",
                                    f"exp_root_dir={tmp_path}",
                                    "system.guidance.pretrained_model_name_or_path=none"])
    exp = assembly.build_experiment(zero123, device="cpu")
    assert isinstance(exp, assembly.Zero123Experiment)
    assert tuple(exp.state.geo_params["encoding"]["tables"].shape) == (16, 65536, 16)
    with pytest.raises(RuntimeError, match="through the launcher"):
        assembly.build_experiment(load_config(
            os.path.join(REPO, "configs", "stable-zero123.yaml"), makedirs=False,
            cli_args=["data.image_path=/x/a_rgba.png", f"exp_root_dir={tmp_path}",
                      "system.guidance.pretrained_model_name_or_path=none", "trainer.devices=2"]),
            device="cpu")
    gaussian = assembly.build_experiment(load_config(
        YAML, cli_args=dotlist + ["system.stage=gaussian", "system.geometry.max_num=512",
                                  "system.geometry.init_num_pts=64"], makedirs=False), device="cpu")
    assert isinstance(gaussian, assembly.GaussianStageExperiment)
    assert int(gaussian.state.gaussians.alive.sum()) == 64 and gaussian.state.gaussians.xyz.shape == (512, 3)
    for extra in (["trainer.devices=2"], ["trainer.mesh=[2,1]"]):
        with pytest.raises(RuntimeError, match="through the launcher"):
            assembly.build_experiment(load_config(YAML, cli_args=dotlist + extra, makedirs=False),
                                      device="cpu")
    assert not assembly.make_parallel_context(
        load_config(YAML, cli_args=dotlist + ["trainer.devices=1", "trainer.mesh=[1,1]"],
                    makedirs=False), "cpu").active


def test_export_writes_mesh_and_gaussians(dotlist, tmp_path):
    """``--export resume=LAST`` of a static trial writes ``refined_mesh.obj``
    (the checkpoint's points on the bind mesh's faces) and ``gaussians.ply``
    (3DGS layout, one row per Gaussian)."""
    from dreammesh4d_tpu_torch import launch
    from dreammesh4d_tpu_torch.export.gaussian_io import load_gaussians_ply
    from dreammesh4d_tpu_torch.export.mesh_io import load_obj
    from dreammesh4d_tpu_torch.models.geometry.sugar import gaussian_attributes
    from dreammesh4d_tpu_torch.utils.checkpoint import save_checkpoint

    extras = dotlist + [f"exp_root_dir={tmp_path}", "tag=export"]
    cfg = load_config(YAML, cli_args=extras)
    exp = assembly.build_experiment(cfg, device="cpu")
    rng = np.random.default_rng(5)
    saved = exp.state_for_checkpoint()
    saved["params"] = {k: v + 0.05 * torch.as_tensor(rng.normal(size=tuple(v.shape)), dtype=v.dtype)
                       for k, v in saved["params"].items()}
    save_checkpoint(os.path.join(cfg.trial_dir, "ckpts"), 3, saved)
    launch.main(launch.make_args(YAML, "export", device="cpu"), extras + ["resume=LAST"])
    save = os.path.join(cfg.trial_dir, "save")
    assert sorted(os.listdir(save)) == ["gaussians.ply", "refined_mesh.obj"]
    mesh = load_obj(os.path.join(save, "refined_mesh.obj"))
    np.testing.assert_allclose(mesh.v_pos, saved["params"]["points"].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mesh.t_pos_idx, exp.static.faces.numpy())
    g = load_gaussians_ply(os.path.join(save, "gaussians.ply"))
    attrs = gaussian_attributes(SuGaRParams(**saved["params"]), exp.static)
    assert g["xyz"].shape == (480, 3) and g["sh"].shape == (480, 16, 3)
    np.testing.assert_allclose(g["xyz"], attrs.means3d.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g["opacity_logits"], saved["params"]["density_logits"].numpy().reshape(-1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("flags", [["--gpu", "0"], ["--gpu=1"], ["--verbose"], ["--typecheck"]])
def test_parse_args_takes_the_jax_launchers_flags(flags):
    """``--gpu``, ``--verbose`` and ``--typecheck`` (JAX ``launch.py:162,
    168-170``) are accepted and stay out of the dotlist."""
    from dreammesh4d_tpu_torch import launch

    args, extras = launch.parse_args(["--config", YAML, "--export", *flags])
    assert extras == [] and args.export and args.device == "cuda"
    args, extras = launch.parse_args(["--config", YAML, *flags, "--train", "--device", "cpu", "tag=x"])
    assert extras == ["tag=x"] and args.train and args.device == "cpu"


def test_launcher_runs_a_verb_with_the_jax_launchers_flags(dotlist, tmp_path, caplog):
    """``main`` runs ``--export`` of a saved static checkpoint with all three
    flags on its command line; ``--typecheck`` logs that the port has no
    shape annotations to check."""
    from dreammesh4d_tpu_torch import launch
    from dreammesh4d_tpu_torch.utils.checkpoint import save_checkpoint

    extras = dotlist + [f"exp_root_dir={tmp_path}", "tag=flags"]
    args, got = launch.parse_args(["--config", YAML, "--gpu", "0", "--verbose", "--typecheck", "--export",
                                   "--device", "cpu", *extras, "resume=LAST"])
    assert got == extras + ["resume=LAST"] and args.typecheck and args.verbose
    cfg = load_config(YAML, cli_args=extras)
    save_checkpoint(os.path.join(cfg.trial_dir, "ckpts"), 2,
                    assembly.build_experiment(cfg, device="cpu").state_for_checkpoint())
    with caplog.at_level("INFO"):
        launch.main(args, got)
    assert sorted(os.listdir(os.path.join(cfg.trial_dir, "save"))) == ["gaussians.ply", "refined_mesh.obj"]
    assert "--typecheck: the port has no shape annotations" in caplog.text

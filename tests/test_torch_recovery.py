"""The recovery benchmark's parts on the port against the JAX package (CPU):
the mesh rasterizer, the procedural scene and its ground-truth frames, the
metrics (PSNR, SSIM, LPIPS with the JAX parameters carried across, the
torchvision weight loader) and the OBJ/PLY writers; then the port's own
``run_recovery`` at a cut size, and (``slow`` tier) the full gate.

Tolerances, with the numbers measured here:
- ``rasterize_mesh`` from the same camera: ``face_idx`` equal on ≥ 99.9 %
  of pixels (measured 100 %), depth ≤ 1e-5 (≤ 2.7e-6).  Barycentrics: each
  package's float32 values sit up to ~5e-5 from the float64 barycentrics of
  the same triangle and pixel (the pixel-minus-vertex differences cancel,
  and 1/det of a few-pixel triangle amplifies the projection's last bit;
  which package lands closer varies pixel by pixel), so the two cannot
  agree to 1e-5 everywhere.  The test holds the port's RMS distance from
  the float64 answer within 1.5× the reference's (over 12 random cameras
  the two RMS were 7.8e-7–1.4e-6 each), and the port within 1e-5 of the
  reference on 99 % of hit pixels and 1e-4 on all (measured ≤ 8.6e-5).
- ``deform_recovery`` ≤ 1e-6; the ground-truth PNGs (L = 4, 32²) equal but
  for ≤ 0.1 % of their values by 1 LSB (measured: equal); ``psnr`` ≤ 1e-4 dB
  (1.9e-6), ``ssim`` ≤ 1e-5 (7.7e-7); LPIPS ≤ 1e-4 relative at 32² (3.1e-6);
  the weight loader and the writers exact.

The JAX rasterizer and ``init_perceptual`` run under ``jax.jit`` (the same
functions; eager dispatch costs ~10 s of per-op compiles at these sizes).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import _cheap_xla  # noqa: F401

import dreammesh4d_tpu.ops.mesh_raster as jmr
from dreammesh4d_tpu.export import mesh_io as jio
from dreammesh4d_tpu.ops import cameras as jcam
from dreammesh4d_tpu.utils import metrics as jmetrics
from dreammesh4d_tpu.utils import perceptual as jperc
from dreammesh4d_tpu.utils import procedural as jproc
from dreammesh4d_tpu_torch import convert, recovery
from dreammesh4d_tpu_torch.data.png import read_png
from dreammesh4d_tpu_torch.export import mesh_io
from dreammesh4d_tpu_torch.ops import cameras as cam
from dreammesh4d_tpu_torch.ops.mesh_raster import interpolate_attribute, rasterize_mesh
from dreammesh4d_tpu_torch.utils import metrics, perceptual, procedural
from test_recovery_benchmark import assert_recovery_gate
from test_recovery_benchmark import make_gt_assets as j_make_gt_assets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_jit_rasterize = jax.jit(jmr.rasterize_mesh, static_argnums=(3, 4, 5, 6))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bary64(verts, faces, camera, face_idx, W, H):
    """The barycentrics of each hit pixel in float64, from the same camera
    and the same face as the float32 rasterizers found."""
    hom = np.concatenate([verts.astype(np.float64), np.ones((len(verts), 1))], -1)
    p = hom @ np.asarray(camera.full_proj_transform, np.float64)
    ndc = p[:, :3] / (p[:, 3:4] + 1e-7)
    pix = np.stack([((ndc[:, 0] + 1.0) * W - 1.0) * 0.5, ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5], -1)
    ys, xs = np.nonzero(face_idx >= 0)
    a, b, c = (pix[faces[face_idx[ys, xs], k]] for k in range(3))
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    dx, dy = xs - a[:, 0], ys - a[:, 1]
    w1 = ((c[:, 1] - a[:, 1]) * dx - (c[:, 0] - a[:, 0]) * dy) / det
    w2 = (-(b[:, 1] - a[:, 1]) * dx + (b[:, 0] - a[:, 0]) * dy) / det
    return np.stack([1.0 - w1 - w2, w1, w2], -1)


@pytest.mark.parametrize("level,elev,azim,hw", [(3, 5.0, 0.0, 64), (3, 30.0, 70.0, 64),
                                                (3, -20.0, 200.0, 64), (2, 10.0, 300.0, 32)])
def test_rasterize_mesh_matches_jax(level, elev, azim, hw):
    mesh = jproc.make_icosphere(level, radius=0.6)
    fov = math.radians(20.0)
    jc = jcam.get_cam_info_gaussian(jnp.asarray(jcam.make_c2w_numpy(elev, azim, 3.8)), fov, fov,
                                    0.01, 100.0)
    jo = _jit_rasterize(jnp.asarray(mesh.v_pos), jnp.asarray(mesh.t_pos_idx), jc, hw, hw, 256, 64)
    tc = cam.GSCameraInfo(*(torch.as_tensor(np.array(x)) for x in jc))
    faces = torch.as_tensor(mesh.t_pos_idx)
    to = rasterize_mesh(torch.as_tensor(mesh.v_pos), faces, tc, hw, hw)
    jf, tf = np.asarray(jo.face_idx), to.face_idx.numpy()
    same = jf == tf
    assert same.mean() >= 0.999 and (tf >= 0).mean() > 0.2
    hit = same & (tf >= 0)
    assert np.abs(np.asarray(jo.depth)[hit] - to.depth.numpy()[hit]).max() <= 1e-5
    assert np.isinf(to.depth.numpy()[tf < 0]).all()
    # barycentrics: the port as close to the float64 answer as the reference
    exact = _bary64(mesh.v_pos, mesh.t_pos_idx, jc, np.where(same, tf, -1), hw, hw)
    rms_jax = np.sqrt(np.mean((np.asarray(jo.bary)[hit] - exact) ** 2))
    rms = np.sqrt(np.mean((to.bary.numpy()[hit] - exact) ** 2))
    assert rms <= 1.5 * rms_jax, (rms, rms_jax)
    d = np.abs(np.asarray(jo.bary)[hit] - to.bary.numpy()[hit])
    assert np.quantile(d, 0.99) <= 1e-5 and d.max() <= 1e-4
    jrgb = np.asarray(jmr.interpolate_attribute(jo, jnp.asarray(mesh.t_pos_idx),
                                                jnp.asarray(mesh.v_rgb)))
    trgb = interpolate_attribute(to, faces, torch.as_tensor(mesh.v_rgb)).numpy()
    assert np.abs(jrgb[same] - trgb[same]).max() <= 1e-4
    assert (trgb[tf < 0] == 0).all()


def test_deform_recovery_matches_jax():
    rest = jproc.make_icosphere(3, radius=0.6).v_pos
    for t in (0.0, 0.13, 0.25, 0.5, 0.77):
        np.testing.assert_allclose(procedural.deform_recovery(rest, t), jproc.deform_recovery(rest, t),
                                   rtol=0, atol=1e-6)


def test_gt_frames_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jmr, "rasterize_mesh", _jit_rasterize)
    (tmp_path / "j").mkdir()
    jframes, jmesh, _, jts = j_make_gt_assets(tmp_path / "j", L=4, H=32, W=32)
    frames, mesh, gt, ts = recovery.make_gt_assets(tmp_path / "t", L=4, H=32, W=32, device="cpu")
    np.testing.assert_array_equal(ts, jts)
    names = sorted(os.listdir(frames))
    assert names == sorted(os.listdir(jframes)) == [f"{i:03d}_rgba.png" for i in range(4)]
    for name in names:
        a = read_png(os.path.join(frames, name)).astype(np.int16)
        b = read_png(os.path.join(jframes, name)).astype(np.int16)
        assert a.shape == b.shape == (32, 32, 4)
        d = np.abs(a - b)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, name
        assert (a[..., 3] > 0).mean() > 0.2
    with open(mesh, "rb") as f, open(jmesh, "rb") as g:
        assert f.read() == g.read()


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(0)
    a = rng.random((3, 32, 32, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(metrics.psnr(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(jmetrics.psnr(a, b)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(metrics.ssim(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(jmetrics.ssim(a, b)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(metrics.ssim(torch.as_tensor(a[0]), torch.as_tensor(b[0])).numpy(),
                               np.asarray(jmetrics.ssim(a[0], b[0])), rtol=0, atol=1e-5)


def test_lpips_matches_jax():
    jparams = jax.jit(jperc.init_perceptual)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    y = np.clip(x + 0.2 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    want = np.asarray(jax.jit(jperc.perceptual_loss)(jparams, x, y))
    carried = convert.perceptual_params(jax.tree.map(np.asarray, jparams), "cpu")
    lp = metrics.LPIPSMetric(params=carried, device="cpu")
    got = lp(x, y).numpy()
    assert lp.converted and got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    # the random features: seeded, and a different draw than the carried one
    rand = metrics.LPIPSMetric(seed=0, device="cpu")
    assert not rand.converted
    np.testing.assert_array_equal(rand(x, y).numpy(), metrics.LPIPSMetric(seed=0, device="cpu")(x, y).numpy())


def test_clip_similarity_matches_jax():
    """``CLIPSimilarityMetric`` at the recovery recipe's tiny tower: the
    port's seeded random weights carried to the JAX metric through its own
    ``convert_clip_vision`` and back through ``clip_vision_params`` (exact);
    the similarities ≤ 1e-5 of the JAX metric's and the embeddings ≤ 1e-4 of
    their max (measured 3.2e-7); the random tower is seeded, relative only,
    and its self-similarity is 1."""
    from transformers import CLIPVisionConfig

    from dreammesh4d_tpu.models.guidance.zero123.convert import convert_clip_vision
    from dreammesh4d_tpu.utils.metrics import CLIPSimilarityMetric as JCLIP

    t = recovery.CLIP_TOWER
    rand = metrics.CLIPSimilarityMetric(config=t, seed=0, device="cpu")
    assert not rand.converted
    sd = {k: v.numpy() for k, v in rand.tower.state_dict().items()}
    jparams = convert_clip_vision({f"visual.{k}": v for k, v in sd.items()}, None)
    jm = JCLIP(params=jparams, config=CLIPVisionConfig(
        hidden_size=t["width"], intermediate_size=t["mlp"], num_hidden_layers=t["layers"],
        num_attention_heads=t["heads"], image_size=t["image_size"], patch_size=t["patch_size"]))
    back = convert.clip_vision_params(jparams)
    assert set(back) == set(sd) and all(np.array_equal(back[k], sd[k]) for k in sd)
    port = metrics.CLIPSimilarityMetric(params=back, config=t, device="cpu")
    assert port.converted and jm.converted
    rng = np.random.default_rng(3)
    x = rng.random((2, 40, 40, 3), dtype=np.float32)
    y = np.clip(x + 0.3 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    got, want = port(x, y).numpy(), np.asarray(jm(x, y))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the similarities sit near 1 with random weights: the embeddings themselves too
    emb, jemb = port.tower.embed(torch.as_tensor(x)).numpy(), np.asarray(jm._embed(jm.params, x))
    err = np.abs(emb - jemb).max() / np.abs(jemb).max()
    print(f"CLIP similarity: port {got} vs JAX {want}; embeddings max |d| / max {err:.3g}")
    assert err <= 1e-4
    np.testing.assert_array_equal(rand(x, y).numpy(),
                                  metrics.CLIPSimilarityMetric(config=t, seed=0, device="cpu")(x, y).numpy())
    np.testing.assert_allclose(rand(x, x).numpy(), 1.0, rtol=1e-6)


def test_load_torch_weights_matches_jax():
    """One seeded torchvision-shaped state dict (the ``features.`` prefix)
    and LPIPS heads for stages 0 and 3 only: both packages give the same
    tree."""
    rng = np.random.default_rng(2)
    state, c_in = {}, 3
    for ids, (c_out, _) in zip(perceptual._CONV_IDS, perceptual._VGG_STAGES):
        for i in ids:
            state[f"features.{i}.weight"] = rng.normal(size=(c_out, c_in, 3, 3)).astype(np.float32)
            state[f"features.{i}.bias"] = rng.normal(size=(c_out,)).astype(np.float32)
            c_in = c_out
    lins = {f"lin{k}.model.1.weight": rng.random((1, c, 1, 1)).astype(np.float32)
            for k, (c, _) in enumerate(perceptual._VGG_STAGES) if k in (0, 3)}
    jtree = jax.tree.map(np.asarray, jperc.load_torch_weights(state, lins))
    want = convert.perceptual_params(jtree, "cpu")
    net = perceptual.load_torch_weights(state, lins, device="cpu")
    for convs, w_stage in zip(net.stages, want["stages"]):
        assert len(convs) == len(w_stage)
        for conv, w in zip(convs, w_stage):
            torch.testing.assert_close(conv.weight, w["w"], rtol=0, atol=0)
            torch.testing.assert_close(conv.bias, w["b"], rtol=0, atol=0)
    for lin, w in zip(net.lins, want["lins"]):
        torch.testing.assert_close(lin.data, w, rtol=0, atol=0)
    torch.testing.assert_close(net.lins[1].data, torch.full((128,), 1 / 128))


def test_writers_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    m = jproc.make_icosphere(1, radius=0.6)
    F = len(m.t_pos_idx)
    uv = rng.random((3 * F, 2)).astype(np.float32)
    tex = rng.random((16, 16, 3)).astype(np.float32)
    meshes = {
        "plain": dict(v_pos=m.v_pos, t_pos_idx=m.t_pos_idx),
        "rgb": dict(v_pos=m.v_pos, t_pos_idx=m.t_pos_idx, v_rgb=m.v_rgb),
        "uv": dict(v_pos=m.v_pos, t_pos_idx=m.t_pos_idx, v_nrm=m.v_pos / 0.6, v_tex=uv,
                   t_tex_idx=np.arange(3 * F, dtype=np.int32).reshape(F, 3)),
    }
    for name, kw in meshes.items():
        for pkg, io in (("j", jio), ("t", mesh_io)):
            d = tmp_path / pkg
            mesh = io.MeshData(**kw)
            if name != "uv":
                io.save_ply_mesh(str(d / f"{name}.ply"), mesh)
                io.save_ply_mesh(str(d / f"{name}_ascii.ply"), mesh, binary=False)
                io.save_obj(str(d / f"{name}.obj"), mesh)
            else:
                io.save_obj(str(d / "uv" / "uv.obj"), mesh, mtl_name="material0", texture_map=tex)
    files = sorted(str(p.relative_to(tmp_path / "t")) for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(tmp_path / "j")) for p in (tmp_path / "j").rglob("*")
                           if p.is_file())
    assert len(files) == 9
    for rel in files:
        if rel.endswith(".png"):
            np.testing.assert_array_equal(read_png(str(tmp_path / "t" / rel)),
                                          read_png(str(tmp_path / "j" / rel)))
        else:
            assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
    back = mesh_io.load_mesh(str(tmp_path / "t" / "rgb.ply"))
    np.testing.assert_array_equal(back.v_pos, m.v_pos)
    np.testing.assert_array_equal(back.t_pos_idx, m.t_pos_idx)


def _jax_dict_keys():
    """The JAX recovery dict's keys as ``RECOVERY.json`` records them, less
    the keys the benchmark script adds."""
    with open(os.path.join(REPO, "RECOVERY.json")) as f:
        keys = set(json.load(f))
    return keys - {
        "resolution", "static_steps", "dynamic_steps", "feature_provenance"}


def test_run_recovery_cut(tmp_path):
    """The port's recipe end to end at 32², 4 frames, 3 + 3 steps on
    ``xla``: every column of the JAX dict, finite."""
    stats = {}
    res = recovery.run_recovery(tmp_path, H=32, W=32, L=4, static_steps=3, dynamic_steps=3,
                                device="cpu", backend="xla", stats=stats)
    assert set(res) == _jax_dict_keys()
    assert all(np.isfinite(v) for k, v in res.items() if not k.endswith("_converted"))
    assert res["lpips_converted"] is False and res["clip_converted"] is False
    assert 0 < stats["static_max_tile_count"] and 0 < stats["dynamic_max_tile_count"]
    assert stats["static_ms_per_step"] > 0 and stats["dynamic_ms_per_step"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            recovery.main(["--device", "cuda"])


@pytest.mark.slow
def test_recovery_gate_cpu(tmp_path):
    """The full recipe (64², 16 frames, 1000 + 600 steps) on ``xla`` passes
    the reference's gate, tier ``cpu``."""
    res = recovery.run_recovery(tmp_path, device="cpu", backend="xla")
    print("recovery:", res)
    assert_recovery_gate(res, tier="cpu")

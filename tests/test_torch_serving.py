"""The port's ``Viewer4D`` against the JAX package's on the same scene: an
icosphere(2) SuGaR mesh (1920 Gaussians, SH degree 3), a 16-node geodesic
deformation graph with hybrid skinning, and a small HexPlane field whose
zero-init heads and time planes are filled from a seeded numpy RNG, so the
scene really moves.  The JAX viewer runs the resident Pallas kernel in
interpret mode with f32 matmuls; the port's the plain PyTorch blend (CPU).

comp_rgb must agree to max |Δ| ≤ 5e-3 and mean |Δ| ≤ 5e-4 (the JAX kernel
forms transmittance from a bf16 triangular matmul, the port from exact f32
products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import _cheap_xla  # noqa: F401

import dreammesh4d_tpu.models.geometry.deformation as jdef
import dreammesh4d_tpu.models.geometry.dynamic_sugar as jdyn
import dreammesh4d_tpu.models.geometry.sugar as jsugar
from dreammesh4d_tpu.ops.gs import RasterizerConfig as JRasterizerConfig
from dreammesh4d_tpu.serving import Viewer4D as JViewer4D
from dreammesh4d_tpu.utils.procedural import make_icosphere
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.serving import Viewer4D

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H = W = 64
FOVY = 20.0


@pytest.fixture(scope="module")
def viewers():
    mesh = make_icosphere(2, radius=0.6)
    jp, js = jsugar.create_sugar(jsugar.SuGaRConfig(), mesh)
    dyn_cfg = jdyn.DynamicSuGaRConfig(
        n_dg_nodes=16, deformation=jdef.DeformationConfig(
            net_width=16, grid_channels=4, base_resolution=(8, 8, 8, 5), multires=(1, 2)))
    jst = jdyn.build_dynamic_static(dyn_cfg, js, np.asarray(jp.points))
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jdef.init_deformation(dyn_cfg.deformation, k))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for name in ("head_dx", "head_dstrain", "head_drot", "head_dopacity"):
        for layer in ("res", "out"):
            for k in ("w", "b"):
                shape = params[name][layer][k].shape
                params[name][layer][k] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    for planes in params["grids"]:
        for i, (a, b) in enumerate(jdef._COMBS):
            if 3 in (a, b):
                planes[i] = (planes[i] + 0.3 * rng.normal(size=planes[i].shape)).astype(np.float32)
    t = float(np.tan(np.radians(FOVY) / 2))
    raster_cfg = JRasterizerConfig(W, H, t, t, tile_capacity=512, max_tiles_per_gaussian=6,
                                   backend="pallas_resident", interpret=True, tile_px=32,
                                   stream_rows=False, bf16_matmuls=False)
    jv = JViewer4D(jp, jst, jax.tree.map(jnp.asarray, params), dyn_cfg, raster_cfg, H, W, FOVY, 32)
    tv = Viewer4D(convert.sugar_params(jax.tree.map(np.asarray, jp), "cpu"),
                  convert.dynamic_static(jax.tree.map(np.asarray, jst), "cpu"),
                  convert.deformation_params(params, "cpu"), convert.config(dyn_cfg),
                  convert.config(raster_cfg), H, W, FOVY, 32, device="cpu")
    return jv, tv


def _check(port_frames, ref_frames):
    assert len(port_frames) == len(ref_frames)
    for a, b in zip(port_frames, ref_frames):
        assert a.shape == (H, W, 3) and np.isfinite(a).all()
        d = np.abs(a - np.asarray(b))
        assert d.max() <= 5e-3, d.max()
        assert d.mean() <= 5e-4, d.mean()


def test_render(viewers):
    """The port's ``render`` against the JAX viewer's render of the same
    camera and time, taken as the first view of a batch of three: the shape
    of ``test_orbit``'s and ``test_play``'s batches, so that the JAX viewer's
    jitted render compiles once for all three tests."""
    jv, tv = viewers
    ts = jnp.asarray([0.3, 0.7, 0.7], jnp.float32)
    jcams = jv._cameras(np.asarray([5.0, 10.0, 10.0]), np.asarray([20.0, 0.0, 120.0]), np.full(3, 3.8))
    ref = np.asarray(jv._render(jv.deform_params, jcams, ts, jv._frame_indices(ts))["comp_rgb"][0])
    _check([tv.render(5.0, 20.0, 3.8, t=0.3)], [ref])


def test_orbit(viewers):
    """Three views: the batch of ``test_play``'s three frames, so that the
    JAX viewer's jitted render compiles once for both."""
    jv, tv = viewers
    port = tv.orbit(n_views=3, elevation_deg=10.0, distance=3.8, t=0.7)
    _check(port, jv.orbit(n_views=3, elevation_deg=10.0, distance=3.8, t=0.7))
    assert np.abs(port[0] - port[1]).max() > 1e-2  # two different views


def test_play(viewers):
    jv, tv = viewers
    port = tv.play(elevation_deg=5.0, azimuth_deg=30.0, distance=3.8, n_frames=3)
    _check(port, jv.play(elevation_deg=5.0, azimuth_deg=30.0, distance=3.8, n_frames=3))
    assert np.abs(port[0] - port[2]).max() > 1e-2  # the scene moves over time
    assert (np.abs(port[0] - 1.0).max(-1) > 1e-3).mean() > 0.05  # and covers the frame


def test_render_builds_no_autograd_graph(viewers):
    """Serving pays nothing for the differentiable blend: even with
    parameters that require grad, ``Viewer4D`` renders under inference mode
    and neither the frames nor the eval render's outputs carry a graph."""
    _, tv = viewers
    leaves = [p for planes in tv.deform_params["grids"] for p in planes]
    for p in leaves:
        p.requires_grad_(True)
    try:
        frame = tv.render(5.0, 20.0, 3.8, t=0.3)
        assert isinstance(frame, np.ndarray) and np.isfinite(frame).all()
        with torch.inference_mode():
            ts = torch.tensor([0.3])
            out = tv._render(tv.deform_params, tv._cameras(5.0, 20.0, 3.8), ts, tv._frame_indices(ts))
        assert all(v.grad_fn is None and not v.requires_grad for v in out.values())
        assert all(p.grad is None for p in leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)

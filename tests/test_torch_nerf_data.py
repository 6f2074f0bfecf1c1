"""The small parts around the port's stage-1 renderer against the JAX
package's (CPU): ray/box intersection, inverse-CDF sampling and compositing,
the point-light material, ray generation, the BCE, and the random camera
sampler — the same ``np.random.RandomState`` seed must give the same cameras,
lights and rays, call for call.

Inputs come from a seeded numpy RNG.  Tolerances: 1e-5 on ray parameters and
samples, 1e-6 on shading, rays and camera batches (2e-6 on the GS transforms,
which pass through a 4×4 inverse).  The JAX functions run under ``jax.jit``
(eagerly every op compiles on first use); the camera sampler, a host loop
around small ops, runs as it is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammesh4d_tpu.models.renderers.nerf_volume_renderer as jnr
import dreammesh4d_tpu.ops.cameras as jcam
from dreammesh4d_tpu.data.uncond import RandomCameraConfig as JRandomCameraConfig
from dreammesh4d_tpu.data.uncond import RandomCameraSampler as JRandomCameraSampler
from dreammesh4d_tpu.models.materials import DiffuseWithPointLightMaterial as JMaterial
from dreammesh4d_tpu_torch.data.uncond import RandomCameraConfig, RandomCameraSampler
from dreammesh4d_tpu_torch.models.materials import DiffuseWithPointLightMaterial
from dreammesh4d_tpu_torch.models.renderers import nerf_volume_renderer as tnr
from dreammesh4d_tpu_torch.ops import cameras as tcam

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_rays(n, seed=3):
    """Rays from a ring of origins at distance 2.4 toward points near the centre."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (2.4 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = 0.3 * rng.normal(size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def close(got, ref, atol, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(ref), rtol=rtol, atol=atol)


def test_ray_bbox_sample_pdf_composite():
    o, d = make_rays(20)
    d[0] = [0.0, 0.0, 1.0]  # exact zeros in the direction
    o[1] = [5.0, 5.0, 5.0]  # misses the box
    rng = np.random.default_rng(5)
    bins = np.sort(rng.uniform(0, 4, (20, 9)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (20, 8)).astype(np.float32)
    w[3] = 0.0
    w[4, :] = 0.0
    w[4, 5] = 1.0
    u = rng.uniform(0, 1, (20, 16)).astype(np.float32)
    dens = rng.uniform(0, 30, (20, 8, 1)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (20, 8)).astype(np.float32)
    j_box, j_pdf, j_comp = jax.jit(lambda o, d, bins, w, dens, dt: (
        jnr.ray_bbox_intersect(o, d, 1.0, 0.05), jnr.sample_pdf(bins, w, 16, None), jnr._composite(dens, dt)))(
            o, d, bins, w, dens, dt)
    for a, b in zip(tnr.ray_bbox_intersect(torch.tensor(o), torch.tensor(d), 1.0, 0.05), j_box):
        close(a, b, 1e-5)
    close(tnr.sample_pdf(torch.tensor(bins), torch.tensor(w), 16, None), j_pdf, 1e-5)
    got = tnr.sample_pdf(torch.tensor(bins), torch.tensor(w), 16, None, jitter=torch.tensor(u))
    assert bool((got >= torch.tensor(bins[:, :1])).all() and (got <= torch.tensor(bins[:, -1:])).all())
    for a, b in zip(tnr._composite(torch.tensor(dens), torch.tensor(dt)), j_comp):
        close(a, b, 1e-6)


def test_material_rays_and_bce():
    rng = np.random.default_rng(6)
    albedo = rng.uniform(0, 1, (5, 4, 3)).astype(np.float32)
    normals = rng.normal(size=(5, 4, 3)).astype(np.float32)
    pos = rng.normal(size=(5, 4, 3)).astype(np.float32)
    light = rng.normal(size=(5, 1, 3)).astype(np.float32) * 3
    jm, tm = JMaterial(), DiffuseWithPointLightMaterial()
    feats = rng.normal(size=(5, 4, 3)).astype(np.float32)
    kws = ({}, {"ambient_ratio": 0.3}, {"ambient_ratio": 1.0}, {"shading_normal_only": True})
    j_shaded, j_albedo = jax.jit(lambda *a: ([jm.shade(*a[:4], **kw) for kw in kws], jm(a[4])))(
        albedo, normals, pos, light, feats)
    for kw, want in zip(kws, j_shaded):
        close(tm.shade(*(torch.tensor(a) for a in (albedo, normals, pos, light)), **kw), want, 1e-6)
    close(tm(torch.tensor(feats)), j_albedo, 1e-6)

    for focal in (20.0, (18.0, 21.0)):
        principal = None if isinstance(focal, float) else (3.2, 2.9)
        close(tcam.get_ray_directions(6, 7, focal, principal, device="cpu"),
              jcam.get_ray_directions(6, 7, focal, principal), 1e-6)
    c2w = np.stack([jcam.make_c2w_numpy(10.0 * i, 40.0 * i, 3.0) for i in range(2)])
    close(tcam.make_c2w_numpy(10.0, 40.0, 3.0), c2w[1], 1e-6)
    dirs = np.asarray(jcam.get_ray_directions(6, 7, 20.0))
    cases = [(dirs.reshape(-1, 3), c2w[0]), (dirs, c2w[0]), (dirs, c2w),
             (np.stack([dirs, 2 * dirs]), c2w)]
    j_rays = jax.jit(jcam.get_rays, static_argnums=(2, 3))
    for dd, cc in cases:
        for keepdim, normalize in ((False, True), (True, False)):
            got = tcam.get_rays(torch.tensor(dd), torch.tensor(cc), keepdim, normalize)
            ref = j_rays(dd, cc, keepdim, normalize)
            for a, b in zip(got, ref):
                assert tuple(a.shape) == tuple(b.shape)
                close(a, b, 1e-6)
    p = rng.uniform(0, 1, (50,)).astype(np.float32)
    t = rng.uniform(0, 1, (50,)).astype(np.float32)
    close(tcam.binary_cross_entropy(torch.tensor(p), torch.tensor(t)), jax.jit(jcam.binary_cross_entropy)(p, t), 1e-6)


def test_random_camera_sampler_matches_jax():
    kw = dict(height=[8, 12], width=[8, 12], batch_size=[3, 2], resolution_milestones=[5],
              eval_height=10, eval_width=10, camera_perturb=0.05, center_perturb=0.02,
              up_perturb=0.01, progressive_until=8, fovy_range=(15.0, 25.0),
              camera_distance_range=(3.0, 4.0), n_val_views=5)
    js = JRandomCameraSampler(JRandomCameraConfig(**kw), seed=7)
    ts = RandomCameraSampler(RandomCameraConfig(**kw), seed=7, device="cpu")
    tensor_keys = ("c2w", "rays_o", "rays_d", "elevation", "azimuth", "camera_distances",
                   "light_positions", "fovy")
    for step in (0, 3, 6):  # the third call is past the resolution milestone
        js.update(step)
        ts.update(step)
        jb, tb = js.sample(), ts.sample()
        assert tb["height"] == jb["height"] and tb["rays_o"].shape == jb["rays_o"].shape
        assert tb["rays_o"].shape == (ts.batch_size, ts.height, ts.width, 3)
        for k in tensor_keys:
            close(tb[k], jb[k], 1e-6)
        for a, b in zip(tb["rand_cameras"], jb["rand_cameras"]):
            close(a, b, 2e-6)
    assert ts.height == 12 and ts.batch_size == 2
    jb, tb = js.orbit(), ts.orbit()
    for k in ("c2w", "elevation", "azimuth", "camera_distances", "fovy"):
        close(tb[k], jb[k], 1e-6)
    for a, b in zip(tb["rand_cameras"], jb["rand_cameras"]):
        close(a, b, 2e-6)
    je, te = js.sample_efficient(4, 4), ts.sample_efficient(4, 4)
    close(te["rays_d"], je["rays_d"], 1e-6)
    np.testing.assert_array_equal(te["ray_indices"].numpy(), np.asarray(je["ray_indices"]))

"""The port's stage-1 NeRF modules against the JAX package's (CPU): the
implicit volume, the volume renderer with both estimators, the occupancy
update, the density export, and parameter gradients through ``render_rays``
(the renderer's small parts, the material, rays and the camera sampler are in
``test_torch_nerf_data.py``).

Inputs and weights come from a seeded numpy RNG and go to both packages
through ``convert``.  On the CPU the JAX cell encode is its XLA twin and the
port's is the plain PyTorch version.  Random draws inside the renderers are
handed to both sides as the same numpy numbers (``jax.random.uniform`` /
``normal`` and the port's ``draw_uniform`` / ``draw_normal`` are replaced
for the call).

Tolerances: forward values 2e-5 absolute on O(1) quantities (float32, other
summation orders), normals 2e-4 (a normalised gradient), parameter gradients
1e-4 of each leaf's max.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import jit_fast

import dreammesh4d_tpu.models.geometry.implicit_volume as jiv
import dreammesh4d_tpu.models.renderers.nerf_volume_renderer as jnr
from dreammesh4d_tpu.models.materials import DiffuseWithPointLightMaterial as JMaterial
from dreammesh4d_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.geometry import implicit_volume as tiv
from dreammesh4d_tpu_torch.models.materials import DiffuseWithPointLightMaterial
from dreammesh4d_tpu_torch.models.renderers import nerf_volume_renderer as tnr
from dreammesh4d_tpu_torch.ops import hashgrid_cell as tcell

JHG = JHashGridConfig(n_levels=3, n_features_per_level=2, log2_hashmap_size=8, base_resolution=4,
                      per_level_scale=2.0, layout="cell")
JGEO = jiv.ImplicitVolumeConfig(radius=1.0, hashgrid=JHG, n_neurons=16, n_hidden_layers=2,
                                density_blob_std=0.6)
JRCFG = jnr.NeRFRendererConfig(num_samples_coarse=6, num_samples_fine=6, radius=1.0,
                               ray_chunk_train=0, estimator="occgrid", grid_resolution=4,
                               occ_candidates=12, occ_samples=6)
R = 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_params(jgeo, seed=0):
    """An implicit-volume tree as numpy: tables at ±0.1, Glorot weights,
    small non-zero biases."""
    rng = np.random.default_rng(seed)
    hg = jgeo.hashgrid
    width = 16 if hg.layout == "cell" else 2
    dims = [hg.out_dim] + [jgeo.n_neurons] * jgeo.n_hidden_layers

    def mlp(dims):
        return [{"w": (rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / (a + b))).astype(np.float32),
                 "b": (0.1 * rng.normal(size=(b,))).astype(np.float32)}
                for a, b in zip(dims[:-1], dims[1:])]

    return {"encoding": {"tables": rng.uniform(-0.1, 0.1, (hg.n_levels, 1 << hg.log2_hashmap_size,
                                                            width)).astype(np.float32)},
            "density_mlp": mlp(dims + [1]), "feature_mlp": mlp(dims + [3])}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def leaves(tree):
    out = [tree["encoding"]["tables"]]
    for name in ("density_mlp", "feature_mlp"):
        for layer in tree[name]:
            out += [layer["w"], layer["b"]]
    return out


def make_rays(n, seed=3):
    """Rays from a ring of origins at distance 2.4 toward points near the
    centre, so most of them cross the blob."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (2.4 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = 0.3 * rng.normal(size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, (1.5 * o).astype(np.float32)


def close(got, ref, atol, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("layout,normal_type", [("cell", "analytic"), ("corner", "analytic"),
                                                ("cell", "finite_difference")])
def test_implicit_volume_matches_jax(layout, normal_type):
    jgeo = dataclasses.replace(JGEO, normal_type=normal_type,
                               hashgrid=dataclasses.replace(JHG, layout=layout))
    geo = convert.implicit_volume_config(jgeo)
    assert geo.hashgrid.layout == layout and geo.n_neurons == 16
    params = make_params(jgeo)
    tparams = convert.implicit_volume_params(params, "cpu")
    pts = np.random.default_rng(1).uniform(-0.95, 0.95, (7, 9, 3)).astype(np.float32)
    mask = np.float32([1, 1, 0])
    j_fwn = jit_fast(lambda p, x, lm: jiv.forward_with_normal(p, jgeo, x, lm))
    j_density = jit_fast(lambda p, x, lm: jiv.forward_density(p, jgeo, x, lm))
    for lm in (None, mask):
        jlm = None if lm is None else jnp.asarray(lm)
        tlm = None if lm is None else torch.tensor(lm)
        jd, jf, jn = j_fwn(to_jax(params), jnp.asarray(pts), jlm)
        d, f, n = tiv.forward_with_normal(tparams, geo, torch.tensor(pts), tlm)
        assert d.shape == (7, 9, 1) and f.shape == (7, 9, 3) and n.shape == (7, 9, 3)
        close(d, jd, 2e-5)
        close(f, jf, 2e-5)
        close(n, jn, 2e-4, rtol=1e-4)
        close(tiv.forward_density(tparams, geo, torch.tensor(pts), tlm),
              j_density(to_jax(params), jnp.asarray(pts), jlm), 2e-5)
        d2, f2 = tiv.forward_field(tparams, geo, torch.tensor(pts), tlm)
        close(d2, jd, 2e-5)
        close(f2, jf, 2e-5)


def test_cell_analytic_normal_without_grad_mode():
    """The written-out chain rule needs no autograd: under ``no_grad`` (and
    ``inference_mode``) it gives the same numbers, and equals the autograd
    gradient of the density."""
    geo = convert.implicit_volume_config(JGEO)
    tparams = convert.implicit_volume_params(make_params(JGEO), "cpu")
    for leaf in leaves(tparams):
        leaf.requires_grad_(True)
    pts = torch.tensor(np.random.default_rng(2).uniform(-0.9, 0.9, (40, 3)).astype(np.float32))
    d0, f0, n0 = tiv.forward_with_normal(tparams, geo, pts)
    assert n0.requires_grad
    for ctx in (torch.no_grad(), torch.inference_mode()):
        with ctx:
            d1, f1, n1 = tiv.forward_with_normal(tparams, geo, pts)
        assert not n1.requires_grad
        assert torch.equal(d1, d0.detach()) and torch.equal(n1, n0.detach())
    # autograd through the plain, x-differentiable encode gives the same normal
    from dreammesh4d_tpu_torch.ops.hashgrid import hashgrid_encode_cell
    from dreammesh4d_tpu_torch.ops.safe_math import safe_normalize

    p = pts.clone().requires_grad_(True)
    enc = hashgrid_encode_cell(tparams["encoding"], geo.hashgrid, tiv._contract(geo, p))
    sigma = tiv._activate_density(geo, tiv._mlp_apply(tparams["density_mlp"], enc)
                                  + tiv.density_bias(geo, p))
    (g,) = torch.autograd.grad(sigma.sum(), p)
    close(n0, -safe_normalize(g), 2e-4, rtol=1e-4)


@pytest.mark.parametrize("bias", ["blob_magic3d", "blob_dreamfusion", -1.5])
@pytest.mark.parametrize("act", ["softplus", "trunc_exp", "shifted_softplus"])
def test_density_bias_and_activations(bias, act):
    jgeo = dataclasses.replace(JGEO, density_bias=bias, density_activation=act)
    geo = convert.implicit_volume_config(jgeo)
    params = make_params(jgeo)
    pts = np.random.default_rng(4).uniform(-0.9, 0.9, (30, 3)).astype(np.float32)
    jbias, (jd, _, jn) = jit_fast(lambda p, x: (jiv.density_bias(jgeo, x), jiv.forward_with_normal(p, jgeo, x)))(
        to_jax(params), jnp.asarray(pts))
    close(tiv.density_bias(geo, torch.tensor(pts)), jbias, 1e-5)
    d, _, n = tiv.forward_with_normal(convert.implicit_volume_params(params, "cpu"), geo,
                                      torch.tensor(pts))
    close(d, jd, 2e-5, rtol=2e-5)
    close(n, jn, 2e-4, rtol=1e-4)


def _occ_state(seed=8):
    binary = (np.random.default_rng(seed).uniform(size=JRCFG.grid_resolution ** 3) > 0.35)
    return {"occ": np.zeros(binary.shape, np.float32), "binary": binary.astype(np.float32)}


def _render_case(estimator):
    """Inputs of the two render_rays parity tests: rays, an occupancy state,
    the position noise of the perturbed normals and the weights of the
    test-defined loss."""
    K = 6 if estimator == "occgrid" else 12
    rng = np.random.default_rng(11)
    o, d, lp = make_rays(R)
    return dict(o=o, d=d, lp=lp, occ=_occ_state(), params=make_params(JGEO),
                noise=rng.normal(size=(R, K, 3)).astype(np.float32),
                w_rgb=rng.normal(size=(R, 3)).astype(np.float32),
                w_op=rng.normal(size=(R, 1)).astype(np.float32),
                w_n=rng.normal(size=(R, K, 3)).astype(np.float32))


def _loss(out, case, lib):
    """A loss over comp_rgb, opacity, the per-sample normals and the
    perturbed normals, in numpy-style calls that jnp and torch share."""
    as_lib = jnp.asarray if lib is jnp else torch.tensor
    return ((out["comp_rgb"] * as_lib(case["w_rgb"])).sum() + (out["opacity"] * as_lib(case["w_op"])).sum()
            + (out["normal"] * as_lib(case["w_n"])).sum()
            + abs(out["normal"] - out["normal_perturb"]).mean())


@functools.lru_cache(maxsize=None)
def render_pair(estimator):
    """One JAX evaluation per estimator — outputs, loss and (occgrid only)
    parameter gradients, under one ``jax.jit`` — and the port's on the same
    inputs and the same noise."""
    case = _render_case(estimator)
    jrcfg = dataclasses.replace(JRCFG, estimator=estimator)

    def jloss(p):
        out = jnr.render_rays(p, JGEO, jrcfg, jnp.asarray(case["o"]), jnp.asarray(case["d"]),
                              jnp.asarray(case["lp"]), jnp.ones(3), rng=None, ambient_ratio=0.4,
                              material=JMaterial(), return_normal_perturb=True,
                              occ_state=jnr.OccGridState(**to_jax(case["occ"])))
        return _loss(out, case, jnp), out

    tparams = convert.implicit_volume_params(case["params"], "cpu")
    for leaf in leaves(tparams):
        leaf.requires_grad_(True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(case["noise"]))
        mp.setattr(tnr, "draw_normal", lambda rng, shape, device: torch.tensor(case["noise"]))
        if estimator == "occgrid":
            (jval, jout), jgrads = jit_fast(jax.value_and_grad(jloss, has_aux=True))(to_jax(case["params"]))
        else:
            (jval, jout), jgrads = jit_fast(jloss)(to_jax(case["params"])), None
        tcell.reset_launch_counts()
        out = tnr.render_rays(tparams, convert.implicit_volume_config(JGEO),
                              convert.nerf_renderer_config(jrcfg), torch.tensor(case["o"]),
                              torch.tensor(case["d"]), torch.tensor(case["lp"]), torch.ones(3),
                              rng=None, ambient_ratio=0.4, material=DiffuseWithPointLightMaterial(),
                              return_normal_perturb=True,
                              occ_state=convert.occgrid_state(case["occ"], "cpu"))
        total = _loss(out, case, torch)
        total.backward()
    return dict(estimator=estimator, jout=jout, jval=float(jval), jgrads=jgrads, out=out,
                total=float(total.detach()), tparams=tparams, counts=dict(tcell.plain_counts))


@pytest.mark.parametrize("estimator", ["occgrid", "importance"])
def test_render_rays_matches_jax(estimator):
    pair = render_pair(estimator)
    out, jout = pair["out"], pair["jout"]
    assert abs(pair["total"] - pair["jval"]) <= 1e-4 * abs(pair["jval"])
    # occgrid: two encodes (samples, perturbed samples), one backward each;
    # importance: a coarse pass without gradient before them
    n_fwd = 2 if estimator == "occgrid" else 3
    assert pair["counts"] == {"hashgrid_cell_fwd": n_fwd, "hashgrid_cell_bwd": 2}
    assert set(out) == set(jout)
    assert float(jout["opacity"].max()) > 0.5  # the rays do hit the blob
    for k in sorted(out):
        assert tuple(out[k].shape) == tuple(jout[k].shape), k
        tol = 2e-4 if "normal" in k else 2e-5
        close(out[k], jout[k], tol, rtol=1e-4)


def test_render_rays_jitter_chunks_and_image_renderer(monkeypatch):
    """Port only: the jittered samples stay inside the ray interval, the
    chunked path (with and without grad mode) equals the whole one, and the
    image renderer is ``render_rays`` reshaped."""
    geo = convert.implicit_volume_config(JGEO)
    rcfg = convert.nerf_renderer_config(JRCFG)
    tparams = convert.implicit_volume_params(make_params(JGEO), "cpu")
    o, d, lp = (torch.tensor(a) for a in make_rays(R))
    occ = convert.occgrid_state(_occ_state(), "cpu")
    gen = torch.Generator().manual_seed(0)
    a = tnr.render_rays(tparams, geo, rcfg, o, d, lp, torch.ones(3), rng=gen, occ_state=occ)
    b = tnr.render_rays(tparams, geo, rcfg, o, d, lp, torch.ones(3), rng=gen, occ_state=occ)
    assert float((a["comp_rgb"] - b["comp_rgb"]).abs().max()) > 0  # fresh jitter per call
    fixed = dataclasses.replace(rcfg, randomized=False)
    c = tnr.render_rays(tparams, geo, fixed, o, d, lp, torch.ones(3), rng=gen, occ_state=occ)
    e = tnr.render_rays(tparams, geo, fixed, o, d, lp, torch.ones(3), rng=None, occ_state=occ)
    assert torch.equal(c["comp_rgb"], e["comp_rgb"])

    chunked = dataclasses.replace(rcfg, ray_chunk_train=4)  # 4 + 4 + 2 rays
    for leaf in leaves(tparams):
        leaf.requires_grad_(True)
    grads = {}
    noise = torch.tensor(np.random.default_rng(12).normal(size=(R, 6, 3)).astype(np.float32))
    served = [0]

    def noise_rows(rng, shape, device):  # the same noise per ray, however the rays are chunked
        served[0] += shape[0]
        return noise[served[0] - shape[0]:served[0]]

    monkeypatch.setattr(tnr, "draw_normal", noise_rows)
    for name, cfg in (("whole", rcfg), ("chunked", chunked)):
        served[0] = 0
        out = tnr.render_rays(tparams, geo, cfg, o, d, lp, torch.ones(3), rng=None,
                              return_normal_perturb=True, occ_state=occ)
        loss = out["comp_rgb"].sum() + (out["normal"] * out["normal_perturb"]).sum()
        grads[name] = (out, torch.autograd.grad(loss, leaves(tparams)))
    for k, v in grads["whole"][0].items():
        np.testing.assert_allclose(grads["chunked"][0][k].detach().numpy(), v.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    for gw, gc in zip(grads["whole"][1], grads["chunked"][1]):
        np.testing.assert_allclose(gc.numpy(), gw.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(gw.abs().max()))
    with torch.no_grad():
        quiet = tnr.render_rays(tparams, geo, chunked, o, d, lp, torch.ones(3), rng=None,
                                occ_state=occ)
    close(quiet["comp_rgb"], grads["whole"][0]["comp_rgb"].detach().numpy(), 1e-6)

    render_image = tnr.make_image_renderer(geo, rcfg, ray_chunk=4)
    img = render_image(tparams, o.reshape(2, 5, 3), d.reshape(2, 5, 3), lp[0], torch.ones(3))
    flat = tnr.render_rays(tparams, geo, rcfg, o, d, lp[:1].expand(R, 3), torch.ones(3))
    assert img["comp_rgb"].shape == (2, 5, 3) and not img["comp_rgb"].requires_grad
    close(img["comp_rgb"].reshape(R, 3), flat["comp_rgb"].detach().numpy(), 1e-6)
    close(img["depth"].reshape(R, 1), flat["depth"].detach().numpy(), 1e-6)


def test_occgrid_update_matches_jax(monkeypatch):
    geo = convert.implicit_volume_config(JGEO)
    rcfg = convert.nerf_renderer_config(JRCFG)
    params = make_params(JGEO)
    n = JRCFG.grid_resolution ** 3
    u = np.random.default_rng(10).uniform(size=(n, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(u))
    monkeypatch.setattr(tnr, "draw_uniform", lambda rng, shape, device: torch.tensor(u))
    jstate = jnr.init_occgrid(JRCFG)
    tstate = tnr.init_occgrid(rcfg, device="cpu")
    assert float(tstate.binary.min()) == 1.0 and tstate.occ.shape == (n,)
    jupdate = jnr.make_occgrid_update(JGEO, JRCFG)
    tupdate = tnr.make_occgrid_update(geo, rcfg, device="cpu")
    tparams = convert.implicit_volume_params(params, "cpu")
    for leaf in leaves(tparams):
        leaf.requires_grad_(True)
    for _ in range(2):  # the second update decays the first one's estimate
        jstate = jupdate(jstate, to_jax(params), jax.random.PRNGKey(0))
        tstate = tupdate(tstate, tparams, torch.Generator().manual_seed(0))
    assert not tstate.occ.requires_grad
    close(tstate.occ, jstate.occ, 1e-6, rtol=1e-5)
    np.testing.assert_array_equal(tstate.binary.numpy(), np.asarray(jstate.binary))
    assert 0 < float(tstate.binary.mean()) < 1  # it prunes some cells and keeps some


def test_render_rays_parameter_gradients_match_jax():
    """d loss / d parameters for a loss over comp_rgb, opacity, the
    per-sample normals and the perturbed normals — the analytic normal makes
    this a second derivative of the density MLP."""
    pair = render_pair("occgrid")
    for leaf, jg in zip(leaves(pair["tparams"]), leaves(pair["jgrads"])):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0
        assert np.abs(leaf.grad.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()


def test_export_density_grid_matches_jax():
    geo = convert.implicit_volume_config(JGEO)
    params = make_params(JGEO)
    tcell.reset_launch_counts()
    grid = tiv.export_density_grid(convert.implicit_volume_params(params, "cpu"), geo, 6, chunk=100)
    assert grid.shape == (6, 6, 6) and grid.dtype == np.float32
    assert tcell.plain_counts == {"hashgrid_cell_fwd": 3, "hashgrid_cell_bwd": 0}  # 216 points / 100
    ref = jiv.export_density_grid(to_jax(params), JGEO, 6, chunk=100)
    np.testing.assert_allclose(grid, ref, rtol=2e-5, atol=2e-5)
    assert grid[2:4, 2:4, 2:4].min() > grid[0, 0, 0]  # the blob sits in the middle

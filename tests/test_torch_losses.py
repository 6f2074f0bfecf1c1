"""The port's geometry losses, schedules and depth losses against the JAX
package's on the same seeded numpy inputs (CPU): values within 1e-5
relative, gradients within 1e-4 of the largest entry of the JAX gradient.

Also: a degenerate face under ``normal_consistency_loss`` and a vertex at
its ring centroid under ``laplacian_smoothing_loss`` keep finite gradients;
``arap_energy_quat_planar`` equals ``arap_energy`` with the same rotations;
``C`` / ``C_max`` / ``C_step`` against ``C`` / ``C_max`` / ``C_jax`` on
scalars, 4-lists and chained lists before, on and after every breakpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammesh4d_tpu.models.geometry.deformation as jdef
import dreammesh4d_tpu.ops.meshops as jmesh
import dreammesh4d_tpu.systems.zero123_system as jz123
import dreammesh4d_tpu.utils.schedule as jsched
from dreammesh4d_tpu.ops.quaternion import quat_to_matrix as j_quat_to_matrix
from dreammesh4d_tpu.utils.procedural import make_icosphere
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.geometry import deformation as tdef
from dreammesh4d_tpu_torch.ops import meshops as tmesh
from dreammesh4d_tpu_torch.systems import zero123_system as tz123
from dreammesh4d_tpu_torch.utils import schedule as tsched


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: with several test workers on the cores, torch's intra-op
    pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(seed=0, batch=()):
    mesh = make_icosphere(1, radius=0.7)
    verts, faces = np.asarray(mesh.v_pos, np.float32), np.asarray(mesh.t_pos_idx)
    rng = np.random.default_rng(seed)
    deformed = (verts + 0.05 * rng.normal(size=batch + verts.shape)).astype(np.float32)
    ring = jmesh.build_one_ring(faces, len(verts))
    pairs = jmesh.build_edge_adjacency(faces).face_pairs
    return verts, faces, deformed, ring, pairs


def _compare(j_fn, t_fn, x, value_rtol=1e-5, grad_tol=1e-4):
    """Value and gradient of a scalar function of one array on both sides."""
    jv, jg = jax.jit(jax.value_and_grad(j_fn))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tv = t_fn(xt)
    tv.backward()
    jv, jg = float(jv), np.asarray(jg)
    assert abs(float(tv.detach()) - jv) <= value_rtol * abs(jv) + 1e-12
    assert np.isfinite(xt.grad.numpy()).all()
    assert np.abs(xt.grad.numpy() - jg).max() <= grad_tol * np.abs(jg).max() + 1e-12
    return float(tv.detach())


def test_cotangent_weights():
    verts, faces, _, ring, _ = _mesh()
    t_ring = tmesh.build_one_ring(faces, len(verts))
    np.testing.assert_array_equal(t_ring.neighbor_idx, ring.neighbor_idx)
    got = tmesh.cotangent_weights(verts, faces, t_ring)
    ref = jmesh.cotangent_weights(verts, faces, ring)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert got.shape == ring.neighbor_idx.shape and got.max() > 0


@pytest.mark.parametrize("batch", [(), (3,)])
def test_normal_consistency_loss(batch):
    _, faces, deformed, _, pairs = _mesh(1, batch)
    v = _compare(lambda x: jmesh.normal_consistency_loss(x, jnp.asarray(faces), jnp.asarray(pairs)),
                 lambda x: tmesh.normal_consistency_loss(x, torch.as_tensor(faces).long(),
                                                         torch.as_tensor(pairs).long()), deformed)
    assert v > 0


def test_normal_consistency_loss_degenerate_face():
    _, faces, deformed, _, pairs = _mesh(2)
    deformed[faces[0, 1]] = deformed[faces[0, 0]]  # collapse an edge: zero-area faces
    _compare(lambda x: jmesh.normal_consistency_loss(x, jnp.asarray(faces), jnp.asarray(pairs)),
             lambda x: tmesh.normal_consistency_loss(x, torch.as_tensor(faces).long(),
                                                     torch.as_tensor(pairs).long()), deformed)


@pytest.mark.parametrize("batch", [(), (2,)])
def test_laplacian_smoothing_loss(batch):
    _, _, deformed, ring, _ = _mesh(3, batch)
    idx, mask = ring.neighbor_idx, ring.neighbor_mask
    _compare(lambda x: jmesh.laplacian_smoothing_loss(x, (jnp.asarray(idx), jnp.asarray(mask))),
             lambda x: tmesh.laplacian_smoothing_loss(x, (torch.as_tensor(idx).long(),
                                                          torch.as_tensor(mask))), deformed)


def test_laplacian_smoothing_loss_vertex_at_centroid():
    _, _, deformed, ring, _ = _mesh(4)
    idx, mask = ring.neighbor_idx, ring.neighbor_mask
    deformed[0] = deformed[idx[0][mask[0]]].astype(np.float64).mean(0)
    ring_t = (torch.as_tensor(idx).long(), torch.as_tensor(mask))
    x = torch.tensor(deformed, requires_grad=True)
    loss = tmesh.laplacian_smoothing_loss(x, ring_t)
    loss.backward()
    assert torch.isfinite(x.grad).all()
    jv, jg = jax.jit(jax.value_and_grad(jmesh.laplacian_smoothing_loss))(
        jnp.asarray(deformed), (jnp.asarray(idx), jnp.asarray(mask)))
    assert abs(float(loss.detach()) - float(jv)) <= 1e-5 * float(jv)
    # the direction of a ~1e-8 Laplacian is rounding noise on both sides:
    # compare the gradient away from that vertex's term
    far = np.ones(len(deformed), bool)
    far[0] = False
    far[idx[0][mask[0]]] = False
    jg = np.asarray(jg)
    assert np.abs(x.grad.numpy()[far] - jg[far]).max() <= 1e-4 * np.abs(jg).max()


def _arap_inputs(seed, batch=()):
    verts, faces, deformed, ring, _ = _mesh(seed, batch)
    w = jmesh.cotangent_weights(verts, faces, ring)
    rng = np.random.default_rng(seed + 10)
    q = np.float32([1, 0, 0, 0]) + 0.2 * rng.normal(size=batch + (len(verts), 4)).astype(np.float32)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return verts, deformed, ring.neighbor_idx, ring.neighbor_mask, w, q


@pytest.mark.parametrize("mode", ["given", "best_fit"])
def test_arap_energy(mode):
    verts, deformed, idx, mask, w, q = _arap_inputs(5)
    R = np.asarray(j_quat_to_matrix(jnp.asarray(q))) if mode == "given" else None
    v = _compare(
        lambda x: jmesh.arap_energy(jnp.asarray(verts), x, jnp.asarray(idx), jnp.asarray(mask),
                                    jnp.asarray(w), None if R is None else jnp.asarray(R)),
        lambda x: tmesh.arap_energy(torch.as_tensor(verts), x, torch.as_tensor(idx).long(),
                                    torch.as_tensor(mask), torch.as_tensor(w),
                                    None if R is None else torch.as_tensor(R.copy())),
        deformed, grad_tol=1e-4 if mode == "given" else 2e-4)
    assert v > 0


@pytest.mark.parametrize("batch", [(), (3,)])
def test_arap_energy_quat_planar(batch):
    verts, deformed, idx, mask, w, q = _arap_inputs(6, batch)
    idx_t = idx.T
    m_t = ((mask & (idx >= 0)).astype(np.float32) * w).T
    rest_p = verts.T
    e_ref_p = rest_p[:, None, :] - rest_p[:, idx_t]  # (3, K, V)
    v = _compare(
        lambda x: jmesh.arap_energy_quat_planar(jnp.asarray(e_ref_p), jnp.asarray(idx_t),
                                                jnp.asarray(m_t), x, jnp.asarray(q)),
        lambda x: tmesh.arap_energy_quat_planar(torch.as_tensor(e_ref_p),
                                                torch.as_tensor(idx_t).long(),
                                                torch.as_tensor(m_t), x, torch.as_tensor(q)),
        deformed)
    # the same energy as arap_energy with the same rotations, summed over the batch
    R = torch.as_tensor(np.array(j_quat_to_matrix(jnp.asarray(q))))
    per_elem = [tmesh.arap_energy(torch.as_tensor(verts), torch.as_tensor(d), torch.as_tensor(idx).long(),
                                  torch.as_tensor(mask), torch.as_tensor(w), r)
                for d, r in zip(deformed.reshape((-1,) + verts.shape), R.reshape((-1,) + R.shape[-3:]))]
    assert abs(float(sum(per_elem)) - v) <= 1e-5 * v
    # gradient to the rotations as well
    _compare(
        lambda x: jmesh.arap_energy_quat_planar(jnp.asarray(e_ref_p), jnp.asarray(idx_t),
                                                jnp.asarray(m_t), jnp.asarray(deformed), x),
        lambda x: tmesh.arap_energy_quat_planar(torch.as_tensor(e_ref_p),
                                                torch.as_tensor(idx_t).long(),
                                                torch.as_tensor(m_t), torch.as_tensor(deformed), x),
        q)


def test_tv_loss():
    img = np.random.default_rng(7).random((2, 9, 11, 3)).astype(np.float32)
    _compare(jmesh.tv_loss, tmesh.tv_loss, img)


@pytest.mark.parametrize("only_time", [False, True])
def test_plane_tv_loss(only_time):
    # the port's seeded planes, carried to the JAX function (the loss reads only the grids)
    cfg = tdef.DeformationConfig(net_width=8, grid_channels=4, base_resolution=(6, 5, 4, 3),
                                 multires=(1, 2))
    grids = tdef.init_deformation(cfg, torch.Generator().manual_seed(0), device="cpu")["grids"]
    rng = np.random.default_rng(8)
    params = {"grids": [[(p.numpy() + 0.3 * rng.normal(size=tuple(p.shape))).astype(np.float32)
                         for p in planes] for planes in grids]}
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jdef.plane_tv_loss(p, only_time_planes=only_time)))(
        jax.tree.map(jnp.asarray, params))
    tp = convert.deformation_params(params, "cpu")
    leaves = [p.requires_grad_(True) for planes in tp["grids"] for p in planes]
    tv = tdef.plane_tv_loss(tp, only_time_planes=only_time)
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) <= 1e-5 * float(jv)
    j_leaves = [np.asarray(p) for planes in jg["grids"] for p in planes]
    scale = max(np.abs(g).max() for g in j_leaves)
    for i, (t_leaf, j_leaf) in enumerate(zip(leaves, j_leaves)):
        got = np.zeros_like(j_leaf) if t_leaf.grad is None else t_leaf.grad.numpy()
        assert np.abs(got - j_leaf).max() <= 1e-4 * scale
        if only_time and 3 not in jdef._COMBS[i % 6]:
            assert np.abs(got).max() == 0.0


def _depth_inputs():
    rng = np.random.default_rng(9)
    gt = rng.uniform(1.0, 3.0, size=(2, 12, 12)).astype(np.float32)
    pred = (0.7 * gt + 0.3 + 0.05 * rng.normal(size=gt.shape)).astype(np.float32)
    mask = (rng.random(gt.shape) > 0.4).astype(np.float32)
    return pred, gt, mask


@pytest.mark.parametrize("name", ["masked_lstsq_depth_loss", "masked_pearson"])
def test_depth_losses(name):
    pred, gt, mask = _depth_inputs()
    _compare(lambda x: getattr(jz123, name)(x, jnp.asarray(gt), jnp.asarray(mask)),
             lambda x: getattr(tz123, name)(x, torch.as_tensor(gt), torch.as_tensor(mask)), pred)


SCHEDULES = [
    0.0, 5, 0.1, 5000.0,
    [200, 500.0, 5000.0, 1000],  # lambda_mask of sugar_dynamic_dg.yaml
    [10.0, 1.0, 50],  # 3-element form
    [100, 7.0, 5.0, 150, 10.0, 200],  # chained
    [200, 500.0, 5000.0, 1000, 100.0, 1500, 100.0, 1800],  # chained, three segments
]


@pytest.mark.parametrize("value", SCHEDULES, ids=[str(v) for v in SCHEDULES])
def test_schedules(value):
    assert tsched.C_max(value) == jsched.C_max(value)
    breaks = [0]
    if isinstance(value, list):
        v = [0] + value if len(value) == 3 else value
        breaks = [int(v[0])] + [int(v[i]) for i in range(3, len(v), 2)]
    steps = sorted({max(s + d, 0) for s in breaks for d in (-50, -1, 0, 1, 17)} | {0, 10_000})
    for step in steps:
        ref = float(jsched.C_jax(value, jnp.asarray(step, jnp.int32)))
        got = tsched.C_step(value, step)
        assert isinstance(got, float)
        # C_jax evaluates in float32, C_step in Python floats
        assert abs(got - ref) <= 1e-5 * max(abs(ref), 1.0), (step, got, ref)
        assert tsched.C(value, 0, step) == jsched.C(value, 0, step)

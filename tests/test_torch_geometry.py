"""PyTorch port vs the JAX package: math ops, cameras, SuGaR geometry, the
deformation graph, the HexPlane field and the skinning chain.

Inputs are made with numpy from a seed and handed to both packages; JAX
structures cross over through ``dreammesh4d_tpu_torch.convert``.  Tolerance
atol = rtol = 1e-5 (float32 on the CPU in both; the chains differ only in
summation order), the deformation graph bit-exact in its indices and 1e-6
in node positions and weights.  The JAX references run under ``jax.jit``
(eagerly every op compiles on first use), and the scenes and fields two
tests share are built once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammesh4d_tpu.models.geometry.deformation as jdef
import dreammesh4d_tpu.models.geometry.deformation_graph as jgraph
import dreammesh4d_tpu.models.geometry.dynamic_sugar as jdyn
import dreammesh4d_tpu.models.geometry.sugar as jsugar
import dreammesh4d_tpu.ops.cameras as jcam
import dreammesh4d_tpu.ops.meshops as jmesh
import dreammesh4d_tpu.ops.quaternion as jq
import dreammesh4d_tpu.export.mesh_io as j_mesh_io
import dreammesh4d_tpu.ops.sh as jsh
from dreammesh4d_tpu.utils.procedural import make_icosphere as j_icosphere
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.export import mesh_io as t_mesh_io
from dreammesh4d_tpu_torch.models.geometry import deformation as tdef
from dreammesh4d_tpu_torch.models.geometry import deformation_graph as tgraph
from dreammesh4d_tpu_torch.models.geometry import dynamic_sugar as tdyn
from dreammesh4d_tpu_torch.models.geometry import sugar as tsugar
from dreammesh4d_tpu_torch.ops import cameras as tcam
from dreammesh4d_tpu_torch.ops import meshops as tmesh
from dreammesh4d_tpu_torch.ops import quaternion as tq
from dreammesh4d_tpu_torch.ops import sh as tsh
from dreammesh4d_tpu_torch.utils.procedural import make_icosphere as t_icosphere


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: with several test workers on the cores, torch's intra-op
    pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-5)
DEV = "cpu"
SMALL_DEFORM = dict(net_width=16, grid_channels=4, base_resolution=(8, 8, 8, 5), multires=(1, 2))


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach().cpu() if torch.is_tensor(port) else port),
                               np.asarray(ref), **(tol or TOL))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# math ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_to_rgb(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tsh.sh_to_rgb(deg, _t(sh), _t(d)), jax.jit(jsh.sh_to_rgb, static_argnums=0)(deg, sh, d))


@functools.lru_cache(maxsize=None)
def _quat_cases():
    rng = np.random.default_rng(0)
    q, q2 = _quats(rng, 64), _quats(rng, 64)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32) * 0.3
    w = rng.random((64, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    idx = rng.integers(0, 64, size=(64, 4))
    near_id = np.concatenate([np.ones((64, 1)), 1e-3 * rng.normal(size=(64, 3))], -1).astype(np.float32)
    R, dq, dq_idx = jax.jit(lambda q, t, idx: (jq.quat_to_matrix(q), jq.dq_from_quat_translation(q, t),
                                               jq.dq_from_quat_translation(q[idx], t[idx])))(q, t, idx)
    return {
        "quat_normalize": ((q * 3.0,), {}),
        "quat_multiply": ((q, q2), {}),
        "quat_conjugate": ((q,), {}),
        "quat_apply": ((q, p), {}),
        "quat_to_matrix": ((q,), {}),
        "matrix_to_quat": ((np.asarray(R),), {}),
        "quat_log": ((np.concatenate([q, near_id]),), {}),
        "quat_exp": ((p,), {}),
        "fuse_rotations": ((idx, w, q), {}),
        "dq_from_quat_translation": ((q, t), {}),
        "dq_normalize": ((np.concatenate([q * 2.0, q2], -1),), {}),
        "dq_apply": ((np.asarray(dq), p), {}),
        "dq_blend": ((np.asarray(dq_idx), w), {}),
    }


@pytest.mark.parametrize("name", sorted(_quat_cases()))
def test_quaternion_ops(name):
    args, _ = _quat_cases()[name]
    ref = jax.jit(getattr(jq, name))(*(jnp.asarray(a) for a in args))
    port = getattr(tq, name)(*(_t(a) for a in args))
    _close(port, ref)


def test_gs_cameras():
    el, az, dist = np.float32([5.0, 30.0, -20.0]), np.float32([0.0, 75.0, 200.0]), np.float32([3.8, 2.2, 2.5])
    fov = np.radians(20.0)

    @jax.jit
    def reference(el, az, dist):
        pos = jcam.camera_position_from_spherical(el, az, dist)
        c2w = jcam.look_at_c2w(pos)
        return (pos, c2w, jcam.get_projection_matrix_gaussian(0.01, 100.0, fov, fov),
                [jcam.get_cam_info_gaussian(c2w[i], fov, fov, 0.01, 100.0) for i in range(3)])

    pos_j, c2w_j, proj_j, info_j = reference(el, az, dist)
    pos_t = tcam.camera_position_from_spherical(el, az, dist, device=DEV)
    _close(pos_t, pos_j)
    c2w_t = tcam.look_at_c2w(pos_t)
    _close(c2w_t, c2w_j)
    _close(tcam.get_projection_matrix_gaussian(0.01, 100.0, fov, fov, device=DEV), proj_j)
    for i in range(3):
        ij = info_j[i]
        it = tcam.get_cam_info_gaussian(c2w_t[i], fov, fov, 0.01, 100.0)
        for a, b in zip(it, ij):
            _close(a, b, atol=2e-5, rtol=1e-5)


def test_face_normals():
    mesh = j_icosphere(1)
    rng = np.random.default_rng(1)
    v = (mesh.v_pos + 0.05 * rng.normal(size=mesh.v_pos.shape)).astype(np.float32)
    _close(tmesh.face_normals(_t(v), _t(mesh.t_pos_idx).long()),
           jax.jit(jmesh.face_normals)(v, mesh.t_pos_idx))


# ---------------------------------------------------------------------------
# SuGaR geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["obj", "ply"])
def test_load_mesh(tmp_path, fmt):
    mesh = j_icosphere(1)
    path = str(tmp_path / f"mesh.{fmt}")
    if fmt == "obj":
        j_mesh_io.save_obj(path, mesh)
    else:
        j_mesh_io.save_ply_mesh(path, mesh)
    a, b = t_mesh_io.load_mesh(path), j_mesh_io.load_mesh(path)
    for k in ("v_pos", "t_pos_idx", "v_rgb"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_icosphere_matches():
    a, b = t_icosphere(2, 0.6), j_icosphere(2, 0.6)
    np.testing.assert_array_equal(a.v_pos, b.v_pos)
    np.testing.assert_array_equal(a.t_pos_idx, b.t_pos_idx)
    np.testing.assert_array_equal(a.v_rgb, b.v_rgb)


def test_create_sugar_and_attributes():
    mesh = j_icosphere(1, 0.7)
    jp, js = jsugar.create_sugar(jsugar.SuGaRConfig(), mesh)
    tp, ts = tsugar.create_sugar(tsugar.SuGaRConfig(), mesh, device=DEV)
    for k in tsugar.SuGaRParams._fields:
        _close(getattr(tp, k), getattr(jp, k))
    for k in ("faces", "bary_coords", "edge_face_pairs", "ring_idx", "ring_mask"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)))
    assert (ts.n_per_face, ts.sh_degree) == (js.n_per_face, js.sh_degree)
    # perturbed vertices and in-plane rotations exercise every branch of
    # the face frame -> quaternion conversion
    rng = np.random.default_rng(2)
    pts = (np.asarray(jp.points) + 0.03 * rng.normal(size=jp.points.shape)).astype(np.float32)
    crot = rng.normal(size=jp.complex_rot.shape).astype(np.float32)
    jp2 = jp._replace(points=jnp.asarray(pts), complex_rot=jnp.asarray(crot))
    tp2 = convert.sugar_params(jax.tree.map(np.asarray, jp2), device=DEV)
    ja = jax.jit(lambda p: jsugar.gaussian_attributes(p, js))(jp2)
    ta = tsugar.gaussian_attributes(tp2, ts)
    for a, b in zip(ta, ja):
        _close(a, b)


@pytest.mark.parametrize("mode", ["geodisc", "eucdisc"])
def test_deformation_graph_same_seed(mode):
    mesh = j_icosphere(2, 0.6)
    gj = jgraph.build_deformation_graph(mesh.v_pos, mesh.t_pos_idx, 24, 4, mode=mode, seed=3)
    gt = tgraph.build_deformation_graph(mesh.v_pos, mesh.t_pos_idx, 24, 4, mode=mode, seed=3)
    np.testing.assert_array_equal(gt.neighbor_idx, gj.neighbor_idx)
    np.testing.assert_array_equal(gt.node_anchor_vertex, gj.node_anchor_vertex)
    np.testing.assert_allclose(gt.node_xyz, gj.node_xyz, atol=1e-6)
    np.testing.assert_allclose(gt.neighbor_weights, gj.neighbor_weights, atol=1e-6)


# ---------------------------------------------------------------------------
# HexPlane field + dynamic chain
# ---------------------------------------------------------------------------


def perturbed_deformation(cfg, seed=0, head_scale=1e-2):
    """JAX ``init_deformation`` with every zero-init head filled at
    ``head_scale`` and the time planes moved off 1, from a seeded numpy RNG
    (a fresh field deforms by exactly nothing and ignores time)."""
    params = jax.tree.map(np.copy, _init_deformation(cfg, seed))
    rng = np.random.default_rng(seed)
    for name in ("head_dx", "head_dstrain", "head_drot", "head_dopacity"):
        for layer in ("res", "out"):
            for k in ("w", "b"):
                shape = params[name][layer][k].shape
                params[name][layer][k] = (head_scale * rng.normal(size=shape)).astype(np.float32)
    for planes in params["grids"]:
        for i, (a, b) in enumerate(jdef._COMBS):
            if 3 in (a, b):
                planes[i] = (planes[i] + 0.3 * rng.normal(size=planes[i].shape)).astype(np.float32)
    return params


def test_forward_dynamic_delta():
    cfg = jdef.DeformationConfig(**SMALL_DEFORM)
    params = perturbed_deformation(cfg, head_scale=0.1)
    rng = np.random.default_rng(4)
    # points and times past the bounds exercise the bilinear border clip
    pts = rng.uniform(-1.2, 1.2, size=(3, 40, 3)).astype(np.float32)
    ts = rng.uniform(-1.1, 1.1, size=(3, 40)).astype(np.float32)
    dj = jax.jit(lambda p, x, t: jdef.forward_dynamic_delta(p, cfg, x, t))(params, pts, ts)
    dt = tdef.forward_dynamic_delta(convert.deformation_params(params, DEV), convert.config(cfg),
                                    _t(pts), _t(ts))
    for a, b in zip(dt, dj):
        _close(a, b)
    s = rng.normal(size=(5, 6)).astype(np.float32)
    _close(tdef.strain_tensor_to_matrix(_t(s)), jax.jit(jdef.strain_tensor_to_matrix)(s))


_INITS = {}


def _init_deformation(cfg, seed):
    """The JAX ``init_deformation`` under one jit, as numpy (once per config and seed)."""
    key = (repr(cfg), seed)
    if key not in _INITS:
        _INITS[key] = jax.tree.map(np.asarray, jax.jit(lambda k: jdef.init_deformation(cfg, k))(
            jax.random.PRNGKey(seed)))
    return _INITS[key]


@functools.lru_cache(maxsize=None)
def _sugar_scene():
    """The JAX SuGaR of icosphere(1, 0.6), built once."""
    return jsugar.create_sugar(jsugar.SuGaRConfig(), j_icosphere(1, 0.6))


def _dynamic_scene(skinning, use_graph=True, mode="deformation"):
    jp, js = _sugar_scene()
    cfg = jdyn.DynamicSuGaRConfig(n_dg_nodes=12, skinning_method=skinning, use_deform_graph=use_graph,
                                  dynamic_mode=mode, num_frames=4,
                                  deformation=jdef.DeformationConfig(**SMALL_DEFORM))
    jst = jdyn.build_dynamic_static(cfg, js, np.asarray(jp.points))
    return jp, jst, cfg


@pytest.mark.parametrize("skinning", ["hybrid", "lbs", "dqs"])
def test_skinning_and_timed_gs(skinning):
    jp, jst, cfg = _dynamic_scene(skinning)
    params = perturbed_deformation(cfg.deformation, head_scale=0.1)
    ts = np.float32([0.1, 0.6])
    # the JAX side jitted: eagerly every op compiles on first use
    jnode = jax.jit(lambda p, t: jdyn.timed_node_attrs(p, cfg.deformation, jst, t))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ts))
    tst = convert.dynamic_static(jax.tree.map(np.asarray, jst), DEV)
    tp = convert.sugar_params(jax.tree.map(np.asarray, jp), DEV)
    tnode = tdyn.timed_node_attrs(convert.deformation_params(params, DEV),
                                  convert.config(cfg.deformation), tst, _t(ts))
    for a, b in zip(tnode, jnode):
        _close(a, b)
    # skin the SAME node attributes on both sides
    node = tdyn.NodeAttrs(*(_t(np.asarray(x)) for x in jnode))
    jvert = jax.jit(lambda pts, n: jdyn.skin_vertices(jst, pts, n))(jp.points, jnode)
    tvert = tdyn.skin_vertices(tst, tp.points, node)
    for a, b in zip(tvert, jvert):
        if b is not None:
            _close(a, b)
    jgs = jax.jit(lambda p, v: jdyn.timed_gs_attrs(p, jst, v))(jp, jvert)
    tgs = tdyn.timed_gs_attrs(tp, tst, tdyn.VertexAttrs(*(None if x is None else _t(np.asarray(x))
                                                          for x in jvert)))
    for a, b in zip(tgs, jgs):
        _close(a, b)


@pytest.mark.parametrize("use_graph,mode", [(True, "discrete"), (False, "discrete"),
                                            (False, "deformation")])
def test_timed_all_other_modes(use_graph, mode):
    jp, jst, cfg = _dynamic_scene("hybrid", use_graph, mode)
    rng = np.random.default_rng(5)
    if mode == "discrete":
        params = jax.tree.map(np.asarray, jdyn.init_discrete_params(cfg, jp.points.shape[0]))
        params = {k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
    else:
        params = perturbed_deformation(cfg.deformation, head_scale=0.1)
    ts = np.float32([0.0, 0.4, 1.0])
    jgs, jvert = jax.jit(lambda p, t: jdyn.timed_all(jp, p, cfg.deformation, jst, t))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ts))
    tgs, tvert = tdyn.timed_all(convert.sugar_params(jax.tree.map(np.asarray, jp), DEV),
                                convert.deformation_params(params, DEV), convert.config(cfg.deformation),
                                convert.dynamic_static(jax.tree.map(np.asarray, jst), DEV), _t(ts))
    for a, b in zip(tuple(tgs) + tuple(tvert), tuple(jgs) + tuple(jvert)):
        if b is not None:
            _close(a, b)

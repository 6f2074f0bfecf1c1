"""The port's sketch-shape loss (``ops/shape_loss.py``) and its trilinear
lookup (``models/geometry/volume_grid._trilerp``) against the JAX package
(CPU).

The guide: a closed 80-face mesh (an icosphere of one subdivision,
stretched and bent so that no axis is symmetric) written as an OBJ by
numpy.  Bands:

- ``winding_number`` at 512 seeded points in [-1, 1]³ within 1e-5;
- ``_trilerp`` of a seeded (3, 5, 6, 7) grid at 300 points (some outside
  [0, 1]) within 1e-6;
- ``ShapeLoss`` at ``grid_res=16``: the occupancy grid equal except where
  the JAX winding number lies within 1e-4 of 0.5, the weight grid within
  1e-6;
- the loss and d loss/dσ at 4096 points drawn over [-2, 2]³ (the zoo
  step's box; most clip to the grids' [-1, 1]³) within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreammesh4d_tpu.export.mesh_io import load_mesh
from dreammesh4d_tpu.models.geometry import volume_grid as jvg
from dreammesh4d_tpu.ops import shape_loss as jsl
from dreammesh4d_tpu_torch.models.geometry import volume_grid as pvg
from dreammesh4d_tpu_torch.ops import shape_loss as psl
from dreammesh4d_tpu_torch.utils.procedural import make_icosphere

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_guide_obj(path) -> str:
    """A closed, asymmetric 80-face mesh as an OBJ at ``path``."""
    mesh = make_icosphere(1, radius=1.0)
    v = np.asarray(mesh.v_pos, np.float64)
    v = v * np.array([1.4, 0.8, 1.0]) + np.stack([0.3 * np.sin(2 * v[:, 1]), 0.2 * v[:, 0] ** 2,
                                                  0.1 * v[:, 2] * v[:, 0]], -1) + np.array([0.2, -0.1, 0.3])
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in np.asarray(mesh.t_pos_idx)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    assert len(mesh.t_pos_idx) == 80
    return str(path)


@pytest.fixture(scope="module")
def guide(tmp_path_factory):
    return write_guide_obj(tmp_path_factory.mktemp("guide") / "guide.obj")


@pytest.fixture(scope="module")
def losses(guide):
    return psl.ShapeLoss(guide, grid_res=16, device="cpu"), jsl.ShapeLoss(guide, grid_res=16)


def test_winding_number_matches_jax(guide):
    mesh = load_mesh(guide)
    pts = np.random.default_rng(0).uniform(-1, 1, size=(512, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jsl.winding_number)(jnp.asarray(pts), jnp.asarray(mesh.v_pos),
                                                  jnp.asarray(mesh.t_pos_idx)))
    got = psl.winding_number(torch.as_tensor(pts), torch.as_tensor(mesh.v_pos),
                             torch.as_tensor(mesh.t_pos_idx), chunk=100).numpy()
    assert np.abs(got - want).max() <= 1e-5
    inside = want > 0.5
    assert 20 < inside.sum() < 492 and np.abs(want[inside] - 1).max() < 1e-3  # closed: 1 inside, 0 out


def test_trilerp_matches_jax():
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(3, 5, 6, 7)).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, size=(300, 3)).astype(np.float32)
    want = np.asarray(jvg._trilerp(jnp.asarray(grid), jnp.asarray(x)))
    got = pvg._trilerp(torch.as_tensor(grid), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_shape_loss_grids_match_jax(losses, guide):
    port, ref = losses
    R = 16
    axis = np.linspace(-1.0, 1.0, R, dtype=np.float32)
    pts = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    want = np.asarray(ref.occ_grid)
    # the JAX winding number at the cells, to leave out those within 1e-4 of 0.5
    mesh = load_mesh(guide)
    vv = np.asarray(mesh.v_pos, np.float32)
    vv = vv - vv.mean(0)
    vv = vv / np.linalg.norm(vv, axis=1).max() * ref.mesh_scale @ jsl._GUIDE_ROT.T
    wn = np.asarray(jsl.winding_number(jnp.asarray(pts), jnp.asarray(vv), jnp.asarray(mesh.t_pos_idx)))
    sure = (np.abs(wn - 0.5) >= 1e-4).reshape(R, R, R)
    got = port.occ_grid.numpy()
    assert sure.mean() > 0.99 and 0 < want.sum() < want.size
    np.testing.assert_array_equal(got[sure], want[sure])
    np.testing.assert_allclose(port.weight_grid.numpy(), np.asarray(ref.weight_grid), rtol=0, atol=1e-6)
    assert port.n_faces == 80


def test_shape_loss_and_its_gradient_match_jax(losses):
    port, ref = losses
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2.0, 2.0, size=(4096, 3)).astype(np.float32)
    sig = rng.gamma(2.0, 3.0, size=(4096,)).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(lambda s: ref(jnp.asarray(pts), s)))(jnp.asarray(sig))
    s = torch.tensor(sig, requires_grad=True)
    got = port(torch.as_tensor(pts), s)
    got.backward()
    got = float(got.detach())
    assert float(want) > 0 and abs(got - float(want)) <= 1e-5 * float(want)
    want_g = np.asarray(want_g)
    assert np.abs(s.grad.numpy() - want_g).max() <= 1e-5 * np.abs(want_g).max()
    # most points lie outside the grids' [-1, 1]^3 and clip to its boundary (ROADMAP watch list)
    assert (np.abs(pts).max(1) > 1.0).mean() > 0.8

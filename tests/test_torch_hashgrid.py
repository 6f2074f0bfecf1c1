"""The port's hash-grid encodings against the JAX package's (CPU).

Inputs come from a seeded numpy RNG and go to both packages.  The JAX cell
encode runs twice: as its XLA twin (``hashgrid_encode_cell``) and as the
Pallas kernel in interpret mode (``encode_cell_with_grad(..., interpret=True)``),
the way ``tests/test_hashgrid_cell.py`` runs it.  The port's cell encode runs
its plain PyTorch version, which is what CPU tensors get.

Tolerances: row indices exactly; feats rtol 1e-5 / atol 1e-5, dfeats rtol
1e-5 / atol 1e-4 (tables scaled to ~0.1, dfeats carry the level's
resolution); table gradients rtol 1e-4 with an absolute floor of 1e-4 of the
gradient's max (float32 sums over the points of a cell, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import jit_fast

import dreammesh4d_tpu.ops.hashgrid as jhg
from dreammesh4d_tpu.ops.hashgrid_pallas import encode_cell_with_grad as j_encode_cell
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.ops import hashgrid as thg
from dreammesh4d_tpu_torch.ops import hashgrid_cell as tcell


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: with several test workers on the cores, torch's intra-op
    pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JCFG = jhg.HashGridConfig(n_levels=4, n_features_per_level=2, log2_hashmap_size=8,
                          base_resolution=4, per_level_scale=2.0, layout="cell")
CFG = convert.hashgrid_config(JCFG)
N = 300


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    tables = rng.uniform(-0.1, 0.1, (JCFG.n_levels, 1 << JCFG.log2_hashmap_size, 16)).astype(np.float32)
    x = rng.uniform(0.01, 0.99, (N, 3)).astype(np.float32)
    g_feats = rng.normal(size=(N, JCFG.out_dim)).astype(np.float32)
    g_dfeats = rng.normal(size=(N, JCFG.out_dim, 3)).astype(np.float32)
    return tables, x, g_feats, g_dfeats


@pytest.fixture(scope="module")
def jax_cell(data):
    """The JAX side, each function traced once: XLA twin and interpret-mode
    kernel outputs, and the kernel's table gradient for both cotangents."""
    tables, x, g_feats, g_dfeats = (jnp.asarray(a) for a in data)
    twin = jax.jit(lambda t: jhg.hashgrid_encode_cell({"tables": t}, JCFG, x, with_grad=True))(tables)
    kernel = jax.jit(lambda t: j_encode_cell({"tables": t}, JCFG, x, interpret=True))(tables)

    def loss(t, wf, wd):
        f, d = j_encode_cell({"tables": t}, JCFG, x, interpret=True)
        return wf * (f * g_feats).sum() + wd * (d * g_dfeats).sum()

    grad = jax.jit(jax.grad(loss))
    grads = {k: np.asarray(grad(tables, *w)) for k, w in
             (("both", (1.0, 1.0)), ("feats", (1.0, 0.0)), ("dfeats", (0.0, 1.0)))}
    return tuple(np.asarray(a) for a in twin), tuple(np.asarray(a) for a in kernel), grads


def test_level_resolutions():
    for jcfg in (JCFG, jhg.HashGridConfig(), jhg.HashGridConfig(n_levels=12, base_resolution=7,
                                                                 per_level_scale=1.3819)):
        assert convert.hashgrid_config(jcfg).level_resolutions() == jcfg.level_resolutions()
    res = thg.HashGridConfig().level_resolutions()
    assert res[0] == 16 and res[-1] == 4095  # floor(16 · 1.447…^15) = floor(4095.99…)


@pytest.mark.parametrize("jcfg", [
    JCFG,  # level 0 dense (4³ ≤ 256), levels 1..3 hashed
    jhg.HashGridConfig(n_levels=1, log2_hashmap_size=16, base_resolution=4096, layout="cell"),
    jhg.HashGridConfig(n_levels=16, log2_hashmap_size=16, layout="cell"),  # the shipped widths
], ids=["small", "res4096", "shipped"])
def test_cell_indices_exact(jcfg):
    rng = np.random.default_rng(1)
    x = rng.uniform(0.0, 1.0, (2000, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.25, 0.5, 0.75], [0.999999, 0.5, 0.5],
             [0.5, 1, 0], [1e-7, 1e-7, 1e-7], [0.5, 0.5, 0.5]]
    ref = np.asarray(jhg.cell_indices(jcfg, jnp.asarray(x)))
    got = thg.cell_indices(convert.hashgrid_config(jcfg), torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    T = 1 << jcfg.log2_hashmap_size
    hashed = [l for l, r in enumerate(jcfg.level_resolutions()) if r ** 3 > T]
    assert hashed and len(np.unique(got[hashed[-1]])) > min(T, 2000) // 4  # the hash spreads


def test_hash_uses_uint32_wraparound():
    """iy · 2654435761 exceeds 2³¹ for every iy ≥ 1: the hash must wrap at
    32 bits, not at 63."""
    x0 = torch.tensor([[3, 4000, 4095], [4095, 4095, 4095], [0, 1, 0]])
    got = thg._cell_index(x0, 4096, 1 << 16).numpy()
    ref = [(ix ^ (iy * 2654435761 % 2**32) ^ (iz * 805459861 % 2**32)) % 2**16
           for ix, iy, iz in x0.tolist()]
    np.testing.assert_array_equal(got, ref)


def test_cell_encode_matches_twin_and_kernel(data, jax_cell):
    tables, x, _, _ = data
    twin, kernel, _ = jax_cell
    tcell.reset_launch_counts()
    feats, dfeats = tcell.encode_cell_with_grad({"tables": torch.tensor(tables)}, CFG, torch.tensor(x))
    assert feats.shape == (N, 8) and dfeats.shape == (N, 8, 3)
    for ref_f, ref_d in (twin, kernel):
        np.testing.assert_allclose(feats.numpy(), ref_f, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dfeats.numpy(), ref_d, rtol=1e-5, atol=1e-4)
    # the free function of ops/hashgrid.py is the same plain version
    f2, d2 = thg.hashgrid_encode_cell({"tables": torch.tensor(tables)}, CFG, torch.tensor(x),
                                      with_grad=True)
    assert torch.equal(f2, feats) and torch.equal(d2, dfeats)
    assert tcell.plain_counts["hashgrid_cell_fwd"] == 1 and tcell.launch_counts["hashgrid_cell_fwd"] == 0


@pytest.mark.parametrize("which", ["both", "feats", "dfeats"])
def test_table_gradients_match_kernel(data, jax_cell, which):
    tables, x, g_feats, g_dfeats = data
    ref = jax_cell[2][which]
    t = torch.tensor(tables, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    feats, dfeats = tcell.encode_cell_with_grad({"tables": t}, CFG, xt)
    loss = 0.0
    if which in ("both", "feats"):
        loss = loss + (feats * torch.tensor(g_feats)).sum()
    if which in ("both", "dfeats"):
        loss = loss + (dfeats * torch.tensor(g_dfeats)).sum()
    loss.backward()
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    # the explicit index_add_ backward equals autograd through the plain forward
    t2 = torch.tensor(tables, requires_grad=True)
    f2, d2 = thg.hashgrid_encode_cell({"tables": t2}, CFG, torch.tensor(x), with_grad=True)
    loss2 = 0.0
    if which in ("both", "feats"):
        loss2 = loss2 + (f2 * torch.tensor(g_feats)).sum()
    if which in ("both", "dfeats"):
        loss2 = loss2 + (d2 * torch.tensor(g_dfeats)).sum()
    loss2.backward()
    np.testing.assert_allclose(t.grad.numpy(), t2.grad.numpy(), rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    assert xt.grad is None  # the contract: no gradient for the query points


def test_query_point_gradient_contract(data):
    """The cell encode returns no gradient for x (the JAX kernel: zeros),
    while the JAX XLA twin — and the port's free plain function — return the
    true one."""
    tables, x, g_feats, _ = data
    jt, jx, jg = jnp.asarray(tables), jnp.asarray(x[:32]), jnp.asarray(g_feats[:32])
    g_kernel = jax.jit(jax.grad(lambda p: (j_encode_cell({"tables": jt}, JCFG, p, interpret=True)[0] * jg).sum()))(jx)
    g_twin = jax.jit(jax.grad(lambda p: (jhg.hashgrid_encode_cell({"tables": jt}, JCFG, p) * jg).sum()))(jx)
    assert np.abs(np.asarray(g_kernel)).max() == 0.0
    assert np.abs(np.asarray(g_twin)).max() > 0.1

    xt = torch.tensor(x[:32], requires_grad=True)
    t = torch.tensor(tables, requires_grad=True)
    feats, _ = tcell.encode_cell_with_grad({"tables": t}, CFG, xt)
    (feats * torch.tensor(g_feats[:32])).sum().backward()
    assert xt.grad is None and t.grad is not None
    xt2 = torch.tensor(x[:32], requires_grad=True)
    (thg.hashgrid_encode_cell({"tables": torch.tensor(tables)}, CFG, xt2)
     * torch.tensor(g_feats[:32])).sum().backward()
    np.testing.assert_allclose(xt2.grad.numpy(), np.asarray(g_twin), rtol=1e-4, atol=1e-4)


def test_duplicate_cell_gradient_accumulation(data):
    """257 points in one cell: their gradients add up in that cell's row."""
    tables = data[0]
    x = np.tile(np.float32([[0.31, 0.52, 0.73]]), (257, 1))
    jt = jnp.asarray(tables)
    ref = np.asarray(jax.jit(jax.grad(lambda t: j_encode_cell({"tables": t}, JCFG, jnp.asarray(x),
                                                              interpret=True)[0].sum()))(jt))
    t = torch.tensor(tables, requires_grad=True)
    tcell.encode_cell_with_grad({"tables": t}, CFG, torch.tensor(x))[0].sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert [len(np.unique(np.nonzero(t.grad[l].numpy())[0])) for l in range(4)] == [1, 1, 1, 1]
    t1 = torch.tensor(tables, requires_grad=True)
    tcell.encode_cell_with_grad({"tables": t1}, CFG, torch.tensor(x[:1]))[0].sum().backward()
    assert float(t.grad.abs().max()) > 0.9 * 257 * float(t1.grad.abs().max())


def test_level_mask_and_features_only(data, jax_cell):
    tables, x, _, _ = data
    mask = np.float32([1.0, 1.0, 0.0, 0.0])
    ref_f, ref_d = j_encode_cell({"tables": jnp.asarray(tables)}, JCFG, jnp.asarray(x),
                                 level_mask=jnp.asarray(mask), interpret=True)
    params = {"tables": torch.tensor(tables)}
    feats, dfeats = tcell.encode_cell_with_grad(params, CFG, torch.tensor(x), level_mask=mask)
    assert float(feats[:, 4:].abs().max()) == 0.0 and float(dfeats[:, 4:].abs().max()) == 0.0
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_f), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dfeats.numpy(), np.asarray(ref_d), rtol=1e-5, atol=1e-4)
    only_f, none = tcell.encode_cell_with_grad(params, CFG, torch.tensor(x), level_mask=mask,
                                               with_dfeats=False)
    assert none is None and torch.equal(only_f, feats)
    # leading batch dimensions are kept
    f3, d3 = tcell.encode_cell_with_grad(params, CFG, torch.tensor(x).reshape(10, 30, 3))
    assert f3.shape == (10, 30, 8) and d3.shape == (10, 30, 8, 3)
    np.testing.assert_allclose(f3.reshape(N, 8).numpy(), jax_cell[0][0], rtol=1e-5, atol=1e-5)


def test_cell_wrapper_refuses_what_the_kernel_does_not_take(data):
    tables, x, _, _ = data
    bad = thg.HashGridConfig(n_levels=4, n_features_per_level=4, log2_hashmap_size=8, layout="cell")
    with pytest.raises(ValueError):
        tcell.encode_cell_with_grad({"tables": torch.tensor(tables)}, bad, torch.tensor(x))
    with pytest.raises(ValueError):  # table shape against the config
        tcell.encode_cell_with_grad({"tables": torch.tensor(tables[:, :128])}, CFG, torch.tensor(x))
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA tensors only
        tcell.encode_cell_fwd_cuda(torch.tensor(tables), torch.tensor(x), CFG)


def test_corner_layout_and_frequency_encode():
    jcfg = jhg.HashGridConfig(n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
                              base_resolution=4, per_level_scale=2.0)  # levels 2, 3 hashed
    cfg = convert.hashgrid_config(jcfg)
    rng = np.random.default_rng(2)
    tables = rng.uniform(-0.1, 0.1, (4, 1 << 10, 2)).astype(np.float32)
    x = rng.uniform(0, 1, (5, 40, 3)).astype(np.float32)
    mask = np.float32([1, 1, 1, 0])
    ref = jit_fast(lambda t, p, m: jhg.hashgrid_encode({"tables": t}, jcfg, p, m))(
        jnp.asarray(tables), jnp.asarray(x), jnp.asarray(mask))
    xt = torch.tensor(x, requires_grad=True)
    got = thg.hashgrid_encode({"tables": torch.tensor(tables)}, cfg, xt, torch.tensor(mask))
    assert got.shape == (5, 40, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    w = rng.normal(size=(5, 40, 8)).astype(np.float32)
    g_ref = jit_fast(jax.grad(lambda p: (jhg.hashgrid_encode({"tables": jnp.asarray(tables)}, jcfg, p)
                                         * jnp.asarray(w)).sum()))(jnp.asarray(x))
    (thg.hashgrid_encode({"tables": torch.tensor(tables)}, cfg, xt) * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-4)

    np.testing.assert_allclose(thg.frequency_encode(torch.tensor(x), 4).numpy(),
                               np.asarray(jit_fast(lambda p: jhg.frequency_encode(p, 4))(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    pj = jhg.HashGridConfig(n_levels=8, progressive=True, start_level=2, update_steps=100)
    for step in (0, 250, 10000):
        np.testing.assert_array_equal(
            thg.progressive_level_mask(convert.hashgrid_config(pj), step),
            jhg.progressive_level_mask(pj, step))


def test_init_tables():
    gen = torch.Generator().manual_seed(0)
    cell = thg.init_hashgrid_cell(CFG, gen, device="cpu")["tables"]
    corner = thg.init_hashgrid(CFG, gen, device="cpu")["tables"]
    assert cell.shape == (4, 256, 16) and corner.shape == (4, 256, 2)
    for t in (cell, corner):
        assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 3e-5

"""The port's PatchGAN, hinge losses and GAN volume renderer against the JAX
package (CPU, small widths).

- The discriminator (ndf 8, 3 layers) on 32² and 30² inputs: logits within
  1e-5, their shapes those of the (1, 2) padding (a symmetric padding of 1
  gives other sides); its parameters carried by
  ``convert.discriminator_params``, every bias drawn non-zero.
- ``hinge_d_loss``, ``generator_loss`` and ``discriminator_loss`` within
  1e-6 relative; the discriminator loss's gradient in the parameters within
  1e-4 of each leaf's max (a bias before a norm with one channel a group has
  none but rounding: ≤ 1e-5 of the largest leaf's max on both sides).
- ``posterior_sample``: the mode and a sample from the same normal draw.
- ``GANVolumeRenderer`` (ch 16, ch_mult (1, 2, 4), z 4: 32² over an 8²
  base) around a differentiable base renderer, at ``generator_level`` 0, 1
  and 2 (the posterior's normal draw fed to both): ``comp_gan_rgb`` and
  ``comp_lr_rgb`` within 1e-5, the gradient of a weighted sum of them in
  every renderer parameter and the base's within 1e-4 of each leaf's max;
  the parameters carried by ``convert.gan_renderer_params`` (every key of
  the port's state dict, nothing left over).

The JAX references run under one ``jax.jit`` with XLA's cheaper passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import jit_fast

from dreammesh4d_tpu.models.renderers import gan_volume_renderer as jgr
from dreammesh4d_tpu.utils import gan as jgan
from dreammesh4d_tpu_torch import convert, registry
from dreammesh4d_tpu_torch.models.renderers import gan_volume_renderer as pgr
from dreammesh4d_tpu_torch.utils import gan as pgan

B, HW, LR = 2, 32, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def disc():
    """(JAX tree, port tree) of a seeded discriminator."""
    cfg = jgan.DiscriminatorConfig(ndf=8, n_layers=3)
    shapes = jax.eval_shape(lambda k: jgan.init_discriminator(cfg, k), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32), shapes)
    return tree, convert.discriminator_params(tree, device="cpu")


@pytest.mark.parametrize("hw", [32, 30])
def test_discriminator_logits_match_jax(disc, hw):
    jtree, ptree = disc
    x = np.random.default_rng(hw).random((B, hw, hw, 3), dtype=np.float32)
    want = np.asarray(jit_fast(jgan.apply_discriminator)(jtree, x))
    got = pgan.apply_discriminator(ptree, torch.as_tensor(x)).numpy()
    side = hw
    for _ in range(3):
        side = (side + 3 - 4) // 2 + 1
    assert want.shape == (B, side, side, 1)  # the (1, 2) padding's sides
    err = np.abs(got - want).max()
    print(f"logits at {hw}^2: max |d| {err:.3g}")
    assert err <= 1e-5


def test_hinge_losses_match_jax(disc):
    jtree, ptree = disc
    rng = np.random.default_rng(5)
    real, fake = (rng.random((B, HW, HW, 3), dtype=np.float32) for _ in range(2))
    lr, lf = (rng.normal(size=(B, 4, 4, 1)).astype(np.float32) for _ in range(2))
    want = {"hinge": jgan.hinge_d_loss(lr, lf)}
    (want["D"], grads), want["G"] = jit_fast(lambda p: (jax.value_and_grad(jgan.discriminator_loss)(p, real, fake),
                                                        jgan.generator_loss(p, fake)))(jtree)
    p = convert.discriminator_params(jtree, device="cpu")
    for leaf in jax.tree_util.tree_leaves(p):
        leaf.requires_grad_(True)
    d_loss = pgan.discriminator_loss(p, torch.as_tensor(real), torch.as_tensor(fake))
    d_loss.backward()
    got = {"hinge": pgan.hinge_d_loss(torch.as_tensor(lr), torch.as_tensor(lf)), "D": d_loss,
           "G": pgan.generator_loss(ptree, torch.as_tensor(fake))}
    for k, v in got.items():
        w = float(want[k])
        print(f"{k}: {float(v)!r} vs JAX {w!r}")
        assert abs(float(v) - w) <= 1e-6 * abs(w) and w != 0, k
    want_grads = convert.discriminator_params(jax.tree_util.tree_map(np.asarray, grads), device="cpu")
    pairs = [(a.grad.numpy(), b.numpy()) for a, b in zip(jax.tree_util.tree_leaves(p),
                                                        jax.tree_util.tree_leaves(want_grads))]
    top = max(np.abs(b).max() for _, b in pairs)
    for a, b in pairs:
        if np.abs(b).max() > 1e-5 * top:
            assert _rel(a, b) <= 1e-4
        else:  # a bias before a one-channel-per-group norm: zero but for rounding, on both sides
            assert np.abs(a).max() <= 1e-5 * top


def test_posterior_sample_matches_jax():
    rng = np.random.default_rng(7)
    lat = rng.normal(size=(B, 4, 4, 8)).astype(np.float32) * 3
    lat[..., 4] = -40.0  # below the log-variance clip
    noise = rng.normal(size=(B, 4, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(pgr.posterior_sample(torch.as_tensor(lat)).numpy(),
                                  np.asarray(jgr.posterior_sample(lat, None)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(noise))
        want = np.asarray(jgr.posterior_sample(lat, jax.random.PRNGKey(0)))
    got = pgr.posterior_sample(torch.as_tensor(lat), torch.as_tensor(noise)).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _base(jnp_or_torch, A):
    """A differentiable base renderer: 11 channels (rgb, latent moments)
    from the rays through ``A`` (6, 11)."""
    def render(lo, ld):
        x = jnp_or_torch.concatenate([lo, ld], -1) if jnp_or_torch is jnp else torch.cat([lo, ld], -1)
        return {"comp_rgb": jnp_or_torch.tanh(x @ A), "opacity": x[..., :1] * 0 + 1}
    return render


@pytest.fixture(scope="module")
def renderer_pair():
    cfg = {"ch": 16, "ch_mult": (1, 2, 4), "z_channels": 4}
    jr = jgr.GANVolumeRenderer(**cfg)
    shapes = jax.eval_shape(lambda k: jr.init_params(k, lr_hw=LR), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return ((1.0 if "scale" in name else 0.0) + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    jparams = jax.tree_util.tree_map_with_path(draw, shapes)
    r = registry.find("gan-volume-renderer")(cfg, device="cpu")
    sd = convert.gan_renderer_params(jparams)
    assert sorted(sd) == sorted(r.state_dict())
    r.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return jr, jparams, r


@pytest.fixture(scope="module")
def render_inputs():
    rng = np.random.default_rng(2)
    return {"o": rng.normal(size=(B, HW, HW, 3)).astype(np.float32),
            "d": rng.normal(size=(B, HW, HW, 3)).astype(np.float32),
            "gt": rng.random((B, HW, HW, 3), dtype=np.float32),
            "A": (0.5 * rng.normal(size=(6, 11))).astype(np.float32),
            "noise": rng.normal(size=(B, LR, LR, 4)).astype(np.float32),
            "cot": rng.normal(size=(B, HW, HW, 3)).astype(np.float32),
            "cot_lr": rng.normal(size=(B, LR, LR, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_renders(renderer_pair, render_inputs):
    jr, jparams, _ = renderer_pair
    x = render_inputs

    def run(params, A):
        out = {}
        for level in (0, 1, 2):
            def loss(p, a):
                o = jr(p, _base(jnp, a), x["o"], x["d"], gt_rgb=x["gt"], generator_level=level,
                       rng=jax.random.PRNGKey(level) if level else None)
                return (o["comp_gan_rgb"] * x["cot"]).sum() + (o["comp_lr_rgb"] * x["cot_lr"]).sum(), o
            (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, A)
            out[level] = (o["comp_gan_rgb"], o["comp_lr_rgb"], grads)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(x["noise"]))
        res = jit_fast(run)(jparams, x["A"])
    return jax.tree_util.tree_map(np.asarray, res)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_gan_renderer_levels_match_jax(renderer_pair, render_inputs, jax_renders, level):
    _, _, r = renderer_pair
    x = render_inputs
    r.zero_grad(set_to_none=True)
    A = torch.as_tensor(x["A"]).requires_grad_(True)
    out = r(_base(torch, A), torch.as_tensor(x["o"]), torch.as_tensor(x["d"]), gt_rgb=torch.as_tensor(x["gt"]),
            generator_level=level, noise=torch.as_tensor(x["noise"]))
    ((out["comp_gan_rgb"] * torch.as_tensor(x["cot"])).sum()
     + (out["comp_lr_rgb"] * torch.as_tensor(x["cot_lr"])).sum()).backward()
    gan, lr, (g_params, g_A) = jax_renders[level]
    assert out["comp_gan_rgb"].shape == (B, HW, HW, 3) and out["comp_lr_rgb"].shape == (B, LR, LR, 3)
    err = max(np.abs(out["comp_gan_rgb"].detach().numpy() - gan).max(),
              np.abs(out["comp_lr_rgb"].detach().numpy() - lr).max())
    want = convert.gan_renderer_params(g_params)
    # level 0 reads neither gt_rgb nor the local encoder: their gradients are zero / absent
    grads = {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
             for k, p in r.named_parameters()}
    g_err = {k: _rel(grads[k], v) for k, v in want.items() if np.abs(v).max() > 0}
    g_err["A"] = _rel(A.grad.numpy(), g_A)
    assert all(np.abs(grads[k]).max() == 0 for k, v in want.items() if np.abs(v).max() == 0)
    print(f"level {level}: outputs max |d| {err:.3g}; worst gradient {max(g_err.values()):.3g} "
          f"({max(g_err, key=g_err.get)}) over {len(g_err)} leaves")
    assert err <= 1e-5 and max(g_err.values()) <= 1e-4
    uses_local = level == 2
    assert any(k.startswith("local_encoder.") for k in g_err) == uses_local

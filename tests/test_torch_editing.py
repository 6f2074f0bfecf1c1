"""The port's editing systems (instructnerf2nerf, control4d) against the JAX
package (CPU, small widths).

- The edit's DDIM timesteps equal ``jnp.linspace(t_start, 1, n).astype(int32)``
  for (20, 0.7) and the tested (4, 0.7).
- ``ip2p_edit_images`` (InstructPix2Pix at ``test_torch_guidance_zoo``'s
  widths, its weights drawn in the port and carried to the JAX tree by the
  JAX package's converter; 4 DDIM steps from 0.7, the partial noise fed to
  both) within 1e-4 of its max.
- One ``make_in2n_train_step`` step (a render of 16² from two parameter
  leaves, L1 and the perceptual net with the JAX weights carried by
  ``convert.perceptual_params``; Adam lr 0.1) and one
  ``make_control4d_train_step`` step (the GAN renderer at 32² over an 8²
  base renderer with a parameter of its own, ``generator_level`` 1 with the
  posterior's draw fed to both, the PatchGAN with ndf 8 and 2 layers; Adams
  lr 1e-2 / 1e-3; β2 0.99 throughout, see ``B2``) against the JAX steps: metrics within 1e-4 relative, the
  gradients (the first Adam moment / (1 − β1), on both sides) within 1e-3
  of each leaf's max (a leaf with no gradient but rounding, ≤ 1e-5 of the
  largest leaf's max in JAX, is held to that size), the parameters after
  both Adams within 1e-6 of each leaf's max where the gradient is at least
  1e-3 of its leaf's max (Adam's first update is lr · g / (|g| + eps), ±lr
  by a sign that rounding decides where g is tiny: those entries, and the
  rounding-only leaves', are held within lr of their start on both sides).
- The generator term leaves the discriminator alone: its gradient in one
  step equals that of λ_D · D by itself, bit for bit.

The JAX steps jit themselves; they are built with XLA's cheaper passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from jax_compile import fast_jit, jit_fast
from test_torch_guidance_zoo import SEQ, TINY, seeded_state_dict

from dreammesh4d_tpu.models.guidance import instructpix2pix as jip
from dreammesh4d_tpu.models.guidance import stable_diffusion as jsd
from dreammesh4d_tpu.models.guidance.zero123 import convert as jconv
from dreammesh4d_tpu.models.renderers import gan_volume_renderer as jgr
from dreammesh4d_tpu.systems import editing as jed
from dreammesh4d_tpu.utils import gan as jgan
from dreammesh4d_tpu.utils import perceptual as jperc
from dreammesh4d_tpu_torch import convert, registry
from dreammesh4d_tpu_torch.models.guidance import stable_diffusion as psd
from dreammesh4d_tpu_torch.systems import editing as ped
from dreammesh4d_tpu_torch.utils import gan as pgan
from dreammesh4d_tpu_torch.utils import perceptual as pperc
from dreammesh4d_tpu_torch.utils.tree import tree_leaves, tree_map

GAN_CFG = {"ch": 16, "ch_mult": (1, 2, 4), "z_channels": 4}
HW, LR = 32, 8
# Adam's β2: 0.99, threestudio's editing YAMLs' (and the zoo's).  At optax's default 0.999 its
# float32 bias correction 1 − 0.999 is 1.3e-5 off the float64 one torch computes, which moves
# the first update by 6.4e-6 relative (6.6e-7 at lr 0.1, past the 1e-6 band for reasons of the
# reference's rounding, not of the step)
B2 = 0.99


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


@pytest.mark.parametrize("n", [20, 4])
def test_edit_timesteps_equal_jax(n):
    want = np.asarray(jnp.linspace(int(0.7 * 999), 1, n).astype(jnp.int32))
    np.testing.assert_array_equal(ped.edit_timesteps(n, 0.7), want)
    assert ped.edit_timesteps(1, 0.7).tolist() == [699]


def test_ip2p_edit_images_matches_jax():
    cfg = dict(TINY, guidance_scale=7.5)
    jguid = jip.InstructPix2PixGuidance(jip.InstructPix2PixConfig(**cfg))
    guidance = registry.find("stable-diffusion-instructpix2pix-guidance")(cfg, device="cpu")
    sd = seeded_state_dict(guidance.modules, 7)
    guidance.modules.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    jparams, _ = jconv.convert_sd_state_dict(sd, jguid)
    rng = np.random.default_rng(8)
    rgb, cond_rgb = (rng.random((1, 64, 64, 3), dtype=np.float32) for _ in range(2))
    noise = rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
    cond, uncond = (0.5 * rng.normal(size=(5, SEQ, 32))).astype(np.float32), \
        (0.5 * rng.normal(size=(SEQ, 32))).astype(np.float32)
    el, az = np.float32([15.0]), np.float32([-40.0])
    jprompts = jsd.PromptEmbeddings(jnp.asarray(cond), jnp.asarray(uncond),
                                    jsd.PromptProcessorConfig(context_dim=32, seq_len=SEQ))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(noise.transpose(0, 2, 3, 1)))
        want = np.asarray(jit_fast(lambda r, c: jed.ip2p_edit_images(
            jguid, jparams, jprompts, jax.random.PRNGKey(0), r, c, el, az, diffusion_steps=4))(rgb, cond_rgb))
    prompts = psd.PromptEmbeddings(torch.as_tensor(cond), torch.as_tensor(uncond),
                                   psd.PromptProcessorConfig(context_dim=32, seq_len=SEQ))
    got = ped.ip2p_edit_images(guidance, prompts, torch.as_tensor(rgb), torch.as_tensor(cond_rgb),
                               torch.as_tensor(el), torch.as_tensor(az), diffusion_steps=4,
                               noise=torch.as_tensor(noise)).numpy()
    err = _rel(got, want)
    print(f"ip2p_edit_images: max |d| / max {err:.3g}; output range {want.min():.3f}..{want.max():.3f}")
    assert err <= 1e-4 and got.shape == (1, 64, 64, 3) and want.std() > 0.01


def _adam_grads(opt_state):
    """The first step's gradients from optax Adam's first moment."""
    adam = opt_state[0] if isinstance(opt_state, tuple) else opt_state
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam.mu)


def _check_step(label, metrics, want_metrics, grads, want_grads, params, want_params, start, lrs):
    m_err = {k: abs(float(v) - float(want_metrics[k])) / max(abs(float(want_metrics[k])), 1e-30)
             for k, v in metrics.items()}
    assert sorted(metrics) == sorted(want_metrics)
    # a bias before a norm with one channel a group (the PatchGAN's) has no gradient but rounding:
    # such leaves (below 1e-5 of the largest leaf's max) are held to that size on both sides
    top = max(np.abs(b).max() for b in want_grads)
    noise = [np.abs(b).max() <= 1e-5 * top for b in want_grads]
    assert all(np.abs(a).max() <= 1e-5 * top for a, n in zip(grads, noise) if n)
    g_err = [_rel(a, b) for a, b, n in zip(grads, want_grads, noise) if not n]
    # Adam's first update is lr · g / (|g| + eps) per entry: ±lr by the sign of g, which rounding
    # decides where g is tiny.  Entries with |g| ≥ 1e-3 of their leaf's max are compared; the others
    # (the noise leaves' all) are held within lr of where they started, on both sides
    p_err, n_free = [], 0
    for a, b, g, p0, n, lr in zip(params, want_params, want_grads, start, noise, lrs):
        sure = np.abs(g) >= 1e-3 * np.abs(g).max() if not n else np.zeros(np.shape(g), bool)
        n_free += int((~sure).sum())
        p_err.append(np.abs(np.asarray(a, np.float64) - b)[sure].max(initial=0) / np.abs(b).max())
        for q in (a, b):
            assert np.abs(np.asarray(q, np.float64) - p0)[~sure].max(initial=0) <= lr * (1 + 1e-5)
    print(f"{label}: metrics {max(m_err.values()):.3g} relative; gradients {max(g_err):.3g}, parameters "
          f"{max(p_err):.3g} of each leaf's max over {len(g_err)} leaves ({n_free} entries within lr)")
    assert max(m_err.values()) <= 1e-4 and max(g_err) <= 1e-3 and max(p_err) <= 1e-6
    assert all(float(want_metrics[k]) != 0 for k in want_metrics)


@pytest.fixture(scope="module")
def perceptual():
    jparams = jax.tree.map(np.asarray, jax.jit(jperc.init_perceptual)(jax.random.PRNGKey(3)))
    return jparams, pperc.from_params(convert.perceptual_params(jparams, "cpu"), device="cpu")


def test_in2n_step_matches_jax(perceptual):
    jp, net = perceptual
    rng = np.random.default_rng(11)
    params = {"img": rng.normal(size=(1, 16, 16, 3)).astype(np.float32),
              "tint": (0.3 * rng.normal(size=(3,))).astype(np.float32)}
    edited = rng.random((1, 16, 16, 3), dtype=np.float32)
    losses = {"lambda_l1": 10.0, "lambda_p": [0, 1.0, 10.0, 100]}

    def jrender(p, batch, key):
        return jax.nn.sigmoid(p["img"] + p["tint"])

    opt = optax.adam(0.1, b2=B2)
    with fast_jit():
        jstep = jed.make_in2n_train_step(jrender, opt, jed.In2NLosses(**losses),
                                         lambda a, b: jperc.perceptual_loss(jp, a, b))
        jparams = jax.tree.map(jnp.asarray, params)
        jstate, jm = jstep(jed.In2NState(jparams, opt.init(jparams), jnp.asarray(5, jnp.int32)),
                           {"edited_rgb": jnp.asarray(edited)}, jax.random.PRNGKey(0))

    def render(p, batch, generator):
        return torch.sigmoid(p["img"] + p["tint"])

    step = ped.make_in2n_train_step(render, ped.In2NLosses(**losses), net, device="cpu")
    state = ped.init_in2n_state({k: torch.as_tensor(v) for k, v in params.items()}, lr=0.1, betas=(0.9, B2),
                                eps=1e-8, step=5, device="cpu")
    state, metrics = step(state, {"edited_rgb": torch.as_tensor(edited)}, torch.Generator().manual_seed(0))
    assert state.step == 6 and "loss_p" in metrics
    _check_step("in2n", metrics, jm, [p.grad.numpy() for p in tree_leaves(state.geo_params)],
                [_adam_grads(jstate.opt_state)[k] for k in params],
                [p.detach().numpy() for p in tree_leaves(state.geo_params)],
                [np.asarray(jstate.geo_params[k]) for k in params], list(params.values()), [0.1] * len(params))


@pytest.fixture(scope="module")
def control4d_setup():
    rng = np.random.default_rng(12)
    jr = jgr.GANVolumeRenderer(**GAN_CFG)
    shapes = jax.eval_shape(lambda k: jr.init_params(k, lr_hw=LR), jax.random.PRNGKey(0))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return ((1.0 if "scale" in name else 0.0) + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    gan = jax.tree_util.tree_map_with_path(draw, shapes)
    dshapes = jax.eval_shape(lambda k: jgan.init_discriminator(jgan.DiscriminatorConfig(ndf=8, n_layers=2), k),
                             jax.random.PRNGKey(0))
    disc = jax.tree_util.tree_map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32), dshapes)
    x = {"rays_o": rng.normal(size=(1, HW, HW, 3)).astype(np.float32),
         "rays_d": rng.normal(size=(1, HW, HW, 3)).astype(np.float32),
         "edited_rgb": rng.random((1, HW, HW, 3), dtype=np.float32),
         "A": (0.5 * rng.normal(size=(6, 11))).astype(np.float32),
         "noise": rng.normal(size=(1, LR, LR, 4)).astype(np.float32)}
    return jr, gan, disc, x


def _port_control4d(gan, disc, x, device="cpu"):
    """The port's renderer, step and state from the JAX trees."""
    r = registry.find("gan-volume-renderer")(GAN_CFG, device=device)
    scene = {"gan": {k: torch.as_tensor(v) for k, v in convert.gan_renderer_params(gan).items()},
             "A": torch.as_tensor(x["A"])}

    def render(scene, batch, generator):
        def base(lo, ld):
            return {"comp_rgb": torch.tanh(torch.cat([lo, ld], -1) @ scene["A"])}
        return functional_call(r, scene["gan"], (base, batch["rays_o"], batch["rays_d"]),
                                {"gt_rgb": batch["edited_rgb"], "generator_level": 1, "noise": batch["noise"]})

    state = ped.init_control4d_state(scene, convert.discriminator_params(disc, device=device), lr=1e-2,
                                     disc_lr=1e-3, betas=(0.9, B2), device=device)
    return ped.make_control4d_train_step(render, ped.Control4DLosses(), device=device), state, render


def test_control4d_step_matches_jax(control4d_setup):
    jr, gan, disc, x = control4d_setup

    def jrender(scene, batch, key):
        def base(lo, ld):
            return {"comp_rgb": jnp.tanh(jnp.concatenate([lo, ld], -1) @ scene["A"])}
        return jr(scene["gan"], base, batch["rays_o"], batch["rays_d"], gt_rgb=batch["edited_rgb"],
                  generator_level=1, rng=key)

    opt, dopt = optax.adam(1e-2, b2=B2), optax.adam(1e-3, b2=B2)
    batch = {k: jnp.asarray(x[k]) for k in ("rays_o", "rays_d", "edited_rgb")}
    with pytest.MonkeyPatch.context() as mp, fast_jit():
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(x["noise"]))
        jstep = jed.make_control4d_train_step(jrender, opt, dopt, jed.Control4DLosses())
        jscene = {"gan": jax.tree.map(jnp.asarray, gan), "A": jnp.asarray(x["A"])}
        jstate, jm = jstep(jed.init_control4d_state(jscene, jax.tree.map(jnp.asarray, disc), opt, dopt),
                           batch, jax.random.PRNGKey(0))

    step, state, _ = _port_control4d(gan, disc, x)
    pbatch = {k: torch.as_tensor(x[k]) for k in ("rays_o", "rays_d", "edited_rgb", "noise")}
    state, metrics = step(state, pbatch, torch.Generator().manual_seed(0))
    assert state.step == 1 and sorted(metrics) == ["loss_D", "loss_G", "loss_l1", "loss_total"]
    jg = _adam_grads(jstate.opt_state)
    want_grads = list(convert.gan_renderer_params(jg["gan"]).values()) + [jg["A"]]
    want_params = list(convert.gan_renderer_params(jax.tree.map(np.asarray, jstate.scene_params["gan"])).values()) \
        + [np.asarray(jstate.scene_params["A"])]
    keys = list(convert.gan_renderer_params(gan))
    start = list(convert.gan_renderer_params(gan).values()) + [x["A"]]
    assert list(state.scene_params["gan"]) == keys
    scene_leaves = tree_leaves(state.scene_params)
    # the local encoder takes no part at level 1: no gradient on either side
    used = [i for i, g in enumerate(want_grads) if np.abs(g).max() > 0]
    assert all(scene_leaves[i].grad is None for i in range(len(keys)) if i not in used)
    dg = _adam_grads(jstate.disc_opt_state)
    disc_grads = [p.grad.numpy() for p in tree_leaves(state.disc_params)]
    want_disc = [b.numpy() for b in tree_leaves(convert.discriminator_params(dg, device="cpu"))]
    want_disc_params = [b.numpy() for b in tree_leaves(convert.discriminator_params(
        jax.tree.map(np.asarray, jstate.disc_params), device="cpu"))]
    _check_step("control4d", metrics, jm,
                [scene_leaves[i].grad.numpy() for i in used] + disc_grads,
                [want_grads[i] for i in used] + want_disc,
                [scene_leaves[i].detach().numpy() for i in used] + [p.detach().numpy() for p in
                                                                    tree_leaves(state.disc_params)],
                [want_params[i] for i in used] + want_disc_params,
                [start[i] for i in used] + [b.numpy() for b in tree_leaves(convert.discriminator_params(disc, "cpu"))],
                [1e-2] * len(used) + [1e-3] * len(disc_grads))


def test_control4d_generator_term_leaves_discriminator_alone(control4d_setup):
    _, gan, disc, x = control4d_setup
    step, state, render = _port_control4d(gan, disc, x)
    before = tree_map(lambda p: p.detach().clone(), state.disc_params)
    pbatch = {k: torch.as_tensor(x[k]) for k in ("rays_o", "rays_d", "edited_rgb", "noise")}
    fake = render(state.scene_params, pbatch, None)["comp_gan_rgb"].detach()
    state, _ = step(state, pbatch, torch.Generator().manual_seed(0))
    # λ_D · D alone on the same fake images and the discriminator before the step
    d_params = tree_map(lambda p: p.requires_grad_(True), before)
    (ped.Control4DLosses().lambda_D * pgan.discriminator_loss(d_params, pbatch["edited_rgb"], fake)).backward()
    got = [p.grad for p in tree_leaves(state.disc_params)]
    for a, b in zip(got, tree_leaves(d_params)):
        assert torch.equal(a, b.grad)
    assert all(float(g.abs().max()) > 0 for g in got)

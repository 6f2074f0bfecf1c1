"""The port's unified guidance (``models/guidance/unified.py``) against the
JAX package's: the Perp-Neg math and the SDS of both guidances (CPU, the
widths of ``tests/test_unified_guidance.py``'s TINY and TINY123 at one
UNet level, with a one-level VAE, so that the JAX references compile
inside each file's time).  The ``vsd`` dispatches are held in
``test_torch_unified_sd_vsd.py``, ``test_torch_unified_zero123.py`` and
``test_torch_unified_zero123_nocam.py``, on this file's helpers.

- ``perpendicular_component`` (its |y|² floor too), ``shifted_expotional_decay``
  and ``get_perp_neg_embeddings`` within 1e-6, on three views, one in each
  branch (front-side, side-back, overhead);
- ``stable-diffusion-unified-guidance`` from ``registry.find``: every weight
  drawn in the port (so that the zero-initialised output convolution does
  not make every ε zero) and carried to the JAX tree by its
  ``convert_sd_state_dict``; ``sds_loss_perp_neg`` (through ``loss`` with
  ``use_perp_neg``) on the same draws: ``loss_sds`` and ``grad_norm``
  within 1e-5 relative, d loss/d rgb within 1e-3 of its max, for both
  ``rgb_as_latents``; the perpendicular term moves the loss (every
  coefficient zero gives another);
- ``zero123-unified-guidance`` from ``registry.find`` (every weight drawn
  in the port, carried to the JAX tree by its ``convert_state_dict``), with
  ``guidance_type: sds``: equal to the port's ``Zero123Guidance.sds_loss``
  (rtol 1e-6) and within 1e-5 relative of JAX (``loss_sds``,
  ``grad_norm``), d loss/d rgb within 1e-3 of its max.

The JAX draws (``jax.random.uniform`` / ``normal`` / ``bernoulli``) are
monkeypatched to the test's numbers, the noise given to the port in NCHW.
Each JAX loss runs under one ``jax.jit`` (its UNet applies under a shared
inner ``jax.jit``, so that a batch shape is traced once), compiled with
XLA's cheaper optimisation level.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compile import FAST_COMPILE
from test_torch_zoo_sd import _close, _one_torch_thread, _seeded_tree  # noqa: F401

from dreammesh4d_tpu.models.guidance import stable_diffusion as jsd
from dreammesh4d_tpu.models.guidance import unified as ju
from dreammesh4d_tpu.models.guidance.zero123.convert import convert_state_dict
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.guidance import stable_diffusion as psd
from dreammesh4d_tpu_torch.models.guidance import unified as pu
from dreammesh4d_tpu_torch.models.guidance.zero123 import guidance as pg
from dreammesh4d_tpu_torch.registry import find

# tests/test_unified_guidance.py's TINY and TINY123 widths and latent sizes at one UNet level; the
# VAE one level of 16 channels (the images at the latent size)
VAE = dict(vae_ch=16, vae_ch_mult=(1,), vae_num_res_blocks=1)
TINY = dict(model_channels=16, channel_mult=(1,), num_res_blocks=1, num_heads=2, context_dim=32,
            latent_size=16, image_size=16, min_step_percent=0.2, max_step_percent=0.6, **VAE)
TINY123 = dict(model_channels=16, channel_mult=(1,), num_res_blocks=1, num_heads=2, context_dim=32,
               latent_size=8, image_size=8, use_clip=False, min_step_percent=0.2, max_step_percent=0.6,
               cond_camera_distance=1.5, cond_elevation_deg=10.0, **VAE)
SEQ, STEP = 6, 40
# one view in each Perp-Neg branch: front-side, side-back, overhead
VIEWS = {"el": np.float32([10.0, 20.0, 75.0]), "az": np.float32([30.0, -130.0, 200.0]),
         "dist": np.float32([2.0, 2.5, 3.0])}


class Draws:
    """Stand-ins for ``jax.random.uniform`` / ``normal`` / ``bernoulli``
    that return the given arrays in call order; ``reset`` before each
    traced loss."""

    def __init__(self, uniforms, normals, drop=None):
        self.all = (uniforms, normals, drop)
        self.reset()

    def reset(self):
        self.u, self.n = list(self.all[0]), list(self.all[1])

    def patch(self, mp):
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(self.u.pop(0)))
        mp.setattr(jax.random, "normal", lambda key, shape=(), *a, **k: jnp.asarray(self.n.pop(0)))
        mp.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(self.all[2]).reshape(shape))


def _nhwc(x):
    return x.transpose(0, 2, 3, 1)


def inner_jit_unet(holder):
    """``holder.unet.apply`` under one ``jax.jit``: each batch shape the
    losses give the UNet is traced once."""
    holder.unet = types.SimpleNamespace(apply=jax.jit(holder.unet.apply))
    return holder


def jit_run(fn, *args):
    """``fn(*args)`` through one ``jax.jit``, compiled with FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


# ---------------------------------------------------------------------------
# the Perp-Neg math
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prompt_arrays():
    rng = np.random.default_rng(21)
    return ((0.5 * rng.normal(size=(5, SEQ, 32))).astype(np.float32),
            (0.5 * rng.normal(size=(SEQ, 32))).astype(np.float32))


def _prompts(pkg, arrays, lib):
    cfg = pkg.PromptProcessorConfig(context_dim=32, seq_len=SEQ)
    return pkg.PromptEmbeddings(lib(arrays[0]), lib(arrays[1]), cfg)


def test_perp_neg_math_matches_jax(prompt_arrays):
    rng = np.random.default_rng(22)
    x, y = rng.normal(size=(2, 3, 4, 5, 5)).astype(np.float32)
    y[1] = 0.0  # the floor of |y|²
    r = np.float32([0.0, 0.3, 1.0, 1.7])
    abc = (pu.PerpNegCoeffs().f_fs, pu.PerpNegCoeffs().f_sb)

    @jax.jit
    def reference(x, y, r, cond, uncond, el, az):
        prompts = jsd.PromptEmbeddings(cond, uncond, jsd.PromptProcessorConfig(context_dim=32, seq_len=SEQ))
        return (ju.perpendicular_component(x, y), [ju.shifted_expotional_decay(*c, r) for c in abc],
                ju.get_perp_neg_embeddings(prompts, el, az, ju.PerpNegCoeffs()))

    j_perp, j_decay, want = reference(x, y, r, *prompt_arrays, VIEWS["el"], VIEWS["az"])
    np.testing.assert_allclose(pu.perpendicular_component(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
                               np.asarray(j_perp), atol=1e-6)
    for c, j in zip(abc, j_decay):
        np.testing.assert_allclose(pu.shifted_expotional_decay(*c, torch.as_tensor(r)).numpy(), np.asarray(j),
                                   atol=1e-6)
    got = pu.get_perp_neg_embeddings(_prompts(psd, prompt_arrays, torch.as_tensor), torch.as_tensor(VIEWS["el"]),
                                     torch.as_tensor(VIEWS["az"]), pu.PerpNegCoeffs())
    for name, a, b in zip(("pos", "uncond", "neg", "neg_w"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=name)
    neg_w = got[3].numpy()
    assert (neg_w[:2] != 0).all() and (neg_w[2] == 0).all()  # the overhead view has no negatives
    cond = prompt_arrays[0]
    np.testing.assert_allclose(got[0][2].numpy(), cond[4], atol=1e-6)  # overhead row
    np.testing.assert_allclose(got[2][1].numpy(), cond[[2, 1]], atol=1e-6)  # side-back: [side, front]


# ---------------------------------------------------------------------------
# stable-diffusion-unified-guidance
# ---------------------------------------------------------------------------


def seeded_state_dict(modules, seed):
    """A numpy draw for every entry of the port's ``modules.state_dict()``:
    N(0, 1/fan_in) (1-D entries N(0, 1)), so that no output is zero."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=tuple(v.shape)) / np.sqrt(max(v[0].numel(), 1))).astype(np.float32)
            for k, v in modules.state_dict().items()}


def drawn_lora(jguid, unet_params, rng):
    """A LoRA in the JAX ``init_lora_params`` tree's layout (``jax.eval_shape``),
    drawn with numpy: A ~ N(0, 1/r), B ~ N(0, 0.3²) (not 0, so that phi
    differs from the pretrained UNet), ``camera_proj`` w ~ N(0, 0.02²), b
    ~ N(0, 0.1²)."""
    shapes = jax.eval_shape(jguid.init_lora_params, jax.random.PRNGKey(1), unet_params)
    std = {"A": None, "B": 0.3, "w": 0.02, "b": 0.1}

    def draw(path, leaf):
        name = path[-1].key
        s = std[name] if name != "A" else leaf.shape[1] ** -0.5
        return (s * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def sd_setup():
    """(JAX params, port guidance, JAX LoRA and the port's as numpy, draws):
    the port's weights drawn, carried to the JAX tree by its
    ``convert_sd_state_dict`` (and back by ``convert.sd_guidance_params``)."""
    guidance = find("stable-diffusion-unified-guidance")(TINY, device="cpu")
    jguid = ju.SDUnifiedGuidance(ju.SDUnifiedConfig(**TINY))
    jparams = _seeded_tree(jax.eval_shape(jguid.init_params, jax.random.PRNGKey(0)), 0)
    guidance.modules.load_state_dict(
        {k: torch.as_tensor(v) for k, v in convert.sd_guidance_params(jparams, guidance.cfg).items()})
    rng = np.random.default_rng(4)
    jlora = drawn_lora(jguid, jparams["unet"], rng)
    B, n_lat = 3, guidance.cfg.image_size
    d = {"rgb3": rng.random((B, 24, 24, 3), dtype=np.float32), "rgb4": rng.random((B, 24, 24, 4), dtype=np.float32),
         "u": np.float32([0.3, 0.9, 0.55]), "u2": np.float32([0.45, 0.12, 0.8]),
         "noise": rng.normal(size=(B, 4, n_lat, n_lat)).astype(np.float32),
         "noise_lat": rng.normal(size=(B, 4, TINY["latent_size"], TINY["latent_size"])).astype(np.float32),
         "noise2": rng.normal(size=(B, 4, n_lat, n_lat)).astype(np.float32),
         "drop": np.array([True, False, False]), "cam": rng.normal(size=(B, 16)).astype(np.float32), **VIEWS}
    return jparams, guidance, jlora, convert.vsd_lora_params(jlora, guidance.cfg), d


@pytest.fixture(scope="module")
def jax_perp_neg(sd_setup, prompt_arrays):
    """The JAX Perp-Neg SDS, value and d/d rgb, for both ``rgb_as_latents``
    (one jit)."""
    jparams, _, _, _, d = sd_setup
    prompts = _prompts(jsd, prompt_arrays, jnp.asarray)
    perp = inner_jit_unet(ju.SDUnifiedGuidance(ju.SDUnifiedConfig(**TINY, use_perp_neg=True)))
    view = (d["el"], d["az"], d["dist"])
    with pytest.MonkeyPatch.context() as mp:
        Draws([d["u"]] * 2, [_nhwc(d["noise"]), _nhwc(d["noise_lat"])]).patch(mp)

        def both(rgb3, rgb4):
            res = {}
            for as_latents, rgb in ((False, rgb3), (True, rgb4)):
                def loss(x, as_latents=as_latents):
                    o = perp.loss(jparams, prompts, jax.random.PRNGKey(0), x, *view, STEP,
                                  rgb_as_latents=as_latents)
                    return o["loss_sds"], o
                res[as_latents] = jax.value_and_grad(loss, has_aux=True)(rgb)
            return res

        return {k: ({n: float(v) for n, v in o.items()}, np.asarray(g))
                for k, ((_, o), g) in jit_run(both, d["rgb3"], d["rgb4"]).items()}


def _port_view(d):
    return [torch.as_tensor(d[k]) for k in ("el", "az", "dist")]


@pytest.mark.parametrize("as_latents", [False, True])
def test_sd_perp_neg_matches_jax(sd_setup, jax_perp_neg, prompt_arrays, as_latents):
    _, guidance, _, _, d = sd_setup
    g = pu.SDUnifiedGuidance(dict(TINY, use_perp_neg=True), modules=guidance.modules)
    prompts = _prompts(psd, prompt_arrays, torch.as_tensor)
    rgb = torch.as_tensor(d["rgb4" if as_latents else "rgb3"]).requires_grad_(True)
    noise = torch.as_tensor(d["noise_lat" if as_latents else "noise"])
    out = g.loss(prompts, rgb, *_port_view(d), STEP, rgb_as_latents=as_latents, u=torch.as_tensor(d["u"]),
                 noise=noise)
    out["loss_sds"].backward()
    jout, jgrad = jax_perp_neg[as_latents]
    for k in ("loss_sds", "grad_norm"):
        got, want = float(out[k].detach()), jout[k]
        print(f"{k}: {got!r} vs JAX {want!r}")
        assert want > 0 and abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    _close(rgb.grad.numpy(), jgrad, 1e-3, "d loss_sds / d rgb")
    # the perpendicular term is not zero: without it (every coefficient 0) the loss moves
    zero = dict(TINY, use_perp_neg=True, **{f"perp_neg_f_{n}": (0.0, 0.0, 0.0) for n in ("sb", "fsb", "fs", "sf")})
    with torch.no_grad():
        bare = float(pu.SDUnifiedGuidance(zero, modules=guidance.modules).loss(
            prompts, rgb, *_port_view(d), STEP, rgb_as_latents=as_latents, u=torch.as_tensor(d["u"]),
            noise=noise)["loss_sds"])
    print(f"loss_sds without the perpendicular term: {bare!r}")
    assert abs(bare - jout["loss_sds"]) > 1e-3 * jout["loss_sds"]


# ---------------------------------------------------------------------------
# zero123-unified-guidance: sds (vsd in test_torch_unified_zero123*.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def z_setup():
    """(port guidance, JAX params, bank, JAX LoRA, the port's LoRA as numpy, draws)."""
    guidance = find("zero123-unified-guidance")(TINY123, device="cpu")
    sd = seeded_state_dict(guidance.modules, 7)
    guidance.modules.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    jguid = ju.Zero123UnifiedGuidance(ju.Zero123UnifiedConfig(**TINY123))
    jparams, report = convert_state_dict({k: v for k, v in sd.items() if k != "clip_proj"}, jguid.modules)
    assert report["unmapped"] == []
    jparams["clip_proj"] = sd["clip_proj"]
    rng = np.random.default_rng(8)
    jlora = drawn_lora(jguid, jparams["unet"], rng)
    B, n_lat = 2, guidance.cfg.image_size
    bank = {"c_crossattn": rng.normal(size=(2, 32)).astype(np.float32),
            "c_concat": rng.normal(size=(2, 4, n_lat, n_lat)).astype(np.float32)}
    d = {"rgb": rng.random((B, 24, 24, 3), dtype=np.float32), "el": np.float32([10.0, 35.0]),
         "az": np.float32([30.0, -120.0]), "dist": np.float32([1.8, 2.2]), "u": np.float32([0.3, 0.9]),
         "u2": np.float32([0.45, 0.12]), "noise": rng.normal(size=(B, 4, n_lat, n_lat)).astype(np.float32),
         "noise2": rng.normal(size=(B, 4, n_lat, n_lat)).astype(np.float32), "drop": np.array([True, False]),
         "cam": rng.normal(size=(B, 16)).astype(np.float32), "frames": np.int32([1, 0])}
    return guidance, jparams, bank, jlora, convert.vsd_lora_params(jlora, guidance.cfg), d


def _jbank(bank):
    return {"c_crossattn": jnp.asarray(bank["c_crossattn"]), "c_concat": jnp.asarray(_nhwc(bank["c_concat"]))}


@pytest.fixture(scope="module")
def jax_sds(z_setup):
    """The JAX ``sds``: the loss and d/d rgb (one jit)."""
    _, jparams, bank, _, _, d = z_setup
    g = ju.Zero123UnifiedGuidance(ju.Zero123UnifiedConfig(**TINY123))
    inner_jit_unet(g.modules)
    with pytest.MonkeyPatch.context() as mp:
        Draws([d["u"]], [_nhwc(d["noise"])]).patch(mp)

        def loss(rgb):
            o = g.loss(jparams, _jbank(bank), jax.random.PRNGKey(0), rgb, d["el"], d["az"], d["dist"], STEP,
                       frame_indices=d["frames"])
            return o["loss_sds"], o

        (_, o), grad = jit_run(jax.value_and_grad(loss, has_aux=True), d["rgb"])
    return {n: float(v) for n, v in o.items()}, np.asarray(grad)


def _z_args(z_setup):
    guidance, _, bank, _, _, d = z_setup
    tbank = {k: torch.as_tensor(v) for k, v in bank.items()}
    return tbank, [torch.as_tensor(d[k]) for k in ("el", "az", "dist")], torch.as_tensor(d["frames"])


def test_zero123_unified_sds_matches_port_and_jax(z_setup, jax_sds):
    guidance, _, _, _, _, d = z_setup
    bank, view, frames = _z_args(z_setup)
    draws = {"u": torch.as_tensor(d["u"]), "noise": torch.as_tensor(d["noise"])}
    rgb = torch.as_tensor(d["rgb"]).requires_grad_(True)
    out = guidance.loss(bank, rgb, *view, STEP, frame_indices=frames, **draws)
    out["loss_sds"].backward()
    plain = pg.Zero123Guidance(guidance.cfg, modules=guidance.modules)
    with torch.no_grad():
        ref = plain.sds_loss(bank, rgb, *view, frames, STEP, **draws)
    np.testing.assert_allclose(float(out["loss_sds"].detach()), float(ref["loss_sds"]), rtol=1e-6)
    jout, jgrad = jax_sds
    for k in ("loss_sds", "grad_norm"):
        got, want = float(out[k].detach()), jout[k]
        print(f"{k}: {got!r} vs JAX {want!r}")
        assert want > 0 and abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    _close(rgb.grad.numpy(), jgrad, 1e-3, "d loss_sds / d rgb")

"""The port's Stable Zero123 guidance against the JAX package (CPU, tiny
widths): the noise schedule and DDIM, the ``jax.image.resize`` semantics,
the UNet, the VAE and the CLIP tower, the SDS timestep draw, ``sds_loss``
on the same draws (its gradient in the renders included),
``prepare_embeddings``, ``guidance_eval`` and the checkpoint loader.

Every weight, the LDM's zero-initialised output convolutions included, is a
seeded numpy draw, written into the port's modules and carried to the JAX
package through its own ``convert_state_dict``; ``zero123_guidance_params``
carries it back.  Both round trips are exact.

Bands, float32 (measured here in brackets): the networks ≤ 1e-4 of
max|out| (UNet 1.3e-6, VAE ≤ 1.4e-6, CLIP 4.9e-7); the resize's weights
≤ 1e-7 of ``jax.image.resize``'s (6.0e-8), its images ≤ 1e-5 of
``jax.image.resize`` (4.1e-6: the JAX side's own rounding, it sits 3.8e-6
from a float64 contraction of its weights at 128 → 224) and ≤ 1e-6 of that
float64 contraction (2e-7); ``loss_sds`` and ``grad_norm`` ≤ 1e-5 relative
(1.1e-7), the timesteps equal; d loss/d rgb ≤ 1e-3 of its max (1.8e-6);
the bank ≤ 1e-4 of its max (1.6e-6); the decoded ``guidance_eval`` images
≤ 1e-4 (4.1e-6).  bfloat16 (weights and activations rounded at every
convolution and dense layer, norms and softmax in float32): the port's
UNet within 5e-2 of max|out| of the JAX package's bfloat16 UNet (2.0e-2)
and of its own float32 output (1.5e-2).  The flax CLIP tower's softmax runs
in bfloat16 where the port's does not, so CLIP is held in float32 only.

The JAX functions run under one ``jax.jit`` each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from dreammesh4d_tpu.models.guidance.zero123 import guidance as jg
from dreammesh4d_tpu.models.guidance.zero123 import scheduler as jsched
from dreammesh4d_tpu.models.guidance.zero123.convert import convert_state_dict, load_zero123_checkpoint
from dreammesh4d_tpu.models.guidance.zero123.vae import AutoencoderKL as JAutoencoderKL
from dreammesh4d_tpu.utils.schedule import C_jax
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.guidance.zero123 import checkpoint as pckpt
from dreammesh4d_tpu_torch.models.guidance.zero123 import guidance as pg
from dreammesh4d_tpu_torch.models.guidance.zero123 import scheduler as psched
from dreammesh4d_tpu_torch.ops.resize import resize_hw, weight_matrix
from dreammesh4d_tpu_torch.registry import find

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, num_heads=4, context_dim=32,
            vae_ch=16, vae_ch_mult=(1, 2), vae_num_res_blocks=1, latent_size=8, image_size=16,
            use_clip=True, clip_hidden_size=32, clip_layers=2, clip_heads=4, clip_intermediate=64,
            clip_image_size=32, clip_patch_size=8, guidance_scale=3.0,
            min_step_percent=[50, 0.7, 0.3, 200], max_step_percent=[50, 0.98, 0.8, 200])
L = 8  # latent side: 16 / 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_state_dict(modules, seed=0) -> dict:
    """Every entry of ``modules.state_dict()`` from one numpy stream: weights
    N(0, 1/fan_in), 1-D entries (biases, norm scales) around 0 / 1."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in modules.state_dict().items():
        shape = tuple(v.shape)
        if len(shape) == 1:
            base = 1.0 if k.endswith(".weight") else 0.0
            sd[k] = (base + 0.1 * rng.normal(size=shape)).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            sd[k] = (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def pair():
    """(port guidance, JAX guidance, JAX params, the LDM state dict), float32."""
    cfg = pg.Zero123Config(**TINY)
    guidance = pg.StableZero123Guidance(cfg, device="cpu")
    sd = seeded_state_dict(guidance.modules)
    guidance.modules.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    jguid = jg.StableZero123Guidance(jg.Zero123Config(**TINY))
    jparams, report = convert_state_dict(sd, jguid.modules)
    assert report["unmapped"] == [] and report["skipped"] == []
    assert set(report["consumed"]) == set(sd)
    return guidance, jguid, jparams, sd


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max() / scale
    print(f"{what}: max |d| / max |ref| = {err:.3g} (band {rel:g})")
    assert err <= rel, (what, err)
    return err


def _nhwc(x):
    return np.asarray(x.detach()).transpose(0, 2, 3, 1)


def test_state_dict_round_trip_is_exact(pair):
    guidance, jguid, jparams, sd = pair
    back = convert.zero123_guidance_params(jax.tree.map(np.asarray, jparams), guidance.cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for k, v in guidance.modules.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_schedule_and_ddim_match_jax():
    ps, js = psched.make_schedule(device="cpu"), jsched.make_schedule()
    np.testing.assert_array_equal(ps.betas.numpy(), np.asarray(js.betas))
    np.testing.assert_array_equal(ps.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    rng = np.random.default_rng(1)
    x0, eps = (rng.normal(size=(3, 4, 5, 5)).astype(np.float32) for _ in range(2))
    t, t_prev = np.array([1, 400, 999]), np.array([-1, 200, 500])
    got = psched.add_noise(ps, torch.as_tensor(x0), torch.as_tensor(eps), torch.as_tensor(t))
    want = jsched.add_noise(js, jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    got = psched.ddim_step(ps, torch.as_tensor(x0), torch.as_tensor(eps), torch.as_tensor(t),
                           torch.as_tensor(t_prev))
    want = jsched.ddim_step(js, jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(t_prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst,method", [(128, 224, "bicubic"), (512, 224, "bicubic"),
                                            (512, 256, "bilinear"), (64, 256, "bilinear")])
def test_resize_matches_jax(src, dst, method):
    """The weights equal ``jax.image.resize``'s to 1e-7; the images agree to
    1e-5 (measured ≤ 3.9e-6: ``jax.image.resize`` itself sits 3.8e-6 from
    a float64 contraction of its own weights at 128 → 224, the port 2e-7)."""
    kernel = {"bicubic": jscale._fill_keys_cubic_kernel, "bilinear": jscale._fill_triangle_kernel}
    want_w = np.asarray(jscale.compute_weight_mat(src, dst, dst / src, 0.0, kernel[method], True)).T
    w = weight_matrix(src, dst, method)
    np.testing.assert_allclose(w, want_w, rtol=0, atol=1e-7)
    img = np.random.default_rng(src + dst).random((1, src, src, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (1, dst, dst, 3), method))
    got = resize_hw(torch.as_tensor(img), dst, dst, method).numpy()
    print(f"weights max |d| {np.abs(w - want_w).max():.3g}, images {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    w64 = w.astype(np.float64)
    exact = np.einsum("oh,bhwc,pw->bopc", w64, img.astype(np.float64), w64, optimize=True)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)


def _unet_inputs(rng, B=2):
    x = rng.normal(size=(B, 8, L, L)).astype(np.float32)
    t = np.array([17, 613][:B])
    ctx = rng.normal(size=(B, 1, 32)).astype(np.float32)
    return x, t, ctx


def test_unet_matches_jax(pair):
    guidance, jguid, jparams, _ = pair
    x, t, ctx = _unet_inputs(np.random.default_rng(2))
    got = guidance.modules.unet(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(ctx))
    want = jax.jit(jguid.modules.apply_unet)(jparams, x.transpose(0, 2, 3, 1), t, ctx)
    assert got.dtype == torch.float32
    _close(_nhwc(got), want, 1e-4, "unet")


def test_unet_bf16_band(pair):
    """bfloat16 on both sides, the same weights; and the port's bfloat16
    against its own float32."""
    guidance, _, jparams, sd = pair
    cfg = pg.Zero123Config(**{**TINY, "dtype": "fp16"})
    assert cfg.dtype == torch.bfloat16
    mods = pg.Zero123Modules(cfg, device="cpu")
    mods.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    jmods = jg.Zero123Modules(jg.Zero123Config(**{**TINY, "dtype": "bfloat16"}))
    x, t, ctx = _unet_inputs(np.random.default_rng(3))
    got = mods.unet(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(ctx))
    want = jax.jit(jmods.apply_unet)(jparams, x.transpose(0, 2, 3, 1), t, ctx)
    assert got.dtype == torch.float32
    _close(_nhwc(got), want, 5e-2, "unet bf16 vs JAX bf16")
    f32 = guidance.modules.unet(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(ctx))
    _close(got.numpy(), f32.numpy(), 5e-2, "unet bf16 vs float32")


def test_vae_matches_jax(pair):
    guidance, jguid, jparams, _ = pair
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    z = rng.normal(size=(2, 4, L, L)).astype(np.float32)
    vae = jguid.modules.vae

    def j_encode(p, x):
        return vae.apply({"params": p["vae"]}, x, method=JAutoencoderKL.encode_moments)

    def j_decode(p, z):
        return vae.apply({"params": p["vae"]}, z, method=JAutoencoderKL.decode)

    mean, logvar = guidance.modules.vae.encode_moments(torch.as_tensor(img))
    j_mean, j_logvar = jax.jit(j_encode)(jparams, img.transpose(0, 2, 3, 1))
    _close(_nhwc(mean), j_mean, 1e-4, "vae mean")
    _close(_nhwc(logvar), j_logvar, 1e-4, "vae logvar")
    dec = guidance.modules.vae.decode(torch.as_tensor(z))
    _close(_nhwc(dec), jax.jit(j_decode)(jparams, z.transpose(0, 2, 3, 1)), 1e-4, "vae decode")


def test_clip_matches_jax(pair):
    """The tower through ``clip_embed``: the bicubic preprocess (24² up to
    32²) and the ViT."""
    guidance, jguid, jparams, _ = pair
    rgb = np.random.default_rng(5).random((3, 24, 24, 3), dtype=np.float32)
    got = guidance.modules.clip_embed(torch.as_tensor(rgb))
    want = jax.jit(jguid.modules.clip_embed)(jparams, rgb)
    _close(got.numpy(), want, 1e-4, "clip")


def test_timesteps_match_jax():
    """t = int32(min_p·T + u·(max_p − min_p)·T) for the stage-1 schedules
    at steps before, inside and after their ramp."""
    cfg = pg.Zero123Config(**TINY)
    u = np.random.default_rng(6).random(4096, dtype=np.float32)
    u[:5] = [0.0, 0.5, 0.25, 0.75, 0.999999]

    @jax.jit
    def j_t(u, step):  # the lines of the JAX sds_loss
        min_p = C_jax(cfg.min_step_percent, step)
        max_p = C_jax(cfg.max_step_percent, step)
        t = (min_p * 1000 + u * (max_p - min_p) * 1000).astype(jnp.int32)
        return jnp.clip(t, 1, 999), min_p, max_p

    for step in (0, 50, 77, 123, 199, 200, 5000):
        t, min_p, max_p = pg.sds_timesteps(cfg, torch.as_tensor(u), step, 1000)
        jt, jmin, jmax = j_t(u, step)
        assert float(min_p) == float(jmin) and float(max_p) == float(jmax), step
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt), err_msg=str(step))


def test_linspace_matches_jax():
    for t0, n in [(t0, n) for t0 in range(1, 1000, 7) for n in (1, 2, 3, 5, 10, 25, 50)]:
        np.testing.assert_array_equal(pg.linspace_int_f32(t0, 0, n + 1),
                                      np.asarray(jnp.linspace(t0, 0, n + 1).astype(jnp.int32)))


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(7)
    B, F = 2, 3
    return dict(
        rgb=rng.random((B, 24, 24, 3), dtype=np.float32),
        el=np.float32([10.0, -5.0]), az=np.float32([30.0, -120.0]), dist=np.float32([3.8, 3.8]),
        fi=np.array([2, 0]), u=np.float32([0.3, 0.8]),
        noise=rng.normal(size=(B, 4, L, L)).astype(np.float32),
        bank_cross=rng.normal(size=(F, 32)).astype(np.float32),
        bank_concat=rng.normal(size=(F, 4, L, L)).astype(np.float32))


@pytest.fixture
def fixed_jax_draws(monkeypatch, draws):
    """``jax.random.uniform`` / ``normal`` return the test's draws (NHWC)."""
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(draws["u"]))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(draws["noise"].transpose(0, 2, 3, 1)))


def test_sds_loss_matches_jax(pair, draws, fixed_jax_draws):
    guidance, jguid, jparams, _ = pair
    d = draws
    step = 120
    bank = {"c_crossattn": torch.as_tensor(d["bank_cross"]),
            "c_concat": torch.as_tensor(d["bank_concat"])}
    jbank = {"c_crossattn": d["bank_cross"], "c_concat": d["bank_concat"].transpose(0, 2, 3, 1)}

    def j_loss(rgb):
        out = jguid.sds_loss(jparams, jbank, jax.random.PRNGKey(0), rgb, d["el"], d["az"], d["dist"],
                             d["fi"], step)
        return out["loss_sds"], out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(d["rgb"])
    rgb = torch.as_tensor(d["rgb"]).requires_grad_(True)
    out = guidance.sds_loss(bank, rgb, torch.as_tensor(d["el"]), torch.as_tensor(d["az"]),
                            torch.as_tensor(d["dist"]), torch.as_tensor(d["fi"]), step,
                            u=torch.as_tensor(d["u"]), noise=torch.as_tensor(d["noise"]))
    out["loss_sds"].backward()
    t_jax = np.asarray(jnp.clip((C_jax(TINY["min_step_percent"], step) * 1000 + jnp.asarray(d["u"])
                                 * (C_jax(TINY["max_step_percent"], step)
                                    - C_jax(TINY["min_step_percent"], step)) * 1000).astype(jnp.int32),
                                1, 999))
    np.testing.assert_array_equal(out["t"].numpy(), t_jax)
    for k in ("loss_sds", "grad_norm", "min_step", "max_step"):
        got, want = float(out[k].detach()), float(jout[k])
        print(f"{k}: {got!r} vs JAX {want!r}, relative {abs(got - want) / abs(want):.3g}")
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    assert float(out["loss_sds"].detach()) > 0
    _close(rgb.grad.numpy(), jgrad, 1e-3, "d loss / d rgb")


def test_prepare_embeddings_and_guidance_eval_match_jax(pair, draws, fixed_jax_draws, monkeypatch):
    guidance, jguid, jparams, _ = pair
    d = draws
    frames = np.random.default_rng(8).random((5, 24, 24, 3), dtype=np.float32)
    # the JAX bank is built eagerly per chunk: run its two encoders jitted
    jmods = jguid.modules
    monkeypatch.setattr(jmods, "clip_embed", jax.jit(jmods.clip_embed))
    monkeypatch.setattr(jmods, "encode_cond_latent", jax.jit(jmods.encode_cond_latent))
    jbank = jguid.prepare_embeddings(jparams, frames)
    bank = guidance.prepare_embeddings(torch.as_tensor(frames))
    _close(bank["c_crossattn"].numpy(), jbank["c_crossattn"], 1e-4, "c_crossattn")
    _close(_nhwc(bank["c_concat"]), jbank["c_concat"], 1e-4, "c_concat")

    args = (torch.as_tensor(d["rgb"]), torch.as_tensor(d["el"]), torch.as_tensor(d["az"]),
            torch.as_tensor(d["dist"]), torch.as_tensor(d["fi"]))
    out = guidance.guidance_eval(bank, *args, noise=torch.as_tensor(d["noise"]), n_denoise_steps=2)
    jout = jax.jit(lambda p, b, rgb, el, az, dist, fi: jguid.guidance_eval(
        p, b, jax.random.PRNGKey(0), rgb, el, az, dist, fi, n_denoise_steps=2))(
        jparams, jbank, d["rgb"], d["el"], d["az"], d["dist"], d["fi"])
    for k in ("img_noisy", "img_1step", "img_final"):
        assert out[k].shape == (2, 16, 16, 3)
        print(f"{k}: max |d| {np.abs(out[k].numpy() - np.asarray(jout[k])).max():.3g}")
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=0, atol=1e-4, err_msg=k)


def test_checkpoint_loads_like_jax(pair, tmp_path):
    """A tiny ``.ckpt`` in the LDM layout with schedule, EMA and text-tower
    keys to skip: both loaders report the same keys and load the same
    weights; ``strict`` refuses an unmapped key; a directory is refused."""
    guidance, jguid, _, sd = pair
    extra = {"betas": np.zeros(4, np.float32), "alphas_cumprod": np.ones(4, np.float32),
             "model_ema.decay": np.float32(0.99),
             "cond_stage_model.model.transformer.resblocks.0.ln_1.weight": np.ones(4, np.float32),
             "cond_stage_model.model.logit_scale": np.float32(1.0),
             "first_stage_model.loss.logvar": np.zeros(1, np.float32)}
    full = {k: torch.as_tensor(np.asarray(v)) for k, v in {**sd, **extra}.items()}
    path = str(tmp_path / "tiny.ckpt")
    torch.save({"state_dict": full, "global_step": 7}, path)

    mods = pg.Zero123Modules(pg.Zero123Config(**TINY), device="cpu")
    report = pckpt.load_zero123_checkpoint(path, mods, strict=True)
    _, jreport = convert_state_dict({k: v.numpy() for k, v in full.items()}, jguid.modules)
    assert report == jreport
    assert report["unmapped"] == [] and set(report["skipped"]) == set(extra)
    jparams = load_zero123_checkpoint(path, jguid.modules, strict=True)
    back = convert.zero123_guidance_params(jax.tree.map(np.asarray, jparams), guidance.cfg)
    for k, v in mods.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), back[k], err_msg=k)

    torch.save({"state_dict": {**full, "model.diffusion_model.extra.weight": torch.ones(1)}}, path)
    with pytest.raises(KeyError, match="extra.weight"):
        pckpt.load_zero123_checkpoint(path, mods, strict=True)
    assert "model.diffusion_model.extra.weight" in pckpt.load_zero123_checkpoint(path, mods)["unmapped"]
    del full["model.diffusion_model.out.2.bias"]
    torch.save(full, path)
    with pytest.raises(KeyError, match="missing"):
        pckpt.load_zero123_checkpoint(path, mods)
    with pytest.raises(ValueError, match="orbax"):
        pckpt.load_zero123_checkpoint(str(tmp_path), mods)


def test_registry_and_config():
    assert find("stable-zero123-guidance") is pg.StableZero123GuidanceComponent
    assert find("temporal-stable-zero123-guidance") is pg.TemporalStableZero123Guidance
    for name, dt in (("float32", torch.float32), ("bf16", torch.bfloat16), ("float16", torch.bfloat16)):
        assert pg.Zero123Config(dtype=name).dtype == dt
    with pytest.raises(ValueError, match="guidance.dtype"):
        pg.Zero123Config(dtype="int8")
    cfg = pg.config_from_dict({"guidance_render_size": 256, "allow_missing": True, "use_clip": False,
                               "channel_mult": [1, 2]})
    assert cfg.channel_mult == (1, 2) and not cfg.use_clip


def test_init_params_keeps_the_zero_inits():
    """Random weights from a ``torch.Generator``: the LDM's zero-initialised
    convolutions stay zero (so the UNet returns zeros), ``cc_projection`` is
    the identity on the CLIP embedding; ``zero_init=False`` draws them."""
    cfg = pg.Zero123Config(**{**TINY, "use_clip": False})
    mods = pg.Zero123Modules(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    sd = mods.state_dict()
    names = mods.zero_init_names()
    assert len(names) == 2 * (8 + 7) + 2  # 8 ResBlocks and 7 transformers hold 2 each; out.2
    assert all(float(sd[n].abs().max()) == 0 for n in names)
    np.testing.assert_array_equal(sd["cc_projection.weight"].numpy(), np.eye(32, 36, dtype=np.float32))
    assert float(sd["clip_proj"].abs().max()) > 0
    x, t, ctx = _unet_inputs(np.random.default_rng(9))
    out = mods.unet(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(ctx))
    assert float(out.abs().max()) == 0
    again = pg.Zero123Modules(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    drawn = pg.Zero123Modules(cfg, device="cpu").init_params(torch.Generator().manual_seed(0),
                                                             zero_init=False)
    assert all(float(drawn.state_dict()[n].abs().max()) > 0 for n in names if n.endswith("weight"))

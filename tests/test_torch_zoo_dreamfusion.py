"""The port's ``dreamfusion-system`` from ``configs/zoo/dreamfusion-sd.yaml``
against the JAX package's (CPU): one train step of each experiment, built
from the YAML through both packages' config loaders at a tiny size, with
the Stable Diffusion guidance on.

The size: 8² random views (one a step, the YAML's data block otherwise),
2 hash levels of 2⁸ corner rows (base 4, scale 2), the YAML's MLPs and
renderer (64 + 64 samples a ray), SD at ``random:0`` with a UNet 16 × [1]
(2 heads, context 16), a VAE 8 × [1], latents and images 8², prompt
embeddings 4 × 16.  The JAX guidance's ``init_params`` is replaced by
seeded numpy draws of the same tree (its eager flax init compiles op by
op), and the JAX train step, jitted while the experiment is built, compiles
with XLA's cheaper passes (but prolificdreamer's: its test sits at a ReLU's
kink, where the other passes' rounding moves a gradient past its band).  The JAX experiment's guidance weights reach the port
through ``convert.sd_guidance_params``, its initial state through
``convert.zero123_checkpoint``; the prompt embeddings are the hash
embeddings of the same prompt on both sides.  The random draws (the
samples' jitter, the SDS timestep and noise) are handed to both sides as
the same numpy numbers per shape (``jax.random.uniform`` / ``normal``, the
renderer's ``draw_uniform`` / ``draw_normal`` and the guidances' ``_draw``
monkeypatched).  Bands, those of ``test_torch_nerf_train.py``: every metric
within 1e-4 relative (1e-6 absolute floor), every leaf's gradient within
1e-3 of its max |g|, the parameters after Adam (the YAML's eps 1e-15)
within 1e-6 where |g| ≥ 5 % of the leaf's max.  The helpers here serve
``test_torch_zoo_eff.py``, ``test_torch_zoo_magic123.py``,
``test_torch_zoo_latentnerf.py``, ``test_torch_zoo_sjc.py`` and
``test_torch_zoo_prolificdreamer.py`` too.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax_compile import FAST_COMPILE, _cheap_xla  # noqa: F401
from test_torch_zoo_sd import _seeded_tree as seeded_tree

import dreammesh4d_tpu.models.geometry.implicit_volume as jiv
from dreammesh4d_tpu.config import load_config as j_load_config
from dreammesh4d_tpu.models.guidance import stable_diffusion as jsd
from dreammesh4d_tpu.models.guidance.zero123 import guidance as jz123
from dreammesh4d_tpu.systems import assembly as jasm
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.models.guidance import stable_diffusion as psd
from dreammesh4d_tpu_torch.models.guidance import vsd as pvsd
from dreammesh4d_tpu_torch.models.guidance.zero123 import guidance as pz123
from dreammesh4d_tpu_torch.models.renderers import nerf_volume_renderer as tnr
from dreammesh4d_tpu_torch.systems import assembly
from dreammesh4d_tpu_torch.systems import threestudio_zoo2 as tz2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SD = ["system.guidance.pretrained_model_name_or_path=random:0", "system.guidance.model_channels=16",
           "system.guidance.channel_mult=[1]", "system.guidance.num_res_blocks=1",
           "system.guidance.num_heads=2", "system.guidance.context_dim=16", "system.guidance.latent_size=8",
           "system.guidance.image_size=8", "system.guidance.vae_ch=8", "system.guidance.vae_ch_mult=[1]",
           "system.guidance.vae_num_res_blocks=1", "system.prompt_processor.context_dim=16",
           "system.prompt_processor.seq_len=4", "system.prompt_processor.prompt=a test object"]
GRID = ["system.geometry.pos_encoding_config.n_levels=2",
        "system.geometry.pos_encoding_config.log2_hashmap_size=8",
        "system.geometry.pos_encoding_config.base_resolution=4",
        "system.geometry.pos_encoding_config.per_level_scale=2.0"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree):
    out = [tree["encoding"]["tables"]]
    for name in ("density_mlp", "feature_mlp"):
        for layer in tree[name]:
            out += [layer["w"], layer["b"]]
    return out


def _grad_keeper():
    """An optax transformation that passes the gradient on and keeps it as
    its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


def build_jax(path, dotlist, fast_compile=True):
    """The JAX experiment of the YAML at ``path`` and the dotlist; its Adam
    keeps each step's gradient in its first state.  ``fast_compile``: its
    train step compiled with XLA's cheaper passes."""
    real = optax.adam
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "adam", lambda *a, **kw: optax.chain(_grad_keeper(), real(*a, **kw)))
        for cls in (jsd.StableDiffusionGuidance, jz123.Zero123Modules):
            init = cls.init_params  # eager flax inits compile op by op: seeded draws instead
            mp.setattr(cls, "init_params", lambda self, rng, init=init: seeded_tree(
                jax.eval_shape(lambda k: init(self, k), rng), 0))
        for name in ("clip_embed", "encode_cond_latent"):  # the bank's encoders, jitted
            method = getattr(jz123.Zero123Modules, name)
            mp.setattr(jz123.Zero123Modules, name, lambda self, *a, m=method: jax.jit(
                lambda *b: m(self, *b))(*a))
        init_volume = jiv.init_implicit_volume
        mp.setattr(jiv, "init_implicit_volume", lambda cfg, rng: jax.jit(lambda k: init_volume(cfg, k))(rng))
        if fast_compile:  # the train step is jitted while the experiment is built
            mp.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
        return jasm.build_experiment(j_load_config(path, cli_args=dotlist))


def build_port(path, dotlist, jexp):
    """The port's experiment of the same YAML, from the JAX one's state."""
    exp = assembly.build_experiment(load_config(path, cli_args=dotlist), device="cpu")
    s = np_tree(jexp.state)
    exp.load_state(convert.zero123_checkpoint(
        {"geo_params": s.geo_params, "step": s.step, "opt_state": s.opt_state[1]}, eps=exp.adam["eps"]))
    return exp


def build_pair(yaml, dotlist):
    """Both packages' experiments from ``configs/zoo/<yaml>`` and the dotlist;
    the port's starts from the JAX one's parameters and SD weights."""
    path = os.path.join(REPO, "configs", "zoo", yaml)
    jexp = build_jax(path, dotlist)
    exp = build_port(path, dotlist, jexp)
    gparams = jexp._gstate["2d"]["params"] if "2d" in jexp._gstate else jexp._gstate["params"]
    guidance = exp.pack[0]
    guidance.modules.load_state_dict(
        {k: torch.tensor(v) for k, v in convert.sd_guidance_params(np_tree(gparams), guidance.cfg).items()})
    return jexp, exp


def same_draws(monkeypatch):
    """The JAX draws and the port's give the same numbers for the same shape
    (the port's SDS noise is the NCHW view of the JAX NHWC one; a JAX
    uniform's ``minval`` / ``maxval`` scale its numbers, and its
    ``bernoulli(p, (B, 1, 1))`` is the port's (B,) uniform below p)."""
    tables = {}

    def numbers(kind, shape):
        key = (kind, tuple(int(s) for s in shape))
        if key not in tables:
            rng = np.random.default_rng(len(tables) + 11)
            tables[key] = (rng.uniform(size=key[1]) if kind == "u"
                           else rng.normal(size=key[1])).astype(np.float32)
        return tables[key]

    def sds_draw(generator, shape, normal, device):
        if normal and len(shape) == 4:
            B, C, H, W = shape
            return torch.tensor(numbers("n", (B, H, W, C)).transpose(0, 3, 1, 2).copy())
        return torch.tensor(numbers("n" if normal else "u", shape))

    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), dtype=None, minval=0.0, maxval=1.0:
                        jnp.asarray(numbers("u", shape)) * (maxval - minval) + minval)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape:
                        jnp.asarray(numbers("u", shape[:1]).reshape(shape) < p))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), *a, **k: jnp.asarray(numbers("n", shape)))
    monkeypatch.setattr(tnr, "draw_uniform", lambda rng, shape, device: torch.tensor(numbers("u", shape)))
    monkeypatch.setattr(tz2, "draw_uniform", lambda rng, shape, device: torch.tensor(numbers("u", shape)))
    monkeypatch.setattr(tnr, "draw_normal", lambda rng, shape, device: torch.tensor(numbers("n", shape)))
    for module in (psd, pz123, pvsd):
        monkeypatch.setattr(module, "_draw", sds_draw)
    return tables


def check_one_step(jexp, exp, monkeypatch, sds_keys=("loss_sds",), reseed=None,
                   jax_grads=lambda state: state.opt_state[0]):
    """``train_step(0)`` of both on the same draws, within the bands;
    ``reseed`` seeds the global numpy stream before each; ``jax_grads``
    reads the kept gradient out of the JAX state."""
    same_draws(monkeypatch)
    jparams = np_tree(jexp.state.geo_params)
    if reseed is not None:
        np.random.seed(reseed)
    jmetrics = np_tree(jexp.train_step(0))
    if reseed is not None:
        np.random.seed(reseed)
    metrics = exp.train_step(0)
    assert exp.state.step == int(jexp.state.step) == 1
    assert set(metrics) == set(jmetrics)
    for k in sds_keys:
        assert float(metrics[k]) > 0, k
    for k in sorted(metrics):
        ref, got = float(jmetrics[k]), float(metrics[k])
        print(f"{k}: {got!r} vs JAX {ref!r}")
        assert abs(got - ref) <= max(1e-4 * abs(ref), 1e-6), (k, got, ref)
    jgrads = np_tree(jax_grads(jexp.state))
    jnew = np_tree(jexp.state.geo_params)
    n_checked = 0
    for leaf, jg, jp, jn in zip(leaves(exp.state.geo_params), leaves(jgrads), leaves(jparams), leaves(jnew)):
        g = leaf.grad.numpy()
        assert g.shape == jg.shape and np.isfinite(g).all() and np.abs(jg).max() > 0
        err = np.abs(g - jg).max() / np.abs(jg).max()
        assert err <= 1e-3, err
        sure = np.abs(jg) >= 0.05 * np.abs(jg).max()
        n_checked += int(sure.sum())
        np.testing.assert_allclose(leaf.detach().numpy()[sure], jn[sure], atol=1e-6)
        assert np.abs(jn - jp).max() > 0
    assert n_checked > 100
    return metrics


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo_dreamfusion")
    return build_pair("dreamfusion-sd.yaml", TINY_SD + GRID + [
        "data.width=8", "data.height=8", f"exp_root_dir={out}", "use_timestamp=false"])


def test_dreamfusion_step_matches_jax(pair, monkeypatch):
    jexp, exp = pair
    assert type(exp).__name__ == "ZooTextExperiment" and not exp._eff
    assert exp.geo_cfg == convert.implicit_volume_config(jexp.geo_cfg)
    assert exp.rcfg == convert.nerf_renderer_config(jexp.rcfg)
    assert exp.geo_cfg.hashgrid.layout == "corner"
    assert (exp.adam["lr"], exp.adam["betas"], exp.adam["eps"]) == (0.01, (0.9, 0.99), 1e-15)
    np.testing.assert_array_equal(exp.pack[1].cond.numpy(), np.asarray(jexp._gstate["prompts"].cond))
    metrics = check_one_step(jexp, exp, monkeypatch)
    assert set(metrics) == {"loss_sds", "loss_orient", "loss_sparsity", "loss_opaque", "loss_total"}
